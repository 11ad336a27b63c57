"""One run of one cell: set-up, the timed window, the traced stretches, the
output check and the result line's contents.

The cell's model family (portbench/families/) gives its weights, its entry,
its plain reference and its operations per image. The program is imported
only inside a family's `program` and here to load the kernels; the
reference, the traffic, the weights and the yardstick import nothing of it.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

import torch

from portbench import cells, check, trace, weights, work
from portbench.serve import Server

# modules that may not be loaded in the process that prints the result,
# compared by whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "vit_pruning_tpu")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among the loaded modules."""
    names = {name.split(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def prune_schedule(cell: dict) -> list:
    return work.schedule(cell["model"], cell["traffic"]["keep_fraction"])


def program_call(cell: dict, params: dict, quant: str = None):
    """The timed entry of the cell's family (families/<name>.py's
    `program`; a cell dict without a family is a `vit`): f(pixels_u8) ->
    outputs. `quant` None takes the traffic's."""
    return cells.family_of(cell).program(cell, params, quant)


def precision(cell: dict) -> dict:
    """The reference's weight products for this cell's traffic
    (portbench/reference.py): the int8 scheme in layers 0..L-2 of an int8
    cell, float32 elsewhere."""
    return {"layers": "int8" if cell["traffic"]["quant"] == "int8" else "f32", "other": "f32"}


def _profiled(server, batches: int, activities, shapes: bool) -> list:
    """Serve `batches` under torch.profiler; the Chrome trace's events."""
    from torch.profiler import profile

    prof = profile(activities=activities, record_shapes=shapes)
    prof.start()
    try:
        server.run(batches=batches, annotate=shapes)
    finally:
        prof.stop()
    with tempfile.TemporaryDirectory(prefix="portbench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def traced_stretches(server, cell: dict) -> tuple:
    """The device timeline, then the host stretch, each over `trace_batches`
    batches after `in_flight + 2` that fill the pipeline and warm the
    profiler up (portbench/trace.py)."""
    from torch.profiler import ProfilerActivity

    fill = cell["traffic"]["in_flight"] + 2
    n = fill + cell["traffic"]["trace_batches"]
    timeline = trace.device_timeline(
        _profiled(server, n, [ProfilerActivity.CUDA], False), fill)
    rec = trace.records(
        _profiled(server, n, [ProfilerActivity.CPU, ProfilerActivity.CUDA], True), fill)
    return timeline, rec


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, device: torch.device,
             t_start: float, serve=None) -> dict:
    """Set up, serve the window, trace (traced runs), check. `serve(cell,
    params) -> call` replaces the program (a control or a planted fault).
    Returns the result line's contents, with the numbers compared and their
    limits under 'checks' (last), and what the run prints beside it."""
    m, traffic, fam = cell["model"], cell["traffic"], cells.family_of(cell)
    seed = seed % (1 << 63)
    phases = {"start": time.perf_counter() - t_start}

    def phase(name):
        if device.type == "cuda":
            torch.cuda.synchronize()
        phases[name] = time.perf_counter() - t_start

    if device.type == "cuda":
        from vit_pruning_tpu_torch.ops.cuda.build import load_library

        torch.cuda.init()
        phase("cuda")
        load_library()
        phase("kernels")
    params = fam.make_params(m, seed, device, DTYPES[traffic["dtype"]])
    pool = weights.make_pool(m, traffic, seed, device)
    phase("inputs")
    call = (serve or program_call)(cell, params)
    server = Server(call, pool, traffic["in_flight"])
    phase("entry")
    server.run(batches=traffic["pool"] + traffic["in_flight"])  # every shape the window uses
    phase("warm_up")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    window = server.run(seconds=seconds)
    setup_s = window["t_first"] - t_start
    timeline = rec = None
    if traced:
        timeline, rec = traced_stretches(server, cell)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    answers = server.answers()
    del server, call  # the program's state; the answers stay
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sched = prune_schedule(cell)
    t_check = time.perf_counter()
    judged = check.judge(params, pool, answers, m, sched, cell["limits"], precision(cell),
                         fam.forward)
    correct = check.verdict(judged["numbers"], cell["limits"])
    phases["check_s"] = time.perf_counter() - t_check

    records = {"model": m, "traffic": traffic, "schedule": sched, "setup_s": setup_s,
               "window": window, "flops_per_image": fam.model_flops(m, sched), "trace": rec,
               "timeline": timeline}
    wanted = cell["per_layer"] if traced else cell["end_to_end"]
    metrics = {}
    for spec in wanted:
        value = cells.reader(cell["bench_dir"], spec["name"])(records)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    result = {"correct": correct, "attempted": window["attempted"],
              "failed": window["attempted"] - window["images"] + judged["failed"],
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    if traced:
        result["device"].update(busy_s=trace.busy(timeline),
                                window_s=timeline["t1"] - timeline["t0"])
        result["breakdown"] = trace.breakdown(timeline, rec)
    result["checks"] = {name: {"value": v, "limit": cell["limits"][name]}
                        for name, v in judged["numbers"].items()}
    info = {"phases_s": phases, "checked_images": judged["checked"],
            "window_batches": window["batches"], "window_s": window["seconds"], "setup_s": setup_s,
            "latency_ms_median": statistics.median(window["latency_ms"]),
            "service_ms_median": statistics.median(window["service_ms"]),
            "dispatch_ms_mean": 1e3 * window["inside_s"] / window["batches"],
            "unplaced_device_ops": rec["unplaced"] if rec else None}
    return result, info
