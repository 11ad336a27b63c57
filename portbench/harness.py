"""One run of one cell: set-up, the timed window, the traced stretches, the
output check and the result line's contents.

The program is imported only here and only inside `program_call`; the
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
    """The timed entry: vit_pruning_tpu_torch.serving.serving_forward on the
    cell's model and traffic, in the program's default kernel mode. Under
    int8 the layers' int8 weights are attached once here, at set-up, as a
    deployment quantizes once at load. Returns f(pixels_u8) -> outputs."""
    from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
    from vit_pruning_tpu_torch.ops.quant import attach_int8_weights
    from vit_pruning_tpu_torch.serving import serving_forward

    m, traffic = cell["model"], cell["traffic"]
    quant = traffic["quant"] if quant is None else quant
    vcfg = ViTConfig(image_size=m["image"], patch_size=m["patch"], num_channels=m["channels"],
                     hidden_size=m["hidden"], num_layers=m["layers"], num_heads=m["heads"],
                     mlp_dim=m["mlp"], num_labels=m["labels"], layernorm_eps=m["eps"])
    sched = prune_schedule(cell)
    if traffic["keep_fraction"] is None:  # nothing drops: no predictor runs
        pcfg = PruneConfig(mode="topk_prog", keep_schedule=tuple(sched))
    else:  # one drop before layer 0, the PruneConfig default schedule
        pcfg = PruneConfig(mode="topk_prog", predictor=m["predictor"],
                           predictor_hidden=m["predictor_hidden"], top_k=sched[0])
    if quant == "int8":
        bb = params["backbone"]
        params = dict(params, backbone=dict(bb, layers=attach_int8_weights(bb["layers"])))

    def call(pixels):
        return serving_forward(params, pixels, vcfg, pcfg, logits_only=True, quant=quant)
    return call


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
    m, traffic = cell["model"], cell["traffic"]
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
    params = weights.make_params(m, seed, device, DTYPES[traffic["dtype"]])
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
    judged = check.judge(params, pool, answers, m, sched, cell["limits"], precision(cell))
    correct = check.verdict(judged["numbers"], cell["limits"])
    phases["check_s"] = time.perf_counter() - t_check

    records = {"model": m, "traffic": traffic, "schedule": sched, "setup_s": setup_s,
               "window": window, "flops_per_image": work.model_flops(m, sched), "trace": rec,
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
