"""The program stretch (portbench/program.py) and the readers of the
program's spans: on a planted Chrome trace and spans on the CPU, and on the
card, where the stretch has to place the device's operations by their
launches."""

import json

import pytest

from portbench import cells, program, trace
from portbench.metrics import (embed_device_ms, entry_idle_ms, layer_row_ns, outputs_device_ms,
                               prep_device_ms, select_device_ms)

BASE = 10 ** 18  # the trace's baseTimeNanoseconds
US = 1e-6
READERS = {"embed_device_ms": embed_device_ms, "prep_device_ms": prep_device_ms,
           "select_device_ms": select_device_ms, "outputs_device_ms": outputs_device_ms,
           "entry_idle_ms": entry_idle_ms, "layer_row_ns": layer_row_ns}


def _spans() -> dict:
    """Three served calls, times in microseconds from BASE: (name, start, end,
    parent index), and the token rows of a run of layers. The first fills
    the pipeline."""
    rows = [("serve", 0, 40, None),
            ("serve", 105, 185, None), ("embed", 110, 120, 1), ("prep", 120, 125, 1),
            ("select", 125, 135, 1), ("layers", 135, 170, 1, 1000), ("prep", 136, 138, 5),
            ("outputs", 170, 182, 1),
            ("serve", 195, 290, None), ("embed", 197, 205, 8), ("prep", 205, 210, 8),
            ("select", 210, 220, 8), ("layers", 220, 280, 8, 2000), ("prep", 221, 223, 12),
            ("outputs", 280, 285, 8)]
    spans, call = [], 0
    for name, s, e, parent, *n in rows:
        call += parent is None
        spans.append({"name": name, "start": BASE + s * 1000, "end": BASE + e * 1000,
                      "parent": parent, "call": call, "rows": n[0] if n else None})
    return {"spans": spans, "dropped": 0}


# device operations: (name, launch us or None, start, end)
OPS = [("fill", 10, 20, 80), (trace.ANSWER_COPY, 41, 80, 100), ("stray", None, 40, 50),
       ("embed2", 111, 111, 121), ("prep2", 121, 121, 124), ("select2", 126, 127, 134),
       ("prep2b", 137, 137, 138), ("layer2", 139, 139, 165), ("outputs2", 171, 171, 174),
       (trace.ANSWER_COPY, 186, 186, 188),
       ("embed3", 198, 198, 206), ("prep3", 206, 206, 208), ("select3", 211, 211, 219),
       ("prep3b", 221.5, 222, 223), ("layer3", 224, 224, 270), ("outputs3", 281, 281, 284),
       (trace.ANSWER_COPY, 291, 291, 300)]


def _exported() -> dict:
    events = []
    for k, (name, launch, s, e) in enumerate(OPS):
        cat = "gpu_memcpy" if name == trace.ANSWER_COPY else "kernel"
        events.append({"ph": "X", "cat": cat, "name": name, "ts": s, "dur": e - s, "tid": 7,
                       "args": {"correlation": k}})
        if launch is not None:
            events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                           "ts": launch, "dur": 0.5, "tid": 1, "args": {"correlation": k}})
    return {"baseTimeNanoseconds": BASE, "traceEvents": events}


def _prog() -> dict:
    return program.records(_exported(), _spans(), 1)


def test_the_stretch_places_operations_in_their_innermost_span():
    prog = _prog()
    assert prog["window"]["batches"] == 2 and prog["counted"] == [2, 3]
    assert prog["window"]["t1"] == pytest.approx(200 * US)
    assert prog["unplaced"] == 1
    where = {d["name"]: (None if d["span"] is None else prog["spans"][d["span"]]["name"])
             for d in prog["device_ops"]}
    assert where["prep2b"] == "prep" and where["layer2"] == "layers"
    assert where["select3"] == "select" and where["fill"] == "serve"
    assert where["stray"] is None
    # idle by the innermost span at each gap's midpoint, per batch (ms)
    split = program.idle_split(prog)
    want = {"serve": 18, "select": 3, "layers": 25, "outputs": 12, "prep": 3,
            program.OUTSIDE: 10}
    assert split == pytest.approx({k: v * 1e-3 / 2 for k, v in want.items()})
    assert program.idle_share(prog) == pytest.approx(35.5)
    assert program.host_self_ms(prog) == pytest.approx(
        {"serve": 7.5e-3, "embed": 9e-3, "prep": 7e-3, "select": 10e-3, "layers": 45.5e-3,
         "outputs": 8.5e-3})
    assert program.device_ms(prog, "head") is None
    assert program.records(_exported(), {"spans": [], "dropped": 0}, 1) is None


@pytest.mark.parametrize("name, want", [
    ("embed_device_ms", 18e-3 / 2), ("prep_device_ms", 7e-3 / 2),
    ("select_device_ms", 15e-3 / 2), ("outputs_device_ms", 6e-3 / 2),
    ("entry_idle_ms", 61e-3 / 2), ("layer_row_ns", (26 + 46) * 1e3 / (1000 + 2000))])
def test_program_readers(name, want):
    """Each reader on the planted stretch, per batch (layer_row_ns: per token
    row of the `layers` spans); None where the run has no program records
    (a control or a planted fault records no spans)."""
    reader = READERS[name]
    assert reader.read({"program": _prog()}) == pytest.approx(want)
    assert reader.read({"program": None}) is None
    assert reader.read({"trace": None}) is None


def test_entry_idle_and_outside_make_the_stretchs_idle_time():
    prog = _prog()
    idle = sum(length for length, _ in program.idle_gaps(prog)) * 1e3 / 2
    assert entry_idle_ms.read({"program": prog}) + program.idle_split(prog)[program.OUTSIDE] \
        == pytest.approx(idle)


def test_the_existing_readers_read_the_same_beside_the_program_records():
    def x(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
                "args": args}
    host = [x("user_annotation", "portbench.batch", 0, 100),
            x("user_annotation", "portbench.batch", 200, 100),
            x("cpu_op", "vpt::fused_vit_layer", 210, 20, **{"Input Dims": [[8, 99, 384]]}),
            x("cuda_runtime", "cudaLaunchKernel", 215, 2, correlation=7),
            x("kernel", "layer_kernel", 230, 50, tid=7, correlation=7),
            x("cuda_runtime", "cudaLaunchKernel", 240, 2, correlation=8),
            x("kernel", "topk_kernel", 290, 10, tid=7, correlation=8),
            x("user_annotation", "portbench.copy", 250, 10),
            x("cuda_runtime", "cudaMemcpyAsync", 252, 2, correlation=9),
            x("gpu_memcpy", "Memcpy DtoH", 300, 5, tid=7, correlation=9)]
    timeline = trace.device_timeline(_exported()["traceEvents"], 1)
    cfg = json.loads((cells.ROOT / "portbench" / "configs" / "deit_s.json").read_text())
    records = {"model": cells.model_dims(cfg), "setup_s": 9.5, "flops_per_image": 4.2e9,
               "window": {"images": 4096, "seconds": 0.1, "batches": 8, "inside_s": 0.04,
                          "latency_ms": [25.0, 25.5, 26.0, 24.0]},
               "trace": trace.records(host, 1), "timeline": timeline}
    names = [p.stem for p in sorted((cells.ROOT / "portbench" / "metrics").glob("*.py"))
             if p.stem not in READERS]
    assert {"other_device_ms", "device_idle_share", "b1_roofline"} <= set(names)
    for name in names:
        read = cells.reader(cells.ROOT / "portbench", name)
        assert read(dict(records, program=_prog())) == read(records), name


@pytest.mark.card
def test_the_program_stretch_places_the_device_operations(card):
    """DeiT-S headline at its size: at least 99% of the stretch's device
    operations have a launch event, and of those in the window that the
    benchmark did not launch (its answer copies), 99% fall in a span."""
    from portbench.program_run import serving

    cell = cells.load_cell("deit_s.headline.bf16.b512")
    cell["traffic"] = dict(cell["traffic"], trace_batches=8)
    server = serving(cell, 2 ** 31 + 21, card)
    prog = program.stretch(server, cell)
    ops = prog["device_ops"]
    assert prog["unplaced"] <= 0.01 * len(ops)
    mine = [d for d in ops if d["end"] > 0 and d["start"] < prog["window"]["t1"]
            and d["name"] != trace.ANSWER_COPY]
    assert sum(d["span"] is not None for d in mine) >= 0.99 * len(mine)
    assert program.device_ms(prog, "embed") > 0 and program.device_ms(prog, "select") > 0
