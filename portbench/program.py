"""The program stretch: a traced run's device operations placed in the
program's own spans (vit_pruning_tpu_torch/utils/profiling.py), and the
numbers read from them.

A third profiled stretch beside the two of portbench/trace.py:
`trace_batches` batches after the same `in_flight + 2` that fill the
pipeline, profiled with CUDA activity alone while the program records its
spans, so that the host runs at its untraced pace but for the spans' own
cost. The program stamps its spans
with time.time_ns(), the clock torch.profiler exports its events on (an
event's `ts` in microseconds x 1000 + the trace's `baseTimeNanoseconds`),
so the spans lie on the trace as exported. Each device operation carries
the correlation id of the host API call that launched it; that call's
timestamp places the operation in the innermost span that holds it.

Batches: the program's `serve` spans are the served calls, one a batch, in
order, and the answer copies of portbench/trace.py count them on the
device. As trace.device_timeline, the stretch runs from the end of the
answer copy of the last filling batch to the end of the last batch's, and
the calls after the filling ones are the counted batches.

Spans and what reads them: `embed`, `prep`, `select` and `outputs` give
the device time launched inside them (metrics embed_device_ms,
prep_device_ms, select_device_ms, outputs_device_ms); `serve` holds the
card's idle gaps the program's own dispatch made (entry_idle_ms); `layers`
holds the layer kernels B1, B4 and B5, whose device time over the token rows
its `rows` count gives (layer_row_ns); `head` holds B2 (read by trace.py's
operator spans, not here).

No cell runs this yet: portbench/run.py reads these six metrics once
harness.run_cell calls `stretch(server, cell)` after trace.py's two
stretches and stores the result under the records key `program` (PERF.md,
Open questions); until then every reader of them returns None. A run whose
entry is not the program (a control, a planted fault) records no spans and
reads None too. `portbench/program_run.py` runs a cell with it meanwhile.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

from portbench import trace

SERVE = "serve"
OUTSIDE = "outside the program"


def stretch(server, cell: dict):
    """Serve `in_flight + 2 + trace_batches` batches under torch.profiler
    (CUDA activity alone) with the program's spans recorded; their records,
    or None where the entry recorded no spans."""
    from torch.profiler import ProfilerActivity, profile

    from vit_pruning_tpu_torch.utils import profiling

    fill = cell["traffic"]["in_flight"] + 2
    n = fill + cell["traffic"]["trace_batches"]
    profiling.take()  # nothing recorded before the stretch
    prof = profile(activities=[ProfilerActivity.CUDA])
    with profiling.tracing(True):
        prof.start()
        try:
            server.run(batches=n)
        finally:
            prof.stop()
    spans = profiling.take()
    with tempfile.TemporaryDirectory(prefix="portbench-program-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            exported = json.load(f)
    return records(exported, spans, fill)


def records(exported: dict, taken: dict, skip_batches: int):
    """The program stretch's records from an exported Chrome trace and the
    program's taken spans (utils/profiling.py::take), the first
    `skip_batches` calls filling the pipeline. Times in seconds from the
    end of the last filling batch's answer copy. None without `serve` spans.

    spans: name, start, end, parent, call, rows, as taken; counted: the
    call ids of the counted batches; device_ops: name, start, end, span
    (index of the innermost span holding the launch, or None); window: t0,
    t1, batches; unplaced: device operations without a launch event;
    dropped: spans the program's buffer had no room for."""
    spans = taken["spans"]
    serves = [sp for sp in spans if sp["name"] == SERVE and sp["parent"] is None]
    if len(serves) <= skip_batches:
        return None
    events = [e for e in exported["traceEvents"] if e.get("ph") == "X"]
    base = exported["baseTimeNanoseconds"]
    ends = sorted(e["ts"] + e["dur"] for e in events
                  if e.get("cat") in trace.DEVICE_CATS and e["name"] == trace.ANSWER_COPY)
    if len(ends) <= skip_batches:
        raise ValueError(f"the program stretch holds {len(ends)} answer copies")
    t0, t1 = ends[skip_batches - 1], ends[-1]
    out = [dict(sp, start=((sp["start"] - base) / 1e3 - t0) * 1e-6,
                end=((sp["end"] - base) / 1e3 - t0) * 1e-6) for sp in spans]
    starts = [sp["start"] for sp in out]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in trace.LAUNCH_CATS and "correlation" in e.get("args", {})}
    dev, unplaced = [], 0
    for e in events:
        if e.get("cat") not in trace.DEVICE_CATS:
            continue
        lt = launch_ts.get(e.get("args", {}).get("correlation"))
        unplaced += lt is None
        dev.append({"name": e["name"], "start": (e["ts"] - t0) * 1e-6,
                    "end": (e["ts"] + e["dur"] - t0) * 1e-6,
                    "span": None if lt is None else innermost(out, starts, (lt - t0) * 1e-6)})
    return {"spans": out, "counted": [sp["call"] for sp in serves[skip_batches:]],
            "device_ops": dev, "unplaced": unplaced, "dropped": taken["dropped"],
            "window": {"t0": 0.0, "t1": (t1 - t0) * 1e-6, "batches": len(ends) - skip_batches}}


def innermost(spans: list, starts: list, t: float):
    """Index of the innermost span holding time t, else None. Spans of one
    thread nest, and `starts` is their starts in order: the last span to
    start by t holds it, or one of its ancestors does."""
    i = bisect.bisect_right(starts, t) - 1
    while i is not None and i >= 0:
        if spans[i]["end"] >= t:
            return i
        i = spans[i]["parent"]
    return None


def device_ms(prog: dict, name: str):
    """Device milliseconds per counted batch of the operations launched with
    span `name` innermost; None where no counted call opened one."""
    counted = set(prog["counted"])
    spans = prog["spans"]
    if not any(sp["name"] == name and sp["call"] in counted for sp in spans):
        return None
    total = sum(d["end"] - d["start"] for d in prog["device_ops"]
                if d["span"] is not None and spans[d["span"]]["name"] == name
                and spans[d["span"]]["call"] in counted)
    return 1e3 * total / prog["window"]["batches"]


def layer_row_ns(prog: dict):
    """Device nanoseconds per token row per layer of the operations launched
    with a `layers` span innermost: their device time over the rows the
    counted calls' `layers` spans ran; None where no counted call ran one."""
    counted = set(prog["counted"])
    spans = prog["spans"]
    rows = sum(sp["rows"] for sp in spans if sp["name"] == "layers" and sp["call"] in counted)
    if not rows:
        return None
    return 1e6 * device_ms(prog, "layers") * prog["window"]["batches"] / rows


def idle_gaps(prog: dict) -> list:
    """The device's idle gaps over the window: (length in seconds, index of
    the innermost span holding the gap's midpoint, or None)."""
    t0, t1 = prog["window"]["t0"], prog["window"]["t1"]
    ivs = [(max(d["start"], t0), min(d["end"], t1)) for d in prog["device_ops"]
           if d["end"] > t0 and d["start"] < t1]
    spans = prog["spans"]
    starts = [sp["start"] for sp in spans]
    gaps, prev = [], t0
    for s, e in trace.union(ivs) + [[t1, t1]]:
        if s > prev:
            gaps.append((s - prev, innermost(spans, starts, (prev + s) / 2)))
        prev = max(prev, e)
    return gaps


def _root(spans: list, i):
    while spans[i]["parent"] is not None:
        i = spans[i]["parent"]
    return spans[i]


def idle_split(prog: dict) -> dict:
    """Idle milliseconds per batch by the innermost span at each gap's
    midpoint; gaps outside every span under OUTSIDE."""
    by = {}
    for length, i in idle_gaps(prog):
        label = OUTSIDE if i is None else prog["spans"][i]["name"]
        by[label] = by.get(label, 0.0) + length
    return {k: 1e3 * v / prog["window"]["batches"] for k, v in by.items()}


def entry_idle_ms(prog: dict) -> float:
    """Idle milliseconds per batch whose midpoint falls inside a `serve`
    span: the card waited on the program's own dispatch."""
    spans = prog["spans"]
    total = sum(length for length, i in idle_gaps(prog)
                if i is not None and _root(spans, i)["name"] == SERVE)
    return 1e3 * total / prog["window"]["batches"]


def idle_share(prog: dict) -> float:
    """Percent of the window in which no device operation ran."""
    wall = prog["window"]["t1"] - prog["window"]["t0"]
    return 100.0 * sum(length for length, _ in idle_gaps(prog)) / wall


def host_self_ms(prog: dict) -> dict:
    """Host milliseconds per counted batch in each span name less the
    part its child spans cover (children of one thread nest)."""
    counted = set(prog["counted"])
    spans = prog["spans"]
    own = [sp["end"] - sp["start"] for sp in spans]
    for sp in spans:
        if sp["parent"] is not None:
            own[sp["parent"]] -= sp["end"] - sp["start"]
    by = {}
    for sp, t in zip(spans, own):
        if sp["call"] in counted:
            by[sp["name"]] = by.get(sp["name"], 0.0) + t
    return {k: 1e3 * v / prog["window"]["batches"] for k, v in by.items()}
