"""From profiled stretches of batches to the records the per-layer readers
read. A traced run profiles two stretches after its window, each exported
as a Chrome trace and read back here:

  * the device timeline (torch.profiler with CUDA activity alone, so that
    the host runs at its untraced pace): the device's operations, and the
    batches told apart by the one copy of each batch's logits into pinned
    host memory that the benchmark makes;
  * the host stretch (CPU and CUDA activity, input shapes recorded), in
    which host and device events share a clock. The benchmark marks each
    batch with the span `portbench.batch` (the call of the served entry and
    the copy of its logits), the copy with `portbench.copy` and the wait
    on a batch with `portbench.wait`. Recording every host operation slows
    the host, so its idle gaps are longer than untraced ones.

Attribution: each device operation (kernel, memset, memcpy) carries the
correlation id of the host API call that launched it (cudaLaunchKernel and
the like, runtime or driver). The launch's host timestamp places the
operation in the batch span and in the program's `vpt::` operator span
that enclose it: the operator's device time is the sum of the operations
launched inside its span.
"""

from __future__ import annotations

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
BATCH, COPY, WAIT = "portbench.batch", "portbench.copy", "portbench.wait"
OP_PREFIX = "vpt::"
ANSWER_COPY = "Memcpy DtoH (Device -> Pinned)"


def device_timeline(events: list, skip_batches: int) -> dict:
    """The device's operations between the end of the answer copy of batch
    `skip_batches` - 1 and the end of the last batch's, in seconds from the
    first: ops [(name, start, end)], t0, t1, batches."""
    dev = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    ends = [e for _, e, name in dev if name == ANSWER_COPY]
    if len(ends) <= skip_batches:
        raise ValueError(f"the device timeline holds {len(ends)} answer copies")
    t0, t1 = ends[skip_batches - 1], ends[-1]
    ops = [(name, (s - t0) * 1e-6, (e - t0) * 1e-6) for s, e, name in dev if e > t0 and s < t1]
    return {"ops": ops, "t0": 0.0, "t1": (t1 - t0) * 1e-6, "batches": len(ends) - skip_batches}


def _inside(spans: list, t: float):
    """Index of the span (start, end, ...) sorted by start that holds t, else None."""
    lo, hi = 0, len(spans)
    while lo < hi:  # the last span starting at or before t
        mid = (lo + hi) // 2
        if spans[mid][0] <= t:
            lo = mid + 1
        else:
            hi = mid
    i = lo - 1
    return i if i >= 0 and spans[i][0] <= t <= spans[i][1] else None


def union(intervals: list) -> list:
    """Merged [start, end] intervals of a list of them."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def records(events: list, skip_batches: int) -> dict:
    """Records of a stretch whose first `skip_batches` batch spans filled the
    pipeline and are not counted. Times in seconds from the first counted
    batch's start.

    device_ops: name, start, end, batch (counted batch index or None),
    op (index into ops or None), harness (launched by the benchmark's copy);
    ops: the vpt:: operator calls of counted batches, name, start, end, dims
    (input shapes); stretch: t0, t1 (the first counted batch's start, the
    end of the last device operation of a counted batch), batches;
    host: (start, end, name) of every host event on the serving thread."""
    xs = [e for e in events if e.get("ph") == "X"]
    anns = [e for e in xs if e.get("cat") == "user_annotation"]
    batches = sorted((e["ts"], e["ts"] + e["dur"]) for e in anns if e["name"] == BATCH)
    if len(batches) <= skip_batches:
        raise ValueError(f"the trace holds {len(batches)} batch spans")
    tid = next(e["tid"] for e in anns if e["name"] == BATCH)
    copies = sorted((e["ts"], e["ts"] + e["dur"]) for e in anns if e["name"] == COPY)
    counted = batches[skip_batches:]
    t0 = counted[0][0]
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in xs
                  if e.get("tid") == tid and e.get("cat") in ("cpu_op", "user_annotation"))
    ops_raw = sorted((e["ts"], e["ts"] + e["dur"], e) for e in xs
                     if e.get("cat") == "cpu_op" and e["name"].startswith(OP_PREFIX))
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in xs
                 if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    ops, op_index = [], {}
    for k, (s, e, ev) in enumerate(ops_raw):
        if _inside(counted, s) is not None:
            op_index[k] = len(ops)
            ops.append({"name": ev["name"], "start": (s - t0) * 1e-6, "end": (e - t0) * 1e-6,
                        "dims": ev.get("args", {}).get("Input Dims")})
    spans = [(s, e) for s, e, _ in ops_raw]
    dev, unplaced = [], 0
    for e in xs:
        if e.get("cat") not in DEVICE_CATS:
            continue
        lt = launch_ts.get(e.get("args", {}).get("correlation"))
        b = k = None
        harness = False
        if lt is None:
            unplaced += 1
        else:
            b = _inside(counted, lt)
            k = _inside(spans, lt)
            harness = _inside(copies, lt) is not None
        dev.append({"name": e["name"], "start": (e["ts"] - t0) * 1e-6,
                    "end": (e["ts"] + e["dur"] - t0) * 1e-6, "batch": b,
                    "op": op_index.get(k) if b is not None else None, "harness": harness})
    t1 = max(d["end"] for d in dev if d["batch"] is not None)
    return {"device_ops": dev, "ops": ops, "unplaced": unplaced,
            "stretch": {"t0": 0.0, "t1": t1, "batches": len(counted)},
            "host": [((s - t0) * 1e-6, (e - t0) * 1e-6, n) for s, e, n in host]}


def busy(timeline: dict) -> float:
    """Seconds of the device timeline in which some operation ran."""
    t0, t1 = timeline["t0"], timeline["t1"]
    ivs = [(max(s, t0), min(e, t1)) for _, s, e in timeline["ops"] if e > t0 and s < t1]
    return sum(e - s for s, e in union(ivs))


def op_share(rec: dict, op: str, least_s) -> float | None:
    """Percent of the device time of operator `op`'s calls that their least
    times (least_s(dims) each) make up; None where no call ran."""
    dev = {}
    for d in rec["device_ops"]:
        if d["op"] is not None:
            dev[d["op"]] = dev.get(d["op"], 0.0) + d["end"] - d["start"]
    least = spent = 0.0
    for k, o in enumerate(rec["ops"]):
        if o["name"] == op and dev.get(k):
            least += least_s(o["dims"])
            spent += dev[k]
    return 100.0 * least / spent if spent else None


def breakdown(timeline: dict, rec: dict, top: int = 10) -> dict:
    """The device operations that took most time over the device timeline,
    and the host stretch's device idle gaps summed by what the host was
    doing (the innermost host event on the serving thread at the gap's
    middle)."""
    t0, t1 = timeline["t0"], timeline["t1"]
    by = {}
    for name, s, e in timeline["ops"]:
        s, e = max(s, t0), min(e, t1)
        by[name[:120]] = by.get(name[:120], 0.0) + e - s
    t0, t1 = rec["stretch"]["t0"], rec["stretch"]["t1"]
    ivs = [(max(d["start"], t0), min(d["end"], t1)) for d in rec["device_ops"]
           if d["end"] > t0 and d["start"] < t1]
    holes, prev = [], t0
    for s, e in union(ivs) + [[t1, t1]]:
        if s > prev:
            holes.append(((prev + s) / 2, s - prev))
        prev = max(prev, e)
    # host events on one thread nest: sweep them with a stack of the open ones
    gaps, host, stack, nxt = {}, rec["host"], [], 0
    for mid, length in holes:
        while nxt < len(host) and host[nxt][0] <= mid:
            while stack and stack[-1][1] < host[nxt][0]:
                stack.pop()
            stack.append(host[nxt])
            nxt += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2][:120] if stack else "host: no traced event"
        gaps[label] = gaps.get(label, 0.0) + length
    order = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gap_order = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in order], "idle_gaps": [[n, v] for n, v in gap_order]}
