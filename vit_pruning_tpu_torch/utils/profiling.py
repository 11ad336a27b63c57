"""Profiling: device traces, the program's spans, complexity reports.

Mirrors vit_pruning_tpu/utils/profiling.py: `torch_trace` records a
torch.profiler trace (CPU and CUDA activity) and writes it as a Chrome
trace (ui.perfetto.dev) where the reference writes an XLA trace; the
reference's name `xla_trace` is kept as an alias. `complexity_report`
prints the analytic FLOPs (utils/flops.py).

Spans. `span(name)` marks a stage of the served forward (the entry, the
embed, weight preparation, selection, the outputs, the layers, the head).
Recording is off by default, and then a span is one read of a module flag
and a shared null context: no clock read, no allocation, no profiler call.
Switched on (`set_tracing(True)`, scoped with `tracing`), each span records
its name, its start and end in nanoseconds of `time.time_ns()`, the index
of the span enclosing it, the id of the outermost span it runs under (one
id per served call) and, for a run of layers, the token rows its layers
ran (`rows`). That clock is the one torch.profiler exports its events on:
an event's `ts` (microseconds) x 1000 plus the trace's
`baseTimeNanoseconds`, so spans lie over an exported trace without the
profiler recording host operations. Spans stay in a bounded buffer,
counting those that did not fit, until `take()` hands them over and clears
it. Under torch.export or torch.compile a span records nothing, so no
traced program holds one.

No span's name begins with `vpt::`, the prefix of the kernels' registered
operators (ops/cuda/library.py), whose spans a host trace shows as well.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from typing import Optional

import torch
from torch.compiler import is_compiling, is_exporting

# --- the program's spans ------------------------------------------------------------

SPAN_CAPACITY = 1 << 17  # recorded spans kept until take(); more are counted as dropped
_ON = False
_NULL = contextlib.nullcontext()
# the recorded spans, flat, _WIDTH slots each: name, start, end, parent, call, rows.
# Names, ints and None only, so that the buffer adds no objects for the garbage
# collector to trace while it fills.
_log: list = []
_WIDTH = 6
_dropped = 0
_calls = 0  # ids handed to outermost spans
_open = threading.local()  # each thread's open spans: (index or None, call id)


def set_tracing(enabled: bool):
    """Record spans (True) or not (False, the default)."""
    global _ON
    _ON = bool(enabled)


@contextlib.contextmanager
def tracing(enabled: bool = True):
    prev = _ON
    set_tracing(enabled)
    try:
        yield
    finally:
        set_tracing(prev)


def span(name: str, rows: Optional[int] = None):
    """A context marking one stage of the program. `rows`: for a run of
    layers, the token rows they ran, summed over the layers (batch x live
    tokens x layers)."""
    if not _ON:
        return _NULL
    return _Span(name, rows)


def _stack() -> list:
    try:
        return _open.stack
    except AttributeError:
        _open.stack = []
        return _open.stack


class _Span:
    __slots__ = ("name", "rows", "log", "at")

    def __init__(self, name: str, rows: Optional[int]):
        if name.startswith("vpt::"):
            raise ValueError(f"span {name!r}: the prefix vpt:: names the kernels' operators")
        self.name, self.rows = name, rows
        self.log = self.at = None

    def __enter__(self):
        global _calls, _dropped
        if is_compiling() or is_exporting():
            return self
        stack = _stack()
        if stack:
            parent, call = stack[-1]
        else:
            _calls += 1
            parent, call = None, _calls
        log = self.log = _log  # the list this span's end goes to, should take() run meanwhile
        if len(log) < SPAN_CAPACITY * _WIDTH:
            self.at = len(log)
            stack.append((self.at // _WIDTH, call))
            log.extend((self.name, None, None, parent, call, self.rows))
        else:
            self.at = -1
            stack.append((None, call))
            _dropped += 1
        start = time.time_ns()
        if self.at >= 0:
            log[self.at + 1] = start
        return self

    def __exit__(self, *exc):
        if self.log is None:
            return False
        end = time.time_ns()
        if self.at >= 0:
            self.log[self.at + 2] = end
        _open.stack.pop()
        return False


def take() -> dict:
    """The spans recorded since the last take(), in the order they opened,
    and the count of those the buffer had no room for; clears both. Each
    span: name, start and end (ns, time.time_ns()), parent (index of the
    enclosing span in this list, or None), call (id shared by every span
    under one outermost span), rows (token rows its layers ran, or None).
    Take them between calls: a span still open has end None."""
    global _log, _dropped
    log, out_dropped = _log, _dropped
    _log, _dropped = [], 0
    spans = []
    for i in range(0, len(log), _WIDTH):
        name, start, end, parent, call, rows = log[i:i + _WIDTH]
        spans.append({"name": name, "start": start, "end": end, "parent": parent,
                      "call": call, "rows": rows})
    return {"spans": spans, "dropped": out_dropped}


# --- device traces -------------------------------------------------------------------


@contextlib.contextmanager
def torch_trace(log_dir: Optional[str] = None):
    """Record a torch.profiler trace around a block and write it to
    `log_dir`/trace.json (default: torch-trace under the temp directory).
    Yields the profiler, whose key_averages() give per-op times."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "torch-trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


xla_trace = torch_trace


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def complexity_report(config, pcfg=None, tokens_per_layer=None,
                      images_per_sec: Optional[float] = None) -> str:
    """The get_complexity printout: GFLOPs/image pruned vs dense (+ optional
    measured GFLOP/s)."""
    from vit_pruning_tpu_torch.utils.flops import pruned_vit_flops, vit_flops

    dense = vit_flops(config)
    lines = [f"Dense FLOPs/image: {dense / 1e9:.2f} GFLOPs"]
    if pcfg is not None:
        pruned = pruned_vit_flops(config, pcfg, tokens_per_layer)
        lines.append(
            f"Pruned FLOPs/image: {pruned / 1e9:.2f} GFLOPs ({pruned / dense:.1%} of dense)"
        )
        if images_per_sec:
            lines.append(
                f"Throughput: {images_per_sec:.1f} img/s = "
                f"{images_per_sec * pruned / 1e9:.1f} GFLOPS effective"
            )
    return "\n".join(lines)
