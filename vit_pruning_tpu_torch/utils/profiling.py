"""Profiling: device traces, throughput counters, complexity reports.

Mirrors vit_pruning_tpu/utils/profiling.py: `torch_trace` records a
torch.profiler trace (CPU and CUDA activity) and writes it as a Chrome
trace (ui.perfetto.dev) where the reference writes an XLA trace; the
reference's name `xla_trace` is kept as an alias. `throughput` synchronises
the card before every clock read; `complexity_report` prints the analytic
FLOPs (utils/flops.py).
"""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
import time
from typing import Callable, Optional

import torch


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


def throughput(fn: Callable, args: tuple, batch_size: int, iters: int = 10,
               warmup: int = 2) -> dict:
    """Median images/sec of `fn(*args)`, the card synchronised before each
    clock read (a launch returns before the work ends)."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    t = statistics.median(times)
    return {"sec_per_batch": t, "images_per_sec": batch_size / t, "ms_per_batch": t * 1e3}


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
