"""Spawn the ranks of one multi-process run and collect their results.

The JAX package runs one SPMD program over every device; here each mesh
position is a process. `run_ranks` starts them (spawn, so a rank imports
only the module of its function, never the caller's JAX), gives each its
default process group (mesh.py::init_distributed on a free local port, with
a timeout on every collective), calls the function in every rank, and
returns the ranks' results as numpy. It waits until a deadline: a rank that
raises, dies or hangs fails the run, every child is killed, and the error
names the rank with its traceback. The tests, dryrun_multichip_torch.py and
chip_smoke.py's parallel phase all run through it.
"""

from __future__ import annotations

import multiprocessing as mp
import queue
import socket
import time
import traceback
from typing import Any, Callable, List

import numpy as np
import torch
import torch.distributed as dist


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def to_numpy(tree: Any) -> Any:
    """Tensors (in dicts, lists and tuples) as numpy arrays, on the host."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def _rank_main(rank: int, world_size: int, port: int, device: str, timeout_s: float,
               fn: Callable, args: tuple, results) -> None:
    from vit_pruning_tpu_torch.parallel.mesh import init_distributed

    try:
        if device == "cpu":
            torch.set_num_threads(1)
        init_distributed(device=device, rank=rank, world_size=world_size,
                         init_method=f"tcp://127.0.0.1:{port}", timeout_s=timeout_s)
        out = to_numpy(fn(*args))
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
        return
    dist.destroy_process_group()


def _stop(procs: list):
    for p in procs:
        if p.is_alive():
            p.kill()
    for p in procs:
        p.join(10)


def run_ranks(fn: Callable, world_size: int, *args, device: str = "cuda",
              timeout_s: float = 300.0) -> List[Any]:
    """fn(*args) in `world_size` spawned ranks; returns [result of rank 0,
    rank 1, ...] with every tensor as numpy. fn must be importable by
    module path (a module-level function) and see its rank through
    torch.distributed. device 'cuda' (the default) puts each rank on a
    card, 'cpu' keeps it on the host (one thread a rank). Raises
    RuntimeError when a rank raises or exits without a result, and
    TimeoutError when the ranks have not all finished within timeout_s
    (every child is killed either way). Build the CUDA kernels before
    calling it, or every rank compiles them."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_ranks(device='cuda'): no CUDA device is available; "
                           "pass device='cpu'")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, port, device, timeout_s, fn, args, results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    got, dead_since = {}, {}
    try:
        while len(got) < world_size:
            now = time.monotonic()
            if now > deadline:
                missing = sorted(set(range(world_size)) - set(got))
                raise TimeoutError(f"run_ranks: ranks {missing} of {world_size} did not finish "
                                   f"within {timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=min(0.5, deadline - now + 0.01))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if r in got or p.exitcode is None:
                        continue
                    # a result may still be in the pipe: give it a second
                    if now - dead_since.setdefault(r, now) > 1.0:
                        raise RuntimeError(f"run_ranks: rank {r} exited with code {p.exitcode} "
                                           f"without a result")
                continue
            if not ok:
                raise RuntimeError(f"run_ranks: rank {rank} of {world_size} failed:\n{payload}")
            got[rank] = payload
        for p in procs:  # each rank leaves its process group after its result
            p.join(max(0.0, min(10.0, deadline - time.monotonic())))
    finally:
        _stop(procs)
    return [got[r] for r in range(world_size)]
