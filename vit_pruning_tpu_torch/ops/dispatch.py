"""Kernel dispatch: hand-written CUDA kernels vs plain PyTorch.

Mirrors vit_pruning_tpu/ops/dispatch.py. One process-wide mode, set by the
caller or scoped with `kernel_mode`:

  'auto'   — model code calls the kernel wrappers; a wrapper launches its
             kernel for a CUDA tensor and runs its plain version for a CPU
             tensor
  'kernel' — as 'auto', but a wrapper given a CPU tensor raises
  'eager'  — model code runs the plain PyTorch layers and never calls a
             wrapper: the port's own reference on the card

A wrapper never falls back from a CUDA tensor to its plain version: it
launches the kernel or raises.
"""

from __future__ import annotations

import contextlib

import torch

MODES = ("auto", "kernel", "eager")
_MODE = "auto"


def set_kernel_mode(mode: str):
    global _MODE
    if mode not in MODES:
        raise ValueError(f"kernel mode {mode!r} not in {MODES}")
    _MODE = mode


def get_kernel_mode() -> str:
    return _MODE


@contextlib.contextmanager
def kernel_mode(mode: str):
    prev = _MODE
    set_kernel_mode(mode)
    try:
        yield
    finally:
        set_kernel_mode(prev)


def kernels_enabled() -> bool:
    """Should model code route through the kernel wrappers?"""
    return _MODE != "eager"


def launch_kernel_for(t: torch.Tensor) -> bool:
    """Inside a wrapper: True = launch the CUDA kernel on `t`; False = `t`
    lies on the CPU and mode 'auto' runs the plain version. Raises for a
    CPU tensor in mode 'kernel'."""
    if t.is_cuda:
        return True
    if _MODE == "kernel":
        raise RuntimeError(
            f"kernel mode 'kernel' needs CUDA tensors; got one on {t.device}"
        )
    return False
