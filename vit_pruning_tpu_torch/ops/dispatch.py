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

A second process-wide switch, the serving quantization ('none' or 'int8',
set with `set_serving_quant` or scoped with `quant_mode`), turns every
inference layer of every entry point into int8 weight products (ops/quant.py
scheme): kernel B4 in modes 'auto' / 'kernel', the eager int8 layer in
'eager'. An entry point's `quant=None` reads it at call time.
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


QUANT_MODES = ("none", "int8")
_QUANT = "none"


def set_serving_quant(mode: str):
    """Serving quantization: 'none' (the params' float dtype) or 'int8'. The
    training side forces it off, as the JAX package does."""
    global _QUANT
    if mode not in QUANT_MODES:
        raise ValueError(f"serving quant {mode!r} not in {QUANT_MODES}")
    _QUANT = mode


def serving_quant() -> str:
    return _QUANT


@contextlib.contextmanager
def quant_mode(mode: str):
    prev = _QUANT
    set_serving_quant(mode)
    try:
        yield
    finally:
        set_serving_quant(prev)


def resolve_quant(quant) -> str:
    """An entry point's `quant` argument: None reads the switch now."""
    if quant is None:
        return _QUANT
    if quant not in QUANT_MODES:
        raise ValueError(f"serving quant {quant!r} not in {QUANT_MODES}")
    return quant
