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

A third, encoder fusion (`set_encoder_fusion`, scoped with
`encoder_fusion`, else the environment variable VIT_PRUNING_TPU_ENCODER=1),
runs every fixed-length stretch of layers as one call of kernel B5
(ops/cuda/model.py) when kernels are on and the weights fit.
"""

from __future__ import annotations

import contextlib
import os

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


def attention_kernel_enabled() -> bool:
    """Should the per-op attention (mha) run kernel B6? Only in mode
    'kernel', as the JAX package runs its fused attention only in 'pallas':
    every route of the models reaches attention inside B1 / B5 instead."""
    return _MODE == "kernel"


_ENCODER_FUSION = None


def set_encoder_fusion(enabled):
    """Opt into (True) or out of (False) the whole-encoder kernel B5; None
    hands the choice back to the environment variable."""
    global _ENCODER_FUSION
    _ENCODER_FUSION = None if enabled is None else bool(enabled)


def encoder_fusion_enabled() -> bool:
    """An explicit setting wins, else VIT_PRUNING_TPU_ENCODER == '1'."""
    if _ENCODER_FUSION is not None:
        return _ENCODER_FUSION
    return os.environ.get("VIT_PRUNING_TPU_ENCODER") == "1"


@contextlib.contextmanager
def encoder_fusion(enabled: bool):
    prev = _ENCODER_FUSION
    set_encoder_fusion(enabled)
    try:
        yield
    finally:
        set_encoder_fusion(prev)


def launch_kernel_for(t: torch.Tensor) -> bool:
    """Inside a wrapper: True = launch the CUDA kernel on `t` (through its
    registered operator, ops/cuda/library.py); False = `t` lies on the CPU
    and mode 'auto' runs the plain version. Raises for a CPU tensor in mode
    'kernel'. In mode 'kernel' a meta tensor (shapes only) also takes the
    operator, whose fake implementation gives the output's shape: how a
    trace such as serving.py::export_serving sees the kernels without a
    card."""
    if t.is_cuda:
        return True
    if _MODE == "kernel":
        if t.is_meta:
            return True
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
