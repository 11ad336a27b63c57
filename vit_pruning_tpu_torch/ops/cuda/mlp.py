"""Kernel B7: the transformer MLP, erf-GELU(x W1 + b1) W2 + b2, all in f32.

`fused_mlp` replaces vit_pruning_tpu/ops/pallas/mlp.py::fused_mlp: x and the
weights are upcast to f32, both products, the bias adds and the GELU run
in f32 (the second product takes the unrounded GELU output), and the output
is cast to x's dtype. The CUDA kernel is csrc/mlp.cu, with two bodies that
C picks by dtype and shape: in bf16 (D and M multiples of 8, x, w1, w2
16-byte aligned) a wgmma + TMA body whose second product runs as three
bf16 passes over an exact split of the f32 GELU output; in f32, or for
any other shape, an FMA body on the CUDA cores. `body_counts()` reads the
launches per body; the head of the .cu file says what bounds each.

models/vit.py::mlp_block runs it when kernels are on, which is the MLP of
the per-op layer route (head_mask, return_probs). The wrapper launches the
kernel for CUDA tensors and counts the launch in its `launches` attribute;
for CPU tensors it runs the plain version (mode 'auto') or raises (mode
'kernel').
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from vit_pruning_tpu_torch.ops.cuda.layer import _check, _raise_on, _stream, refuse_grad
from vit_pruning_tpu_torch.ops.dispatch import launch_kernel_for


def fused_mlp_ref(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of kernel B7: everything in f32, erf GELU,
    cast to x's dtype at the end."""
    h = F.gelu(x.float() @ w1.float() + b1.float())
    return (h @ w2.float() + b2.float()).to(x.dtype)


def fused_mlp(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
) -> torch.Tensor:
    """Kernel B7. x [T, D], w1 [D, M], b1 [M], w2 [M, D], b2 [D], all
    contiguous in one dtype (float32 or bfloat16). Returns [T, D] in x's
    dtype."""
    if not launch_kernel_for(x):
        return fused_mlp_ref(x, w1, b1, w2, b2)
    who = "fused_mlp"
    refuse_grad(who, x, w1, b1, w2, b2)
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"{who}: x must be [T, D] with T >= 1, got {tuple(x.shape)}")
    t, d = x.shape
    m = w1.shape[-1]
    if d > lib.vpt_mlp_max_hidden():
        raise ValueError(f"{who}: hidden size {d} over the kernel's {lib.vpt_mlp_max_hidden()}")
    shapes = {"w1": (d, m), "b1": (m,), "w2": (m, d), "b2": (d,)}
    dtype = _check(x, {"w1": w1, "b1": b1, "w2": w2, "b2": b2}, shapes, who)

    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = lib.vpt_mlp_forward(dtype, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(),
                                 b2.data_ptr(), out.data_ptr(), t, d, m, _stream(x))
    _raise_on(lib, rc, who)
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0


def takes_tensor_cores(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor) -> bool:
    """Whether B7 runs these operands (which fused_mlp accepts) on its
    tensor-core body: the C rule, csrc/mlp.cu::mlp_tc_takes (its shared
    memory does not depend on D or M)."""
    d, m = w1.shape
    return (x.dtype == torch.bfloat16 and d % 8 == 0 and m % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, w1, w2)))


def body_counts() -> dict:
    """Launches of B7's tensor-core ('wgmma') and FMA ('fma') bodies since
    the last reset_body_counts()."""
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    counts = (ctypes.c_longlong * 2)()
    load_library().vpt_mlp_body_counts(counts)
    return {"wgmma": counts[0], "fma": counts[1]}


def reset_body_counts():
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    load_library().vpt_mlp_body_reset()
