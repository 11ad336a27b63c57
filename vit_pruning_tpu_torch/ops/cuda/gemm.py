"""The bf16 GEMM under kernels B1, B2, B3 and B5, called on its own: a
wrapper around csrc/gemm.cu's gemm() beside its plain PyTorch version.

The layer kernels run this product from C for every bf16 projection (QKV,
O, fc1, fc2, B2's K/V, Q and classifier). It is not exported from the
package: it exists so that chip_smoke.py and the tests can hold the GEMM
bodies against their plain version at every product shape of the main
paths, one product at a time.

    out[M, N] = cast(residual + act(A[M, K] @ W[K, N] + bias))

A and W bf16; A may be a row-strided view (B2 reads the CLS rows of [B, S,
D] with row stride S*D); bias bf16 [N]; act 'none', 'gelu_erf' or
'gelu_tanh' (in f32); residual [M, N] bf16 or float32, rows contiguous
(B2's residual is the CLS rows of x, row stride S*D); out bf16 or float32.
On the card gemm() takes the wgmma + TMA body where TMA can describe A and
W (16-byte aligned, lda, N and K multiples of 8) and the WMMA body
otherwise, by shape alone; `body_counts()` reads the launches per body.
For CPU tensors the wrapper runs the plain version; for CUDA tensors it
launches or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from vit_pruning_tpu_torch.ops.cuda.library import ptr, run
from vit_pruning_tpu_torch.ops.dispatch import launch_kernel_for

ACTS = {"none": 0, "gelu_erf": 1, "gelu_tanh": 2}
_OUT = (torch.bfloat16, torch.float32)


def gemm_bf16_ref(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  act: str = "none", residual: Optional[torch.Tensor] = None,
                  out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version: the product in f32, then the epilogue in the
    TPU kernels' order (+ bias, activation, + residual) in f32, one cast."""
    y = a.float() @ w.float()
    if bias is not None:
        y = y + bias.float()
    if act != "none":
        y = F.gelu(y, approximate="tanh" if act == "gelu_tanh" else "none")
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def _check(a, w, bias, act, residual, out_dtype) -> tuple:
    """The shapes, dtypes and layouts the kernel takes; (M, N, K, lda)."""
    who = "gemm_bf16"
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"{who}: a and w must be bfloat16, got {a.dtype} and {w.dtype}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"{who}: a [M, K] and w [K, N], got {tuple(a.shape)} and {tuple(w.shape)}")
    m, k = a.shape
    n = w.shape[1]
    if min(m, n, k) < 1:
        raise ValueError(f"{who}: empty product {m} x {k} x {n}")
    if act not in ACTS:
        raise ValueError(f"{who}: act {act!r} not in {tuple(ACTS)}")
    if out_dtype not in _OUT:
        raise ValueError(f"{who}: out_dtype {out_dtype} not in {_OUT}")
    lda = a.stride(0)
    if a.stride(1) != 1 or lda < k:
        raise ValueError(f"{who}: a's rows must be contiguous (strides {a.stride()})")
    if k % 8 or lda % 8 or a.data_ptr() % 16:
        raise ValueError(f"{who}: K {k} and a's row stride {lda} must be multiples of 8 and a "
                         f"16-byte aligned")
    if not w.is_contiguous() or w.data_ptr() % 16:
        raise ValueError(f"{who}: w must be contiguous and 16-byte aligned")
    if bias is not None and (bias.dtype != torch.bfloat16 or tuple(bias.shape) != (n,)
                             or not bias.is_contiguous()):
        raise ValueError(f"{who}: bias must be contiguous bfloat16 [{n}]")
    if residual is not None and (residual.dtype not in _OUT or tuple(residual.shape) != (m, n)
                                 or residual.stride(1) != 1 or residual.stride(0) < n):
        raise ValueError(f"{who}: residual must be bfloat16 or float32 [{m}, {n}] with "
                         f"contiguous rows")
    for name, t in (("w", w), ("bias", bias), ("residual", residual)):
        if t is not None and t.device != a.device:
            raise ValueError(f"{who}: {name} is on {t.device}, a on {a.device}")
    return m, n, k, lda


def gemm_bf16(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
              act: str = "none", residual: Optional[torch.Tensor] = None,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """One bf16 product through the layer kernels' GEMM: [M, N] in out_dtype."""
    m, n, k, lda = _check(a, w, bias, act, residual, out_dtype)
    if not launch_kernel_for(a):
        return gemm_bf16_ref(a, w, bias, act, residual, out_dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    run("gemm_bf16", a.device, "vpt_gemm_bf16", ptr(a), lda, ptr(w), m, n, k, ptr(bias),
        ACTS[act], ptr(residual), n if residual is None else residual.stride(0),
        int(residual is not None and residual.dtype == torch.float32), ptr(out), n,
        int(out_dtype == torch.float32))
    gemm_bf16.launches += 1
    return out


gemm_bf16.launches = 0


def takes_wgmma(a: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether gemm() runs a product that gemm_bf16 accepts on the wgmma +
    TMA body (the C rule, wgmma.cuh::wgmma_takes): N a multiple of 8, the
    rest being gemm_bf16's own conditions."""
    return w.shape[1] % 8 == 0


def body_counts() -> dict:
    """Launches of each bf16 GEMM body since the last reset_body_counts(),
    from every caller of gemm() (the layer kernels included), and the
    distinct (M, N, K) that took the WMMA body."""
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    counts = (ctypes.c_longlong * 2)()
    lib.vpt_gemm_body_counts(counts)
    shapes = (ctypes.c_int * 192)()
    n = lib.vpt_gemm_wmma_shapes(shapes, 64)
    return {"wgmma": counts[0], "wmma": counts[1],
            "wmma_shapes": [tuple(shapes[3 * i:3 * i + 3]) for i in range(min(n, 64))]}


def reset_body_counts():
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    load_library().vpt_gemm_body_reset()
