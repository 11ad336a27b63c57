"""Kernel B6: multi-head attention on q, k, v [B, H, S, hd], all in f32.

`fused_attention` replaces vit_pruning_tpu/ops/pallas/attention.py::
fused_attention: softmax(q k^T / sqrt(hd), masked keys at -1e30) v, with q,
k, v upcast to f32, the softmax normalised before PV, and the output cast
to q's dtype. The CUDA kernel is csrc/attention.cu, with two bodies that C
picks by dtype and shape: in bf16 (hd a multiple of 8, q, k, v 16-byte
aligned) a wgmma + TMA body, one 64-query tile of one head a block, whose
PV runs as three bf16 passes over an exact split of the f32 P; in f32, or
for any other hd, B1's f32 attention from csrc/common.cuh (FMA on the CUDA
cores). `body_counts()` reads the launches per body; the head of the .cu
file says what bounds each.

ops/attention.py::mha runs it with use_kernel=True, which the models set in
dispatch mode 'kernel' only, for attention without head_mask or
return_probs. The wrapper launches the kernel for CUDA tensors and counts
the launch in its `launches` attribute; for CPU tensors it runs the plain
version (mode 'auto') or raises (mode 'kernel').
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from vit_pruning_tpu_torch.ops.attention import NEG_INF
from vit_pruning_tpu_torch.ops.cuda.layer import (
    _check,
    _check_token_mask,
    _raise_on,
    _stream,
    refuse_grad,
)
from vit_pruning_tpu_torch.ops.dispatch import launch_kernel_for


def fused_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    token_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of kernel B6: f32 logits, masked keys -1e30,
    P = exp(l - max) / sum in f32, PV in f32, cast to q's dtype."""
    logits = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if token_mask is not None:
        logits = torch.where(token_mask[:, None, None, :], logits, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return (p @ v.float()).to(q.dtype)


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    token_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel B6. q, k, v [B, H, S, hd] contiguous, float32 or bfloat16;
    token_mask [B, S] bool (True = valid key) or None. Returns [B, H, S, hd]
    in q's dtype; rows of masked tokens are computed but meaningless.
    Takes any S and hd <= 128 (past S 257 the bf16 body streams K and V)."""
    if not launch_kernel_for(q):
        return fused_attention_ref(q, k, v, token_mask)
    who = "fused_attention"
    refuse_grad(who, q, k, v)
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    if q.dim() != 4:
        raise ValueError(f"{who}: q must be [B, H, S, hd], got {tuple(q.shape)}")
    b, h, s, hd = q.shape
    if s < 1 or not 1 <= b <= 65535:
        raise ValueError(f"{who}: batch {b} not in [1, 65535] or empty sequence")
    if not 1 <= hd <= lib.vpt_attention_max_head_dim():
        raise ValueError(f"{who}: head dim {hd} not in [1, {lib.vpt_attention_max_head_dim()}]")
    dtype = _check(q, {"k": k, "v": v}, {"k": tuple(q.shape), "v": tuple(q.shape)}, who)
    _check_token_mask(token_mask, q, b, s, who)

    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = lib.vpt_attention_forward(
            dtype, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if token_mask is None else token_mask.data_ptr(), out.data_ptr(),
            b, h, s, hd, _stream(q),
        )
    _raise_on(lib, rc, who)
    fused_attention.launches += 1
    return out


fused_attention.launches = 0


def takes_tensor_cores(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether B6 runs these operands (which fused_attention accepts) on its
    tensor-core body: the C rule, csrc/attention.cu::attention_tc_takes."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))


def body_counts() -> dict:
    """Launches of B6's tensor-core ('wgmma') and FMA ('fma') bodies since
    the last reset_body_counts()."""
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    counts = (ctypes.c_longlong * 2)()
    load_library().vpt_attention_body_counts(counts)
    return {"wgmma": counts[0], "fma": counts[1]}


def reset_body_counts():
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    load_library().vpt_attention_body_reset()
