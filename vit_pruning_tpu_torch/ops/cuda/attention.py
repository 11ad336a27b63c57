"""Kernel B6: multi-head attention on q, k, v [B, H, S, hd], all in f32.

`fused_attention` replaces vit_pruning_tpu/ops/pallas/attention.py::
fused_attention: softmax(q k^T / sqrt(hd), masked keys at -1e30) v, with q,
k, v upcast to f32, the softmax normalised before PV, and the output cast
to q's dtype. The CUDA kernel is csrc/attention.cu, with two bodies on
wgmma + TMA that C picks by dtype and shape (`body` mirrors the rule): in
bf16 (hd a multiple of 8, q, k, v 16-byte aligned) the 'wgmma' body, one
64-query tile of one head a block, whose PV runs as three bf16 passes over
an exact split of the f32 P; in f32, or for any other bf16 shape, the
'split' body (csrc/split_attention.cuh, which B1's f32 attention runs too):
q, k and v split once into exact bf16 planes (hi, mid, lo for f32) in a
workspace the op allocates, both products as six bf16 passes over the
planes. `body_counts()` reads the launches per body; the heads of the
sources say what bounds each.

ops/attention.py::mha runs it with use_kernel=True, which the models set in
dispatch mode 'kernel' only, for attention without head_mask or
return_probs. The wrapper launches the kernel for CUDA tensors through the
registered operator vpt::fused_attention (ops/cuda/library.py), which counts
the launch in the wrapper's `launches` attribute; for CPU tensors it runs
the plain version (mode 'auto') or raises (mode 'kernel').
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from vit_pruning_tpu_torch.ops.attention import NEG_INF
from vit_pruning_tpu_torch.ops.cuda.layer import _DTYPES, _check, _check_token_mask, refuse_grad
from vit_pruning_tpu_torch.ops.cuda.library import check_aligned, kernel_op, ptr, run
from vit_pruning_tpu_torch.ops.cuda.widths import round_up
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


def _b6_fake(q, k, v, token_mask):
    return torch.empty_like(q)


@kernel_op("fused_attention", _b6_fake)
def _b6_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           token_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """B6's launch."""
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    who = "fused_attention"
    b, h, s, hd = q.shape
    max_hd = load_library().vpt_attention_max_head_dim()
    if hd > max_hd:
        raise ValueError(f"{who}: head dim {hd} not in [1, {max_hd}]")
    check_aligned(who, q=q, k=k, v=v)
    out = torch.empty_like(q)
    planes = None
    if body(q, k, v) == "split":
        n_planes = 3 if q.dtype == torch.float32 else 1
        planes = torch.empty(3 * n_planes * b * h * s * round_up(hd, 8), dtype=torch.bfloat16,
                             device=q.device)
    run(who, q.device, "vpt_attention_forward", _DTYPES[q.dtype], ptr(q), ptr(k), ptr(v),
        ptr(token_mask), ptr(out), b, h, s, hd, ptr(planes))
    fused_attention.launches += 1
    return out


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    token_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel B6. q, k, v [B, H, S, hd] contiguous, float32 or bfloat16;
    token_mask [B, S] bool (True = valid key) or None. Returns [B, H, S, hd]
    in q's dtype; rows of masked tokens are computed but meaningless.
    Takes any S and hd <= 128 (past S 257 the wgmma body streams K and V;
    the split body streams them past 256 keys or past hd 64)."""
    if not launch_kernel_for(q):
        return fused_attention_ref(q, k, v, token_mask)
    who = "fused_attention"
    refuse_grad(who, q, k, v)
    if q.dim() != 4:
        raise ValueError(f"{who}: q must be [B, H, S, hd], got {tuple(q.shape)}")
    b, h, s, hd = q.shape
    if s < 1 or not 1 <= b <= 65535 or hd < 1:
        raise ValueError(f"{who}: batch {b} not in [1, 65535], or an empty sequence or head")
    _check(q, {"k": k, "v": v}, {"k": tuple(q.shape), "v": tuple(q.shape)}, who)
    _check_token_mask(token_mask, q, b, s, who)
    return torch.ops.vpt.fused_attention(q, k, v, token_mask)


fused_attention.launches = 0


def body(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The body B6 runs these operands (which fused_attention accepts) on:
    'wgmma' where csrc/attention.cu::attention_tc_takes holds (bf16, hd a
    multiple of 8, q, k, v 16-byte aligned), else 'split'."""
    tc = (q.dtype == torch.bfloat16 and q.shape[-1] % 8 == 0
          and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    return "wgmma" if tc else "split"


def body_counts() -> dict:
    """Launches of B6's 'wgmma' and 'split' bodies since the last
    reset_body_counts()."""
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    counts = (ctypes.c_longlong * 2)()
    load_library().vpt_attention_body_counts(counts)
    return {"wgmma": counts[0], "split": counts[1]}


def reset_body_counts():
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    load_library().vpt_attention_body_reset()
