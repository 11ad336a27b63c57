"""Multi-head attention with a token-validity mask — plain PyTorch.

Mirrors vit_pruning_tpu/ops/attention.py: fused QKV projection, heads split
from the projection width (so head-pruned params with KW < D work), masked
keys get an additive -1e30 (finite, so a fully masked row cannot produce
NaNs from (-inf) - (-inf)), softmax in the input dtype.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, w = x.shape
    return x.reshape(b, s, num_heads, w // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def attention_probs(
    q: torch.Tensor, k: torch.Tensor, token_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Softmax probabilities [B, H, S, S]; q, k [B, H, S, hd]; token_mask
    [B, S] bool, True = valid key."""
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if token_mask is not None:
        bias = torch.where(token_mask[:, None, None, :], 0.0, NEG_INF).to(logits.dtype)
        logits = logits + bias
    return torch.softmax(logits, dim=-1)


def mha(
    x: torch.Tensor,
    params: dict,
    num_heads: int,
    token_mask: Optional[torch.Tensor] = None,
    head_mask: Optional[torch.Tensor] = None,
    return_probs: bool = False,
    use_kernel: bool = False,
):
    """QKV projection -> masked attention -> output projection.

    params: {'q','k','v','o': {'w' [in, out], 'b'}}. token_mask [B, S] bool:
    True = the token is a valid key/value; query rows of masked tokens still
    produce outputs, which callers discard. head_mask [H] or [B, H] float
    multiplies the probabilities (1.0 keeps the head). return_probs: return
    (out, probs [B, H, S, S]). use_kernel: the attention core runs as kernel
    B6 (ops/cuda/attention.py, f32 arithmetic) when neither head_mask nor
    return_probs asks for the probabilities.
    """
    wqkv = torch.cat([params["q"]["w"], params["k"]["w"], params["v"]["w"]], dim=1)
    bqkv = torch.cat([params["q"]["b"], params["k"]["b"], params["v"]["b"]])
    qkv = x @ wqkv + bqkv
    q, k, v = (_split_heads(t, num_heads) for t in qkv.chunk(3, dim=-1))
    if use_kernel and not return_probs and head_mask is None:
        from vit_pruning_tpu_torch.ops.cuda.attention import fused_attention

        ctx = fused_attention(q.contiguous(), k.contiguous(), v.contiguous(), token_mask)
        return _merge_heads(ctx) @ params["o"]["w"] + params["o"]["b"]
    probs = attention_probs(q, k, token_mask)
    if head_mask is not None:
        hm = head_mask if head_mask.dim() == 2 else head_mask[None, :]
        probs = probs * hm[:, :, None, None].to(probs.dtype)
    out = _merge_heads(probs @ v) @ params["o"]["w"] + params["o"]["b"]
    return (out, probs) if return_probs else out
