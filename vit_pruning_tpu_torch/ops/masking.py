"""Keep-mask selection for progressive compaction.

Mirrors the two functions of vit_pruning_tpu/ops/masking.py the serving path
uses. Mask convention: True = keep the token.
"""

from __future__ import annotations

import torch


def rank_keep_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Mask of the k highest-scoring tokens per image.

    Token i is kept iff fewer than k tokens beat it, where j beats i when
    s_j > s_i, or s_j == s_i and j < i: ties go to the lower index, as in
    the JAX package (jax.lax.top_k's order). torch.topk promises no order
    among ties, so it is not used.
    """
    n = scores.shape[-1]
    s_i = scores[..., :, None]
    s_j = scores[..., None, :]
    idx = torch.arange(n, device=scores.device)
    lower = idx[None, :] < idx[:, None]  # [i, j]: j < i
    beats = (s_j > s_i) | ((s_j == s_i) & lower)
    return beats.sum(-1) < k


def add_cls_keep(patch_mask: torch.Tensor) -> torch.Tensor:
    """Prepend an always-True CLS column: [B, N] -> [B, N+1]."""
    cls_col = torch.ones(
        (patch_mask.shape[0], 1), dtype=torch.bool, device=patch_mask.device
    )
    return torch.cat([cls_col, patch_mask], dim=1)
