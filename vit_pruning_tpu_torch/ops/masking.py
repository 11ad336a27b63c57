"""Token-skip scoring, selection and compaction ops.

Mirrors vit_pruning_tpu/ops/masking.py function by function: the similarity
oracle, threshold / top-k / rank / random keep masks, neighbour averaging,
kept-first compaction and the predictor-vs-oracle confusion counts. Mask
convention: True = keep (process) the token.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Tuple

import numpy as np
import torch

# (rows of the whole batch, first row of this rank's shard) while a
# data-parallel step runs (parallel/steps.py), set by `draw_rows`
_DRAW_ROWS = contextvars.ContextVar("draw_rows", default=None)


@contextlib.contextmanager
def draw_rows(batch: int, start: int):
    """Within the block, random_keep_mask draws the noise of a whole batch
    of `batch` rows and keeps the caller's rows from `start` on: a
    data-parallel rank draws what the single-process run draws and keeps
    its shard's part, so the same generator gives the same masks."""
    token = _DRAW_ROWS.set((batch, start))
    try:
        yield
    finally:
        _DRAW_ROWS.reset(token)


# --- Oracle -----------------------------------------------------------------------

def similarity_oracle(
    x_in: torch.Tensor,
    x_out: torch.Tensor,
    alpha: float = 0.3,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Per-token similarity of a token before/after a full layer pass:
    alpha * (cos + 1) / 2 + (1 - alpha) / (1 + ||out - in||^2 / ||out||^2).
    x_in, x_out [..., D] (patch tokens only); returns [...]."""
    dot = (x_out * x_in).sum(-1)
    nrm = torch.linalg.vector_norm(x_out, dim=-1) * torch.linalg.vector_norm(x_in, dim=-1)
    cos = (dot / nrm.clamp_min(eps) + 1.0) / 2.0
    out_sq = (x_out * x_out).sum(-1)
    eucl = ((x_out - x_in) ** 2).sum(-1) / out_sq.clamp_min(eps)
    return alpha * cos + (1.0 - alpha) * (1.0 / (1.0 + eucl))


# --- Keep-mask construction --------------------------------------------------------

def threshold_keep_mask(scores: torch.Tensor, threshold: float) -> torch.Tensor:
    """True where the predictor score >= threshold."""
    return scores >= threshold


def topk_keep_mask(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k highest-scoring patch tokens per image: (mask [B, N] bool,
    indices [B, k] long) with the indices in jax.lax.top_k's order, value
    descending and ties to the lower index. A stable descending sort keeps
    equal values in index order; torch.topk promises no order among ties."""
    idx = torch.sort(scores, dim=-1, descending=True, stable=True).indices[..., :k]
    mask = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    return mask.scatter(-1, idx, True), idx


def rank_keep_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Mask of the k highest-scoring tokens per image.

    Token i is kept iff fewer than k tokens beat it, where j beats i when
    s_j > s_i, or s_j == s_i and j < i: ties go to the lower index, as in
    the JAX package (jax.lax.top_k's order), so it selects the same set as
    topk_keep_mask.
    """
    n = scores.shape[-1]
    s_i = scores[..., :, None]
    s_j = scores[..., None, :]
    idx = torch.arange(n, device=scores.device)
    lower = idx[None, :] < idx[:, None]  # [i, j]: j < i
    beats = (s_j > s_i) | ((s_j == s_i) & lower)
    return beats.sum(-1) < k


def random_keep_mask(
    generator: torch.Generator, batch: int, n: int, keep: int, device=None
) -> torch.Tensor:
    """Uniformly random keep mask with a fixed per-image budget: the `keep`
    highest of uniform noise drawn from the caller's generator (on its
    device), as rank_keep_mask(noise, keep). torch's and JAX's generators
    give different bits from one seed, so the masks differ from the JAX
    package's; their law is the same."""
    rows = _DRAW_ROWS.get()
    if rows is None:
        noise = torch.rand((batch, n), generator=generator, device=generator.device)
    else:  # a shard of a larger batch: draw it all, keep this rank's rows
        noise = torch.rand((rows[0], n), generator=generator,
                           device=generator.device)[rows[1]:rows[1] + batch]
    return rank_keep_mask(noise.to(device or generator.device), keep)


def add_cls_keep(patch_mask: torch.Tensor, prefix: int = 1) -> torch.Tensor:
    """Prepend always-True columns for the `prefix` leading tokens (CLS, and
    the registers where the model has them): [B, N] -> [B, prefix + N]."""
    cls_col = torch.ones(
        (patch_mask.shape[0], prefix), dtype=torch.bool, device=patch_mask.device
    )
    return torch.cat([cls_col, patch_mask], dim=1)


# --- Neighbour averaging -----------------------------------------------------------

def neighbor_index_table(grid: int) -> np.ndarray:
    """[N, 8] int32 8-neighbour table over the patch grid, clamped at the
    borders (the well-defined 2-D form of the reference's flat offsets)."""
    coords = np.stack(np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij"), -1)
    coords = coords.reshape(-1, 2)
    offsets = np.array(
        [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]
    )
    nbr = np.clip(coords[:, None, :] + offsets[None, :, :], 0, grid - 1)
    return (nbr[..., 0] * grid + nbr[..., 1]).astype(np.int32)


def neighbor_average(
    patches: torch.Tensor,
    neighbor_idx: torch.Tensor,
    weight: float,
    source_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Blend each patch token with the mean of its grid neighbours.

    patches [B, N, D]; neighbor_idx [N, 8] (long); weight in [0, 1].
    source_mask [B, N] bool: only neighbours with True contribute; a token
    whose neighbourhood is then empty keeps its own value.
    """
    nbrs = patches[:, neighbor_idx, :]  # [B, N, 8, D]
    if source_mask is None:
        mean = nbrs.mean(dim=2)
    else:
        w = source_mask[:, neighbor_idx].to(patches.dtype)  # [B, N, 8]
        cnt = w.sum(dim=2, keepdim=True)
        mean = (nbrs * w[..., None]).sum(dim=2) / cnt.clamp_min(1.0)
        mean = torch.where(cnt > 0, mean, patches)
    return patches * (1.0 - weight) + mean * weight


# --- Compaction ----------------------------------------------------------------------

def compact_dest(keep_mask: torch.Tensor) -> torch.Tensor:
    """[..., S] long compacted row of every token: kept tokens first, then
    the skipped ones, each group in token order (two cumsums, no sort)."""
    kept = keep_mask.to(torch.int64)
    counts = kept.sum(-1, keepdim=True)
    kept_rank = torch.cumsum(kept, -1) - 1
    skip_rank = counts + torch.cumsum(1 - kept, -1) - 1
    return torch.where(keep_mask, kept_rank, skip_rank)


def compact_indices(keep_mask: torch.Tensor, k: int) -> torch.Tensor:
    """Source positions of the first k rows of the kept-first order:
    [..., S] bool -> [..., k] long, ascending where all k are kept."""
    dest = compact_dest(keep_mask)
    pos = torch.arange(keep_mask.shape[-1], device=keep_mask.device).expand_as(dest)
    return torch.empty_like(dest).scatter_(-1, dest, pos)[..., :k]


def gather_compact(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """x [B, S, D], indices [B, K] -> [B, K, D]."""
    return torch.gather(x, 1, indices[..., None].expand(-1, -1, x.shape[-1]))


def scatter_back(x: torch.Tensor, indices: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """A copy of x [B, S, D] with rows `indices` [B, K] set to values
    [B, K, D] (output[i][mask[i]] = processed)."""
    return x.scatter(1, indices[..., None].expand(-1, -1, x.shape[-1]), values)


# --- Metrics -------------------------------------------------------------------------

def confusion_counts(true_labels: torch.Tensor, pred_labels: torch.Tensor) -> torch.Tensor:
    """2x2 confusion matrix [[TN, FP], [FN, TP]] (rows true, columns
    predicted), int32, computed on the tensors' device."""
    t = true_labels.reshape(-1).to(torch.int32)
    p = pred_labels.reshape(-1).to(torch.int32)
    cells = [((1 - t) * (1 - p)).sum(), ((1 - t) * p).sum(), (t * (1 - p)).sum(), (t * p).sum()]
    return torch.stack(cells).to(torch.int32).reshape(2, 2)
