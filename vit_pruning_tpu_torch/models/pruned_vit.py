"""Progressive top-k compaction (mode='topk_prog'), the serving forward.

Mirrors init_pruned_vit_params, _keep_projection, progressive_drop and
progressive_topk_forward of vit_pruning_tpu/models/pruned_vit.py. At each
drop layer the cls_mlp predictor scores the live patches, CLS and the top-k
patches are kept in token order, and the sequence physically shrinks;
dropped tokens never rejoin. The JAX package gathers the kept rows with a
one-hot matmul (a TPU workaround for slow dynamic gathers); here they are
gathered by index, with the same kept set and row order.

With logits_only=True and kernels enabled, the last layer, the final LN and
the classifier run as kernel B2 on the CLS row
(ops/cuda/layer.py::fused_vit_layer_cls_logits); every other layer goes
through vit_layer (kernel B1).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
from vit_pruning_tpu_torch.models.predictors import apply_predictor, init_predictor_params
from vit_pruning_tpu_torch.models.vit import (
    check_attn_geometry,
    embed,
    init_vit_params,
    layer_norm,
    layer_slice,
    vit_layer,
)
from vit_pruning_tpu_torch.ops.dispatch import kernels_enabled
from vit_pruning_tpu_torch.ops.masking import add_cls_keep, rank_keep_mask


def init_pruned_vit_params(
    config: ViTConfig,
    pcfg: PruneConfig,
    generator: torch.Generator,
    device="cpu",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """{'backbone': ViT params, 'predictor': predictor params or None}."""
    if pcfg.skip_correction == "updatenet":
        raise NotImplementedError("skip_correction='updatenet': ROADMAP A.7")
    return {
        "backbone": init_vit_params(config, generator, device, dtype),
        "predictor": init_predictor_params(config, pcfg, generator, device, dtype),
    }


def _is_active(pcfg: PruneConfig, i: int) -> bool:
    if pcfg.mode == "none":
        return False
    return pcfg.active_layers is None or i in pcfg.active_layers


def _keep_projection(scores: torch.Tensor, k: int):
    """CLS + the top-k patches by score (rank_keep_mask tie-break).

    Returns (mask [B, S] bool, cidx [B, k+1] long): cidx[b, r] is the source
    position of compacted row r, in token order — the rows of the JAX
    package's one-hot P, as indices.
    """
    mask = add_cls_keep(rank_keep_mask(scores, k))
    b, s = mask.shape
    rank = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    # dropped tokens write to a spare column k+1, cut off below (no host sync)
    dest = torch.where(mask, rank, k + 1)
    src = torch.arange(s, device=mask.device).expand(b, s)
    cidx = torch.zeros((b, k + 2), dtype=torch.int64, device=mask.device)
    cidx.scatter_(1, dest, src)
    return mask, cidx[:, : k + 1]


def progressive_drop(
    x: torch.Tensor,
    pred_params: Optional[dict],
    layer_idx: int,
    k: int,
    config: ViTConfig,
    pcfg: PruneConfig,
    layer_params: Optional[dict] = None,
):
    """Score the live sequence, keep CLS + the top-k patches in token order.
    Returns (x_compacted [B, k+1, D], scores [B, cur-1], cidx [B, k+1])."""
    scores, _ = apply_predictor(
        pred_params, layer_idx, x, config, pcfg, layer_params=layer_params
    )
    _, cidx = _keep_projection(scores, k)
    xc = torch.gather(x, 1, cidx[..., None].expand(-1, -1, x.shape[-1]))
    return xc, scores, cidx


def progressive_topk_forward(
    params: dict,
    pixel_values: Optional[torch.Tensor],
    config: ViTConfig,
    pcfg: PruneConfig,
    *,
    x0: Optional[torch.Tensor] = None,
    logits_only: bool = False,
) -> dict:
    """Returns dict(logits, keep_masks [L, B, S] bool over original
    positions, scores [L, B, N] over original patch positions with -inf at
    dropped ones; + cls, last_hidden when logits_only=False)."""
    if pcfg.merge_dropped:
        raise NotImplementedError("merge_dropped: ROADMAP A.7")
    if os.environ.get("VIT_PRUNING_TPU_ENCODER") == "1":
        raise NotImplementedError("whole-encoder segments: kernel B5, ROADMAP A.12")
    backbone = params["backbone"]
    pred = params.get("predictor")
    check_attn_geometry(backbone["layers"]["attn"]["q"]["w"].shape[-1], config)

    x = x0 if x0 is not None else embed(pixel_values, backbone["embed"], config)
    b, s, _ = x.shape
    L = config.num_layers
    schedule = pcfg.keep_schedule or tuple([pcfg.top_k] + [0] * (L - 1))
    schedule = tuple(min(k, s - 1) if k else 0 for k in schedule)

    orig = torch.arange(s, device=x.device).expand(b, s)  # source position of each live token
    masks, scores_l = [], []
    cur = s
    use_cls_kernel = logits_only and kernels_enabled()
    for i in range(L):
        lp = layer_slice(backbone["layers"], i)
        k_i = schedule[i]
        if k_i and k_i < cur - 1 and _is_active(pcfg, i):
            x, scores, cidx = progressive_drop(x, pred, i, k_i, config, pcfg, layer_params=lp)
            full = torch.full((b, s - 1), float("-inf"), dtype=scores.dtype, device=x.device)
            scores_l.append(full.scatter(1, orig[:, 1:] - 1, scores))
            orig = torch.gather(orig, 1, cidx)
            cur = k_i + 1
        else:
            scores_l.append(torch.full((b, s - 1), float("-inf"), dtype=x.dtype, device=x.device))
        masks.append(torch.zeros((b, s), dtype=torch.bool, device=x.device).scatter(1, orig, True))
        if i == L - 1 and use_cls_kernel:
            break
        x = vit_layer(x, lp, config)

    if use_cls_kernel:
        from vit_pruning_tpu_torch.ops.cuda.layer import fused_vit_layer_cls_logits

        logits = fused_vit_layer_cls_logits(
            x, layer_slice(backbone["layers"], L - 1), backbone["ln_f"], backbone["head"],
            config.num_heads, config.layernorm_eps,
        )
        return {"logits": logits, "keep_masks": torch.stack(masks), "scores": torch.stack(scores_l)}

    x = layer_norm(x, backbone["ln_f"], config.layernorm_eps)
    cls = x[:, 0]
    out = {
        "logits": cls @ backbone["head"]["w"] + backbone["head"]["b"],
        "keep_masks": torch.stack(masks),
        "scores": torch.stack(scores_l),
    }
    if not logits_only:
        out["cls"] = cls
        out["last_hidden"] = x  # compacted: live tokens only
    return out
