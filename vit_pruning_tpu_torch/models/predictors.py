"""Skip-predictor heads. The serving path's kind, cls_mlp, is ported; every
other kind of vit_pruning_tpu/models/predictors.py waits for the re-decide
slice (ROADMAP A.7) and raises NotImplementedError here.

cls_mlp scores each patch token with MLP([CLS ⊕ token]) -> sigmoid, sizes
[2D, hidden, 1], ReLU between. Params are stacked per layer:
{'mlp': {'l0': {'w' [L, 2D, h], 'b' [L, h]}, 'l1': {'w' [L, h, 1], 'b' [L, 1]}}}.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
from vit_pruning_tpu_torch.models.convert import tree_to
from vit_pruning_tpu_torch.models.vit import linear_init, stack_trees


def _not_ported(kind: str) -> NotImplementedError:
    return NotImplementedError(
        f"predictor {kind!r}: only 'cls_mlp' is ported; the others are ROADMAP A.7"
    )


def init_predictor_params(
    config: ViTConfig,
    pcfg: PruneConfig,
    generator: torch.Generator,
    device="cpu",
    dtype: torch.dtype = torch.float32,
) -> Optional[dict]:
    """Predictor params for all layers (None for predictor='none')."""
    if pcfg.predictor == "none":
        return None
    if pcfg.predictor != "cls_mlp":
        raise _not_ported(pcfg.predictor)
    d, h = config.hidden_size, pcfg.predictor_hidden
    per_layer = [
        {"l0": linear_init(generator, 2 * d, h), "l1": linear_init(generator, h, 1)}
        for _ in range(config.num_layers)
    ]
    return tree_to({"mlp": stack_trees(per_layer)}, device, dtype)


def apply_predictor(
    pred_params: dict,
    layer_idx: int,
    hidden_states: torch.Tensor,
    config: ViTConfig,
    pcfg: PruneConfig,
    layer_params: Optional[dict] = None,
) -> Tuple[torch.Tensor, dict]:
    """Score the patch tokens of hidden_states [B, S, D] (CLS at 0).
    Returns (scores [B, S-1] in (0, 1), extras)."""
    if pcfg.predictor != "cls_mlp":
        raise _not_ported(pcfg.predictor)
    # concat([cls, t]) @ W0 == cls @ W0[:D] + t @ W0[D:]: the CLS term is one
    # row broadcast over all patches, so the [B, N, 2D] concat is never built
    mlp = pred_params["mlp"]
    w0, b0 = mlp["l0"]["w"][layer_idx], mlp["l0"]["b"][layer_idx]
    w1, b1 = mlp["l1"]["w"][layer_idx], mlp["l1"]["b"][layer_idx]
    d = hidden_states.shape[-1]
    hidden = hidden_states[:, 0:1] @ w0[:d] + hidden_states[:, 1:] @ w0[d:] + b0
    scores = torch.sigmoid(torch.relu(hidden) @ w1 + b1)[..., 0]
    return scores, {}
