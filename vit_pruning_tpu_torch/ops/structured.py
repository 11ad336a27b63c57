"""Structured pruning: attention heads and MLP channels.

Mirrors vit_pruning_tpu/ops/structured.py over the port's tensor tree
(per-layer leaves stacked [L, ...]), at its two levels:
  * soft masks for mask search: a head mask [L, H] multiplies attention
    probabilities (models/vit.py::vit_forward's head_mask), and
    `apply_channel_mask` zeroes MLP hidden units; `head_importance` and
    `channel_importance` score the units;
  * physical slicing: `prune_heads` / `prune_mlp_channels` rebuild the tree
    with the pruned units removed.
"""

from __future__ import annotations

from typing import Sequence

import torch

from vit_pruning_tpu_torch.configs import ViTConfig


def apply_channel_mask(params: dict, channel_mask: torch.Tensor) -> dict:
    """Soft-zero MLP hidden channels: channel_mask [L, M] in {0, 1}. Zeroing
    fc1's output columns (weight and bias) equals masking the hidden
    activation, since GELU(0) = 0 flows through fc2."""
    fc1 = params["layers"]["mlp"]["fc1"]
    cm = channel_mask.to(fc1["w"].dtype)
    mlp = dict(params["layers"]["mlp"], fc1={"w": fc1["w"] * cm[:, None, :], "b": fc1["b"] * cm})
    return dict(params, layers=dict(params["layers"], mlp=mlp))


def _gather(a: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """Per-layer index select: a [L, ...], idx [L, K] along `dim` (>= 1)."""
    shape = [1] * a.dim()
    shape[0], shape[dim] = idx.shape
    size = list(a.shape)
    size[dim] = idx.shape[1]
    return torch.gather(a, dim, idx.reshape(shape).expand(size))


def _layer_index(keep: Sequence[Sequence[int]], what: str, device) -> torch.Tensor:
    counts = {len(c) for c in keep}
    if len(counts) != 1:
        raise ValueError(f"all layers must keep the same number of {what} (static shapes)")
    return torch.tensor([sorted(c) for c in keep], dtype=torch.long, device=device)


def prune_heads(
    params: dict, config: ViTConfig, keep_heads: Sequence[Sequence[int]]
) -> tuple:
    """keep_heads[i] = head indices kept at layer i (equal counts). Returns
    (new_params, config.replace(num_heads=kept, attn_head_dim=hd)): q/k/v
    then project D -> kept*hd and o takes kept*hd rows."""
    layers = params["layers"]
    heads = _layer_index(keep_heads, "heads", layers["attn"]["q"]["w"].device)
    kept = heads.shape[1]
    hd = config.head_dim
    cols = (heads[:, :, None] * hd + torch.arange(hd, device=heads.device)).reshape(
        heads.shape[0], kept * hd
    )
    attn = layers["attn"]
    new_attn = {
        name: {"w": _gather(attn[name]["w"], cols, 2), "b": _gather(attn[name]["b"], cols, 1)}
        for name in ("q", "k", "v")
    }
    new_attn["o"] = {"w": _gather(attn["o"]["w"], cols, 1), "b": attn["o"]["b"]}
    new_params = dict(params)
    new_params["layers"] = dict(layers, attn=new_attn)
    return new_params, config.replace(num_heads=kept, attn_head_dim=hd)


def prune_mlp_channels(params: dict, keep_channels: Sequence[Sequence[int]]) -> dict:
    """keep_channels[i] = MLP hidden units kept at layer i (equal counts)."""
    mlp = params["layers"]["mlp"]
    idx = _layer_index(keep_channels, "channels", mlp["fc1"]["w"].device)
    new_mlp = {
        "fc1": {"w": _gather(mlp["fc1"]["w"], idx, 2), "b": _gather(mlp["fc1"]["b"], idx, 1)},
        "fc2": {"w": _gather(mlp["fc2"]["w"], idx, 1), "b": mlp["fc2"]["b"]},
    }
    new_params = dict(params)
    new_params["layers"] = dict(params["layers"], mlp=new_mlp)
    return new_params


def channel_importance(params: dict) -> torch.Tensor:
    """Weight-magnitude importance of every MLP hidden unit, [L, M]:
    ||fc1[:, j]|| * ||fc2[j, :]||, the unit's input gain times its output
    gain. Data-free."""
    mlp = params["layers"]["mlp"]
    return (torch.linalg.vector_norm(mlp["fc1"]["w"], dim=1)
            * torch.linalg.vector_norm(mlp["fc2"]["w"], dim=2))


def head_importance(params: dict, pixel_values: torch.Tensor, config: ViTConfig) -> torch.Tensor:
    """Mean CLS-row attention mass per head, per layer, [L, H]: for each
    layer, the probabilities from CLS to the patches summed over patches and
    averaged over the batch. Runs the plain return_probs layer on every
    device (no kernel), as the JAX package's does."""
    from vit_pruning_tpu_torch.models.vit import embed, layer_slice, vit_layer

    x = embed(pixel_values, params["embed"], config)
    scores = []
    for i in range(config.num_layers):
        x, probs = vit_layer(x, layer_slice(params["layers"], i), config, return_probs=True,
                             use_kernels=False)
        scores.append(probs[:, :, 0, 1:].sum(-1).mean(0))
    return torch.stack(scores)
