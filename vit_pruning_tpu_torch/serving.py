"""Serving entry point: raw uint8 images -> logits.

Mirrors embed_from_u8 and serving_forward of vit_pruning_tpu/serving.py:
uint8 pixels go to the device (4x fewer bytes than float32), are normalised
there in float32, cast to the weight dtype, patch-projected, and then run
through the progressive top-k forward, in float or, with quant='int8',
through int8 weight products (kernel B4).
"""

from __future__ import annotations

from typing import Optional

import torch

from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
from vit_pruning_tpu_torch.data.preprocess import VIT_MEAN, VIT_STD
from vit_pruning_tpu_torch.models.pruned_vit import progressive_topk_forward
from vit_pruning_tpu_torch.ops.patch_embed import patch_embed


def _require_u8(pixels: torch.Tensor, who: str):
    if pixels.dtype != torch.uint8:
        raise ValueError(f"{who} expects uint8 pixels, got {pixels.dtype}")


def embed_from_u8(
    pixels_u8: torch.Tensor, embed_params: dict, config: ViTConfig, impl: str = "auto"
) -> torch.Tensor:
    """uint8 [B, C, H, W] -> embeddings [B, S, D]: normalise, patch
    projection (ops/patch_embed.py `impl`), position add, CLS. The serving
    embed, in plain PyTorch as the JAX package's is in XLA; the fused
    kernel form of the same function is ops/cuda/embed.py::embed_u8."""
    _require_u8(pixels_u8, "embed_from_u8")
    w_dtype = embed_params["patch"]["w"].dtype
    x = (pixels_u8.float() / 255.0 - VIT_MEAN) / VIT_STD
    y = patch_embed(x.to(w_dtype), embed_params["patch"], config.patch_size, impl=impl)
    pos = embed_params["pos"]
    y = y + pos[:, 1:]
    cls = (embed_params["cls"] + pos[:, :1]).to(y.dtype).expand(y.shape[0], 1, y.shape[-1])
    return torch.cat([cls, y], dim=1)


def serving_forward(
    params: dict,
    pixels_u8: torch.Tensor,
    config: ViTConfig,
    pcfg: PruneConfig,
    logits_only: bool = True,
    quant: Optional[str] = None,
) -> dict:
    """pixels_u8 [B, C, H, W] uint8 -> the progressive forward's output dict
    (logits, keep_masks, scores; + cls/last_hidden when logits_only=False).
    quant: 'none', 'int8' or None (read the dispatch switch)."""
    _require_u8(pixels_u8, "serving_forward")
    x0 = embed_from_u8(pixels_u8, params["backbone"]["embed"], config)
    return progressive_topk_forward(params, None, config, pcfg, x0=x0, logits_only=logits_only,
                                    quant=quant)
