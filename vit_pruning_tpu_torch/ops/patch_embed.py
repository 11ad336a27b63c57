"""Patch embedding: conv-as-matmul reference + strided-conv path.

Mirrors vit_pruning_tpu/ops/patch_embed.py. Both impls compute the same
Conv2d(C, D, kernel=P, stride=P): `matmul` flattens each P x P patch in
(c, kh, kw) order and multiplies by the [C*P*P, D] weight; `conv` runs
F.conv2d with the weight reshaped to [D, C, P, P]. The JAX package takes
conv on its TPU, where XLA fuses the patch shuffle into the convolution;
on an H100 (700 W) the matmul form measured 0.45 ms against conv's 3.07 ms
for a bf16 DeiT-S batch of 512 (cuDNN spends most of it converting layouts),
so matmul is the default everywhere and conv stays as its cross-check. The
JAX package's `auto` (conv on its TPU) is taken too, and means matmul here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def extract_patches(pixel_values: torch.Tensor, patch_size: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, N, C*P*P] with (c, kh, kw) flattening order."""
    b, c, h, w = pixel_values.shape
    gh, gw = h // patch_size, w // patch_size
    x = pixel_values.reshape(b, c, gh, patch_size, gw, patch_size)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [B, gh, gw, C, P, P]
    return x.reshape(b, gh * gw, c * patch_size * patch_size)


def patch_embed(
    pixel_values: torch.Tensor, params: dict, patch_size: int, impl: str = "matmul"
) -> torch.Tensor:
    """[B, C, H, W] -> [B, N, D]. params: {'w': [C*P*P, D], 'b': [D]}.
    impl: 'matmul', 'conv' or 'auto' (= 'matmul')."""
    if impl == "auto":
        impl = "matmul"
    if impl == "conv":
        b, c, _, _ = pixel_values.shape
        d = params["w"].shape[1]
        w4 = params["w"].reshape(c, patch_size, patch_size, d).permute(3, 0, 1, 2)
        y = F.conv2d(pixel_values, w4.to(pixel_values.dtype), stride=patch_size)
        return y.flatten(2).transpose(1, 2) + params["b"]
    if impl != "matmul":
        raise ValueError(f"patch_embed impl {impl!r} not in ('auto', 'matmul', 'conv')")
    return extract_patches(pixel_values, patch_size) @ params["w"] + params["b"]
