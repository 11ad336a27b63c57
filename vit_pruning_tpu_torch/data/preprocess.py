"""ViT image preprocessing with HF `ViTImageProcessor` semantics.

Mirrors vit_pruning_tpu/data/preprocess.py: resize to size x size
(bilinear), rescale by 1/255, normalise with mean = std = 0.5, CHW layout.

  * `vit_preprocess` — on tensors, on whatever device they lie (the input
                       pipeline runs it on the card). The reference resizes
                       with jax.image.resize(..., 'bilinear'), which
                       antialiases when it downscales; F.interpolate does
                       so only with antialias=True, which is passed whenever
                       an axis shrinks (without it a 224 -> 96 downscale
                       differs by up to 148 on the 0..255 scale).
  * `pil_preprocess` — the exact HF-processor numerics on the host: uniform
                       uint8 batches go through the port's native C++
                       resampler (vit_pruning_tpu_torch/native, PIL-bit-exact),
                       anything else through the per-image PIL loop.

serving.embed_from_u8 and the fused uint8 patch embedding (kernel B8a) read
VIT_MEAN / VIT_STD.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

VIT_MEAN = 0.5
VIT_STD = 0.5


def vit_preprocess(images: torch.Tensor, size: int = 224, mean: float = VIT_MEAN,
                   std: float = VIT_STD) -> torch.Tensor:
    """[B, H, W, 3] uint8/float (0..255) -> [B, 3, size, size] normalised float32,
    on the images' device."""
    x = images.to(torch.float32).permute(0, 3, 1, 2)
    h, w = x.shape[2], x.shape[3]
    if h != size or w != size:
        x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=False,
                          antialias=size < h or size < w)
    return ((x / 255.0 - mean) / std).contiguous()


def pil_preprocess(images, size: int = 224, mean: float = VIT_MEAN, std: float = VIT_STD,
                   _force_pil: bool = False) -> np.ndarray:
    """Exact HF-processor path (PIL-bilinear numerics), host-side.

    images: list of HxWx3 uint8 arrays or PIL Images (or an [N,H,W,3] array).
    Returns [B, 3, size, size] float32. Uniform uint8 ndarray batches take the
    bit-identical native C++ path; `_force_pil` pins the per-image PIL loop
    (the tests compare the two).
    """
    if not isinstance(images, np.ndarray):
        images = list(images)  # accept generators/iterators (single pass)
    if not _force_pil and np.isscalar(mean) and np.isscalar(std):
        batch = None
        if isinstance(images, np.ndarray):
            batch = images
        elif (len(images) and all(isinstance(im, np.ndarray) for im in images)
              and len({im.shape for im in images}) == 1):
            batch = np.stack(images)
        if batch is not None and batch.dtype == np.uint8 and batch.ndim == 4 \
                and batch.shape[-1] == 3:
            from vit_pruning_tpu_torch import native

            if native.available():
                return native.preprocess(batch, size=size, mean=mean, std=std)

    from PIL import Image

    out = []
    for im in images:
        if not isinstance(im, Image.Image):
            im = Image.fromarray(np.asarray(im).astype(np.uint8))
        im = im.convert("RGB").resize((size, size), Image.BILINEAR)
        a = np.asarray(im, dtype=np.float32) / 255.0
        a = (a - mean) / std
        out.append(a.transpose(2, 0, 1))
    return np.stack(out)
