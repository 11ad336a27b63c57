"""Blackout montages and per-layer strips (V4, V5, V9).

The port's copy of vit_pruning_tpu/viz/blackout.py (numpy in, PNG or
arrays out), held equal to it by tests/test_torch_viz.py.

Reference: donal/skipped_patch_visualisation.py:70-251 (per-image 3x4 grid of
all 12 layers with skipped patches painted red + per-layer skip%% titles;
average-skips-per-layer bar chart :216-247), interIIT/interiit.py:411-449
(grayscale 16x16-patch strips, inferno colormap), mukunda/deit.py:93-128
(mask-grid dumps during training).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _to_hwc(image: np.ndarray) -> np.ndarray:
    """Accept [3, H, W] or [H, W, 3] float/uint8 -> [H, W, 3] float in [0,1]."""
    img = np.asarray(image, dtype=np.float64)
    if img.ndim == 3 and img.shape[0] == 3:
        img = img.transpose(1, 2, 0)
    if img.max() > 1.5:
        img = img / 255.0
    return np.clip(img, 0, 1)


def blackout_image(
    image: np.ndarray,
    patch_keep: np.ndarray,
    patch_size: int,
    color=(1.0, 0.0, 0.0),
    alpha: float = 0.8,
) -> np.ndarray:
    """Paint skipped patches with `color` (reference paints red,
    skipped_patch_visualisation.py). patch_keep: [N] bool (no CLS)."""
    img = _to_hwc(image).copy()
    g = img.shape[0] // patch_size
    keep = np.asarray(patch_keep).reshape(g, g)
    col = np.asarray(color, dtype=np.float64)
    for r in range(g):
        for c in range(g):
            if not keep[r, c]:
                ys, xs = r * patch_size, c * patch_size
                blk = img[ys:ys + patch_size, xs:xs + patch_size]
                img[ys:ys + patch_size, xs:xs + patch_size] = (
                    (1 - alpha) * blk + alpha * col
                )
    return img


def blackout_montage(
    image: np.ndarray,
    keep_masks: np.ndarray,
    patch_size: int,
    out_path: Optional[str] = None,
    ncols: int = 4,
    label: Optional[str] = None,
):
    """Grid of all layers for one image, skipped patches red, per-layer
    skip%% in the title (the V4 montage). keep_masks: [L, S] bool (CLS at 0).
    Returns the figure (saved + closed if out_path given)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    km = np.asarray(keep_masks)[:, 1:]
    L = km.shape[0]
    nrows = -(-L // ncols)
    fig, axes = plt.subplots(nrows, ncols, figsize=(3 * ncols, 3 * nrows))
    for i, ax in enumerate(np.ravel(axes)):
        if i < L:
            ax.imshow(blackout_image(image, km[i], patch_size))
            skip_pct = 100.0 * (1 - km[i].mean())
            ax.set_title(f"Layer {i}: {skip_pct:.1f}% skipped", fontsize=9)
        ax.axis("off")
    if label is not None:
        fig.suptitle(label)
    fig.tight_layout()
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, bbox_inches="tight", dpi=100)
        plt.close(fig)
    return fig


def skips_per_layer_chart(
    keep_masks: np.ndarray, out_path: Optional[str] = None
):
    """Average skipped patches per layer bar chart
    (skipped_patch_visualisation.py:216-247). keep_masks: [L, B, S]."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    km = np.asarray(keep_masks)[:, :, 1:]
    avg_skips = (~km).sum(axis=2).mean(axis=1)
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.bar(np.arange(len(avg_skips)), avg_skips, color="tab:red")
    ax.set_xlabel("Layer")
    ax.set_ylabel("Avg skipped patches")
    ax.set_title(f"Average skipped patches per layer (of {km.shape[2]})")
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, bbox_inches="tight", dpi=100)
        plt.close(fig)
    return fig, avg_skips


def layer_strips(
    image: np.ndarray, keep_masks: np.ndarray, patch_size: int, cmap: str = "inferno"
) -> list:
    """V5 (interiit.py:411-449): per layer, the grayscale image with skipped
    patches zeroed, rendered through a colormap. Returns list of [H, W, 3]."""
    import matplotlib

    gray = _to_hwc(image).mean(axis=2)
    g = gray.shape[0] // patch_size
    km = np.asarray(keep_masks)[:, 1:]
    out = []
    mapper = matplotlib.colormaps[cmap]
    for layer_keep in km:
        masked = gray.copy()
        keep = layer_keep.reshape(g, g)
        for r in range(g):
            for c in range(g):
                if not keep[r, c]:
                    masked[r * patch_size:(r + 1) * patch_size,
                           c * patch_size:(c + 1) * patch_size] = 0.0
        out.append(mapper(masked)[..., :3])
    return out


def training_mask_dump(
    images: Sequence[np.ndarray],
    keep_masks: np.ndarray,
    patch_size: int,
    out_dir: str,
    step: int,
):
    """V9 (mukunda/deit.py:93-128): montage per tracked image at a training
    step. keep_masks: [L, B, S]."""
    paths = []
    for bi, img in enumerate(images):
        p = os.path.join(out_dir, f"step{step}_img{bi}.png")
        blackout_montage(img, np.asarray(keep_masks)[:, bi], patch_size, out_path=p)
        paths.append(p)
    return paths
