"""Per-patch frequency heatmaps (V1-V3).

The port's copy of vit_pruning_tpu/viz/heatmaps.py (numpy in, PNG out),
held equal to it by tests/test_torch_viz.py.

Reference: donal/skipped_patches_inference.py:55-121 (predicted-skip
frequency per layer over the test set, 14x14 seaborn heatmap per layer ->
skipped_heatmaps/layer_{i}_skipped_heatmap.png), to_skip_patches_inference.py
(oracle labels -> to_skip_heatmaps/), misclassified_patches_inference.py:70-110
(pred != true frequency -> misclassified_heatmaps/, Reds colormap).

The reference reads side-channel attributes (`layer.pred_labels`); here the
inputs are the explicit keep_masks / oracle_keep outputs of
pruned_vit_forward, as numpy arrays.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def mask_frequency(patch_events: np.ndarray) -> np.ndarray:
    """[L, B, N] boolean events -> per-patch frequency grid [L, g, g]."""
    ev = np.asarray(patch_events, dtype=np.float64)
    L, _, n = ev.shape
    g = int(round(n ** 0.5))
    return ev.mean(axis=1).reshape(L, g, g)


def save_layer_heatmaps(
    freq: np.ndarray,
    out_dir: str,
    name: str,
    cmap: str = "viridis",
    title: str = "frequency",
    vmin: Optional[float] = 0.0,
    vmax: Optional[float] = 1.0,
) -> list:
    """One PNG per layer: <out_dir>/layer_{i}_{name}_heatmap.png."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    try:
        import seaborn as sns
    except ImportError:
        sns = None

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, grid in enumerate(np.asarray(freq)):
        fig, ax = plt.subplots(figsize=(6, 5))
        if sns is not None:
            sns.heatmap(grid, cmap=cmap, vmin=vmin, vmax=vmax, annot=False, ax=ax)
        else:
            im = ax.imshow(grid, cmap=cmap, vmin=vmin, vmax=vmax)
            fig.colorbar(im, ax=ax)
        ax.set_title(f"Layer {i} {title}")
        path = os.path.join(out_dir, f"layer_{i}_{name}_heatmap.png")
        fig.savefig(path, bbox_inches="tight", dpi=100)
        plt.close(fig)
        paths.append(path)
    return paths


def skipped_heatmaps(keep_masks: np.ndarray, out_dir: str = "skipped_heatmaps") -> list:
    """V1: frequency each patch was *predicted skipped* per layer.

    keep_masks: [L, B, S] bool (CLS at 0).
    """
    skipped = ~np.asarray(keep_masks)[:, :, 1:]
    return save_layer_heatmaps(
        mask_frequency(skipped), out_dir, "skipped", title="predicted-skip frequency"
    )


def to_skip_heatmaps(oracle_keep: np.ndarray, out_dir: str = "to_skip_heatmaps") -> list:
    """V2: frequency the oracle says each patch *should* be skipped.

    oracle_keep: [L, B, N] bool (True = should process).
    """
    should_skip = ~np.asarray(oracle_keep)
    return save_layer_heatmaps(
        mask_frequency(should_skip), out_dir, "to_skip", title="oracle-skip frequency"
    )


def misclassified_heatmaps(
    keep_masks: np.ndarray, oracle_keep: np.ndarray, out_dir: str = "misclassified_heatmaps"
) -> list:
    """V3: frequency of predictor-vs-oracle disagreement per patch per layer."""
    pred = np.asarray(keep_masks)[:, :, 1:]
    wrong = pred != np.asarray(oracle_keep)
    return save_layer_heatmaps(
        mask_frequency(wrong), out_dir, "misclassified",
        cmap="Reds", title="predictor-error frequency",
    )
