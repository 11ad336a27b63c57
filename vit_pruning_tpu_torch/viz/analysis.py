"""Cosine-similarity analysis + training-curve plots (V7, V8).

The port's counterpart of vit_pruning_tpu/viz/analysis.py: the similarity
profile runs the port's dense forward (models/vit.py::vit_forward) on the
params' device, in torch; the plots are the JAX package's, numpy in, PNG
out.

Reference: himanshu/cosine_sim_visual.ipynb (per-layer token in/out cosine
similarity distributions — the figure motivating the whole skip approach) and
plots.ipynb (train/test accuracy-loss dual-axis curves).
"""

from __future__ import annotations

import os

import numpy as np
import torch


@torch.no_grad()
def layer_similarity_profile(params, pixel_values, config) -> np.ndarray:
    """Per-layer distribution of token in/out cosine similarity [L, B, N].

    Runs the dense model on the params' device, collecting hidden states,
    and computes the cosine similarity of each patch token before/after
    each layer — the V7 analysis. pixel_values: a tensor or an array
    [B, C, H, W], moved to the params' device. Returns numpy float32.
    """
    from vit_pruning_tpu_torch.models.vit import vit_forward

    device = params["head"]["w"].device
    out = vit_forward(params, torch.as_tensor(pixel_values).to(device), config,
                      output_hidden_states=True)
    hs = out["hidden_states"]  # L+1 tensors [B, S, D]
    sims = []
    for i in range(config.num_layers):
        a, b = hs[i][:, 1:].float(), hs[i + 1][:, 1:].float()
        dot = (a * b).sum(-1)
        nrm = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1)
        sims.append(dot / nrm.clamp_min(1e-12))
    return torch.stack(sims).cpu().numpy()


def plot_similarity_distributions(sims: np.ndarray, out_path: str = "images/cosineSim.png"):
    """Violin/box view of per-layer in/out similarity (figure V7)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    L = sims.shape[0]
    data = [sims[i].reshape(-1) for i in range(L)]
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.violinplot(data, showmedians=True)
    ax.set_xlabel("Layer")
    ax.set_ylabel("cos(token in, token out)")
    ax.set_title("Per-layer token input/output cosine similarity")
    ax.set_xticks(range(1, L + 1), [str(i) for i in range(L)])
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight", dpi=100)
    plt.close(fig)
    return out_path


def plot_training_curves(
    histories: dict,
    out_path: str = "images/train.png",
    metric: str = "accuracy",
):
    """Dual-axis accuracy/loss curves for named runs (plots.ipynb cells 0-2).

    histories: {run_name: {'accuracy': [...], 'loss': [...]}}.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax1 = plt.subplots(figsize=(9, 5))
    ax2 = ax1.twinx()
    for name, h in histories.items():
        epochs = np.arange(1, len(h[metric]) + 1)
        ax1.plot(epochs, h[metric], marker="o", label=f"{name} {metric}")
        if "loss" in h:
            ax2.plot(epochs, h["loss"], linestyle="--", alpha=0.5, label=f"{name} loss")
    ax1.set_xlabel("Epoch")
    ax1.set_ylabel(metric)
    ax2.set_ylabel("loss")
    ax1.legend(loc="lower right")
    fig.suptitle("Training curves")
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, bbox_inches="tight", dpi=100)
    plt.close(fig)
    return out_path
