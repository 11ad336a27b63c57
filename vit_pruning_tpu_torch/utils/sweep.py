"""Hyperparameter sweep (H13).

Mirrors vit_pruning_tpu/utils/sweep.py over the port's phased_train /
evaluate. Reference: hyperparameter_search.ipynb cells 4-6 — a list-of-dicts
experiment grid fed to run_experiment, results collected into a pandas table.
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
from vit_pruning_tpu_torch.models.pruned_vit import init_pruned_vit_params
from vit_pruning_tpu_torch.train.harness import evaluate, phased_train


def grid(**axes: Sequence) -> List[Dict]:
    """grid(sim_threshold=[.85,.9], mode=['mask','topk']) -> list of dicts."""
    keys = list(axes)
    return [dict(zip(keys, vals)) for vals in itertools.product(*axes.values())]


def run_experiment(
    overrides: Dict,
    config: ViTConfig,
    base_pcfg: PruneConfig,
    train_batches,
    test_batches,
    *,
    train_type: str = "both",
    num_epochs=(1, 1),
    lrs=(1e-3, 1e-5),
    seed: int = 0,
    log: Optional[Callable[[str], None]] = None,
    device="cuda",
) -> Dict:
    """Train+eval one configuration, params drawn from a generator seeded
    `seed` on the CPU and moved to `device`; returns a result row."""
    pcfg = base_pcfg.replace(**overrides)
    params = init_pruned_vit_params(config, pcfg, torch.Generator().manual_seed(seed), device)
    params = phased_train(
        params, train_batches, test_batches, config, pcfg,
        train_type=train_type, num_epochs=num_epochs, lrs=lrs, log=log,
    )
    accuracy, mlp_accuracy, acc = evaluate(params, test_batches, config, pcfg, full_testing=True)
    return {
        **overrides,
        "accuracy": accuracy,
        "mlp_accuracy": mlp_accuracy,
        "mean_skip": float(acc.measured_skip_per_layer.mean()),
    }


def sweep(
    experiments: Iterable[Dict],
    config: ViTConfig,
    base_pcfg: PruneConfig,
    train_batches,
    test_batches,
    **kwargs,
):
    """Run every experiment; returns a pandas DataFrame of result rows."""
    import pandas as pd

    rows = [
        run_experiment(e, config, base_pcfg, train_batches, test_batches, **kwargs)
        for e in experiments
    ]
    return pd.DataFrame(rows)
