"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

Inputs come from numpy seeds; weights are made by the JAX package and
handed to the port through models/convert.py, so both packages run the
same numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vit_pruning_tpu.configs import PruneConfig, ViTConfig
from vit_pruning_tpu_torch.models.convert import params_from_jax


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def jax_and_torch_params(tree, dtype=jnp.float32):
    """(JAX tree in `dtype`, port tree from the same numbers)."""
    jtree = jax.tree.map(lambda a: a.astype(dtype), tree)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jtree, params_from_jax(to_numpy(jtree), "cpu", tdtype)


def randn(seed: int, shape, dtype=np.float32) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def as_torch(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def as_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def init_pruned(config: ViTConfig, pcfg: PruneConfig, seed: int = 0) -> dict:
    from vit_pruning_tpu.models.pruned_vit import init_pruned_vit_params

    return init_pruned_vit_params(jax.random.PRNGKey(seed), config, pcfg)
