"""Kernel B5 (ops/cuda/model.py) against the JAX package on the CPU: its
plain version against the Pallas whole-encoder kernel in interpret mode,
and the rule that picks the route.

f32: atol 1e-4 on the rows of valid tokens (masked rows are garbage by
contract), as the port's other layer kernels; the sums run in another order
and the Pallas erf is a polynomial within 1.5e-7 of the true erf the port
uses. bf16: one bf16 step at the output's magnitude: both round QKV, P,
ctx and the GELU output to bf16 at the same points and the output once.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_pruning_tpu.configs as jax_configs
from torch_parity import as_numpy, as_torch, jax_and_torch_params, randn
from vit_pruning_tpu.models.vit import init_vit_params
from vit_pruning_tpu.ops.pallas.model import encoder_weights_fit as jax_encoder_weights_fit
from vit_pruning_tpu.ops.pallas.model import fused_vit_encoder as jax_fused_vit_encoder
from vit_pruning_tpu_torch import configs as port_configs
from vit_pruning_tpu_torch.models.vit import layer_range
from vit_pruning_tpu_torch.ops.cuda import model as tmod
from vit_pruning_tpu_torch.ops.dispatch import kernel_mode

CONFIGS = ["vit_tiny", "deit_tiny", "deit_small", "deit_base", "vit_base_patch16_224",
           "vit_large", "vit_huge"]


def bf16_step(ref: np.ndarray) -> float:
    return 2.0 ** (math.floor(math.log2(max(float(np.abs(ref).max()), 1e-30))) - 7)


def _layers(seed: int = 0):
    """vit_tiny's stacked layers with random LN gains and biases (the init
    leaves them 1 and 0, which would hide a gain or bias bug)."""
    cfg = jax_configs.vit_tiny()
    layers = init_vit_params(jax.random.PRNGKey(seed), cfg)["layers"]
    leaves, tree = jax.tree_util.tree_flatten(layers)
    rs = np.random.RandomState(seed + 10)
    leaves = [a + 0.1 * rs.randn(*a.shape).astype(np.float32) if a.ndim == 2 else a
              for a in leaves]
    return cfg, jax.tree_util.tree_unflatten(tree, leaves)


@pytest.mark.parametrize("span", ["all", "segment"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_vit_encoder_ref_matches_pallas(span, masked, dtype):
    cfg, layers = _layers()
    l0, l1 = (0, cfg.num_layers) if span == "all" else (1, 3)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jl, tl = jax_and_torch_params(jax.tree.map(lambda a: a[l0:l1], layers), jdt)
    x = randn(1, (2, 17, cfg.hidden_size))
    mask = np.random.RandomState(2).rand(2, 17) > 0.3
    mask[:, 0] = True
    want = np.asarray(jax_fused_vit_encoder(
        jnp.asarray(x).astype(jdt), jl, cfg.num_heads, eps=cfg.layernorm_eps,
        token_mask=jnp.asarray(mask) if masked else None, interpret=True).astype(jnp.float32))
    got = as_numpy(tmod.fused_vit_encoder_ref(
        as_torch(x, torch.bfloat16 if dtype == "bfloat16" else torch.float32), tl,
        cfg.num_heads, cfg.layernorm_eps, torch.from_numpy(mask) if masked else None))
    rows = mask[..., None] if masked else np.ones_like(mask)[..., None]
    err = (np.abs(got - want) * rows).max()
    assert err <= (1e-4 if dtype == "float32" else bf16_step(want)), err


def test_fused_vit_encoder_ref_runs_a_layer_range():
    """A slice [l0:l1] of the stacked tree runs exactly those layers."""
    cfg, layers = _layers(1)
    _, tl = jax_and_torch_params(layers)
    x = as_torch(randn(3, (2, 17, cfg.hidden_size)))
    y = tmod.fused_vit_encoder_ref(x, layer_range(tl, 0, 1), cfg.num_heads)
    y = tmod.fused_vit_encoder_ref(y, layer_range(tl, 1, 3), cfg.num_heads)
    torch.testing.assert_close(y, tmod.fused_vit_encoder_ref(x, tl, cfg.num_heads),
                               atol=1e-5, rtol=1e-5)


def test_fused_vit_encoder_on_cpu_runs_plain_version_without_launching():
    cfg, layers = _layers(2)
    _, tl = jax_and_torch_params(layers)
    x = as_torch(randn(4, (2, 17, cfg.hidden_size)))
    before = tmod.fused_vit_encoder.launches
    torch.testing.assert_close(tmod.fused_vit_encoder(x, tl, cfg.num_heads),
                               tmod.fused_vit_encoder_ref(x, tl, cfg.num_heads), rtol=0, atol=0)
    assert tmod.fused_vit_encoder.launches == before
    with kernel_mode("kernel"):
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tmod.fused_vit_encoder(x, tl, cfg.num_heads)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("name", CONFIGS)
def test_encoder_weights_fit_equals_jax(name, itemsize):
    """The same configs take the whole-encoder route in both packages."""
    c = getattr(port_configs, name)()
    assert getattr(jax_configs, name)().to_json() == c.to_json()
    assert tmod.encoder_weights_fit(c.num_layers, c.hidden_size, c.mlp_dim, itemsize) == \
        jax_encoder_weights_fit(c.num_layers, c.hidden_size, c.mlp_dim, itemsize)


def test_encoder_weights_fit_routes_deit_s_and_not_vit_b():
    for itemsize in (2, 4):
        c = port_configs.deit_small()
        assert tmod.encoder_weights_fit(c.num_layers, c.hidden_size, c.mlp_dim, itemsize)
    c = port_configs.deit_base()
    assert not tmod.encoder_weights_fit(c.num_layers, c.hidden_size, c.mlp_dim, 2)
