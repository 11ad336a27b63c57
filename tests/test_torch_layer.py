"""Plain versions of kernels B1 and B2 (vit_pruning_tpu_torch/ops/cuda/layer.py)
against the JAX package's Pallas kernels in interpret mode and its jnp layer.

The CUDA kernels themselves run only on a GPU; chip_smoke.py compares them
with these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_numpy, as_torch, jax_and_torch_params, randn
from vit_pruning_tpu.configs import vit_tiny
from vit_pruning_tpu.models.vit import init_vit_params, layer_norm, vit_layer
from vit_pruning_tpu.ops.pallas.layer import fused_vit_layer, fused_vit_layer_cls_logits
from vit_pruning_tpu.ops.structured import prune_heads, prune_mlp_channels
from vit_pruning_tpu_torch.ops.cuda import layer as tl

# f32 tolerances as tests/test_pallas.py holds the Pallas kernels to the jnp
# layer (:155, :312). bf16: both sides round to bf16 at the same places, but
# their f32 sums run in another order, so an output may land on the
# neighbouring bf16 value: one bf16 step at the outputs' scale (|y| < 4,
# step 2^-6).
F32_ATOL = 2e-5
BF16_ATOL, BF16_RTOL = 2.0 ** -6, 0.0


def _tiny(pruned: bool = False):
    cfg = vit_tiny()
    params = init_vit_params(jax.random.PRNGKey(0), cfg)
    if pruned:  # composed geometry: half the heads (KW < D), half the MLP
        params, cfg = prune_heads(params, cfg, [[0, 2]] * cfg.num_layers)
        params = prune_mlp_channels(params, [list(range(0, cfg.mlp_dim, 2))] * cfg.num_layers)
    return cfg, params


def _layer(params, i):
    return jax.tree.map(lambda a: a[i], params["layers"])


def _mask(b, s, seed=2):
    m = np.random.RandomState(seed).rand(b, s) > 0.3
    m[:, 0] = True
    return m


@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "pruned"])
@pytest.mark.parametrize("s", [17, 11])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_b1_plain_matches_jax_f32(masked, s, pruned):
    cfg, params = _tiny(pruned)
    jlp, tlp = jax_and_torch_params(_layer(params, 0))
    x = randn(1, (4, s, cfg.hidden_size))
    mask = _mask(4, s) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)

    got = as_numpy(tl.fused_vit_layer_ref(as_torch(x), tlp, cfg.num_heads,
                                          cfg.layernorm_eps, tmask))
    kernel = np.asarray(fused_vit_layer(jnp.asarray(x), jlp, cfg.num_heads,
                                        eps=cfg.layernorm_eps, token_mask=jmask,
                                        interpret=True))
    ref = np.asarray(vit_layer(jnp.asarray(x), jlp, cfg, token_mask=jmask,
                               use_pallas=False, quant="none"))
    rows = np.ones((4, s), bool) if mask is None else mask  # masked rows are don't-care
    for want in (kernel, ref):
        err = np.abs(got - want)[rows]
        assert err.max() < F32_ATOL, err.max()


def test_b2_plain_matches_jax_f32():
    cfg, params = _tiny()
    jlp, tlp = jax_and_torch_params(_layer(params, -1))
    _, tf = jax_and_torch_params({"ln_f": params["ln_f"], "head": params["head"]})
    x = randn(1, (4, 11, cfg.hidden_size))  # odd S: a compacted serving shape

    got = as_numpy(tl.fused_vit_layer_cls_logits_ref(
        as_torch(x), tlp, tf["ln_f"], tf["head"], cfg.num_heads, cfg.layernorm_eps))
    kernel = fused_vit_layer_cls_logits(jnp.asarray(x), jlp, params["ln_f"], params["head"],
                                        cfg.num_heads, eps=cfg.layernorm_eps, interpret=True)
    y = vit_layer(jnp.asarray(x), jlp, cfg, use_pallas=False, quant="none")
    ref = layer_norm(y, params["ln_f"], cfg.layernorm_eps)[:, 0] @ params["head"]["w"] \
        + params["head"]["b"]
    for want in (kernel, ref):
        np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL, rtol=1e-4)


def test_b1_plain_matches_jax_bf16():
    """bf16 pins the tanh-GELU rule and the bf16 roundings of staged2."""
    cfg, params = _tiny()
    jlp, tlp = jax_and_torch_params(_layer(params, 0), jnp.bfloat16)
    x = randn(1, (4, 17, cfg.hidden_size))
    mask = _mask(4, 17)
    got = as_numpy(tl.fused_vit_layer_ref(as_torch(x, torch.bfloat16), tlp, cfg.num_heads,
                                          cfg.layernorm_eps, torch.from_numpy(mask)))
    want = fused_vit_layer(jnp.asarray(x, jnp.bfloat16), jlp, cfg.num_heads,
                           eps=cfg.layernorm_eps, token_mask=jnp.asarray(mask), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got[mask], want[mask], atol=BF16_ATOL, rtol=BF16_RTOL)


def test_b2_plain_matches_jax_bf16():
    cfg, params = _tiny()
    jlp, tlp = jax_and_torch_params(_layer(params, -1), jnp.bfloat16)
    jf, tf = jax_and_torch_params({"ln_f": params["ln_f"], "head": params["head"]}, jnp.bfloat16)
    x = randn(1, (4, 11, cfg.hidden_size))
    got = as_numpy(tl.fused_vit_layer_cls_logits_ref(
        as_torch(x, torch.bfloat16), tlp, tf["ln_f"], tf["head"], cfg.num_heads,
        cfg.layernorm_eps))
    want = fused_vit_layer_cls_logits(jnp.asarray(x, jnp.bfloat16), jlp, jf["ln_f"], jf["head"],
                                      cfg.num_heads, eps=cfg.layernorm_eps, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want.astype(jnp.float32)),
                               atol=BF16_ATOL, rtol=BF16_RTOL)


def test_b1_gelu_rule_follows_dtype():
    """The tanh GELU is what makes the bf16 plain version agree with the TPU
    kernel: with erf in its place the f32 path would be untouched and the
    bf16 one would move (guards against a silent swap of the rule)."""
    erf, tanh = tl._gelu_for(torch.float32), tl._gelu_for(torch.bfloat16)
    t = torch.linspace(-4, 4, 101)
    diff = (erf(t) - tanh(t)).abs().max().item()
    assert 1e-5 < diff < 1e-3
