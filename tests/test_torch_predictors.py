"""Every predictor kind of the port (vit_pruning_tpu_torch/models/predictors.py)
against the JAX package's, on JAX-initialised weights carried over by the
bridge: scores and extras equal in float32 (atol 1e-5; key_cosine's dense
layer output within the layer tolerance 2e-5)."""

import jax
import numpy as np
import pytest
import torch

from torch_parity import as_numpy, as_torch, jax_and_torch_params, randn
from vit_pruning_tpu.configs import PREDICTOR_KINDS, PruneConfig, vit_tiny
from vit_pruning_tpu.models import predictors as jp
from vit_pruning_tpu.models.vit import init_vit_params
from vit_pruning_tpu_torch.models import predictors as tpred

KINDS = [k for k in PREDICTOR_KINDS if k != "none"]
ATOL = 1e-5


def _layer(params, i):
    return jax.tree.map(lambda a: a[i], params["layers"])


@pytest.mark.parametrize("kind", KINDS)
def test_predictor_matches_jax(kind):
    cfg = vit_tiny()
    pcfg = PruneConfig(mode="mask", predictor=kind)
    jpred, tpred_params = jax_and_torch_params(
        jp.init_predictor_params(jax.random.PRNGKey(1), cfg, pcfg))
    vit = init_vit_params(jax.random.PRNGKey(0), cfg)
    x = randn(2, (3, cfg.seq_len, cfg.hidden_size))
    for i in (0, cfg.num_layers - 1):
        jlp, tlp = jax_and_torch_params(_layer(vit, i))
        want, wextras = jp.apply_predictor(jpred, i, jax.numpy.asarray(x), cfg, pcfg,
                                           layer_params=jlp)
        got, gextras = tpred.apply_predictor(tpred_params, i, as_torch(x), cfg, pcfg,
                                             layer_params=tlp)
        assert got.shape == (3, cfg.num_patches)
        np.testing.assert_allclose(as_numpy(got), np.asarray(want), atol=ATOL)
        assert set(gextras) == set(wextras)
        for key in wextras:
            tol = 2e-5 if key == "dense_out" else ATOL
            np.testing.assert_allclose(as_numpy(gextras[key]), np.asarray(wextras[key]), atol=tol)


@pytest.mark.parametrize("kind", KINDS)
def test_port_init_has_the_jax_layout(kind):
    """The port's own init builds the same tree of shapes as the JAX one."""
    cfg = vit_tiny()
    pcfg = PruneConfig(mode="mask", predictor=kind)
    want = jax.tree.map(lambda a: a.shape, jp.init_predictor_params(jax.random.PRNGKey(0),
                                                                       cfg, pcfg))
    got = tpred.init_predictor_params(cfg, pcfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), got) == want


def test_updatenet_matches_jax():
    cfg = vit_tiny()
    jun, tun = jax_and_torch_params(jp.init_updatenet_params(jax.random.PRNGKey(4), cfg))
    x = randn(5, (2, cfg.seq_len, cfg.hidden_size))
    for i in range(cfg.num_layers):
        got = tpred.apply_updatenet(tun, i, as_torch(x))
        want = jp.apply_updatenet(jun, i, jax.numpy.asarray(x))
        np.testing.assert_allclose(as_numpy(got), np.asarray(want), atol=ATOL)
    port = tpred.init_updatenet_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), port) == jax.tree.map(lambda a: a.shape, jun)
