"""The port's dense ViT pieces (vit_pruning_tpu_torch/models/vit.py and ops/)
against the JAX package, in float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_numpy, as_torch, jax_and_torch_params, randn, to_numpy
from vit_pruning_tpu.configs import vit_tiny
from vit_pruning_tpu.models.vit import init_vit_params, vit_forward
from vit_pruning_tpu.ops.attention import mha as jax_mha
from vit_pruning_tpu.ops.structured import prune_heads
from vit_pruning_tpu_torch.models import vit as tv
from vit_pruning_tpu_torch.models.convert import params_from_jax, params_to_numpy
from vit_pruning_tpu_torch.ops.attention import mha
from vit_pruning_tpu_torch.ops.patch_embed import patch_embed


def _params():
    cfg = vit_tiny()
    return cfg, init_vit_params(jax.random.PRNGKey(0), cfg)


def test_params_round_trip_exact():
    _, params = _params()
    tree = to_numpy(params)
    back = params_to_numpy(params_from_jax(tree, "cpu"))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    for path, a in flat:
        b = back
        for key in path:
            b = b[key.key]
        assert b.dtype == a.dtype and b.shape == a.shape, path
        np.testing.assert_array_equal(b, a)


def test_patch_embed_matmul_equals_conv():
    cfg, params = _params()
    _, tp = jax_and_torch_params(params["embed"]["patch"])
    x = as_torch(randn(1, (3, 3, cfg.image_size, cfg.image_size)))
    a = patch_embed(x, tp, cfg.patch_size, impl="matmul")
    b = patch_embed(x, tp, cfg.patch_size, impl="conv")
    np.testing.assert_allclose(as_numpy(a), as_numpy(b), atol=1e-5)


def test_mha_with_mask_matches_jax():
    cfg, params = _params()
    attn = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    jattn, tattn = jax_and_torch_params(attn)
    x = randn(1, (4, 17, cfg.hidden_size))
    mask = np.random.RandomState(2).rand(4, 17) > 0.3
    mask[:, 0] = True
    got = mha(as_torch(x), tattn, cfg.num_heads, token_mask=torch.from_numpy(mask))
    want = jax_mha(jnp.asarray(x), jattn, cfg.num_heads, token_mask=jnp.asarray(mask))
    np.testing.assert_allclose(as_numpy(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("mode", ["auto", "eager"])
def test_vit_forward_matches_jax(mode):
    """'auto' on the CPU runs kernel B1's plain version, 'eager' the jnp-like
    layer; both match the JAX dense forward (f32, atol 1e-4)."""
    from vit_pruning_tpu_torch.ops.dispatch import kernel_mode

    cfg, params = _params()
    _, tp = jax_and_torch_params(params)
    x = randn(1, (2, 3, cfg.image_size, cfg.image_size))
    want = vit_forward(params, jnp.asarray(x), cfg, use_pallas=False, quant="none")
    with kernel_mode(mode):
        got = tv.vit_forward(tp, as_torch(x), cfg)
    for key in ("logits", "cls", "last_hidden"):
        np.testing.assert_allclose(as_numpy(got[key]), np.asarray(want[key]), atol=1e-4)


def test_vit_layer_rejects_q_width_mismatch():
    cfg, params = _params()
    pruned, pcfg = prune_heads(params, cfg, [[0, 1]] * cfg.num_layers)
    _, tp = jax_and_torch_params(jax.tree.map(lambda a: a[0], pruned["layers"]))
    x = torch.zeros(1, cfg.seq_len, cfg.hidden_size)
    with pytest.raises(ValueError, match="attention projection width"):
        tv.vit_layer(x, tp, cfg)  # pruned params under the unpruned config
    assert tv.vit_layer(x, tp, pcfg).shape == x.shape
