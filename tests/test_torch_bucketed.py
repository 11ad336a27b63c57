"""Kernel B3's plain version and the port's bucketed mask-mode layer against
the JAX package: fused_vit_layer_bucketed in interpret mode (as
tests/test_pallas.py runs it) and bucketed_masked_layer with
use_pallas=False, on kept and skipped rows; and the ragged-gather
equivalence of the mask mode (tests/test_pruning.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_pruning import ragged_reference
from torch_parity import as_numpy, as_torch, jax_and_torch_params, randn
from vit_pruning_tpu.configs import vit_tiny
from vit_pruning_tpu.models.pruned_vit import bucketed_masked_layer as jax_bucketed
from vit_pruning_tpu.models.vit import init_vit_params
from vit_pruning_tpu.ops.pallas.layer import fused_vit_layer_bucketed
from vit_pruning_tpu.ops.structured import prune_heads, prune_mlp_channels
from vit_pruning_tpu_torch.models import pruned_vit as tp
from vit_pruning_tpu_torch.ops.cuda import layer as tl
from vit_pruning_tpu_torch.ops.dispatch import kernel_mode
from vit_pruning_tpu_torch.ops.masking import compact_dest

F32_ATOL = 2e-5
BF16_ATOL = 2.0 ** -6  # one bf16 step at |y| < 4 (tests/test_torch_layer.py)


def _tiny(pruned: bool = False):
    cfg = vit_tiny()
    params = init_vit_params(jax.random.PRNGKey(0), cfg)
    if pruned:  # composed geometry: half the heads (KW < D), half the MLP
        params, cfg = prune_heads(params, cfg, [[0, 2]] * cfg.num_layers)
        params = prune_mlp_channels(params, [list(range(0, cfg.mlp_dim, 2))] * cfg.num_layers)
    return cfg, jax.tree.map(lambda a: a[0], params["layers"])


def _mask(b, s, p=0.5, seed=2):
    m = np.random.RandomState(seed).rand(b, s) > p
    m[:, 0] = True
    m[1, 1:] = False  # an image with only CLS kept
    return m


@pytest.mark.parametrize("pruned", [False, True], ids=["dense", "pruned"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b3_plain_matches_pallas_interpret(dtype, pruned):
    cfg, lp = _tiny(pruned)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                       torch.bfloat16)
    jlp, tlp = jax_and_torch_params(lp, jdt)
    b, s = 4, cfg.seq_len
    x = randn(1, (b, s, cfg.hidden_size))
    mask = _mask(b, s)
    dest = compact_dest(torch.from_numpy(mask))
    for cap in (int(mask.sum(-1).max()), int(mask.sum(-1).max()) + 3):  # + skipped rows
        got = as_numpy(tl.fused_vit_layer_bucketed_ref(
            as_torch(x, tdt), tlp, dest, torch.from_numpy(mask), cap, cfg.num_heads,
            cfg.layernorm_eps))
        want = fused_vit_layer_bucketed(
            jnp.asarray(x, jdt), jlp, jnp.asarray(dest.numpy(), jnp.int32), jnp.asarray(mask),
            cap, cfg.num_heads, eps=cfg.layernorm_eps, interpret=True)
        want = np.asarray(want.astype(jnp.float32))
        # skipped rows: x itself, exactly, in both
        xs = np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got[~mask], xs[~mask])
        np.testing.assert_array_equal(want[~mask], xs[~mask])
        atol = F32_ATOL if dtype == "float32" else BF16_ATOL
        np.testing.assert_allclose(got[mask], want[mask], atol=atol, rtol=0)


def _run_port(x, tlp, mask, cfg, cap_hint, passthrough, mode):
    with kernel_mode(mode):
        return tp.bucketed_masked_layer(as_torch(x), tlp, torch.from_numpy(mask), cfg,
                                        cap_hint=cap_hint,
                                        passthrough=None if passthrough is None
                                        else as_torch(passthrough))


@pytest.mark.parametrize("route", ["ladder", "cap_hint", "passthrough"])
@pytest.mark.parametrize("mode", ["auto", "eager"])
def test_bucketed_masked_layer_matches_jax(mode, route):
    """auto on the CPU: B3's plain version (cap_hint) or B1's (ladder);
    eager: the plain layer at the same capacity. Both equal JAX's ladder."""
    cfg, lp = _tiny()
    jlp, tlp = jax_and_torch_params(lp)
    b, s = 4, cfg.seq_len
    x = randn(3, (b, s, cfg.hidden_size))
    pas = randn(4, (b, s, cfg.hidden_size)) if route == "passthrough" else None
    for p in (0.5, 0.0):  # a short rung, and every token kept (the full-length rung)
        mask = _mask(b, s, p) if p else np.ones((b, s), bool)
        hint = None if route == "ladder" else int(mask.sum(-1).max()) + 1
        got = as_numpy(_run_port(x, tlp, mask, cfg, hint, pas, mode))
        want = np.asarray(jax_bucketed(
            jnp.asarray(x), jlp, jnp.asarray(mask), cfg, use_pallas=False, quant="none",
            cap_hint=hint, passthrough=None if pas is None else jnp.asarray(pas)))
        np.testing.assert_allclose(got[mask], want[mask], atol=F32_ATOL)
        np.testing.assert_array_equal(got[~mask], want[~mask])  # the passthrough, exactly


def test_bucket_caps_ladder():
    assert tp._bucket_caps(197) == (80, 104, 128, 152, 176, 197)
    assert tp._bucket_caps(17) == (16, 17)


@pytest.mark.parametrize("cap_hint", [False, True], ids=["ladder", "cap_hint"])
def test_mask_mode_matches_ragged_gather(cap_hint):
    cfg, lp = _tiny()
    jlp, tlp = jax_and_torch_params(lp)
    x = randn(5, (3, cfg.seq_len, cfg.hidden_size))
    keep = np.random.RandomState(0).rand(3, cfg.num_patches) > 0.4
    mask = np.concatenate([np.ones((3, 1), bool), keep], axis=1)
    ref = ragged_reference(x, jlp, mask, cfg)
    hint = int(mask.sum(-1).max()) if cap_hint else None
    got = as_numpy(_run_port(x, tlp, mask, cfg, hint, None, "auto"))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
