"""The port's serving path (selection, progressive top-k forward, uint8
serving entry) against the JAX package with use_pallas=False, float32, CPU.

Three configurations on vit_tiny mirror the bench's: a headline-like single
drop, and composed- and ultra-like schedules on a head- and channel-pruned
backbone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_numpy, as_torch, init_pruned, jax_and_torch_params, randn
from vit_pruning_tpu.configs import PruneConfig, composed_schedule, ultra_schedule, vit_tiny
from vit_pruning_tpu.models.pruned_vit import progressive_topk_forward
from vit_pruning_tpu.ops.masking import rank_keep_mask as jax_rank_keep_mask
from vit_pruning_tpu.ops.structured import prune_heads, prune_mlp_channels
from vit_pruning_tpu.serving import serving_forward
from vit_pruning_tpu_torch.models import pruned_vit as tp
from vit_pruning_tpu_torch.ops.masking import rank_keep_mask
from vit_pruning_tpu_torch.serving import serving_forward as t_serving_forward

# the predictor's random init (std 0.02) puts every score within ~1e-3 of
# 0.5; scaling its weights spreads the scores so that the top-k cut is not a
# near tie (asserted below), in both packages alike
PREDICTOR_GAIN = 30.0
MIN_CUT_GAP = 1e-6


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_rank_keep_mask_equals_jax(ties):
    rs = np.random.RandomState(3)
    scores = rs.randint(0, 5, (6, 40)).astype(np.float32) if ties else rs.rand(6, 40).astype(np.float32)
    for k in (1, 7, 20, 39):
        got = rank_keep_mask(torch.from_numpy(scores), k).numpy()
        want = np.asarray(jax_rank_keep_mask(jnp.asarray(scores), k))
        np.testing.assert_array_equal(got, want)
        assert (got.sum(-1) == k).all()


def _setup(preset: str):
    cfg = vit_tiny()
    n, L = cfg.num_patches, cfg.num_layers
    schedule = {"headline": (8, 0, 0), "composed": composed_schedule(n, L),
                "ultra": ultra_schedule(n, L)}[preset]
    pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention",
                       top_k=schedule[0], keep_schedule=schedule)
    params = init_pruned(cfg, pcfg)
    params["predictor"] = jax.tree.map(lambda a: a * PREDICTOR_GAIN, params["predictor"])
    if preset != "headline":
        bb, cfg = prune_heads(params["backbone"], cfg, [[0, 2]] * L)
        params["backbone"] = prune_mlp_channels(bb, [list(range(0, cfg.mlp_dim, 2))] * L)
    jparams, tparams = jax_and_torch_params(params)
    return cfg, pcfg, jparams, tparams


def _assert_same(got: dict, want: dict, schedule):
    jmasks = np.asarray(want["keep_masks"])
    jscores = np.asarray(want["scores"])
    # a near tie at a cut would flip on rounding noise: make sure there is none
    for i, k in enumerate(schedule):
        live = np.isfinite(jscores[i])
        if not k or not live.any():
            continue
        srt = -np.sort(-np.where(live, jscores[i], -np.inf), axis=-1)
        gap = srt[:, k - 1] - srt[:, k]
        assert gap.min() > MIN_CUT_GAP, (i, gap.min())
    np.testing.assert_array_equal(got["keep_masks"].numpy(), jmasks)
    np.testing.assert_allclose(as_numpy(got["scores"]), jscores, atol=1e-5)
    np.testing.assert_allclose(as_numpy(got["logits"]), np.asarray(want["logits"]),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("preset", ["headline", "composed", "ultra"])
@pytest.mark.parametrize("entry", ["progressive", "serving_u8"])
def test_serving_path_matches_jax(entry, preset):
    cfg, pcfg, jparams, tparams = _setup(preset)
    if entry == "progressive":
        x = randn(1, (4, 3, cfg.image_size, cfg.image_size))
        want = progressive_topk_forward(jparams, jnp.asarray(x), cfg, pcfg, use_pallas=False,
                                        quant="none", logits_only=True)
        got = tp.progressive_topk_forward(tparams, as_torch(x), cfg, pcfg, logits_only=True)
    else:
        u8 = np.random.RandomState(1).randint(0, 256, (4, 3, cfg.image_size, cfg.image_size),
                                              dtype=np.uint8)
        want = serving_forward(jparams, jnp.asarray(u8), cfg, pcfg, use_pallas=False,
                               quant="none")
        got = t_serving_forward(tparams, torch.from_numpy(u8), cfg, pcfg)
    assert set(got) == {"logits", "keep_masks", "scores"}
    _assert_same(got, want, pcfg.keep_schedule)


def test_progressive_full_output_matches_jax():
    """logits_only=False keeps cls and the compacted last_hidden."""
    cfg, pcfg, jparams, tparams = _setup("composed")
    x = randn(1, (4, 3, cfg.image_size, cfg.image_size))
    want = progressive_topk_forward(jparams, jnp.asarray(x), cfg, pcfg, use_pallas=False,
                                    quant="none")
    got = tp.progressive_topk_forward(tparams, as_torch(x), cfg, pcfg)
    _assert_same(got, want, pcfg.keep_schedule)
    for key in ("cls", "last_hidden"):
        np.testing.assert_allclose(as_numpy(got[key]), np.asarray(want[key]), atol=1e-4)


def test_serving_forward_rejects_float_pixels():
    cfg, pcfg, _, tparams = _setup("headline")
    with pytest.raises(ValueError, match="uint8"):
        t_serving_forward(tparams, torch.zeros(1, 3, cfg.image_size, cfg.image_size), cfg, pcfg)


def test_keep_projection_rows_in_token_order():
    scores = torch.tensor([[0.1, 0.9, 0.5, 0.9, 0.2]])
    mask, cidx = tp._keep_projection(scores, 3)
    assert mask.tolist() == [[True, False, True, True, True, False]]
    assert cidx.tolist() == [[0, 2, 3, 4]]  # CLS, then kept patches (+1) in order
