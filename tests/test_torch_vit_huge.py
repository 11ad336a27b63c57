"""The port at ViT-H/14's geometry (head dim 80, sequence 257, patch 14)
against the JAX package, float32 (and bf16 where stated) on the CPU.

The layer kernels B1-B4 take hd 80 and S 257 on the card; here their plain
versions are held to the Pallas kernels in interpret mode at that geometry,
and the entry points to the JAX package's forwards. A narrow ViT-H-shaped
config keeps the file fast: image 224, patch 14 (256 patches + CLS), two
heads of 80 (D 160), MLP 320, three layers. Two cases run at ViT-H's full
width, at the exact geometries tests/test_pallas.py pins for its kernels
(:456-474, B1 at S 33; :316-344, B2 at batch 16, S 9).

Tolerances: tests/test_pallas.py's per kernel (f32 atol 2e-5; B2 at full
width 5e-5 + rtol 1e-3; B3 5e-5 + rtol 1e-4), tests/test_torch_quant.py's
for B4 (1e-4), and 1e-4 + rtol 1e-4 on the logits end to end with the keep
masks exact (no score within 1e-6 of a cut, asserted). bf16: two bf16 steps
at the output's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_numpy, as_torch, init_pruned, jax_and_torch_params, randn, to_numpy
from vit_pruning_tpu.configs import PruneConfig, composed_schedule, vit_huge
from vit_pruning_tpu.models.pruned_vit import progressive_topk_forward, pruned_vit_forward
from vit_pruning_tpu.models.vit import init_vit_params, layer_norm, vit_forward, vit_layer
from vit_pruning_tpu.ops import quant as jq
from vit_pruning_tpu.ops.pallas.layer import (
    fused_vit_layer,
    fused_vit_layer_bucketed,
    fused_vit_layer_cls_logits,
)
from vit_pruning_tpu.ops.pallas.layer_int8 import fused_vit_layer_int8
from vit_pruning_tpu.ops.structured import prune_heads, prune_mlp_channels
from vit_pruning_tpu.serving import serving_forward
from vit_pruning_tpu_torch.models import pruned_vit as tp
from vit_pruning_tpu_torch.models import vit as tv
from vit_pruning_tpu_torch.models.convert import params_from_jax, params_to_numpy
from vit_pruning_tpu_torch.ops import quant as tq
from vit_pruning_tpu_torch.ops.cuda import layer as tl
from vit_pruning_tpu_torch.ops.cuda import layer_int8 as tl8
from vit_pruning_tpu_torch.ops.masking import compact_dest
from vit_pruning_tpu_torch.serving import serving_forward as t_serving_forward

F32_ATOL = 2e-5
INT8_ATOL = 1e-4
E2E_ATOL = 1e-4
MIN_GAP = 1e-6
PREDICTOR_GAIN = 30.0
CFG = vit_huge(num_labels=10).replace(hidden_size=160, num_heads=2, mlp_dim=320, num_layers=3)
S = CFG.seq_len  # 257


def test_narrow_config_keeps_vit_h_geometry():
    assert (CFG.head_dim, CFG.seq_len, CFG.patch_dim, CFG.num_patches) == (80, 257, 588, 256)


def _bf16_tol(ref: np.ndarray) -> float:
    return 2.0 * 2.0 ** (np.floor(np.log2(max(float(np.abs(ref).max()), 1e-30))) - 7)


def _layer(cfg=CFG, i=0):
    """Layer i with random LN gains / biases and linear biases (the init
    leaves them 1 and 0, which would hide a bias bug)."""
    params = init_vit_params(jax.random.PRNGKey(0), cfg)
    lp = jax.tree.map(lambda a: a[i], params["layers"])
    rs = np.random.RandomState(7)
    for path in (("ln1", "g"), ("ln1", "b"), ("ln2", "g"), ("ln2", "b"), ("attn", "q", "b"),
                 ("attn", "k", "b"), ("attn", "v", "b"), ("attn", "o", "b"), ("mlp", "fc1", "b"),
                 ("mlp", "fc2", "b")):
        node = lp
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = node[path[-1]] + 0.1 * rs.randn(*node[path[-1]].shape).astype(np.float32)
    return lp, params


def _mask(b, s, seed=2):
    m = np.random.RandomState(seed).rand(b, s) > 0.3
    m[:, 0] = True
    return m


def _torch_mask(m):
    return None if m is None else torch.from_numpy(m)


# --- the layer kernels' plain versions against the Pallas kernels ----------------------

@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_b1_plain_matches_pallas_at_s257(masked):
    lp, _ = _layer()
    jlp, tlp = jax_and_torch_params(lp)
    x = randn(1, (2, S, CFG.hidden_size))
    mask = _mask(2, S) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    got = as_numpy(tl.fused_vit_layer_ref(as_torch(x), tlp, CFG.num_heads, CFG.layernorm_eps,
                                          _torch_mask(mask)))
    kernel = fused_vit_layer(jnp.asarray(x), jlp, CFG.num_heads, eps=CFG.layernorm_eps,
                             token_mask=jmask, interpret=True)
    ref = vit_layer(jnp.asarray(x), jlp, CFG, token_mask=jmask, use_pallas=False, quant="none")
    rows = np.ones((2, S), bool) if mask is None else mask  # masked rows are don't-care
    for want in (kernel, ref):
        assert np.abs(got - np.asarray(want))[rows].max() < F32_ATOL


def test_b1_plain_matches_pallas_at_s257_bf16():
    lp, _ = _layer()
    jlp, tlp = jax_and_torch_params(lp, jnp.bfloat16)
    x = randn(1, (2, S, CFG.hidden_size))
    mask = _mask(2, S)
    got = as_numpy(tl.fused_vit_layer_ref(as_torch(x, torch.bfloat16), tlp, CFG.num_heads,
                                          CFG.layernorm_eps, torch.from_numpy(mask)))
    want = fused_vit_layer(jnp.asarray(x, jnp.bfloat16), jlp, CFG.num_heads,
                           eps=CFG.layernorm_eps, token_mask=jnp.asarray(mask), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got - want)[mask].max() <= _bf16_tol(want)


def test_b1_plain_at_full_vit_h_width():
    """tests/test_pallas.py::test_staged2_at_vit_huge_head_dim's geometry:
    D 1280, 16 heads of 80, MLP 5120, x [2, 33, 1280]."""
    cfg = vit_huge(num_labels=100).replace(num_layers=1)
    params = init_vit_params(jax.random.PRNGKey(0), cfg)
    jlp, tlp = jax_and_torch_params(jax.tree.map(lambda a: a[0], params["layers"]))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 33, cfg.hidden_size)))
    got = as_numpy(tl.fused_vit_layer_ref(as_torch(x), tlp, cfg.num_heads, cfg.layernorm_eps))
    kernel = fused_vit_layer(jnp.asarray(x), jlp, cfg.num_heads, eps=cfg.layernorm_eps,
                             interpret=True, attn_impl="staged2")
    ref = vit_layer(jnp.asarray(x), jlp, cfg, use_pallas=False, quant="none")
    for want in (kernel, ref):
        assert np.abs(got - np.asarray(want)).max() < F32_ATOL


def test_b2_plain_at_full_vit_h_width():
    """tests/test_pallas.py::test_fused_cls_logits_wide_model_block_promotion's
    geometry: D 1280, batch 16, S 9, 10 labels."""
    cfg = vit_huge(num_labels=10).replace(num_layers=1)
    params = init_vit_params(jax.random.PRNGKey(0), cfg)
    lp = jax.tree.map(lambda a: a[-1], params["layers"])
    jlp, tlp = jax_and_torch_params(lp)
    _, tf = jax_and_torch_params({"ln_f": params["ln_f"], "head": params["head"]})
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (16, 9, cfg.hidden_size)))
    got = as_numpy(tl.fused_vit_layer_cls_logits_ref(as_torch(x), tlp, tf["ln_f"], tf["head"],
                                                     cfg.num_heads, cfg.layernorm_eps))
    kernel = fused_vit_layer_cls_logits(jnp.asarray(x), jlp, params["ln_f"], params["head"],
                                        cfg.num_heads, eps=cfg.layernorm_eps, interpret=True)
    y = vit_layer(jnp.asarray(x), jlp, cfg, use_pallas=False, quant="none")
    ref = layer_norm(y, params["ln_f"], cfg.layernorm_eps)[:, 0] @ params["head"]["w"] \
        + params["head"]["b"]
    for want in (kernel, ref):
        np.testing.assert_allclose(got, np.asarray(want), atol=5e-5, rtol=1e-3)


def test_b2_plain_matches_pallas_at_s129():
    lp, params = _layer(i=-1)
    jlp, tlp = jax_and_torch_params(lp)
    jf, tf = jax_and_torch_params({"ln_f": params["ln_f"], "head": params["head"]})
    x = randn(3, (2, 129, CFG.hidden_size))
    got = as_numpy(tl.fused_vit_layer_cls_logits_ref(as_torch(x), tlp, tf["ln_f"], tf["head"],
                                                     CFG.num_heads, CFG.layernorm_eps))
    want = fused_vit_layer_cls_logits(jnp.asarray(x), jlp, jf["ln_f"], jf["head"], CFG.num_heads,
                                      eps=CFG.layernorm_eps, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL, rtol=1e-4)


def test_b3_plain_at_s257_cap129_keeps_the_last_token():
    """Capacity 129 of 257 (topk50 at ViT-H), with token 256 kept in every
    image: the inversion must see the sequence's last token."""
    lp, _ = _layer()
    jlp, tlp = jax_and_torch_params(lp)
    b, cap = 3, 129
    x = randn(4, (b, S, CFG.hidden_size))
    rs = np.random.RandomState(5)
    kept = np.zeros((b, S), bool)
    kept[:, 0] = kept[:, -1] = True
    for i, count in enumerate((cap, 60, 2)):  # a full bucket, a partial one, CLS + the last
        kept[i, 1 + rs.permutation(S - 2)[:count - 2]] = True
    dest = compact_dest(torch.from_numpy(kept))
    got = tl.fused_vit_layer_bucketed_ref(as_torch(x), tlp, dest, torch.from_numpy(kept), cap,
                                          CFG.num_heads, CFG.layernorm_eps)
    want = np.asarray(fused_vit_layer_bucketed(
        jnp.asarray(x), jlp, jnp.asarray(dest.numpy()), jnp.asarray(kept), cap, CFG.num_heads,
        eps=CFG.layernorm_eps, interpret=True))
    np.testing.assert_allclose(as_numpy(got), want, atol=5e-5, rtol=1e-4)
    assert np.abs(as_numpy(got)[:, -1] - x[:, -1]).min() > 0  # the last token went through
    np.testing.assert_array_equal(as_numpy(got)[~kept], x[~kept])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_b4_plain_matches_pallas_int8_at_s257(masked, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    lp, _ = _layer()
    jlp, tlp = jax_and_torch_params(lp, jdt)
    jqp, tqp = jq.quantize_layer_params(jlp), tq.quantize_layer_params(tlp)
    x = randn(1, (2, S, CFG.hidden_size))
    mask = _mask(2, S) if masked else None
    got = tl8.fused_vit_layer_int8_ref(as_torch(x, tdt), tqp, CFG.num_heads, CFG.layernorm_eps,
                                       _torch_mask(mask))
    want = fused_vit_layer_int8(jnp.asarray(x, jdt), jqp, CFG.num_heads, eps=CFG.layernorm_eps,
                                token_mask=None if mask is None else jnp.asarray(mask),
                                interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    rows = np.ones((2, S), bool) if mask is None else mask
    tol = INT8_ATOL if dtype == "float32" else _bf16_tol(want)
    assert np.abs(as_numpy(got) - want)[rows].max() <= tol


def test_bridge_carries_a_vit_h_embed_tree_unchanged():
    """The embed subtree at patch 14 (w [588, D]) crosses the weight bridge
    bit for bit, in both directions."""
    params = init_vit_params(jax.random.PRNGKey(0), CFG)
    tree = to_numpy(params["embed"])
    got = params_from_jax(tree, "cpu")
    assert tuple(got["patch"]["w"].shape) == (588, CFG.hidden_size)
    assert tuple(got["pos"].shape) == (1, S, CFG.hidden_size)
    back = params_to_numpy(got)
    for key in ("cls", "pos"):
        np.testing.assert_array_equal(back[key], tree[key])
    for key in ("w", "b"):
        np.testing.assert_array_equal(back["patch"][key], tree["patch"][key])


# --- end to end against the JAX package ------------------------------------------------

def _pruned_params(pcfg, structured: bool):
    params = init_pruned(CFG, pcfg)
    params["predictor"] = jax.tree.map(lambda a: a * PREDICTOR_GAIN, params["predictor"])
    cfg = CFG
    if structured:  # composed geometry: one head of 80 (KW 80 < D), half the MLP
        bb, cfg = prune_heads(params["backbone"], CFG, [[1]] * CFG.num_layers)
        params["backbone"] = prune_mlp_channels(bb, [list(range(0, CFG.mlp_dim, 2))]
                                                * CFG.num_layers)
    jparams, tparams = jax_and_torch_params(params)
    return cfg, jparams, tparams


def _rank_gap(scores: np.ndarray, k: int) -> float:
    live = np.isfinite(scores)
    srt = -np.sort(-np.where(live, scores, -np.inf), axis=-1)
    return float((srt[:, k - 1] - srt[:, k]).min())


def _schedule_cuts(schedule, n: int):
    """(layer, k) of every entry of a progressive schedule that drops
    patches: k below the patches still live."""
    cuts, live = [], n
    for i, k in enumerate(schedule):
        if k and k < live:
            cuts.append((i, k))
            live = k
    return cuts


def _assert_same(got: dict, want: dict, cuts):
    """cuts: (layer, k) of every rank cut; none may be a near tie."""
    scores = np.asarray(want["scores"])
    for i, k in cuts:
        assert _rank_gap(scores[i], k) > MIN_GAP, (i, k)
    np.testing.assert_array_equal(got["keep_masks"].numpy(), np.asarray(want["keep_masks"]))
    np.testing.assert_allclose(as_numpy(got["logits"]), np.asarray(want["logits"]),
                               atol=E2E_ATOL, rtol=1e-4)


def test_vit_forward_matches_jax():
    params = init_vit_params(jax.random.PRNGKey(0), CFG)
    _, tparams = jax_and_torch_params(params)
    x = randn(1, (2, 3, CFG.image_size, CFG.image_size))
    want = vit_forward(params, jnp.asarray(x), CFG, use_pallas=False, quant="none")
    got = tv.vit_forward(tparams, as_torch(x), CFG)
    assert got["last_hidden"].shape == (2, S, CFG.hidden_size)
    for key in ("logits", "cls", "last_hidden"):
        np.testing.assert_allclose(as_numpy(got[key]), np.asarray(want[key]), atol=E2E_ATOL)


@pytest.mark.parametrize("preset", ["headline", "composed"])
def test_serving_forward_matches_jax(preset):
    n, L = CFG.num_patches, CFG.num_layers
    schedule = (n // 2,) + (0,) * (L - 1) if preset == "headline" else composed_schedule(n, L)
    pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention",
                       top_k=schedule[0], keep_schedule=schedule)
    cfg, jparams, tparams = _pruned_params(pcfg, structured=preset == "composed")
    u8 = np.random.RandomState(1).randint(0, 256, (2, 3, CFG.image_size, CFG.image_size),
                                          dtype=np.uint8)
    want = serving_forward(jparams, jnp.asarray(u8), cfg, pcfg, use_pallas=False, quant="none")
    got = t_serving_forward(tparams, torch.from_numpy(u8), cfg, pcfg)
    cuts = _schedule_cuts(schedule, n)
    assert len(cuts) == (1 if preset == "headline" else 2)
    _assert_same(got, want, cuts)
    # the same forward on float pixels, the progressive entry
    x = randn(2, (2, 3, CFG.image_size, CFG.image_size))
    want = progressive_topk_forward(jparams, jnp.asarray(x), cfg, pcfg, use_pallas=False,
                                    quant="none", logits_only=True)
    got = tp.progressive_topk_forward(tparams, as_torch(x), cfg, pcfg, logits_only=True)
    _assert_same(got, want, cuts)


def test_pruned_vit_forward_topk_matches_jax():
    pcfg = PruneConfig(mode="topk", predictor="cls_mlp", top_k=CFG.num_patches // 2)
    cfg, jparams, tparams = _pruned_params(pcfg, structured=False)
    x = randn(1, (2, 3, CFG.image_size, CFG.image_size))
    want = pruned_vit_forward(jparams, jnp.asarray(x), cfg, pcfg, use_pallas=False, quant="none")
    got = tp.pruned_vit_forward(tparams, as_torch(x), cfg, pcfg)
    _assert_same(got, want, [(i, pcfg.top_k) for i in range(CFG.num_layers)])
    np.testing.assert_allclose(as_numpy(got["scores"]), np.asarray(want["scores"]), atol=1e-5)
