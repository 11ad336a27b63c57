"""int8 serving through every entry point of the port (vit_forward,
progressive_topk_forward, serving_forward, pruned_vit_forward) against the
JAX package with use_pallas=False, quant='int8', float32 on the CPU: keep
masks exact, logits atol 1e-4 + rtol 1e-4 (the port in kernel mode 'eager',
the counterpart of the JAX package's jnp route).

Also: which layer route each forward takes under int8 (kernel B4 for every
layer, never B3; the float B2 tail under 'auto' with logits_only), the
key_cosine predictor's dense pass staying float, and the quantization
moving the logits by more than nothing and less than 5%.

A keep mask is only comparable where no score sits on its cut: each case
asserts that the smallest gap in the JAX run is above 1e-6, as
tests/test_torch_redecide.py does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_numpy, as_torch, init_pruned, jax_and_torch_params, randn
from vit_pruning_tpu.configs import PruneConfig, ViTConfig, composed_schedule, ultra_schedule
from vit_pruning_tpu.models.pruned_vit import progressive_topk_forward as jax_progressive
from vit_pruning_tpu.models.pruned_vit import pruned_vit_forward as jax_pruned
from vit_pruning_tpu.models.vit import vit_forward as jax_vit_forward
from vit_pruning_tpu.ops.structured import prune_heads, prune_mlp_channels
from vit_pruning_tpu.serving import serving_forward as jax_serving
from vit_pruning_tpu_torch.models import predictors as tpred
from vit_pruning_tpu_torch.models import pruned_vit as tp
from vit_pruning_tpu_torch.models.vit import embed, layer_slice, vit_forward, vit_layer
from vit_pruning_tpu_torch.ops import dispatch
from vit_pruning_tpu_torch.ops.cuda import layer as tl
from vit_pruning_tpu_torch.ops.cuda import layer_int8 as tl8
from vit_pruning_tpu_torch.ops.quant import quantize_layer_params
from vit_pruning_tpu_torch.serving import serving_forward

MIN_GAP = 1e-6
GAIN = 10.0  # spreads the random predictors' scores away from 0.5
CFG = ViTConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=3, num_heads=2,
                mlp_dim=128, num_labels=10)
L = CFG.num_layers


def _params(pcfg, pruned=False, seed=0):
    params = init_pruned(CFG, pcfg, seed)
    if params["predictor"] is not None:
        params["predictor"] = jax.tree.map(lambda a: a * GAIN, params["predictor"])
    cfg = CFG
    if pruned:  # composed geometry: 1 of 2 heads (KW < D), half the MLP
        bb, cfg = prune_heads(params["backbone"], CFG, [[1]] * L)
        params["backbone"] = prune_mlp_channels(bb, [list(range(0, CFG.mlp_dim, 2))] * L)
    jparams, tparams = jax_and_torch_params(params)
    return cfg, jparams, tparams


def _pixels(seed=1, b=4):
    return randn(seed, (b, 3, CFG.image_size, CFG.image_size))


def _rank_gap(vals: np.ndarray, k: int) -> float:
    srt = -np.sort(-vals, axis=-1)
    if k >= vals.shape[-1]:
        return np.inf
    with np.errstate(invalid="ignore"):
        gap = np.where(np.isfinite(srt[:, k]), srt[:, k - 1] - srt[:, k], np.inf)
    return float(gap.min())


def _min_gap(scores: np.ndarray, pcfg) -> float:
    gaps = [np.inf]
    for i, sc in enumerate(scores):
        if pcfg.mode == "mask":
            thr = pcfg.mlp_threshold[i]
            gaps.append(float(np.abs(sc - thr).min()))
            if pcfg.mask_budget is not None:
                gaps.append(_rank_gap(np.where(sc >= thr, sc, -np.inf), pcfg.mask_budget))
        elif pcfg.mode == "topk":
            gaps.append(_rank_gap(sc, pcfg.top_k))
        elif pcfg.mode == "topk_prog" and pcfg.keep_schedule[i]:
            gaps.append(_rank_gap(sc, pcfg.keep_schedule[i]))
    return min(gaps)


def _assert_same(got, want, pcfg=None):
    if pcfg is not None:
        gap = _min_gap(np.asarray(want["scores"]), pcfg)
        assert gap > MIN_GAP, gap
        np.testing.assert_array_equal(got["keep_masks"].numpy(), np.asarray(want["keep_masks"]))
        np.testing.assert_allclose(as_numpy(got["scores"]), np.asarray(want["scores"]),
                                   atol=1e-5)
    np.testing.assert_allclose(as_numpy(got["logits"]), np.asarray(want["logits"]),
                               atol=1e-4, rtol=1e-4)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


# --- every entry point against the JAX package ------------------------------------------

def test_vit_forward_int8_matches_jax():
    _, jparams, tparams = _params(PruneConfig(mode="none", predictor="none"))
    x = _pixels()
    want = jax_vit_forward(jparams["backbone"], jnp.asarray(x), CFG, use_pallas=False,
                           quant="int8")
    with dispatch.kernel_mode("eager"):
        got = vit_forward(tparams["backbone"], as_torch(x), CFG, quant="int8")
        with dispatch.quant_mode("int8"):  # quant=None reads the switch
            switched = vit_forward(tparams["backbone"], as_torch(x), CFG)
    _assert_same(got, want)
    torch.testing.assert_close(switched["logits"], got["logits"], rtol=0, atol=0)


def _prog_setup(preset):
    n = CFG.num_patches
    schedule = {"headline": (8, 0, 0), "composed": composed_schedule(n, L),
                "ultra": ultra_schedule(n, L)}[preset]
    pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention",
                       top_k=schedule[0], keep_schedule=schedule)
    cfg, jparams, tparams = _params(pcfg, pruned=preset != "headline")
    return cfg, pcfg, jparams, tparams


@pytest.mark.parametrize("logits_only", [False, True], ids=["full", "logits_only"])
@pytest.mark.parametrize("preset", ["headline", "composed", "ultra"])
def test_progressive_int8_matches_jax(preset, logits_only):
    cfg, pcfg, jparams, tparams = _prog_setup(preset)
    x = _pixels()
    want = jax_progressive(jparams, jnp.asarray(x), cfg, pcfg, use_pallas=False, quant="int8",
                           logits_only=logits_only)
    with dispatch.kernel_mode("eager"):
        got = tp.progressive_topk_forward(tparams, as_torch(x), cfg, pcfg, quant="int8",
                                          logits_only=logits_only)
    _assert_same(got, want, pcfg)
    if not logits_only:
        np.testing.assert_allclose(as_numpy(got["last_hidden"]), np.asarray(want["last_hidden"]),
                                   atol=1e-4)


def test_serving_forward_int8_matches_jax():
    cfg, pcfg, jparams, tparams = _prog_setup("composed")
    u8 = np.random.RandomState(1).randint(0, 256, (4, 3, cfg.image_size, cfg.image_size),
                                          dtype=np.uint8)
    want = jax_serving(jparams, jnp.asarray(u8), cfg, pcfg, use_pallas=False, quant="int8")
    with dispatch.kernel_mode("eager"), dispatch.quant_mode("int8"):
        got = serving_forward(tparams, torch.from_numpy(u8), cfg, pcfg)
    _assert_same(got, want, pcfg)


REDECIDE = {
    "topk": PruneConfig(mode="topk", top_k=8),
    "mask": PruneConfig(mode="mask"),
    "mask_budget": PruneConfig(mode="mask", mask_budget=6),
    "query_only": PruneConfig(mode="mask", query_only=True),
    "measure_only": PruneConfig(mode="mask", measure_only=True),
    "none": PruneConfig(mode="none", predictor="none"),
    "topk_prog": PruneConfig(mode="topk_prog", top_k=8, keep_schedule=(10, 6, 0)),
    "key_cosine": PruneConfig(mode="mask", predictor="key_cosine", measure_only=True),
}


@pytest.mark.parametrize("name", list(REDECIDE))
def test_pruned_vit_forward_int8_matches_jax(name):
    pcfg = REDECIDE[name]
    _, jparams, tparams = _params(pcfg)
    x = _pixels()

    def run_jax(p):
        return jax_pruned(jparams, jnp.asarray(x), CFG, p, use_pallas=False, quant="int8")

    if pcfg.mode == "mask":  # per-layer median thresholds of an int8 measure_only probe
        probe = run_jax(pcfg.replace(mlp_threshold=0.5, mask_budget=None, measure_only=True,
                                     query_only=False))
        pcfg = pcfg.replace(mlp_threshold=tuple(float(np.median(s))
                                                for s in np.asarray(probe["scores"])))
    want = run_jax(pcfg)
    with dispatch.kernel_mode("eager"):
        got = tp.pruned_vit_forward(tparams, as_torch(x), CFG, pcfg, quant="int8")
    _assert_same(got, want, pcfg)


# --- routes ------------------------------------------------------------------------------

def _count_calls(monkeypatch):
    """Count the calls to each layer kernel's wrapper (on CPU tensors the
    wrappers run their plain versions and launch nothing)."""
    calls = {"b1": 0, "b2": 0, "b3": 0, "b4": 0}

    def counted(key, fn):
        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapper

    monkeypatch.setattr(tl, "fused_vit_layer", counted("b1", tl.fused_vit_layer))
    monkeypatch.setattr(tl, "fused_vit_layer_cls_logits",
                        counted("b2", tl.fused_vit_layer_cls_logits))
    monkeypatch.setattr(tp, "fused_vit_layer_bucketed", counted("b3", tp.fused_vit_layer_bucketed))
    monkeypatch.setattr(tl8, "fused_vit_layer_int8", counted("b4", tl8.fused_vit_layer_int8))
    return calls


@pytest.mark.parametrize("forward", ["dense", "progressive", "topk", "mask_budget", "random",
                                     "mask"])
def test_int8_routes_every_layer_through_b4(forward, monkeypatch):
    """Mode 'auto', quant int8: B4 runs every layer (B3 never: a budget-bounded
    layer gathers to its cap and runs B4 there), except the progressive
    logits_only tail, which is the float B2."""
    pcfg = {"dense": PruneConfig(mode="none", predictor="none"),
            "progressive": PruneConfig(mode="topk_prog", top_k=8, keep_schedule=(8, 0, 0)),
            "topk": PruneConfig(mode="topk", top_k=8),
            "mask_budget": PruneConfig(mode="mask", mask_budget=6),
            "random": PruneConfig(mode="random", top_k=7),
            "mask": PruneConfig(mode="mask")}[forward]
    _, _, tparams = _params(pcfg)
    calls = _count_calls(monkeypatch)
    x = as_torch(_pixels())
    with dispatch.quant_mode("int8"):
        if forward == "progressive":
            tp.progressive_topk_forward(tparams, x, CFG, pcfg, logits_only=True)
        else:
            tp.pruned_vit_forward(tparams, x, CFG, pcfg, generator=torch.Generator().manual_seed(0))
    want = {"b1": 0, "b2": 0, "b3": 0, "b4": L}
    if forward == "progressive":
        want.update(b2=1, b4=L - 1)
    assert calls == want


def test_int8_progressive_tail_follows_the_two_jax_routes():
    """logits_only under int8: mode 'auto' runs the last layer, final LN and
    classifier as the float B2 (the JAX package's Pallas route), mode 'eager'
    runs the last layer int8 (its jnp route). The 'auto' logits equal B2's
    plain version on the int8 hidden state before the last layer."""
    cfg, pcfg, jparams, tparams = _prog_setup("headline")
    x = as_torch(_pixels())
    with dispatch.quant_mode("int8"):
        auto = tp.progressive_topk_forward(tparams, x, cfg, pcfg, logits_only=True)
        with dispatch.kernel_mode("eager"):
            eager = tp.progressive_topk_forward(tparams, x, cfg, pcfg, logits_only=True)
    # by hand: the drop before layer 0, int8 layers 0 .. L-2 (B4's plain
    # version), then B2's plain version with the float last layer
    bb = tparams["backbone"]
    h, _, _ = tp.progressive_drop(embed(x, bb["embed"], cfg), tparams["predictor"], 0, 8, cfg,
                                  pcfg, layer_params=layer_slice(bb["layers"], 0))
    qlayers = quantize_layer_params(bb["layers"])
    for i in range(L - 1):
        h = tl8.fused_vit_layer_int8_ref(h, layer_slice(qlayers, i), cfg.num_heads,
                                         cfg.layernorm_eps)
    want = tl.fused_vit_layer_cls_logits_ref(h, layer_slice(bb["layers"], L - 1), bb["ln_f"],
                                             bb["head"], cfg.num_heads, cfg.layernorm_eps)
    torch.testing.assert_close(auto["logits"], want, rtol=0, atol=1e-6)
    assert torch.equal(auto["keep_masks"], eager["keep_masks"])
    jeager = jax_progressive(jparams, jnp.asarray(as_numpy(x)), cfg, pcfg, use_pallas=False,
                             quant="int8", logits_only=True)
    _assert_same(eager, jeager)
    rel = _rel(auto["logits"], eager["logits"])
    assert 0.0 < rel < 0.05, rel  # the two tails differ, within the int8 error


def test_key_cosine_dense_pass_stays_float():
    pcfg = PruneConfig(mode="mask", predictor="key_cosine")
    _, _, tparams = _params(pcfg)
    x = embed(as_torch(_pixels()), tparams["backbone"]["embed"], CFG)
    lp = layer_slice(tparams["backbone"]["layers"], 0)
    with dispatch.kernel_mode("eager"):
        with dispatch.quant_mode("int8"):
            _, extras = tpred.apply_predictor(tparams["predictor"], 0, x, CFG, pcfg,
                                              layer_params=lp)
            int8_out = vit_layer(x, lp, CFG)
        float_out = vit_layer(x, lp, CFG)
    torch.testing.assert_close(extras["dense_out"], float_out, rtol=0, atol=0)
    assert not torch.equal(extras["dense_out"], int8_out)


@pytest.mark.parametrize("mode", ["auto", "eager"])
def test_int8_random_bucketed_equals_full_length_masked(mode):
    """mode='random' cannot share JAX's random bits: each int8 layer at the
    cap (gather -> int8 layer -> scatter) equals the full-length masked
    int8 layer with the same mask on the kept rows."""
    pcfg = PruneConfig(mode="random", top_k=7)
    _, _, tparams = _params(pcfg)
    with dispatch.kernel_mode(mode), dispatch.quant_mode("int8"):
        out = tp.pruned_vit_forward(tparams, as_torch(_pixels()), CFG, pcfg,
                                    generator=torch.Generator().manual_seed(3),
                                    return_layer_inputs=True)
        xs, masks = out["layer_inputs"], out["keep_masks"]
        for i in range(L - 1):
            y = vit_layer(xs[i], layer_slice(tparams["backbone"]["layers"], i), CFG,
                          token_mask=masks[i])
            want = torch.where(masks[i][..., None], y, xs[i])
            torch.testing.assert_close(xs[i + 1], want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("mode", ["auto", "eager"])
def test_int8_logits_close_to_float(mode):
    """The quantization engages (logits move) and stays small (< 5% relative,
    the bound of tests/test_pallas.py:241)."""
    _, _, tparams = _params(PruneConfig(mode="none", predictor="none"))
    x = as_torch(_pixels())
    with dispatch.kernel_mode(mode):
        ref = vit_forward(tparams["backbone"], x, CFG)["logits"]
        got = vit_forward(tparams["backbone"], x, CFG, quant="int8")["logits"]
    assert 0.0 < _rel(got, ref) < 0.05


def test_int8_auto_is_close_to_eager():
    """B4's plain version (mode 'auto' on the CPU) and the eager int8 layer
    differ by float noise only (the scale's last bit, staged2 attention)."""
    _, _, tparams = _params(PruneConfig(mode="none", predictor="none"))
    x = as_torch(_pixels())
    with dispatch.quant_mode("int8"):
        a = vit_forward(tparams["backbone"], x, CFG)["logits"]
        with dispatch.kernel_mode("eager"):
            e = vit_forward(tparams["backbone"], x, CFG)["logits"]
    torch.testing.assert_close(a, e, atol=1e-4, rtol=1e-4)


def test_quantized_params_need_int8():
    _, _, tparams = _params(PruneConfig(mode="none", predictor="none"))
    qlp = layer_slice(quantize_layer_params(tparams["backbone"]["layers"]), 0)
    x = torch.zeros(1, 17, CFG.hidden_size)
    with pytest.raises(ValueError, match="int8"):
        vit_layer(x, qlp, CFG, quant="none")
    assert vit_layer(x, qlp, CFG, quant="int8").shape == x.shape
