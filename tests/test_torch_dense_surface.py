"""The dense model's remaining routes in the port against the JAX package on
the CPU: vit_forward with head_mask and output_hidden_states, the
whole-encoder route (kernel B5) through vit_forward, progressive_topk_forward
and pruned_vit_forward mode 'none', the encoder route under int8, the
dispatch switches, and the soft-mask and importance helpers.

The port runs in kernel mode 'auto' (its wrappers' plain versions on CPU
tensors) or 'eager'; the JAX package runs with use_pallas=True, its Pallas
kernels swapped for interpret-mode partials (fused_mlp, and the whole
encoder), or with use_pallas=False. f32: logits and hidden states within
atol 1e-4, keep masks exact. Spies on the kernel wrappers show which route
a forward took.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_pruning_tpu.ops.dispatch as jax_dispatch
import vit_pruning_tpu.ops.pallas.mlp as pallas_mlp
import vit_pruning_tpu.ops.pallas.model as pallas_model
from torch_parity import as_numpy, as_torch, init_pruned, jax_and_torch_params, randn
from vit_pruning_tpu.configs import PruneConfig, composed_schedule, vit_tiny
from vit_pruning_tpu.models.pruned_vit import progressive_topk_forward as jax_progressive
from vit_pruning_tpu.models.pruned_vit import pruned_vit_forward as jax_pruned
from vit_pruning_tpu.models.vit import init_vit_params
from vit_pruning_tpu.models.vit import vit_forward as jax_vit_forward
from vit_pruning_tpu.ops import structured as jax_structured
from vit_pruning_tpu_torch.models import pruned_vit as tp
from vit_pruning_tpu_torch.models.vit import vit_forward
from vit_pruning_tpu_torch.ops import dispatch
from vit_pruning_tpu_torch.ops import structured as tstruct
from vit_pruning_tpu_torch.ops.cuda import layer as tl
from vit_pruning_tpu_torch.ops.cuda import mlp as tmlp
from vit_pruning_tpu_torch.ops.cuda import model as tmod

GAIN = 30.0  # spreads the random predictor's scores away from 0.5 (test_torch_pruned.py)
MIN_CUT_GAP = 1e-6


def _dense(dtype=jnp.float32):
    cfg = vit_tiny()
    params = init_vit_params(jax.random.PRNGKey(0), cfg)
    # random LN gains and biases: the init leaves them 1 and 0
    leaves, tree = jax.tree_util.tree_flatten(params["layers"])
    rs = np.random.RandomState(10)
    params["layers"] = jax.tree_util.tree_unflatten(
        tree, [a + 0.1 * rs.randn(*a.shape).astype(np.float32) if a.ndim == 2 else a
               for a in leaves])
    jp, tpar = jax_and_torch_params(params, dtype)
    x = randn(1, (2, 3, cfg.image_size, cfg.image_size))
    return cfg, jp, tpar, x


def _spy(monkeypatch, module, name):
    """Count the calls of a kernel wrapper that models import at call time."""
    wrapper, calls = getattr(module, name), []
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(a) or wrapper(*a, **k))
    return calls


def _forbid(monkeypatch, module, name):
    def refuse(*a, **k):
        raise AssertionError(f"{name} must not run on this route")
    monkeypatch.setattr(module, name, refuse)


@pytest.fixture
def jax_fused(monkeypatch):
    """The JAX package's Pallas MLP and whole-encoder kernels in interpret
    mode, its encoder fusion on, and a count of its encoder calls (all
    restored after the test)."""
    monkeypatch.setattr(pallas_mlp, "fused_mlp",
                        functools.partial(pallas_mlp.fused_mlp, interpret=True))
    encoder, calls = pallas_model.differentiable_fused_encoder, []

    def interpreted(num_heads, eps):
        f = encoder(num_heads, eps, interpret=True)
        return lambda *a: calls.append(a) or f(*a)

    monkeypatch.setattr(pallas_model, "differentiable_fused_encoder", interpreted)
    monkeypatch.setattr(jax_dispatch, "_ENCODER_FUSION", True)
    return calls


def _assert_close(got, want, keys=("logits", "cls", "last_hidden"), atol=1e-4):
    for key in keys:
        np.testing.assert_allclose(as_numpy(got[key]), np.asarray(want[key]), atol=atol,
                                   err_msg=key)


# --- head_mask and output_hidden_states ------------------------------------------------

@pytest.mark.parametrize("hm_shape", ["LH", "LBH"])
@pytest.mark.parametrize("mode", ["auto", "eager"])
def test_vit_forward_head_mask_matches_jax(mode, hm_shape, jax_fused, monkeypatch):
    """'auto': every layer takes the per-op route with B7's plain version as
    its MLP and never B1, as the JAX package's use_pallas=True runs its
    Pallas MLP; 'eager': the plain layer, as use_pallas=False."""
    cfg, jp, tpar, x = _dense()
    rs = np.random.RandomState(4)
    shape = (cfg.num_layers, cfg.num_heads) if hm_shape == "LH" else (cfg.num_layers, 2,
                                                                       cfg.num_heads)
    hm = ((rs.rand(*shape) > 0.3) * rs.rand(*shape)).astype(np.float32)
    mlp_calls = _spy(monkeypatch, tmlp, "fused_mlp")
    _forbid(monkeypatch, tl, "fused_vit_layer")
    _forbid(monkeypatch, tmod, "fused_vit_encoder")
    with dispatch.kernel_mode(mode), dispatch.encoder_fusion(True):
        got = vit_forward(tpar, as_torch(x), cfg, head_mask=as_torch(hm))
    want = jax_vit_forward(jp, jnp.asarray(x), cfg, head_mask=jnp.asarray(hm),
                           use_pallas=mode == "auto", quant="none")
    _assert_close(got, want)
    assert len(mlp_calls) == (cfg.num_layers if mode == "auto" else 0)
    assert not jax_fused  # the JAX package's head_mask route bypasses its encoder too


def test_vit_forward_head_mask_ignores_int8():
    """Under head_mask the layers run in float, with or without int8."""
    cfg, _, tpar, x = _dense()
    hm = torch.ones(cfg.num_layers, cfg.num_heads)
    hm[1, 2] = 0.0
    with dispatch.kernel_mode("eager"):
        a = vit_forward(tpar, as_torch(x), cfg, head_mask=hm, quant="int8")["logits"]
        b = vit_forward(tpar, as_torch(x), cfg, head_mask=hm, quant="none")["logits"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["auto", "eager"])
def test_output_hidden_states_matches_jax(mode, monkeypatch):
    """All L + 1 states; the per-layer loop even with encoder fusion on (B1's
    plain version per layer in 'auto', never B5)."""
    cfg, jp, tpar, x = _dense()
    b1_calls = _spy(monkeypatch, tl, "fused_vit_layer")
    _forbid(monkeypatch, tmod, "fused_vit_encoder")
    with dispatch.kernel_mode(mode), dispatch.encoder_fusion(True):
        got = vit_forward(tpar, as_torch(x), cfg, output_hidden_states=True)
    want = jax_vit_forward(jp, jnp.asarray(x), cfg, output_hidden_states=True, use_pallas=False,
                           quant="none")
    assert len(got["hidden_states"]) == cfg.num_layers + 1
    for g, w in zip(got["hidden_states"], want["hidden_states"]):
        np.testing.assert_allclose(as_numpy(g), np.asarray(w), atol=1e-4)
    _assert_close(got, want)
    assert len(b1_calls) == (cfg.num_layers if mode == "auto" else 0)


# --- the whole-encoder route (B5) --------------------------------------------------------

def _progressive(preset: str):
    cfg = vit_tiny()
    sched = (8, 0, 0) if preset == "headline" else composed_schedule(cfg.num_patches,
                                                                     cfg.num_layers)
    pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention",
                       top_k=sched[0], keep_schedule=sched)
    params = init_pruned(cfg, pcfg)
    params["predictor"] = jax.tree.map(lambda a: a * GAIN, params["predictor"])
    if preset == "composed":
        bb, cfg = jax_structured.prune_heads(params["backbone"], cfg, [[0, 2]] * cfg.num_layers)
        params["backbone"] = jax_structured.prune_mlp_channels(
            bb, [list(range(0, cfg.mlp_dim, 2))] * cfg.num_layers)
    jp, tpar = jax_and_torch_params(params)
    return cfg, pcfg, jp, tpar


def _cut_gaps_ok(scores, schedule):
    scores = np.asarray(scores)
    for i, k in enumerate(schedule):
        live = np.isfinite(scores[i])
        if k and live.any():
            srt = -np.sort(-np.where(live, scores[i], -np.inf), axis=-1)
            assert (srt[:, k - 1] - srt[:, k]).min() > MIN_CUT_GAP


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("entry", ["vit_forward", "headline", "composed", "pruned_none"])
def test_encoder_route_matches_jax(entry, quant, jax_fused, monkeypatch):
    """With encoder fusion on, each fixed-length stretch of layers is one
    call of B5 (its plain version here) wherever the JAX package's rule
    makes one call of its encoder kernel, B1 never runs, and the outputs
    match; under int8 the route stays float, as the JAX package's does."""
    b5_calls = _spy(monkeypatch, tmod, "fused_vit_encoder")
    _forbid(monkeypatch, tl, "fused_vit_layer")
    x = randn(1, (4, 3, 32, 32))
    with dispatch.encoder_fusion(True):
        if entry == "vit_forward":
            cfg, jp, tpar, _ = _dense()
            got = vit_forward(tpar, as_torch(x), cfg, quant=quant)
            want = jax_vit_forward(jp, jnp.asarray(x), cfg, use_pallas=True, quant=quant)
        elif entry == "pruned_none":
            cfg = vit_tiny()
            pcfg = PruneConfig(mode="none", predictor="cls_mlp")
            jp, tpar = jax_and_torch_params(init_pruned(cfg, pcfg))
            got = tp.pruned_vit_forward(tpar, as_torch(x), cfg, pcfg, quant=quant)
            want = jax_pruned(jp, jnp.asarray(x), cfg, pcfg, use_pallas=True, quant=quant)
        else:
            cfg, pcfg, jp, tpar = _progressive(entry)
            got = tp.progressive_topk_forward(tpar, as_torch(x), cfg, pcfg, quant=quant)
            want = jax_progressive(jp, jnp.asarray(x), cfg, pcfg, use_pallas=True, quant=quant)
            _cut_gaps_ok(want["scores"], pcfg.keep_schedule)
            np.testing.assert_allclose(as_numpy(got["scores"]), np.asarray(want["scores"]),
                                       atol=1e-5)
    if "keep_masks" in want:
        np.testing.assert_array_equal(got["keep_masks"].numpy(), np.asarray(want["keep_masks"]))
    _assert_close(got, want)
    assert len(b5_calls) == len(jax_fused) >= 1
    assert len(b5_calls) == (2 if entry == "composed" else 1)


@pytest.mark.parametrize("entry", ["vit_forward", "composed"])
def test_encoder_route_under_int8_equals_float(entry):
    x = as_torch(randn(2, (2, 3, 32, 32)))
    if entry == "vit_forward":
        cfg, _, tpar, _ = _dense()
        run = functools.partial(vit_forward, tpar, x, cfg)
    else:
        cfg, pcfg, _, tpar = _progressive(entry)
        run = functools.partial(tp.progressive_topk_forward, tpar, x, cfg, pcfg)
    with dispatch.encoder_fusion(True):
        a, b = run(quant="int8"), run(quant="none")
    for key in ("logits", "last_hidden"):
        torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)


def test_encoder_fusion_off_keeps_the_per_layer_route(monkeypatch):
    """Fusion off (or kernels off): the layer-by-layer route, bit for bit
    what it was, and B5 never runs."""
    cfg, pcfg, _, tpar = _progressive("composed")
    x = as_torch(randn(3, (2, 3, 32, 32)))
    _forbid(monkeypatch, tmod, "fused_vit_encoder")
    b1_calls = _spy(monkeypatch, tl, "fused_vit_layer")
    with dispatch.encoder_fusion(False):
        got = tp.progressive_topk_forward(tpar, x, cfg, pcfg)
    assert len(b1_calls) == cfg.num_layers
    with dispatch.encoder_fusion(True), dispatch.kernel_mode("eager"):
        eager = tp.progressive_topk_forward(tpar, x, cfg, pcfg)
    assert len(b1_calls) == cfg.num_layers
    torch.testing.assert_close(got["keep_masks"], eager["keep_masks"], rtol=0, atol=0)


def test_fusion_on_runs_b5_not_b1_in_bf16(jax_fused, monkeypatch):
    """The fault this route repairs: with encoder fusion on, vit_forward in
    'auto' ignored the switch and ran B1 per layer, whose bf16 numerics
    (unnormalised P, tanh GELU, x rounded after every layer) are not the
    JAX package's B5 route. Now it runs B5 (its plain version on the CPU)
    and matches that route in bf16 to within one bf16 step of the output's
    magnitude (the embedding and final LN run in bf16 in both, their sums
    in another order); B1 per layer lands outside that step."""
    cfg, jp, tpar, x = _dense(jnp.bfloat16)
    b5_calls = _spy(monkeypatch, tmod, "fused_vit_encoder")
    b1 = tl.fused_vit_layer
    _forbid(monkeypatch, tl, "fused_vit_layer")
    with dispatch.kernel_mode("auto"), dispatch.encoder_fusion(True):
        got = vit_forward(tpar, as_torch(x, torch.bfloat16), cfg)["last_hidden"]
    want = jax_vit_forward(jp, jnp.asarray(x).astype(jnp.bfloat16), cfg,
                           use_pallas=True)["last_hidden"]
    want = np.asarray(want.astype(jnp.float32))
    assert len(b5_calls) == 1 and len(jax_fused) == 1
    tol = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    assert np.abs(as_numpy(got) - want).max() <= tol
    monkeypatch.setattr(tl, "fused_vit_layer", b1)
    with dispatch.kernel_mode("auto"), dispatch.encoder_fusion(False):
        per_layer = vit_forward(tpar, as_torch(x, torch.bfloat16), cfg)["last_hidden"]
    assert np.abs(as_numpy(per_layer) - want).max() > tol


# --- dispatch switches ---------------------------------------------------------------------

def test_encoder_fusion_switch_rule(monkeypatch):
    """An explicit setting wins, else VIT_PRUNING_TPU_ENCODER == '1'; the
    scoped switch restores what was there, None included."""
    monkeypatch.setattr(dispatch, "_ENCODER_FUSION", None)
    monkeypatch.delenv("VIT_PRUNING_TPU_ENCODER", raising=False)
    assert not dispatch.encoder_fusion_enabled()
    monkeypatch.setenv("VIT_PRUNING_TPU_ENCODER", "1")
    assert dispatch.encoder_fusion_enabled()
    with dispatch.encoder_fusion(False):
        assert not dispatch.encoder_fusion_enabled()
    assert dispatch._ENCODER_FUSION is None and dispatch.encoder_fusion_enabled()
    monkeypatch.setenv("VIT_PRUNING_TPU_ENCODER", "0")
    assert not dispatch.encoder_fusion_enabled()
    dispatch.set_encoder_fusion(True)
    assert dispatch.encoder_fusion_enabled()


def test_attention_kernel_only_in_kernel_mode():
    for mode, want in (("auto", False), ("eager", False), ("kernel", True)):
        with dispatch.kernel_mode(mode):
            assert dispatch.attention_kernel_enabled() is want


# --- soft masks and importance ---------------------------------------------------------------

def test_apply_channel_mask_matches_jax():
    cfg, jp, tpar, x = _dense()
    cm = (np.random.RandomState(6).rand(cfg.num_layers, cfg.mlp_dim) > 0.5).astype(np.float32)
    jm = jax_structured.apply_channel_mask(jp, jnp.asarray(cm))
    tm = tstruct.apply_channel_mask(tpar, as_torch(cm))
    for name in ("w", "b"):
        np.testing.assert_array_equal(as_numpy(tm["layers"]["mlp"]["fc1"][name]),
                                      np.asarray(jm["layers"]["mlp"]["fc1"][name]))
    assert tpar["layers"]["mlp"]["fc1"]["w"].abs().min() > 0  # the input is left as it was
    with dispatch.kernel_mode("eager"):
        got = vit_forward(tm, as_torch(x), cfg)
    _assert_close(got, jax_vit_forward(jm, jnp.asarray(x), cfg, use_pallas=False, quant="none"))


def test_channel_importance_matches_jax():
    cfg, jp, tpar, _ = _dense()
    got = tstruct.channel_importance(tpar)
    assert got.shape == (cfg.num_layers, cfg.mlp_dim)
    np.testing.assert_allclose(as_numpy(got), jax_structured.channel_importance(jp), rtol=1e-5)


def test_head_importance_matches_jax(monkeypatch):
    """The plain return_probs route on every device: no kernel wrapper runs,
    in 'auto' either."""
    cfg, jp, tpar, x = _dense()
    _forbid(monkeypatch, tmlp, "fused_mlp")
    _forbid(monkeypatch, tl, "fused_vit_layer")
    with dispatch.kernel_mode("auto"):
        got = tstruct.head_importance(tpar, as_torch(x), cfg)
    assert got.shape == (cfg.num_layers, cfg.num_heads)
    np.testing.assert_allclose(as_numpy(got), jax_structured.head_importance(jp, jnp.asarray(x),
                                                                             cfg), atol=1e-5)
