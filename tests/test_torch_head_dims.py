"""The layer kernels B1-B5 at the short head dims of the repo's own configs,
and the bf16 GEMM wrapper under them, against the JAX package on the CPU.

The kernels take head dims 16, 32, 64 and 80 on the card
(ops/cuda/layer.py::LAYER_HEAD_DIMS, csrc/common.cuh::layer_head_dim_ok).
64 and 80 are held in tests/test_torch_layer.py and test_torch_vit_huge.py;
here the plain versions of B1-B5 are held to the Pallas kernels in
interpret mode at the other two:
  - hd 16: configs.vit_tiny (D 64, 4 heads, MLP 128, image 32 / patch 8:
    S 17), the geometry tests/test_pallas.py uses;
  - hd 32: quality.py's gate model (D 128, 4 heads, MLP 256, image 32 /
    patch 4: S 65).
Then vit_forward and serving_forward at vit_tiny against the JAX package,
and ops/cuda/gemm.py's plain version against numpy for every epilogue the
layer kernels use, with the inputs it must refuse.

Tolerances: f32 atol 2e-5 (tests/test_pallas.py's), B4 1e-4 (the int8
bound of tests/test_torch_quant.py) plus one int8 step of the layer's
update (max |y - x| / 127: a code rounded apart near k + 0.5, as
chip_smoke.py holds B4), B5 1e-4 (tests/test_torch_encoder.py's: the
Pallas erf is a polynomial within 1.5e-7 of the true erf), 1e-4 + rtol 1e-4
on the logits end to end with the keep masks exact (no score within 1e-6
of a cut, asserted); bf16: two bf16 steps at the output's largest
magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_numpy, as_torch, init_pruned, jax_and_torch_params, randn
from vit_pruning_tpu.configs import PruneConfig, ViTConfig, deit_small, vit_huge, vit_tiny
from vit_pruning_tpu.models.pruned_vit import progressive_topk_forward
from vit_pruning_tpu.models.vit import init_vit_params, vit_forward, vit_layer
from vit_pruning_tpu.ops import quant as jq
from vit_pruning_tpu.ops.pallas import embed as jax_embed
from vit_pruning_tpu.ops.pallas.layer import (
    fused_vit_layer,
    fused_vit_layer_bucketed,
    fused_vit_layer_cls_logits,
)
from vit_pruning_tpu.ops.pallas.layer_int8 import fused_vit_layer_int8
from vit_pruning_tpu.ops.pallas.model import fused_vit_encoder
from vit_pruning_tpu.serving import serving_forward
from vit_pruning_tpu_torch.models import pruned_vit as tp
from vit_pruning_tpu_torch.models import vit as tv
from vit_pruning_tpu_torch.ops import quant as tq
from vit_pruning_tpu_torch.ops.cuda import embed as te
from vit_pruning_tpu_torch.ops.cuda import gemm as tg
from vit_pruning_tpu_torch.ops.cuda import layer as tl
from vit_pruning_tpu_torch.ops.cuda import layer_int8 as tl8
from vit_pruning_tpu_torch.ops.cuda import model as tmod
from vit_pruning_tpu_torch.ops.dispatch import kernel_mode
from vit_pruning_tpu_torch.ops.masking import compact_dest
from vit_pruning_tpu_torch.serving import serving_forward as t_serving_forward

F32_ATOL = 2e-5
INT8_ATOL = 1e-4
ENCODER_ATOL = 1e-4
E2E_ATOL = 1e-4
MIN_GAP = 1e-6
PREDICTOR_GAIN = 30.0
# quality.py's gate model (its ViTConfig without --gate_model): hd 32, S 65
GATE = ViTConfig(image_size=32, patch_size=4, hidden_size=128, num_layers=6, num_heads=4,
                 mlp_dim=256, num_labels=128)
GEOMETRIES = {"vit_tiny": vit_tiny(), "gate": GATE}


def _bf16_tol(ref: np.ndarray) -> float:
    return 2.0 * 2.0 ** (np.floor(np.log2(max(float(np.abs(ref).max()), 1e-30))) - 7)


def _layers(cfg, seed=0):
    """The stacked layers with random LN gains and biases (the init leaves
    them 1 and 0, which would hide a gain or bias bug), and the params."""
    params = init_vit_params(jax.random.PRNGKey(seed), cfg)
    leaves, tree = jax.tree_util.tree_flatten(params["layers"])
    rs = np.random.RandomState(seed + 10)
    leaves = [a + 0.1 * rs.randn(*a.shape).astype(np.float32) if a.ndim == 2 else a
              for a in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves), params


def _layer(cfg, i=0):
    layers, params = _layers(cfg)
    return jax.tree.map(lambda a: a[i], layers), params


def _mask(b, s, seed=2):
    m = np.random.RandomState(seed).rand(b, s) > 0.3
    m[:, 0] = True
    return m


def test_layer_head_dims_cover_the_repo_configs():
    assert tl.LAYER_HEAD_DIMS == (16, 32, 64, 80)
    dims = {name: c.head_dim for name, c in
            {"vit_tiny": vit_tiny(), "gate": GATE, "deit_small": deit_small(),
             "vit_huge": vit_huge()}.items()}
    assert dims == {"vit_tiny": 16, "gate": 32, "deit_small": 64, "vit_huge": 80}
    assert (vit_tiny().seq_len, GATE.seq_len) == (17, 65)


# --- B1-B5's plain versions against the Pallas kernels ---------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_b1_plain_matches_pallas(geometry, masked):
    cfg = GEOMETRIES[geometry]
    lp, _ = _layer(cfg)
    jlp, tlp = jax_and_torch_params(lp)
    x = randn(1, (3, cfg.seq_len, cfg.hidden_size))
    mask = _mask(3, cfg.seq_len) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    got = as_numpy(tl.fused_vit_layer_ref(as_torch(x), tlp, cfg.num_heads, cfg.layernorm_eps,
                                          None if mask is None else torch.from_numpy(mask)))
    kernel = fused_vit_layer(jnp.asarray(x), jlp, cfg.num_heads, eps=cfg.layernorm_eps,
                             token_mask=jmask, interpret=True)
    ref = vit_layer(jnp.asarray(x), jlp, cfg, token_mask=jmask, use_pallas=False, quant="none")
    rows = np.ones((3, cfg.seq_len), bool) if mask is None else mask  # masked rows: don't care
    for want in (kernel, ref):
        assert np.abs(got - np.asarray(want))[rows].max() < F32_ATOL


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_b1_plain_matches_pallas_bf16(geometry):
    cfg = GEOMETRIES[geometry]
    lp, _ = _layer(cfg)
    jlp, tlp = jax_and_torch_params(lp, jnp.bfloat16)
    x = randn(2, (3, cfg.seq_len, cfg.hidden_size))
    mask = _mask(3, cfg.seq_len)
    got = as_numpy(tl.fused_vit_layer_ref(as_torch(x, torch.bfloat16), tlp, cfg.num_heads,
                                          cfg.layernorm_eps, torch.from_numpy(mask)))
    want = fused_vit_layer(jnp.asarray(x, jnp.bfloat16), jlp, cfg.num_heads,
                           eps=cfg.layernorm_eps, token_mask=jnp.asarray(mask), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    assert np.abs(got - want)[mask].max() <= _bf16_tol(want)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_b2_plain_matches_pallas(geometry):
    cfg = GEOMETRIES[geometry]
    lp, params = _layer(cfg, i=-1)
    jlp, tlp = jax_and_torch_params(lp)
    jf, tf = jax_and_torch_params({"ln_f": params["ln_f"], "head": params["head"]})
    x = randn(3, (4, cfg.seq_len, cfg.hidden_size))
    got = as_numpy(tl.fused_vit_layer_cls_logits_ref(as_torch(x), tlp, tf["ln_f"], tf["head"],
                                                     cfg.num_heads, cfg.layernorm_eps))
    want = fused_vit_layer_cls_logits(jnp.asarray(x), jlp, jf["ln_f"], jf["head"], cfg.num_heads,
                                      eps=cfg.layernorm_eps, interpret=True)
    assert got.shape == (4, cfg.num_labels)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL, rtol=1e-4)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_b3_plain_matches_pallas(geometry):
    """A bucket of about half the sequence: a full image, a partial one and
    one with only CLS kept; skipped rows are x bit for bit."""
    cfg = GEOMETRIES[geometry]
    lp, _ = _layer(cfg)
    jlp, tlp = jax_and_torch_params(lp)
    s = cfg.seq_len
    cap = s // 2 + 1
    x = randn(4, (3, s, cfg.hidden_size))
    rs = np.random.RandomState(5)
    kept = np.zeros((3, s), bool)
    kept[:, 0] = True
    for i, count in enumerate((cap, cap // 2, 1)):
        kept[i, 1 + rs.permutation(s - 1)[:count - 1]] = True
    dest = compact_dest(torch.from_numpy(kept))
    got = as_numpy(tl.fused_vit_layer_bucketed_ref(as_torch(x), tlp, dest, torch.from_numpy(kept),
                                                   cap, cfg.num_heads, cfg.layernorm_eps))
    want = np.asarray(fused_vit_layer_bucketed(
        jnp.asarray(x), jlp, jnp.asarray(dest.numpy()), jnp.asarray(kept), cap, cfg.num_heads,
        eps=cfg.layernorm_eps, interpret=True))
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=1e-4)
    np.testing.assert_array_equal(got[~kept], x[~kept])


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_b4_plain_matches_pallas_int8(geometry, masked):
    cfg = GEOMETRIES[geometry]
    lp, _ = _layer(cfg)
    jlp, tlp = jax_and_torch_params(lp)
    jqp, tqp = jq.quantize_layer_params(jlp), tq.quantize_layer_params(tlp)
    x = randn(1, (3, cfg.seq_len, cfg.hidden_size))
    mask = _mask(3, cfg.seq_len) if masked else None
    got = tl8.fused_vit_layer_int8_ref(as_torch(x), tqp, cfg.num_heads, cfg.layernorm_eps,
                                       None if mask is None else torch.from_numpy(mask))
    want = np.asarray(fused_vit_layer_int8(
        jnp.asarray(x), jqp, cfg.num_heads, eps=cfg.layernorm_eps,
        token_mask=None if mask is None else jnp.asarray(mask), interpret=True))
    rows = np.ones((3, cfg.seq_len), bool) if mask is None else mask
    # an activation within float noise of k + 0.5 may take the neighbouring
    # code in one of the two (their sums run in another order): one code
    # moves a product's output by about one int8 step of the layer's update
    step = np.abs(want - x).max() / 127.0
    assert np.abs(as_numpy(got) - want)[rows].max() <= INT8_ATOL + step


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_b5_plain_matches_pallas(geometry, masked):
    cfg = GEOMETRIES[geometry]
    layers, _ = _layers(cfg, seed=3)
    jl, tlr = jax_and_torch_params(jax.tree.map(lambda a: a[:3], layers))
    x = randn(5, (2, cfg.seq_len, cfg.hidden_size))
    mask = _mask(2, cfg.seq_len) if masked else None
    want = np.asarray(fused_vit_encoder(
        jnp.asarray(x), jl, cfg.num_heads, eps=cfg.layernorm_eps,
        token_mask=None if mask is None else jnp.asarray(mask), interpret=True))
    got = as_numpy(tmod.fused_vit_encoder_ref(as_torch(x), tlr, cfg.num_heads, cfg.layernorm_eps,
                                              None if mask is None else torch.from_numpy(mask)))
    rows = np.ones((2, cfg.seq_len), bool) if mask is None else mask
    assert np.abs(got - want)[rows].max() <= ENCODER_ATOL


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_layer_wrappers_run_their_plain_versions_on_the_cpu(geometry):
    """B1 on a CPU tensor is its plain version and launches nothing, at a
    head dim the card now takes."""
    cfg = GEOMETRIES[geometry]
    lp, _ = _layer(cfg)
    _, tlp = jax_and_torch_params(lp)
    x = as_torch(randn(6, (2, cfg.seq_len, cfg.hidden_size)))
    before = tl.fused_vit_layer.launches
    torch.testing.assert_close(tl.fused_vit_layer(x, tlp, cfg.num_heads, cfg.layernorm_eps),
                               tl.fused_vit_layer_ref(x, tlp, cfg.num_heads, cfg.layernorm_eps),
                               rtol=0, atol=0)
    assert tl.fused_vit_layer.launches == before


# --- vit_tiny end to end against the JAX package ------------------------------------------

def test_vit_forward_matches_jax_at_vit_tiny():
    cfg = vit_tiny()
    params = init_vit_params(jax.random.PRNGKey(0), cfg)
    _, tparams = jax_and_torch_params(params)
    x = randn(1, (3, 3, cfg.image_size, cfg.image_size))
    want = vit_forward(params, jnp.asarray(x), cfg, use_pallas=False, quant="none")
    got = tv.vit_forward(tparams, as_torch(x), cfg)
    for key in ("logits", "cls", "last_hidden"):
        np.testing.assert_allclose(as_numpy(got[key]), np.asarray(want[key]), atol=E2E_ATOL)


def _rank_gap(scores: np.ndarray, k: int) -> float:
    live = np.isfinite(scores)
    srt = -np.sort(-np.where(live, scores, -np.inf), axis=-1)
    return float((srt[:, k - 1] - srt[:, k]).min())


def test_serving_forward_matches_jax_at_vit_tiny():
    """The headline preset at vit_tiny (keep 8 of 16 patches before layer
    0), from uint8 pixels, and the progressive entry on float pixels."""
    cfg = vit_tiny()
    pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention", top_k=8)
    params = init_pruned(cfg, pcfg)
    params["predictor"] = jax.tree.map(lambda a: a * PREDICTOR_GAIN, params["predictor"])
    jparams, tparams = jax_and_torch_params(params)
    u8 = np.random.RandomState(1).randint(0, 256, (4, 3, cfg.image_size, cfg.image_size),
                                          dtype=np.uint8)
    x = randn(2, (4, 3, cfg.image_size, cfg.image_size))
    runs = (
        (serving_forward(jparams, jnp.asarray(u8), cfg, pcfg, use_pallas=False, quant="none"),
         t_serving_forward(tparams, torch.from_numpy(u8), cfg, pcfg)),
        (progressive_topk_forward(jparams, jnp.asarray(x), cfg, pcfg, use_pallas=False,
                                  quant="none", logits_only=True),
         tp.progressive_topk_forward(tparams, as_torch(x), cfg, pcfg, logits_only=True)),
    )
    for want, got in runs:
        assert _rank_gap(np.asarray(want["scores"])[0], 8) > MIN_GAP
        np.testing.assert_array_equal(got["keep_masks"].numpy(), np.asarray(want["keep_masks"]))
        np.testing.assert_allclose(as_numpy(got["logits"]), np.asarray(want["logits"]),
                                   atol=E2E_ATOL, rtol=1e-4)


# --- the bf16 GEMM wrapper's plain version ----------------------------------------------

def _gelu(y: np.ndarray, act: str) -> np.ndarray:
    from math import erf, pi, sqrt

    if act == "gelu_erf":
        return 0.5 * y * (1.0 + np.vectorize(erf)(y / sqrt(2.0)))
    return 0.5 * y * (1.0 + np.tanh(sqrt(2.0 / pi) * (y + 0.044715 * y ** 3)))


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


# (M, K, N, act, residual dtype, out dtype, row stride of A): the layer
# kernels' epilogues (QKV / K-V: bias; O: bias + residual, f32 out; fc1:
# bias + GELU; fc2: bias + f32 residual; B5's erf GELU), a ragged M, the
# classifier's N 100 and B2's strided CLS rows
GEMM_CASES = {
    "qkv": (17, 64, 192, "none", None, torch.bfloat16, None),
    "o_res_bf16_out_f32": (33, 64, 64, "none", torch.bfloat16, torch.float32, None),
    "fc1_tanh": (65, 128, 256, "gelu_tanh", None, torch.bfloat16, None),
    "fc1_erf": (65, 128, 256, "gelu_erf", None, torch.bfloat16, None),
    "fc2_res_f32": (129, 256, 128, "none", torch.float32, torch.bfloat16, None),
    "fc2_res_f32_out_f32": (7, 256, 128, "none", torch.float32, torch.float32, None),
    "classifier_n100": (5, 128, 100, "none", None, torch.bfloat16, None),
    "strided_cls_rows": (4, 64, 64, "none", None, torch.bfloat16, 17 * 64),
    "strided_cls_residual": (4, 64, 64, "none", "strided", torch.float32, 17 * 64),
}


@pytest.mark.parametrize("case", list(GEMM_CASES))
def test_gemm_plain_matches_numpy(case):
    m, k, n, act, res_dt, out_dt, lda = GEMM_CASES[case]
    rs = np.random.RandomState(11)
    a_full = _bf16(rs.randn(m, lda or k))
    a = a_full[:, :k]
    w = _bf16(0.1 * rs.randn(k, n))
    b = _bf16(0.1 * rs.randn(n))
    res = None
    if res_dt == "strided":  # B2's O product: the residual is x's CLS rows, like A
        res = a_full[:, :n]
    elif res_dt is not None:
        res = torch.from_numpy(rs.randn(m, n).astype(np.float32)).to(res_dt)
    got = tg.gemm_bf16(a, w, b, act, res, out_dt)
    y = a.float().numpy().astype(np.float64) @ w.float().numpy() + b.float().numpy()
    if act != "none":
        y = _gelu(y, act)
    if res is not None:
        y = y + res.float().numpy()
    assert got.shape == (m, n) and got.dtype == out_dt
    want = torch.from_numpy(y.astype(np.float32)).to(out_dt).float().numpy()
    # an f32 sum in another order can land on the neighbouring bf16 value
    tol = 1e-5 * np.abs(y).max() if out_dt == torch.float32 else _bf16_tol(y) / 2
    assert np.abs(as_numpy(got) - want).max() <= tol


BAD_GEMM = {
    "float32 a": lambda a, w: (a.float(), w),
    "float16 w": lambda a, w: (a, w.half()),
    "K not a multiple of 8": lambda a, w: (a[:, :60], w[:60]),
    "misaligned a": lambda a, w: (a.reshape(-1)[1:1 + 8 * 64].view(8, 64), w),
    "non-contiguous rows of a": lambda a, w: (a.t().contiguous().t(), w),
    "non-contiguous w": lambda a, w: (a, w.t().contiguous().t()),
    "misaligned w": lambda a, w: (a, w.reshape(-1)[1:1 + 64 * 40].view(64, 40)),
    "shapes that do not chain": lambda a, w: (a, w[:32]),
}


@pytest.mark.parametrize("what", list(BAD_GEMM))
def test_gemm_rejects_what_no_body_takes(what):
    a = torch.zeros(9, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 48, dtype=torch.bfloat16)
    a, w = BAD_GEMM[what](a, w)
    with pytest.raises(ValueError):
        tg.gemm_bf16(a, w)


def test_gemm_rejects_bad_epilogue_operands():
    a = torch.zeros(9, 64, dtype=torch.bfloat16)
    w = torch.zeros(64, 48, dtype=torch.bfloat16)
    for kwargs in ({"bias": torch.zeros(48)}, {"bias": torch.zeros(47, dtype=torch.bfloat16)},
                   {"residual": torch.zeros(9, 47)}, {"residual": torch.zeros(48, 9).t()},
                   {"act": "relu"},
                   {"out_dtype": torch.float16}):
        with pytest.raises(ValueError):
            tg.gemm_bf16(a, w, **kwargs)


def test_gemm_wrapper_on_the_cpu_runs_its_plain_version():
    a = _bf16(np.random.RandomState(3).randn(9, 64))
    w = _bf16(np.random.RandomState(4).randn(64, 48))
    before = tg.gemm_bf16.launches
    torch.testing.assert_close(tg.gemm_bf16(a, w, act="gelu_tanh"),
                               tg.gemm_bf16_ref(a, w, act="gelu_tanh"), rtol=0, atol=0)
    assert tg.gemm_bf16.launches == before
    with kernel_mode("kernel"):
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tg.gemm_bf16(a, w)


def test_takes_wgmma_follows_the_tma_rule():
    """The C rule on which body runs a product gemm_bf16 takes: TMA needs
    16-byte rows of W, so the classifier's N 100 goes to WMMA, and a strided
    A (B2's CLS rows) stays on wgmma."""
    a = torch.zeros(8, 17 * 64, dtype=torch.bfloat16)[:, :64]
    assert tg.takes_wgmma(a, torch.zeros(64, 384, dtype=torch.bfloat16))
    assert not tg.takes_wgmma(a, torch.zeros(64, 100, dtype=torch.bfloat16))


# --- B8b on f32 patches with bf16 weights at ViT-H's patch width ---------------------------

def test_b8b_plain_on_f32_patches_with_bf16_weights_at_k588():
    """embed_fused's f32 pixels with bf16 weights (the wgmma body's register
    producer on the card): the patches rounded to bf16, as the Pallas
    kernel casts them to the weights' dtype."""
    rs = np.random.RandomState(8)
    n, pd, d = 256, 588, 160
    w, b, pos = (0.02 * rs.randn(pd, d), 0.1 * rs.randn(d), 0.02 * rs.randn(n, d))
    jw, jb, jpos = (jnp.asarray(t, jnp.bfloat16) for t in (w, b, pos))
    tw, tb, tpos = (_bf16(t) for t in (w, b, pos))
    x = rs.randn(2, n, pd).astype(np.float32)
    got = te.fused_patch_embed_f_ref(torch.from_numpy(x), tw, tb, tpos)
    want = jax_embed.fused_patch_embed_f(jnp.asarray(x), jw, jb, jpos, interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    assert np.abs(as_numpy(got) - want).max() <= _bf16_tol(want)
