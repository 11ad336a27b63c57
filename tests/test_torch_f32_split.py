"""The arithmetic of the f32 split body (vit_pruning_tpu_torch/csrc/split6.cuh: every
f32 product of kernels B1, B2, B3, B5, B7 and B8 on the card), on the CPU.

The body splits both f32 operands into three bf16 planes (hi + mid + lo, exact)
and sums six of the nine plane products in f32. tests/torch_parity.py's
split_bf16x3 and split6_product mirror it; the kernel itself runs only on a GPU,
where chip_smoke.py phase 3n holds it to a float64 product and to the f32 plain
version, and kernel_variants.py f32 plants faults that phase 3n must catch.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (SPLIT6_PASSES, as_numpy, as_torch, jax_and_torch_params, randn,
                          split6_product, split_bf16x3)
from vit_pruning_tpu.configs import deit_small
from vit_pruning_tpu.models.vit import init_vit_params
from vit_pruning_tpu.ops.pallas.layer import fused_vit_layer
from vit_pruning_tpu_torch.ops.cuda import layer as tl

U = 2.0 ** -24  # f32's unit roundoff
# the mirror's relative error against float64 may be this many times the f32
# product's own (chip_smoke.py's F32_SPLIT_ERR, phase 3n's check on the card)
F32_SPLIT_ERR = 2.0
# a layer on the mirror against the JAX package's f32 kernel, as
# tests/test_torch_layer.py holds B1's plain version (tests/test_pallas.py's 2e-5)
F32_ATOL = 2e-5


def _values(seed: int, n: int, lo_exp: int, hi_exp: int) -> torch.Tensor:
    """n finite f32 values +-m 2^e, m uniform in [1, 1.99) (below bf16's
    largest finite value at e = 127, where hi would round to inf), e uniform
    in [lo_exp, hi_exp]."""
    rs = np.random.RandomState(seed)
    m = rs.uniform(1.0, 1.99, n)
    e = rs.randint(lo_exp, hi_exp + 1, n)
    sign = rs.choice([-1.0, 1.0], n)
    return torch.from_numpy((sign * np.ldexp(m, e)).astype(np.float32))


def _rel_err(got: torch.Tensor, exact: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(got.double() - exact) / torch.linalg.vector_norm(exact))


def _dot_bound(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The f32 dot product's rounding bound, K u sum_k |a_k| |w_k|."""
    return a.shape[-1] * U * (a.abs().double() @ w.abs().double())


@pytest.mark.parametrize("lo_exp,hi_exp", [(-110, -100), (-100, -1), (0, 64), (64, 126),
                                           (127, 127)],
                         ids=["2^-110", "small", "unit", "large", "2^127"])
def test_split_is_exact(lo_exp, hi_exp):
    """hi + mid + lo == a bit for bit for finite |a| from 2^-110 up to near
    2^128 (the three parts summed in float64, where the sum is exact)."""
    a = _values(lo_exp & 0xFFFF, 4096, lo_exp, hi_exp)
    hi, mid, lo = split_bf16x3(a)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, a.double())
    assert torch.equal(total.float().view(torch.int32), a.view(torch.int32))
    # the parts shrink by bf16's precision: the cross terms the body leaves out
    # (mid lo, lo mid, lo lo) are below 2^-26 |a w| together
    assert bool((mid.double().abs() <= 2.0 ** -8 * a.double().abs()).all())
    assert bool((lo.double().abs() <= 2.0 ** -16 * a.double().abs()).all())


def test_split_non_finite():
    """+-inf and NaN come through the split (hi carries them, and hi + mid +
    lo is the value); in a product a row holding one is non-finite exactly
    where the plain f32 product is, and NaN where it is NaN (an infinite hi
    times a zero part of the other operand can turn +-inf into NaN: the
    body's documented limit), while the other rows match."""
    a = torch.tensor([math.inf, -math.inf, math.nan, 1.0, -2.5, 3e38], dtype=torch.float32)
    hi, mid, lo = split_bf16x3(a)
    total = hi.float() + mid.float() + lo.float()
    assert torch.equal(torch.isnan(total), torch.isnan(a))
    assert torch.equal(total[~torch.isnan(a)], a[~torch.isnan(a)])

    x = torch.from_numpy(randn(5, (6, 128)))
    w = torch.from_numpy(randn(6, (128, 24))) / math.sqrt(128)
    x[0, 3], x[1, 5], x[2, 7] = math.inf, math.nan, -math.inf
    got, ref = split6_product(x, w), x @ w
    assert torch.equal(torch.isfinite(got), torch.isfinite(ref))
    assert bool(torch.isnan(got[torch.isnan(ref)]).all())
    fin = torch.isfinite(ref)
    assert float((got[fin] - ref[fin]).abs().max()) < 1e-5


@pytest.mark.parametrize("kind", ["below 2^-110", "f32 subnormal"])
def test_tiny_values_within_f32_rounding(kind):
    """Values below 2^-110 (and f32 subnormals) split with a lo that bf16's
    subnormal step (2^-133) rounds: in rows that also hold normal values (a
    GELU output's far tail beside the rest of its row) the mirrored product
    stays within the f32 dot product's rounding bound, as the plain f32
    product does; in a row of such values alone the loss is at most half that
    step a term, K 2^-134 max|w| in all."""
    k = 256
    lo_exp, hi_exp = (-140, -111) if kind == "below 2^-110" else (-149, -127)
    tiny = _values(11, 8 * k, lo_exp, hi_exp).view(8, k)
    normal = torch.from_numpy(randn(12, (8, k)))
    mixed = torch.where(torch.from_numpy(np.random.RandomState(13).rand(8, k) < 0.25), tiny,
                        normal)
    w = torch.from_numpy(randn(14, (k, 32))) / math.sqrt(k)
    for a in (mixed, tiny):
        exact = a.double() @ w.double()
        err = (split6_product(a, w).double() - exact).abs()
        if a is mixed:
            bound = _dot_bound(a, w)
            assert bool((err <= bound).all())
            assert bool(((a @ w).double() - exact).abs().le(bound).all())
        else:
            assert float(err.max()) <= k * 2.0 ** -134 * float(w.abs().max())


@pytest.mark.parametrize("k", [128, 768, 3072])
def test_split6_product_matches_float64(k):
    """The mirrored product is an f32 product in accuracy: within the f32 dot
    product's rounding bound of a float64 product at every output, and its
    relative error at most F32_SPLIT_ERR times the plain f32 product's."""
    a = torch.from_numpy(randn(k, (96, k)))
    w = torch.from_numpy(randn(k + 1, (k, 80))) / math.sqrt(k)
    exact = a.double() @ w.double()
    got = split6_product(a, w)
    assert bool(((got.double() - exact).abs() <= _dot_bound(a, w)).all())
    assert _rel_err(got, exact) <= F32_SPLIT_ERR * _rel_err(a @ w, exact)


@pytest.mark.parametrize("dropped", [f"pass {p}" for p in range(len(SPLIT6_PASSES))]
                         + ["lo planes"])
def test_float64_check_needs_every_part(dropped):
    """Phase 3n's float64 check is sharp enough to see any one of the six
    passes left out, or both lo planes zeroed (kernel_variants.py f32 plants
    such faults in the kernel): each error exceeds F32_SPLIT_ERR times the
    plain f32 product's."""
    k = 768
    a = torch.from_numpy(randn(21, (96, k)))
    w = torch.from_numpy(randn(22, (k, 80))) / math.sqrt(k)
    exact = a.double() @ w.double()
    pa = [t.float() for t in split_bf16x3(a)]
    pw = [t.float() for t in split_bf16x3(w)]
    if dropped == "lo planes":
        pa[2], pw[2] = torch.zeros_like(pa[2]), torch.zeros_like(pw[2])
        passes = SPLIT6_PASSES
    else:
        passes = [p for i, p in enumerate(SPLIT6_PASSES) if i != int(dropped.split()[1])]
    faulty = sum(pa[i] @ pw[j] for i, j in passes)
    assert _rel_err(faulty, exact) > F32_SPLIT_ERR * _rel_err(a @ w, exact)


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_layer_on_the_mirror_matches_jax_f32(masked, monkeypatch):
    """Two DeiT-S layers (D 384, 6 heads of 64, MLP 1536) at batch 2, S 197,
    B1's plain version with its four products on the mirror, against the JAX
    package's f32 fused_vit_layer (Pallas, interpret mode), layer after
    layer; masked rows are don't-care."""
    cfg = deit_small(num_labels=10).replace(num_layers=2)
    params = init_vit_params(jax.random.PRNGKey(3), cfg)
    x = randn(4, (2, cfg.seq_len, cfg.hidden_size))
    mask = np.random.RandomState(5).rand(2, cfg.seq_len) > 0.3
    mask[:, 0] = True
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.from_numpy(mask) if masked else None
    monkeypatch.setattr(tl, "_linear_f32",
                        lambda a, w, b: split6_product(a.float(), w.float()) + b.float())
    yt, yj = as_torch(x), jnp.asarray(x)
    for i in range(cfg.num_layers):
        jlp, tlp = jax_and_torch_params(jax.tree.map(lambda t: t[i], params["layers"]))
        yt = tl.fused_vit_layer_ref(yt, tlp, cfg.num_heads, cfg.layernorm_eps, tmask)
        yj = fused_vit_layer(yj, jlp, cfg.num_heads, eps=cfg.layernorm_eps, token_mask=jmask,
                             interpret=True)
    rows = mask if masked else np.ones_like(mask)
    err = np.abs(as_numpy(yt) - np.asarray(yj))[rows]
    assert np.isfinite(err).all() and err.max() < F32_ATOL, err.max()


@pytest.mark.parametrize("act, residual, lda", [("none", False, None), ("gelu_erf", True, 200),
                                               ("gelu_tanh", True, None)])
def test_gemm_f32_plain_version(act, residual, lda):
    """ops/cuda/gemm.py::gemm_f32 on CPU tensors (its plain version, what the
    card's split body is held to in phase 3n) against a float64 product with
    the epilogue, and the inputs it refuses: N no multiple of 8 (W's planes
    are a TMA operand), bf16 operands."""
    from vit_pruning_tpu_torch.ops.cuda import gemm as kg

    m, k, n = 37, 136, 48
    a = torch.from_numpy(randn(31, (m, lda or k)))[:, :k]
    w = torch.from_numpy(randn(32, (k, n))) / math.sqrt(k)
    b = torch.from_numpy(randn(33, (n,)))
    r = torch.from_numpy(randn(34, (m, n))) if residual else None
    got = kg.gemm_f32(a, w, b, act, r)
    ref = a.double() @ w.double() + b.double()
    if act != "none":
        ref = torch.nn.functional.gelu(ref, approximate="tanh" if act == "gelu_tanh" else "none")
    if r is not None:
        ref = ref + r.double()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert float((got.double() - ref).abs().max()) < 1e-5
    with pytest.raises(ValueError, match="multiple of 8"):
        kg.gemm_f32(a, w[:, :44].contiguous())
    with pytest.raises(ValueError, match="float32"):
        kg.gemm_f32(a.bfloat16(), w.bfloat16())
