"""Kernel B7 (ops/cuda/mlp.py) and mlp_block's kernel route against the JAX
package on the CPU.

B7's plain version is held to the Pallas kernel in interpret mode, in both
of its variants (resident weights, and M-blocked with an f32 accumulator:
block_m 512 with M > 512): f32 atol 2e-5 / rtol 1e-4 (tests/test_pallas.py's
tolerance for the same kernel: sums in another order, and the Pallas erf is
a polynomial within 1.5e-7 of the true erf the port uses), bf16 within one
bf16 step of the output's magnitude (every operation in f32, one rounding
at the end in both).

The kernel's tensor-core body (bf16 operands) runs only on the card; its
arithmetic is held here through a torch emulation (tests/torch_parity.py):
the split of an f32 value into three bf16 parts must give the value back
bit for bit, and the emulated body (the hidden dimension in chunks of 64,
the second product as three bf16 passes over the split GELU output) is
held to the Pallas kernel at the same tolerances, on bf16-valued operands.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_pruning_tpu.ops.pallas.mlp as pallas_mlp
from torch_parity import as_numpy, as_torch, fused_mlp_emulated, randn, split_bf16x3
from vit_pruning_tpu.models.vit import mlp_block as jax_mlp_block
from vit_pruning_tpu_torch.models.vit import mlp_block
from vit_pruning_tpu_torch.ops.cuda import mlp as tm
from vit_pruning_tpu_torch.ops.dispatch import kernel_mode


def bf16_step(ref: np.ndarray) -> float:
    return 2.0 ** (math.floor(math.log2(max(float(np.abs(ref).max()), 1e-30))) - 7)


def _mlp_inputs(t: int, d: int, m: int, seed: int = 0):
    x = randn(seed, (t, d))
    w1 = randn(seed + 1, (d, m)) * 0.05
    b1 = randn(seed + 2, (m,)) * 0.05
    w2 = randn(seed + 3, (m, d)) * 0.05
    b2 = randn(seed + 4, (d,)) * 0.1
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("variant", ["resident", "blocked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_ref_matches_pallas(variant, dtype):
    t, d, m, block_m = (37, 64, 128, 0) if variant == "resident" else (50, 64, 1100, 512)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jargs = [jnp.asarray(a).astype(jdt) for a in _mlp_inputs(t, d, m)]
    want = np.asarray(pallas_mlp.fused_mlp(*jargs, block_m=block_m, interpret=True)
                      .astype(jnp.float32))
    got = as_numpy(tm.fused_mlp_ref(*(as_torch(np.array(a.astype(jnp.float32)), tdt)
                                      for a in jargs)))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)
    else:
        assert np.abs(got - want).max() <= bf16_step(want)


def test_fused_mlp_on_cpu_runs_plain_version_without_launching():
    args = [as_torch(a) for a in _mlp_inputs(9, 16, 40, seed=7)]
    before = tm.fused_mlp.launches
    torch.testing.assert_close(tm.fused_mlp(*args), tm.fused_mlp_ref(*args), rtol=0, atol=0)
    assert tm.fused_mlp.launches == before
    with kernel_mode("kernel"):
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tm.fused_mlp(*args)


def test_mlp_block_kernel_route_matches_jax_pallas_route(monkeypatch):
    """mlp_block(use_kernel=True) reshapes [B, S, D] to rows for B7 (its plain
    version on the CPU), as the JAX mlp_block(use_pallas=True) does for the
    Pallas kernel (interpret mode here)."""
    x, w1, b1, w2, b2 = _mlp_inputs(2 * 17, 64, 128, seed=3)
    x = x.reshape(2, 17, 64)
    jp = {"fc1": {"w": jnp.asarray(w1), "b": jnp.asarray(b1)},
          "fc2": {"w": jnp.asarray(w2), "b": jnp.asarray(b2)}}
    tp = {n: {k: as_torch(np.array(v)) for k, v in p.items()} for n, p in jp.items()}
    monkeypatch.setattr(pallas_mlp, "fused_mlp",
                        functools.partial(pallas_mlp.fused_mlp, interpret=True))
    wrapper, calls = tm.fused_mlp, []
    monkeypatch.setattr(tm, "fused_mlp", lambda *a: calls.append(a) or wrapper(*a))
    got = mlp_block(as_torch(x), tp, use_kernel=True)
    want = jax_mlp_block(jnp.asarray(x), jp, use_pallas=True)
    assert len(calls) == 1 and calls[0][0].shape == (34, 64)
    np.testing.assert_allclose(as_numpy(got), np.asarray(want), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("exponents", [(-30, -10), (-10, 10), (10, 30)])
def test_split_bf16x3_reconstructs_f32_bit_for_bit(exponents):
    """hi + mid + lo == a exactly, for |a| log-uniform in [1e-30, 1e30] and
    both signs: in f32 (hi + mid first) and in float64."""
    rs = np.random.RandomState(abs(exponents[0]))
    mag = 10.0 ** rs.uniform(*exponents, 8192)
    a = torch.from_numpy((mag * rs.choice([-1.0, 1.0], mag.size)).astype(np.float32))
    hi, mid, lo = split_bf16x3(a)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    assert torch.equal((hi.float() + mid.float()) + lo.float(), a)
    assert torch.equal(hi.double() + mid.double() + lo.double(), a.double())
    # each part is at most half a unit of the last place of the one before
    big = hi.float() != 0
    assert bool((mid.float().abs()[big] <= hi.float().abs()[big] * 2.0 ** -8).all())


def test_split_bf16x3_special_values():
    """Zeros stay zero; an infinity stays in hi with mid = lo = 0, so that
    a product with it is what the plain f32 product gives; a NaN stays."""
    a = torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan, 1.0, -3.0])
    hi, mid, lo = (t.float() for t in split_bf16x3(a))
    assert torch.equal(hi[:4], a[:4]) and torch.equal(mid[:4], torch.zeros(4))
    assert torch.equal(lo[:4], torch.zeros(4))
    assert bool(torch.isnan(hi[4]))
    assert torch.equal(hi[5:], a[5:]) and not bool(mid[5:].any()) and not bool(lo[5:].any())


@pytest.mark.parametrize("shape", [(37, 64, 128), (50, 64, 200)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_mlp_emulated_split_matches_pallas(shape, dtype):
    """The tensor-core body's arithmetic against the Pallas kernel: bf16
    operands (in float32, bf16 values held in f32, so the result keeps f32
    precision); M 200 ends in a partial chunk of 64."""
    t, d, m = shape
    args = [np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
            for a in _mlp_inputs(t, d, m, seed=11)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    want = np.asarray(pallas_mlp.fused_mlp(*(jnp.asarray(a).astype(jdt) for a in args),
                                           interpret=True).astype(jnp.float32))
    got = fused_mlp_emulated(*(as_torch(a, tdt) for a in args))
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(as_numpy(got), want, atol=2e-5, rtol=1e-4)
    else:
        assert np.abs(as_numpy(got) - want).max() <= bf16_step(want)
