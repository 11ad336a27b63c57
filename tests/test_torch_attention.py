"""Kernel B6 (ops/cuda/attention.py) and the port's mha with head_mask,
return_probs and use_kernel, against the JAX package on the CPU.

B6's plain version is held to the Pallas kernel in interpret mode: f32
atol 1e-5 on the rows of valid tokens (masked rows are garbage by
contract), bf16 within one bf16 step of the output's magnitude (both do
every operation in f32 and round once, at the end; the sums run in another
order). mha is held to the JAX mha in f32 at atol 2e-5, as
tests/test_torch_vit.py does.

The kernel's tensor-core body (bf16 operands) runs only on the card; its
arithmetic is held here through a torch emulation (tests/torch_parity.py):
the split of softmax probabilities into three bf16 parts gives them back
bit for bit, and the emulated body (keys in chunks of 64, the row max and
sum in a first pass, P normalised in a second, PV as three bf16 passes
over its split) is held to the Pallas kernel at the same tolerances, on
bf16-valued operands, and to B6's plain version on every row.

f32 operands (and bf16 ones whose hd is no multiple of 8) run the split
body (csrc/split_attention.cuh): q, k, v and P split into exact bf16
planes, both products as six bf16 passes. Its emulation
(torch_parity.split_attention_emulated) is held to the Pallas kernel at
f32 atol 1e-5 on the valid rows at hd 8-128 and S 1-289, and to a float64
attention: its error is no larger than the plain f32 version's, a check
that fails when any one pass of either product, or the lo planes, is
left out.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_pruning_tpu.ops.pallas.attention as pallas_attention
from torch_parity import (
    SPLIT6_PASSES, as_numpy, as_torch, fused_attention_emulated, jax_and_torch_params, randn,
    split_attention_emulated, split_bf16x3)
from vit_pruning_tpu.configs import vit_tiny
from vit_pruning_tpu.models.vit import init_vit_params
from vit_pruning_tpu.ops.attention import mha as jax_mha
from vit_pruning_tpu_torch.ops.attention import mha
from vit_pruning_tpu_torch.ops.cuda import attention as ta
from vit_pruning_tpu_torch.ops.dispatch import kernel_mode


def bf16_step(ref: np.ndarray) -> float:
    """One bf16 step at the largest magnitude of `ref`."""
    return 2.0 ** (math.floor(math.log2(max(float(np.abs(ref).max()), 1e-30))) - 7)


def _qkv_mask(seed: int, shape=(2, 3, 29, 32)):
    q, k, v = (randn(seed + i, shape) for i in range(3))
    mask = np.random.RandomState(seed + 3).rand(shape[0], shape[2]) > 0.4
    mask[:, 0] = True
    return q, k, v, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_ref_matches_pallas(masked, dtype):
    q, k, v, mask = _qkv_mask(0)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv = (jnp.asarray(t).astype(jdt) for t in (q, k, v))
    want = np.asarray(pallas_attention.fused_attention(
        jq, jk, jv, jnp.asarray(mask) if masked else None, interpret=True).astype(jnp.float32))
    got = as_numpy(ta.fused_attention_ref(
        *(as_torch(np.array(t.astype(jnp.float32)), tdt) for t in (jq, jk, jv)),
        torch.from_numpy(mask) if masked else None))
    rows = mask[:, None, :, None] if masked else np.ones_like(mask)[:, None, :, None]
    err = np.abs(got - want) * rows
    assert err.max() <= (1e-5 if dtype == "float32" else bf16_step(want)), err.max()


def test_fused_attention_on_cpu_runs_plain_version_without_launching():
    q, k, v, mask = _qkv_mask(4, (2, 2, 17, 16))
    q, k, v = (as_torch(t) for t in (q, k, v))
    before = ta.fused_attention.launches
    got = ta.fused_attention(q, k, v, torch.from_numpy(mask))
    torch.testing.assert_close(got, ta.fused_attention_ref(q, k, v, torch.from_numpy(mask)),
                               rtol=0, atol=0)
    assert ta.fused_attention.launches == before
    with kernel_mode("kernel"):
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            ta.fused_attention(q, k, v)


def _attn_params():
    cfg = vit_tiny()
    params = init_vit_params(jax.random.PRNGKey(0), cfg)
    attn = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    # nonzero biases: the init leaves them 0, which would hide a bias bug
    attn = jax.tree.map(lambda a: a + 0.05 if a.ndim == 1 else a, attn)
    jattn, tattn = jax_and_torch_params(attn)
    x = randn(1, (4, 17, cfg.hidden_size))
    mask = np.random.RandomState(2).rand(4, 17) > 0.3
    mask[:, 0] = True
    return cfg, jattn, tattn, x, mask


@pytest.mark.parametrize("hm_shape", ["H", "BH"])
def test_mha_head_mask_matches_jax(hm_shape):
    cfg, jattn, tattn, x, mask = _attn_params()
    rs = np.random.RandomState(5)
    shape = (cfg.num_heads,) if hm_shape == "H" else (4, cfg.num_heads)
    hm = (rs.rand(*shape) > 0.5).astype(np.float32) * rs.rand(*shape).astype(np.float32)
    got = mha(as_torch(x), tattn, cfg.num_heads, token_mask=torch.from_numpy(mask),
              head_mask=as_torch(hm))
    want = jax_mha(jnp.asarray(x), jattn, cfg.num_heads, token_mask=jnp.asarray(mask),
                   head_mask=jnp.asarray(hm))
    np.testing.assert_allclose(as_numpy(got), np.asarray(want), atol=2e-5)


def test_mha_return_probs_matches_jax():
    cfg, jattn, tattn, x, mask = _attn_params()
    hm = np.array([1.0, 0.0, 0.5, 1.0], np.float32)
    out, probs = mha(as_torch(x), tattn, cfg.num_heads, token_mask=torch.from_numpy(mask),
                     head_mask=as_torch(hm), return_probs=True)
    jout, jprobs = jax_mha(jnp.asarray(x), jattn, cfg.num_heads, token_mask=jnp.asarray(mask),
                           head_mask=jnp.asarray(hm), return_probs=True)
    assert probs.shape == (4, cfg.num_heads, 17, 17)
    np.testing.assert_allclose(as_numpy(probs), np.asarray(jprobs), atol=1e-6)
    np.testing.assert_allclose(as_numpy(out), np.asarray(jout), atol=2e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_mha_use_kernel_matches_jax_pallas_route(masked, monkeypatch):
    """mha(use_kernel=True) on a CPU tensor runs B6's plain version; the JAX
    mha(use_pallas=True) runs the Pallas kernel, here in interpret mode."""
    cfg, jattn, tattn, x, mask = _attn_params()
    monkeypatch.setattr(pallas_attention, "fused_attention",
                        functools.partial(pallas_attention.fused_attention, interpret=True))
    tm = torch.from_numpy(mask) if masked else None
    wrapper, calls = ta.fused_attention, []
    monkeypatch.setattr(ta, "fused_attention", lambda *a: calls.append(a) or wrapper(*a))
    before = wrapper.launches
    got = mha(as_torch(x), tattn, cfg.num_heads, token_mask=tm, use_kernel=True)
    want = jax_mha(jnp.asarray(x), jattn, cfg.num_heads,
                   token_mask=jnp.asarray(mask) if masked else None, use_pallas=True)
    rows = mask[..., None] if masked else 1.0
    assert (np.abs(as_numpy(got) - np.asarray(want)) * rows).max() < 1e-5
    assert len(calls) == 1 and wrapper.launches == before  # B6's wrapper, its plain version
    mha(as_torch(x), tattn, cfg.num_heads, token_mask=tm, head_mask=torch.ones(4),
        use_kernel=True)
    assert len(calls) == 1  # the probabilities are asked for: the plain route


def test_split_bf16x3_reconstructs_probabilities_bit_for_bit():
    """Softmax rows over logits spread wide (probabilities down to ~1e-30)
    split into three bf16 parts that sum back to P exactly."""
    rs = np.random.RandomState(9)
    logits = torch.from_numpy((rs.randn(64, 257) * 12.0).astype(np.float32))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    p = p[p > 1e-30]
    hi, mid, lo = split_bf16x3(p)
    assert torch.equal((hi.float() + mid.float()) + lo.float(), p)
    assert torch.equal(hi.double() + mid.double() + lo.double(), p.double())


@pytest.mark.parametrize("shape", [(2, 3, 29, 32), (2, 2, 130, 16)])
@pytest.mark.parametrize("masked", ["none", "mask", "empty_image"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_attention_emulated_split_matches_pallas(shape, masked, dtype):
    """The tensor-core body's arithmetic against the Pallas kernel on the
    rows of valid tokens, and against B6's plain version on every row (an
    image whose keys are all masked attends uniformly); S 130 takes three
    chunks of 64 keys, the last one padded."""
    q, k, v, mask = _qkv_mask(7, shape)
    if masked == "empty_image":
        mask[0] = False
    q, k, v = (np.array(jnp.asarray(t).astype(jnp.bfloat16).astype(jnp.float32))
               for t in (q, k, v))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jm = None if masked == "none" else jnp.asarray(mask)
    tmask = None if masked == "none" else torch.from_numpy(mask)
    want = np.asarray(pallas_attention.fused_attention(
        *(jnp.asarray(t).astype(jdt) for t in (q, k, v)), jm, interpret=True).astype(jnp.float32))
    tq, tk, tv = (as_torch(t, tdt) for t in (q, k, v))
    got = fused_attention_emulated(tq, tk, tv, tmask)
    plain = as_numpy(ta.fused_attention_ref(tq, tk, tv, tmask))
    assert got.dtype == tdt
    got = as_numpy(got)
    rows = np.ones_like(mask) if masked == "none" else mask
    tol = 1e-5 if dtype == "float32" else bf16_step(want)
    assert (np.abs(got - want) * rows[:, None, :, None]).max() <= tol
    assert np.abs(got - plain).max() <= (1e-5 if dtype == "float32" else bf16_step(plain))


def test_corrected_reciprocal_quotient_is_the_division():
    """B6's tensor-core body forms P = e / sum as q = e rc, then q + (e - q
    sum) rc, with rc = RN(1 / sum) and the last two steps FMAs (Markstein's
    correction): the correctly rounded quotient, the division's, for every
    normal quotient. Emulated in float64, where each product of two f32
    values is exact, over the kernel's range: e = exp(l - max) in (0, 1],
    sum in [1, 257]."""
    rs = np.random.RandomState(3)
    e = np.exp(-rs.uniform(0.0, 80.0, 200_000)).astype(np.float32)
    s = (1.0 + rs.uniform(0.0, 256.0, e.size)).astype(np.float32)
    rc = (1.0 / s.astype(np.float64)).astype(np.float32)
    q = (e.astype(np.float64) * rc).astype(np.float32)
    r = (e.astype(np.float64) - q.astype(np.float64) * s).astype(np.float32)
    got = (r.astype(np.float64) * rc + q).astype(np.float32)
    assert np.array_equal(got, e / s)


@pytest.mark.parametrize("s", [1, 17, 65, 130, 257, 289])
@pytest.mark.parametrize("hd", [8, 24, 64, 80, 128])
@pytest.mark.parametrize("masked", ["none", "mask", "empty_image"])
def test_split_attention_emulated_matches_pallas(masked, hd, s):
    """B6's f32 route on the split body against the Pallas kernel on the
    rows of valid tokens: one key, a partial chunk, one past a query tile,
    three chunks, ViT-H's 257 and one past 288; hd 8 and 24 (a box wider
    than the head, hd % 16 != 0), 64, 80 and 128 (two boxes: the streamed
    body at any S)."""
    q, k, v, mask = _qkv_mask(11 + hd + s, (2, 2, s, hd))
    if masked == "empty_image":
        mask[0] = False
    jm = None if masked == "none" else jnp.asarray(mask)
    want = np.asarray(pallas_attention.fused_attention(
        *(jnp.asarray(t) for t in (q, k, v)), jm, interpret=True))
    got = split_attention_emulated(*(as_torch(t) for t in (q, k, v)),
                                   None if masked == "none" else torch.from_numpy(mask))
    rows = np.ones_like(mask) if masked == "none" else mask
    assert (np.abs(as_numpy(got) - want) * rows[:, None, :, None]).max() <= 1e-5


@pytest.mark.parametrize("shape", [(2, 3, 65, 20), (2, 2, 130, 12)])
def test_split_attention_emulated_bf16_matches_pallas(shape):
    """B6's bf16 operands at a head dim its wgmma body does not take: the
    split body with q, k, v their own hi planes (QK^T the hi.hi pass, PV
    P's three planes on V), within one bf16 step of the Pallas kernel."""
    q, k, v, mask = _qkv_mask(5, shape)
    jq, jk, jv = (jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v))
    want = np.asarray(pallas_attention.fused_attention(
        jq, jk, jv, jnp.asarray(mask), interpret=True).astype(jnp.float32))
    got = split_attention_emulated(*(as_torch(t, torch.bfloat16) for t in (q, k, v)),
                                   torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    assert (np.abs(as_numpy(got) - want) * mask[:, None, :, None]).max() <= bf16_step(want)


def _float64_case(hd: int, s: int):
    """q, k, v [2, 2, s, hd] (logits of unit spread), a mask with one image
    all masked"""
    q, k, v, mask = _qkv_mask(40 + hd, (2, 2, s, hd))
    mask[1] = False
    return (*(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(mask))


def _float64_errors(q, k, v, mask, normalized, **faults):
    """(the emulated body's, the plain f32 version's) largest error against
    the attention in float64: B6's plain version (normalised) or B1's
    staged2 core"""
    logits = (q.double() @ k.double().transpose(-1, -2)) / math.sqrt(q.shape[-1])
    logits = torch.where(mask[:, None, None, :], logits, torch.tensor(-1e30, dtype=torch.float64))
    exact = torch.softmax(logits, -1) @ v.double()
    if normalized:
        plain = ta.fused_attention_ref(q, k, v, mask)
    else:
        from vit_pruning_tpu_torch.ops.cuda import layer as tl

        b, h, s, hd = q.shape
        merged = [t.transpose(1, 2).reshape(b, s, h * hd) for t in (q, k, v)]
        plain = tl.staged2_attention(*merged, h, mask).reshape(b, s, h, hd).transpose(1, 2)
    got = split_attention_emulated(q, k, v, mask, normalized=normalized, **faults)
    return (float((got.double() - exact).abs().max()), float((plain.double() - exact).abs().max()))


@pytest.mark.parametrize("hd, s", [(16, 65), (64, 130), (64, 197), (80, 257), (128, 289)])
@pytest.mark.parametrize("normalized", [False, True], ids=["staged2", "normalised"])
def test_split_attention_within_f32_rounding(hd, s, normalized):
    """The emulated body is an f32 attention in accuracy: against a float64
    attention its largest error is no larger than the plain f32 version's
    (resident and streamed bodies, staged2 and normalised)."""
    err, plain = _float64_errors(*_float64_case(hd, s), normalized)
    assert err <= plain


@pytest.mark.parametrize("normalized", [False, True], ids=["staged2", "normalised"])
@pytest.mark.parametrize("dropped", [f"{prod} pass {p}" for prod in ("qk", "pv")
                                     for p in range(len(SPLIT6_PASSES))] + ["lo planes"])
def test_float64_check_needs_every_pass(dropped, normalized):
    """The float64 check above is sharp enough to see any one of the six
    passes of QK^T or of PV left out, or the lo planes of q, k and v zeroed
    (kernel_variants.py's `faults` plants such faults in the kernel): each
    error exceeds the plain f32 version's."""
    faults = {"lo_planes": False}
    if dropped != "lo planes":
        prod, _, p = dropped.split()
        kept = [x for i, x in enumerate(SPLIT6_PASSES) if i != int(p)]
        faults = {"passes": kept, "pv_passes": SPLIT6_PASSES} if prod == "qk" else {
            "pv_passes": kept}
    err, plain = _float64_errors(*_float64_case(64, 130), normalized, **faults)
    assert err > plain
