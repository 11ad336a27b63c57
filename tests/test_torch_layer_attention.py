"""The attention of kernels B1, B3, B4 and B5 at the edges of its CUDA body
(vit_pruning_tpu_torch/csrc/layer_attention.cu), on the CPU.

The bf16 body takes 64-query tiles of one head and 64-key chunks, keeps the
logits in registers up to 256 keys and streams K and V past it (the old
body's limit was 288). Here the plain versions the card holds it against
(ops/cuda/layer.py::staged2_attention, B1's, B3's and B5's) are held to the
JAX package's Pallas kernels in interpret mode at every such edge, S in
{63, 64, 65, 128, 129, 197, 256, 257, 288, 289}, at head dim 80 (a narrow
ViT-H: D 160, 2 heads; two boxes of 64 columns on the card) and at a few
of them at head dim 16 (vit_tiny: D 64, 4 heads; a box wider than the
head), with a mask that blanks the whole chunk of keys 64-127 and one image
whose keys are all masked, and B3's per-image counts. Every row is
compared, masked ones included. Each case retraces the Pallas kernel
(~1-3 s), so the cases are chosen, not crossed.

The Pallas kernels pad S to a multiple of 8 and mask the padded keys like
masked ones (-1e30), so an image whose keys are all masked averages the
padded keys too there; the reference (the jnp layer) and the port average
the S real keys. That image is held to the jnp layer, and to the Pallas
kernel only where S is a multiple of 8.

The f32 attention runs csrc/split_attention.cuh's body on the card: q, k, v
and P split into exact bf16 planes, both products as six bf16 passes. Its
arithmetic, emulated by tests/torch_parity.py::split_attention_emulated, is
held to the Pallas kernels' attention core (the context B1 or B5 adds to x
when O is the identity and the MLP zero) at head dims 16, 32 (the gate
model: D 128, 4 heads), 64 (a narrow DeiT-S: D 128, 2 heads) and 80 and S
65, 257 and 289, and to B3's with per-image counts, at f32 atol 2e-5.

Tolerances: tests/test_pallas.py's (f32 atol 2e-5 for B1; B5 1e-4, as
tests/test_torch_head_dims.py holds it; B3 5e-5 + rtol 1e-4); bf16: two
bf16 steps at the output's largest magnitude (the sums run in another
order, so a value may land on the neighbouring bf16 number in an
intermediate and in the output).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_numpy, as_torch, jax_and_torch_params, randn, split_attention_emulated
from vit_pruning_tpu.configs import ViTConfig, deit_small, vit_huge, vit_tiny
from vit_pruning_tpu.models.vit import init_vit_params, vit_layer
from vit_pruning_tpu.ops.pallas.layer import fused_vit_layer, fused_vit_layer_bucketed
from vit_pruning_tpu.ops.pallas.model import fused_vit_encoder
from vit_pruning_tpu_torch.configs import (
    deit_small as t_deit_small,
    vit_base_patch16_224 as t_vit_base,
    vit_huge as t_vit_huge,
    vit_tiny as t_vit_tiny,
)
from vit_pruning_tpu_torch.ops.cuda import layer as tl
from vit_pruning_tpu_torch.ops.cuda import model as tmod
from vit_pruning_tpu_torch.ops.masking import compact_dest

F32_ATOL = 2e-5
ENCODER_ATOL = 1e-4
BUCKETED_ATOL, BUCKETED_RTOL = 5e-5, 1e-4
EDGES = (63, 64, 65, 128, 129, 197, 256, 257, 288, 289)
GEOMETRIES = {  # head dim -> config
    16: vit_tiny(num_labels=10),
    32: ViTConfig(image_size=32, patch_size=4, hidden_size=128, num_layers=3, num_heads=4,
                  mlp_dim=256, num_labels=10),  # the quality gate model
    64: deit_small(num_labels=10).replace(hidden_size=128, num_heads=2, mlp_dim=256),
    80: vit_huge(num_labels=10).replace(hidden_size=160, num_heads=2, mlp_dim=320),
}
BATCH = 3
ALL_MASKED = 1  # the image whose keys are all masked


def _cases(*groups):
    """pytest params (hd, s, ...) from (hd, lengths, extra...) groups."""
    return [pytest.param(hd, s, *extra, id="-".join(map(str, (hd, s, *extra))))
            for hd, lengths, *extra in groups for s in lengths]


def _bf16_tol(ref: np.ndarray) -> float:
    return 2.0 * 2.0 ** (np.floor(np.log2(max(float(np.abs(ref).max()), 1e-30))) - 7)


@functools.lru_cache(maxsize=None)
def _layers(hd: int, n: int = 1):
    """The first n layers (stacked) of the geometry, with random LN gains /
    biases and linear biases (the init leaves them 1 and 0)."""
    cfg = GEOMETRIES[hd]
    layers = init_vit_params(jax.random.PRNGKey(hd), cfg.replace(num_layers=n))["layers"]
    rs = np.random.RandomState(hd)
    for path in (("ln1", "g"), ("ln1", "b"), ("ln2", "g"), ("ln2", "b"), ("attn", "q", "b"),
                 ("attn", "k", "b"), ("attn", "v", "b"), ("attn", "o", "b"), ("mlp", "fc1", "b"),
                 ("mlp", "fc2", "b")):
        node = layers
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = node[path[-1]] + 0.1 * rs.randn(*node[path[-1]].shape).astype(np.float32)
    return cfg, layers


def _edge_mask(s: int, seed: int = 2) -> np.ndarray:
    """[BATCH, s]: 70% of the keys with CLS, the chunk 64-127 blanked where
    S reaches it, image ALL_MASKED with every key masked."""
    m = np.random.RandomState(seed).rand(BATCH, s) > 0.3
    m[:, 0] = True
    m[:, 64:128] = False
    m[ALL_MASKED] = False
    return m


def _pallas_rows(s: int, mask) -> np.ndarray:
    """The images the Pallas kernels compute as the reference does (all but
    the all-masked image where S needs padding)."""
    rows = np.ones(BATCH, bool)
    if mask is not None and s % 8:
        rows[ALL_MASKED] = False
    return rows


@pytest.mark.parametrize("hd, s, masked", _cases(
    (80, EDGES, True), (16, (63, 65, 257, 289), True), (80, (64, 257), False)))
def test_b1_plain_matches_pallas_at_the_edges(hd, s, masked):
    cfg, layers = _layers(hd)
    jlp, tlp = jax_and_torch_params(jax.tree.map(lambda a: a[0], layers))
    x = randn(s, (BATCH, s, cfg.hidden_size))
    mask = _edge_mask(s) if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    got = as_numpy(tl.fused_vit_layer_ref(as_torch(x), tlp, cfg.num_heads, cfg.layernorm_eps,
                                          None if mask is None else torch.from_numpy(mask)))
    kernel = np.asarray(fused_vit_layer(jnp.asarray(x), jlp, cfg.num_heads,
                                        eps=cfg.layernorm_eps, token_mask=jmask, interpret=True))
    ref = np.asarray(vit_layer(jnp.asarray(x), jlp, cfg, token_mask=jmask, use_pallas=False,
                               quant="none"))
    rows = _pallas_rows(s, mask)
    assert np.abs(got - kernel)[rows].max() < F32_ATOL
    assert np.abs(got - ref).max() < F32_ATOL


@pytest.mark.parametrize("hd, s", _cases((80, EDGES), (16, (65, 257))))
def test_b1_plain_matches_pallas_at_the_edges_bf16(hd, s):
    cfg, layers = _layers(hd)
    jlp, tlp = jax_and_torch_params(jax.tree.map(lambda a: a[0], layers), jnp.bfloat16)
    x = randn(s + 1, (BATCH, s, cfg.hidden_size))
    mask = _edge_mask(s)
    got = as_numpy(tl.fused_vit_layer_ref(as_torch(x, torch.bfloat16), tlp, cfg.num_heads,
                                          cfg.layernorm_eps, torch.from_numpy(mask)))
    want = fused_vit_layer(jnp.asarray(x, jnp.bfloat16), jlp, cfg.num_heads,
                           eps=cfg.layernorm_eps, token_mask=jnp.asarray(mask), interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    rows = _pallas_rows(s, mask)
    assert np.abs(got - want)[rows].max() <= _bf16_tol(want)


@pytest.mark.parametrize("hd, s", _cases((80, (63, 65, 129, 256, 257, 289)), (16, (64, 257))))
def test_b5_plain_matches_pallas_at_the_edges(hd, s):
    """One layer of B5's normalised attention, masked as the edges want."""
    cfg, layers = _layers(hd)
    jl, tlr = jax_and_torch_params(layers)
    x = randn(s + 2, (BATCH, s, cfg.hidden_size))
    mask = _edge_mask(s)
    want = np.asarray(fused_vit_encoder(jnp.asarray(x), jl, cfg.num_heads, eps=cfg.layernorm_eps,
                                        token_mask=jnp.asarray(mask), interpret=True))
    got = as_numpy(tmod.fused_vit_encoder_ref(as_torch(x), tlr, cfg.num_heads, cfg.layernorm_eps,
                                              torch.from_numpy(mask)))
    assert np.abs(got - want)[_pallas_rows(s, mask)].max() <= ENCODER_ATOL


@pytest.mark.parametrize("hd, cap", _cases((80, (65, 257)), (16, (64, 289))))
def test_b3_plain_with_counts_matches_pallas_at_the_edges(hd, cap):
    """B3 at a capacity on each edge: the attention runs at S = cap with the
    keys past each image's kept count masked (counts 1, cap and one between)."""
    cfg, layers = _layers(hd)
    jlp, tlp = jax_and_torch_params(jax.tree.map(lambda a: a[0], layers))
    s = cap + 7
    x = randn(cap, (BATCH, s, cfg.hidden_size))
    rs = np.random.RandomState(cap)
    kept = np.zeros((BATCH, s), bool)
    kept[:, 0] = True
    for i, count in enumerate((cap, 1, cap // 2 + 3)):  # a full bucket, CLS alone, between
        kept[i, 1 + rs.permutation(s - 1)[:count - 1]] = True
    dest = compact_dest(torch.from_numpy(kept))
    got = as_numpy(tl.fused_vit_layer_bucketed_ref(as_torch(x), tlp, dest, torch.from_numpy(kept),
                                                   cap, cfg.num_heads, cfg.layernorm_eps))
    want = np.asarray(fused_vit_layer_bucketed(
        jnp.asarray(x), jlp, jnp.asarray(dest.numpy()), jnp.asarray(kept), cap, cfg.num_heads,
        eps=cfg.layernorm_eps, interpret=True))
    np.testing.assert_allclose(got, want, atol=BUCKETED_ATOL, rtol=BUCKETED_RTOL)
    np.testing.assert_array_equal(got[~kept], x[~kept])


def _identity_tail(layers):
    """The layers with O = I (no bias) and the MLP zeroed: the layer (and the
    one-layer encoder) then returns x + ctx, the attention core itself."""
    d = layers["attn"]["o"]["w"].shape[-1]
    out = jax.tree.map(lambda a: a, layers)
    out["attn"]["o"] = {"w": jnp.eye(d)[None], "b": jnp.zeros((1, d))}
    out["mlp"] = jax.tree.map(jnp.zeros_like, layers["mlp"])
    return out


@pytest.mark.parametrize("hd, s, normalized, dtype", _cases(
    *((80, (65, 257), norm, dt) for norm in (False, True) for dt in ("float32", "bfloat16")),
    (16, (257,), False, "float32"), (16, (257,), True, "float32")))
def test_staged2_attention_is_the_pallas_kernels_core(hd, s, normalized, dtype):
    """staged2_attention (staged2: B1's numerics; normalized: B5's) against
    the context the Pallas kernel (B1's, or B5's on one layer) adds to x when
    O is the identity and the MLP is zero. x is small (1e-5) so that in bf16
    x + ctx rounds to ctx; q, k, v are the kernels' (LN, then the products
    in f32, rounded to the dtype)."""
    want, q, k, v, mask, x = _pallas_core(hd, s, normalized, dtype)
    got = as_numpy(tl.staged2_attention(q, k, v, GEOMETRIES[hd].num_heads, torch.from_numpy(mask),
                                        normalized=normalized))
    rows = _pallas_rows(s, mask)
    tol = F32_ATOL if dtype == "float32" else _bf16_tol(want) + np.abs(x).max()
    assert np.abs(got - want)[rows].max() <= tol


@functools.lru_cache(maxsize=None)
def _pallas_core(hd: int, s: int, normalized: bool, dtype: str):
    """The context the Pallas kernel (B1's, or B5's on one layer) adds to x
    ~ 1e-5 when O is the identity and the MLP zero, and the kernels' q, k, v
    [B, S, KW] (LN, then the products in f32, rounded to the dtype), the
    mask (_edge_mask) and x."""
    cfg, layers = _layers(hd)
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32,
                                                                           torch.float32)
    jl, tlr = jax_and_torch_params(_identity_tail(layers), jdt)
    x = 1e-5 * randn(s + 3, (BATCH, s, cfg.hidden_size))
    mask = _edge_mask(s)
    jx, jmask = jnp.asarray(x, jdt), jnp.asarray(mask)
    if normalized:
        out = fused_vit_encoder(jx, jl, cfg.num_heads, eps=cfg.layernorm_eps, token_mask=jmask,
                                interpret=True)
    else:
        out = fused_vit_layer(jx, jax.tree.map(lambda a: a[0], jl), cfg.num_heads,
                              eps=cfg.layernorm_eps, token_mask=jmask, interpret=True)
    xt = as_torch(x, tdt)
    want = np.asarray(out.astype(jnp.float32)) - as_numpy(xt)
    lp = tmod._layer(tlr, 0)
    h = tl._ln_f32(xt.float(), lp["ln1"], cfg.layernorm_eps)
    q, k, v = (tl._linear_f32(h, lp["attn"][n]["w"], lp["attn"][n]["b"]).to(tdt) for n in "qkv")
    return want, q, k, v, mask, x


def _heads(t: torch.Tensor, nh: int) -> torch.Tensor:
    b, s, kw = t.shape
    return t.reshape(b, s, nh, kw // nh).transpose(1, 2)


def _unheads(t: torch.Tensor) -> torch.Tensor:
    b, nh, s, hd = t.shape
    return t.transpose(1, 2).reshape(b, s, nh * hd)


@pytest.mark.parametrize("hd, s, normalized", _cases(
    *((hd, (65, 257, 289), norm) for hd in (16, 32, 64, 80) for norm in (False, True))))
def test_split_attention_emulated_is_the_pallas_kernels_core(hd, s, normalized):
    """The f32 body's arithmetic (csrc/split_attention.cuh, emulated by
    tests/torch_parity.py::split_attention_emulated: the planes, the six
    passes of each product, each chunk's PV summed in f32, staged2 or
    normalised) against the context of the Pallas kernel of B1 (staged2)
    or B5 (normalised) at every head dim the layer kernels take, one chunk
    past a query tile (65), ViT-H's 257 (the resident body's last chunk
    count plus one) and the old 288 limit plus one, masked as the edges
    want, every row of the images the Pallas kernel computes as the
    reference does."""
    want, q, k, v, mask, _ = _pallas_core(hd, s, normalized, "float32")
    nh = GEOMETRIES[hd].num_heads
    got = as_numpy(_unheads(split_attention_emulated(
        *(_heads(t, nh) for t in (q, k, v)), torch.from_numpy(mask), normalized=normalized)))
    assert np.abs(got - want)[_pallas_rows(s, mask)].max() <= F32_ATOL


@pytest.mark.parametrize("hd, cap", _cases((16, (64,)), (32, (129,)), (64, (197,)), (80, (257,))))
def test_split_attention_emulated_with_counts_is_b3s_core(hd, cap):
    """B3's f32 attention on the split body: the keys of each compacted
    bucket past the image's kept count masked by the counts (1, the
    capacity and one between), against the context the Pallas bucketed
    kernel adds to x ~ 1e-5 on the kept rows, O the identity and the MLP
    zero."""
    cfg, layers = _layers(hd)
    jl, tlr = jax_and_torch_params(jax.tree.map(lambda a: a[0], _identity_tail(layers)))
    s = cap + 7
    x = 1e-5 * randn(cap + 1, (BATCH, s, cfg.hidden_size))
    rs = np.random.RandomState(cap + 1)
    kept = np.zeros((BATCH, s), bool)
    kept[:, 0] = True
    for i, count in enumerate((cap, 1, cap // 2 + 3)):
        kept[i, 1 + rs.permutation(s - 1)[:count - 1]] = True
    dest = compact_dest(torch.from_numpy(kept))
    out = np.array(fused_vit_layer_bucketed(
        jnp.asarray(x), jl, jnp.asarray(dest.numpy()), jnp.asarray(kept), cap, cfg.num_heads,
        eps=cfg.layernorm_eps, interpret=True))
    xc, key_ok = tl.bucket_compact(as_torch(x), dest, torch.from_numpy(kept), cap)
    want, _ = tl.bucket_compact(torch.from_numpy(out), dest, torch.from_numpy(kept), cap)
    h = tl._ln_f32(xc, tlr["ln1"], cfg.layernorm_eps)
    q, k, v = (_heads(tl._linear_f32(h, tlr["attn"][n]["w"], tlr["attn"][n]["b"]),
                      cfg.num_heads) for n in "qkv")
    got = _unheads(split_attention_emulated(q, k, v, counts=key_ok.sum(1), normalized=False))
    assert float((got + xc - want).abs()[key_ok].max()) <= BUCKETED_ATOL


def test_attention_body_picks_a_wgmma_body_for_every_bf16_layer():
    """The mirror of the C rule: bf16 at every head dim the layer kernels take
    and every sequence length the repo's configs give (1 - 785: DeiT-S at
    448) runs a wgmma body, resident up to 256 keys and streamed past them;
    f32 runs the split body, resident up to 256 keys at hd <= 64 and
    streamed past them or at hd 80; nothing else is taken, and no input
    names a body that is not ATTENTION_BODIES'."""
    seqs = {c.seq_len for c in (t_vit_tiny(), t_deit_small(), t_vit_base(), t_vit_huge(),
                                t_deit_small().replace(image_size=384),
                                t_deit_small().replace(image_size=448))}
    assert max(seqs) == 785 and 197 in seqs and 257 in seqs
    for hd in tl.LAYER_HEAD_DIMS:
        for s in range(1, 786):
            bf = tl.attention_body(torch.bfloat16, hd, s)
            assert bf == ("wgmma_resident" if s <= 64 * tl.ATTENTION_LOGIT_CHUNKS
                          else "wgmma_streamed")
            assert tl.attention_body(torch.float32, hd, s) == (
                "split_resident" if s <= 64 * tl.ATTENTION_LOGIT_CHUNKS and hd <= 64
                else "split_streamed")
            assert tl.attention_body(torch.float16, hd, s) is None
    for hd in (8, 48, 96, 128):
        assert tl.attention_body(torch.bfloat16, hd, 197) is None
    assert tl.attention_body(torch.bfloat16, 64, 0) is None
    names = {tl.attention_body(dt, hd, s) for dt in (torch.float32, torch.bfloat16)
             for hd in tl.LAYER_HEAD_DIMS for s in (1, 256, 257, 785)}
    assert names == set(tl.ATTENTION_BODIES)


def test_attention_tally_follows_the_mirror():
    """count_attention adds a kernel's calls under the body the mirror names,
    per kernel; reset_attention_body_counts clears the tally (and the C
    counters, which this host has no library for)."""
    tl.attention_launches.clear()
    tl.count_attention("b1", torch.bfloat16, 64, 197)
    tl.count_attention("b5", torch.bfloat16, 80, 257, calls=32)
    tl.count_attention("b1", torch.float32, 16, 17)
    tl.count_attention("b5", torch.float32, 80, 197, calls=12)
    assert tl.attention_launches == {
        "b1": {"wgmma_resident": 1, "wgmma_streamed": 0, "split_resident": 1,
               "split_streamed": 0},
        "b5": {"wgmma_resident": 0, "wgmma_streamed": 32, "split_resident": 0,
               "split_streamed": 12}}
    tl.attention_launches.clear()
