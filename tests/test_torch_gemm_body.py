"""The persistent bf16 GEMM body (csrc/wgmma.cuh::wgmma_gemm_persistent),
which runs every bf16 product of B1, B3 and B5 through csrc/gemm.cu::gemm().

On the CPU: the walk's rule as ops/cuda/gemm.py mirrors it (wgmma_walk),
which the card tests and chip_smoke.py's phase 3i hold the C counters to:
every output tile counted, one block an SM at most and one a tile at most,
and more than one tile a block at the benchmark cells' product shapes.

On the card (marker `card`; they skip without one): the body against
gemm_bf16_ref at the cells' product shapes and at the walk's edges, within
phase 3i's tolerances, with the tiles and blocks it counted. This file
imports no JAX, so on the card it runs as

    python -m pytest tests/test_torch_gemm_body.py -q --noconftest
"""

import math

import pytest
import torch

from vit_pruning_tpu_torch.ops.cuda import gemm as kg

H100_SMS = 132


def products(d):
    """The four products of a layer as B1 runs them, at model width d and MLP
    width 4 d: (K, N, residual dtype, act, out dtype)."""
    bf, f32 = torch.bfloat16, torch.float32
    return {"qkv": (d, 3 * d, None, "none", bf), "o": (d, d, bf, "none", f32),
            "fc1": (d, 4 * d, None, "gelu_tanh", bf), "fc2": (4 * d, d, f32, "none", bf)}


# the bf16 cells' rows: DeiT-S headline 512 x 99, dense 512 x 197; ViT-H
# headline 64 x 129 (64.5 row tiles: a partial last one)
CELLS = {"deit_s.headline": (512 * 99, 384), "deit_s.dense": (512 * 197, 384),
         "vit_h14.headline": (64 * 129, 1280)}
CELL_SHAPES = [(f"{c} {t}", m, *p) for c, (m, d) in CELLS.items()
               for t, p in products(d).items()]
bf16, f32 = torch.bfloat16, torch.float32
# (tag, M, K, N, residual, act, out, lda, ldr): the walk's edges; unaligned
# residual rows take the value-by-value epilogue and no TMA store
EDGES = [("one tile", 8, 384, 128, None, "none", bf16, None, None),
         ("CLS rows, strided A", 8, 384, 384, bf16, "none", f32, 99 * 384, None),
         ("fewer tiles than SMs, N 384", 200, 384, 384, f32, "none", bf16, None, None),
         ("ragged N", 1000, 384, 200, None, "gelu_tanh", bf16, None, None),
         ("ragged K", 777, 72, 256, None, "gelu_erf", f32, None, None),
         ("M < 128, long K", 100, 1536, 384, f32, "none", f32, None, None),
         ("partial last M tile", 8256, 1280, 1280, bf16, "none", f32, None, None),
         ("residual rows not 16-byte aligned", 300, 384, 384, bf16, "none", bf16, None, 385)]


@pytest.mark.parametrize("m,n,tiles,blocks", [
    (1, 8, 1, 1), (8, 128, 1, 1), (200, 384, 6, 6), (1000, 200, 16, 16),
    (8256, 1280, 650, 132),  # ViT-H's 64.5 row tiles: a partial last one
    (50688, 1152, 3564, 132), (100864, 384, 2364, 132), (8256, 5120, 2600, 132)])
def test_walk_counts_every_tile_on_at_most_one_block_an_sm(m, n, tiles, blocks):
    assert kg.wgmma_walk(m, n, H100_SMS) == {"tiles": tiles, "blocks": blocks}
    assert kg.wgmma_walk(m, n, 1) == {"tiles": tiles, "blocks": 1}


@pytest.mark.parametrize("tag,m,k,n,res,act,out", CELL_SHAPES)
def test_walk_gives_each_block_several_tiles_at_the_cells(tag, m, k, n, res, act, out):
    walk = kg.wgmma_walk(m, n, H100_SMS)
    assert walk["blocks"] == H100_SMS and walk["tiles"] >= 2 * walk["blocks"], (tag, walk)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the body runs only there")
    return torch.device("cuda")


def _operands(dev, m, k, n, res, lda=None, ldr=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(m, lda or k, generator=g).to(dev, torch.bfloat16)[:, :k]
    w = (torch.randn(k, n, generator=g) / math.sqrt(k)).to(dev, torch.bfloat16)
    b = (0.1 * torch.randn(n, generator=g)).to(dev, torch.bfloat16)
    r = None if res is None else torch.randn(m, ldr or n, generator=g).to(dev, res)[:, :n]
    return a, w, b, r


def _tol(ref, out):
    """chip_smoke.py's phase 3i: two bf16 steps at the largest magnitude for
    a bf16 output, 1e-4 of it (at least 1e-4) for an f32 one."""
    top = max(float(ref.abs().max()), 1e-30)
    if out == torch.bfloat16:
        return 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7)
    return 1e-4 * max(1.0, top)


@pytest.mark.card
@pytest.mark.parametrize("tag,m,k,n,res,act,out,lda,ldr",
                         [(*c, None, None) for c in CELL_SHAPES] + EDGES)
def test_body_matches_the_plain_product(card, tag, m, k, n, res, act, out, lda, ldr):
    a, w, b, r = _operands(card, m, k, n, res, lda, ldr)
    kg.reset_body_counts()
    got = kg.gemm_bf16(a, w, b, act, r, out)
    torch.cuda.synchronize()
    counts = kg.body_counts()
    ref = kg.gemm_bf16_ref(a, w, b, act, r, out).float()
    err = (got.float() - ref).abs().max().item()
    assert bool(torch.isfinite(got).all()) and err <= _tol(ref, out), (tag, err)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    walk = kg.wgmma_walk(m, n, sms)
    assert counts["wgmma"] == 1 and counts["wmma"] == 0, (tag, counts)
    assert (counts["wgmma_tiles"], counts["wgmma_blocks"]) == (walk["tiles"], walk["blocks"])
