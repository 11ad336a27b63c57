"""DINOv2's kernel parts on the card (marker `card`; they skip without one):
the persistent bf16 GEMM body's two epilogue variants and kernel B1 on
DINOv2's block, at the widths of the benchmark's DINOv2 cell
(vit_pruning_tpu_torch/configs.py::dinov2_giant_reg: D 1536, SwiGLU M 4096,
24 heads of 64, batch 32 x S 689 live tokens).

  * SwiGLU's gated fc1 epilogue: [22,048 x 1536] @ [1536 x 8192] (u1, u2
    pairs interleaved) -> silu(u1) * u2 [22,048 x 4096] in bf16, against
    ops/cuda/gemm.py::gemm_bf16_ref, and at a ragged edge;
  * LayerScale's epilogue on O (N 1536, a bf16 residual, f32 out) and fc2
    (K 4096, an f32 residual, bf16 out), and with residual rows that are not
    16-byte aligned (the value-by-value path);
  * one B1 layer at D 1536, S 689 against ops/cuda/layer.py::fused_vit_layer_ref;
  * the counters: every output tile of a gated product counted as a gated
    tile, of a scaled product as a scaled tile (ops/cuda/gemm.py::body_counts),
    and per B1 call the fc1 tiles gated and the O and fc2 tiles scaled.

Tolerances are chip_smoke.py's: two bf16 steps at the largest magnitude of
a bf16 output (the kernel and its plain version round at the same places,
their f32 sums run in another order), 1e-4 of it for an f32 output. This
file imports no JAX; on the card it runs as

    python -m pytest tests/test_torch_dinov2_card.py -q --noconftest -m card
"""

import math

import pytest
import torch

from vit_pruning_tpu_torch.ops.cuda import gemm as kg
from vit_pruning_tpu_torch.ops.cuda import layer as kl
from vit_pruning_tpu_torch.ops.swiglu import with_gated_fc1

D, M, HEADS, ROWS = 1536, 4096, 24, 32 * 689
bf16, f32 = torch.bfloat16, torch.float32


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


def _tol(ref, out):
    top = max(float(ref.abs().max()), 1e-30)
    if out == bf16:
        return 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7)
    return 1e-4 * max(1.0, top)


def _operands(dev, m, k, n, res=None, ldr=None, seed=0):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(m, k, generator=g).to(dev, bf16)
    w = (torch.randn(k, n, generator=g) / math.sqrt(k)).to(dev, bf16)
    b = (0.1 * torch.randn(n, generator=g)).to(dev, bf16)
    r = None if res is None else torch.randn(m, ldr or n, generator=g).to(dev, res)[:, :n]
    gamma = (0.5 + 0.25 * torch.randn(n, generator=g)).to(dev, bf16)
    return a, w, b, r, gamma


def _counted(card, fn):
    kg.reset_body_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kg.body_counts()


@pytest.mark.card
@pytest.mark.parametrize("m,k,n", [(ROWS, D, 2 * M), (1000, 384, 48)],
                         ids=["dinov2 fc1", "ragged M, N 48"])
def test_the_gated_epilogue_matches_the_plain_product(card, m, k, n):
    a, w, b, _, _ = _operands(card, m, k, n)
    got, counts = _counted(card, lambda: kg.gemm_bf16(a, w, b, gate=True))
    ref = kg.gemm_bf16_ref(a, w, b, gate=True).float()
    err = (got.float() - ref).abs().max().item()
    assert got.shape == (m, n // 2) and bool(torch.isfinite(got).all())
    assert err <= _tol(ref, bf16), err
    walk = kg.wgmma_walk(m, n, torch.cuda.get_device_properties(card).multi_processor_count)
    assert counts["wgmma"] == 1 and counts["gated_tiles"] == walk["tiles"] == counts["wgmma_tiles"]
    assert counts["scaled_tiles"] == 0


@pytest.mark.card
@pytest.mark.parametrize("k,res,out,ldr", [(D, bf16, f32, None), (M, f32, bf16, None),
                                           (D, bf16, bf16, D + 1)],
                         ids=["dinov2 o", "dinov2 fc2", "residual rows not 16-byte aligned"])
def test_the_layerscale_epilogue_matches_the_plain_product(card, k, res, out, ldr):
    a, w, b, r, gamma = _operands(card, ROWS, k, D, res, ldr)
    got, counts = _counted(card, lambda: kg.gemm_bf16(a, w, b, "none", r, out, gamma=gamma))
    ref = kg.gemm_bf16_ref(a, w, b, "none", r, out, gamma=gamma).float()
    err = (got.float() - ref).abs().max().item()
    assert bool(torch.isfinite(got).all()) and err <= _tol(ref, out), err
    walk = kg.wgmma_walk(ROWS, D, torch.cuda.get_device_properties(card).multi_processor_count)
    assert counts["scaled_tiles"] == walk["tiles"] and counts["gated_tiles"] == 0


def _dinov2_layer(dev, seed=1):
    """One DINOv2 layer at the cell's widths, fc1 in checkpoint order."""
    g = torch.Generator().manual_seed(seed)

    def lin(k, n):
        return {"w": (torch.randn(k, n, generator=g) / math.sqrt(k)).to(dev, bf16),
                "b": (0.1 * torch.randn(n, generator=g)).to(dev, bf16)}

    def vec(base):
        return (base + 0.1 * torch.randn(D, generator=g)).to(dev, bf16)

    return {"ln1": {"g": vec(1.0), "b": vec(0.0)}, "ln2": {"g": vec(1.0), "b": vec(0.0)},
            "attn": {n: lin(D, D) for n in "qkvo"},
            "mlp": {"fc1": lin(D, 2 * M), "fc2": lin(M, D)},
            "ls1": (0.5 + 0.25 * torch.randn(D, generator=g)).to(dev, bf16),
            "ls2": (0.5 + 0.25 * torch.randn(D, generator=g)).to(dev, bf16)}


@pytest.mark.card
def test_b1_runs_the_dinov2_layer_with_the_gated_and_scaled_epilogues(card):
    lp = _dinov2_layer(card)
    x = torch.randn(32, 689, D, generator=torch.Generator().manual_seed(2)).to(card, bf16)
    gated = with_gated_fc1(lp)
    got, counts = _counted(card, lambda: kl.fused_vit_layer(x, gated, HEADS, 1e-6))
    ref = kl.fused_vit_layer_ref(x, lp, HEADS, 1e-6).float()
    err = (got.float() - ref).abs().max().item()
    assert bool(torch.isfinite(got).all()) and err <= _tol(ref, bf16), err
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    tiles = {n: kg.wgmma_walk(ROWS, n, sms)["tiles"] for n in (3 * D, D, 2 * M)}
    assert counts["gated_tiles"] == tiles[2 * M]
    assert counts["scaled_tiles"] == 2 * tiles[D]  # O and fc2
    assert counts["wgmma"] == 4 and counts["wgmma_tiles"] == tiles[3 * D] + 2 * tiles[D] + \
        tiles[2 * M]
    # fc1 is interleaved once at load: a checkpoint-order tree is refused, not copied
    with pytest.raises(ValueError, match="checkpoint order"):
        kl.fused_vit_layer(x, lp, HEADS, 1e-6)
