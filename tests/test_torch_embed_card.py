"""Kernel B8a reading the uint8 image (ops/cuda/embed.py::fused_image_embed_u8),
the port's served embed, on the card (marker `card`; they skip without one).

Its patch rows are B8a's on extract_patches of the same image bit for bit
(the same A reaches the tensor cores, the same body and epilogue run); its
CLS and register rows are its plain version's. The served embed
(serving.embed_from_u8, mode 'auto') is the kernel, launched once a call,
and stays within chip_smoke.py phase 5f's bounds of the eager route (mode
'eager'): 2e-4 in float32, 1% relative in bfloat16. This file imports no
JAX, so on the card it runs as

    python -m pytest tests/test_torch_embed_card.py -q --noconftest
"""

import pytest
import torch

from vit_pruning_tpu_torch.configs import PruneConfig, deit_small, dinov2_giant_reg, vit_huge
from vit_pruning_tpu_torch.models.convert import tree_to
from vit_pruning_tpu_torch.models.pruned_vit import init_pruned_vit_params
from vit_pruning_tpu_torch.models.vit import init_vit_params
from vit_pruning_tpu_torch.ops.cuda import embed as te
from vit_pruning_tpu_torch.ops.dispatch import kernel_mode
from vit_pruning_tpu_torch.ops.patch_embed import extract_patches
from vit_pruning_tpu_torch.serving import embed_from_u8, serving_forward

bf16, f32 = torch.bfloat16, torch.float32
# (tag, batch, side, patch, D, registers, dtype, the image's byte offset): the cells' embeds
# (16-byte loads at P 16, 2-byte at P 14), images at odd addresses and P 8 (single bytes), a
# D that is padded, and f32 weights (the split body)
CASES = [("deit_s", 64, 224, 16, 384, 0, bf16, 0), ("vit_h", 16, 224, 14, 1280, 0, bf16, 0),
         ("dinov2_518_reg4", 4, 518, 14, 1536, 4, bf16, 0),
         ("deit_s odd address", 8, 224, 16, 384, 1, bf16, 1),
         ("vit_h odd address", 4, 224, 14, 1280, 2, bf16, 3), ("p8", 6, 32, 8, 64, 1, bf16, 0),
         ("d100", 4, 224, 16, 100, 1, bf16, 0), ("deit_s f32", 16, 224, 16, 384, 2, f32, 0),
         ("dinov2_518_reg4 f32", 2, 518, 14, 1536, 4, f32, 1)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


def _operands(dev, b, side, p, d, r, dt, offset, seed=0):
    g = torch.Generator().manual_seed(seed)
    k, n = 3 * p * p, (side // p) ** 2
    flat = torch.randint(0, 256, (offset + b * 3 * side * side,), generator=g, dtype=torch.uint8)
    pixels = flat.to(dev)[offset:].view(b, 3, side, side)
    w = (torch.randn(k, d, generator=g) / k ** 0.5).to(dev, dt)
    bias = (0.1 * torch.randn(d, generator=g)).to(dev, dt)
    cls = torch.randn(d, generator=g).to(dev, dt)
    pos = (0.02 * torch.randn(1 + n, d, generator=g)).to(dev, dt)
    reg = torch.randn(r, d, generator=g).to(dev, dt) if r else None
    return pixels, w, bias, cls, pos, reg


@pytest.mark.card
@pytest.mark.parametrize("tag,b,side,p,d,r,dt,offset", CASES)
def test_image_kernel_is_b8a_on_the_patch_matrix(card, tag, b, side, p, d, r, dt, offset):
    pixels, w, bias, cls, pos, reg = _operands(card, b, side, p, d, r, dt, offset)
    launches = te.fused_image_embed_u8.launches
    te.reset_body_counts()
    got = te.fused_image_embed_u8(pixels, w, bias, cls, pos, reg, p)
    torch.cuda.synchronize()
    counts = te.body_counts()
    assert te.fused_image_embed_u8.launches == launches + 1
    assert counts == ({"wgmma": 1, "split": 0} if dt == bf16 else {"wgmma": 0, "split": 1})
    patches = te.fused_patch_embed_u8(extract_patches(pixels, p).contiguous(), w, bias, pos[1:])
    ref = te.fused_image_embed_u8_ref(pixels, w, bias, cls, pos, reg, p)
    assert got.shape == ref.shape == (b, 1 + r + (side // p) ** 2, d) and got.dtype == dt
    assert torch.equal(got[:, 1 + r:], patches), tag
    assert torch.equal(got[:, :1 + r], ref[:, :1 + r]), tag


def _embed_params(cfg, dev, dt, seed=1):
    ep = init_vit_params(cfg.replace(num_layers=1), torch.Generator().manual_seed(seed),
                         "cpu")["embed"]
    ep["patch"]["b"] = 0.1 * torch.randn(cfg.hidden_size,
                                         generator=torch.Generator().manual_seed(seed + 1))
    return tree_to(ep, dev, dt)


@pytest.mark.card
@pytest.mark.parametrize("dt", [f32, bf16], ids=["f32", "bf16"])
@pytest.mark.parametrize("model,batch", [("deit_s", 16), ("vit_h", 8), ("dinov2_518", 2)])
def test_served_embed_is_the_kernel_within_the_eager_routes_bounds(card, model, batch, dt):
    cfg = {"deit_s": deit_small(num_labels=10), "vit_h": vit_huge(num_labels=10),
           "dinov2_518": dinov2_giant_reg(num_labels=10)}[model]
    ep = _embed_params(cfg, card, dt)
    side = cfg.image_size
    pixels = torch.randint(0, 256, (batch, 3, side, side), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2)).to(card)
    launches = te.fused_image_embed_u8.launches
    with kernel_mode("auto"):
        served = embed_from_u8(pixels, ep, cfg)
    with kernel_mode("eager"):
        eager = embed_from_u8(pixels, ep, cfg)
    torch.cuda.synchronize()
    assert te.fused_image_embed_u8.launches == launches + 1
    assert served.shape == eager.shape == (batch, cfg.seq_len, cfg.hidden_size)
    assert torch.equal(served, te.embed_u8(pixels, ep, cfg))
    if dt == f32:
        assert (served - eager).abs().max().item() <= 2e-4
    else:
        rel = ((served.float() - eager.float()).norm() / eager.float().norm()).item()
        assert rel < 0.01


@pytest.mark.card
def test_a_served_call_launches_the_embed_once(card):
    cfg = deit_small(num_labels=10).replace(num_layers=2)
    pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp", top_k=98)
    params = tree_to(init_pruned_vit_params(cfg, pcfg, torch.Generator().manual_seed(3), "cpu"),
                     card, bf16)
    pixels = torch.randint(0, 256, (8, 3, 224, 224), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(4)).to(card)
    before = (te.fused_image_embed_u8.launches, te.fused_patch_embed_u8.launches)
    with kernel_mode("auto"):
        out = serving_forward(params, pixels, cfg, pcfg)
    torch.cuda.synchronize()
    after = (te.fused_image_embed_u8.launches, te.fused_patch_embed_u8.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (1, 0)
    assert out["logits"].shape == (8, 10) and bool(torch.isfinite(out["logits"]).all())
