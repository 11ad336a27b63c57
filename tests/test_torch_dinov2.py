"""DINOv2 with registers on the port's served path, on the CPU at a tiny size:
D 64, 2 heads of 32, a SwiGLU MLP of M 128 (fc1 to 256), 3 layers, image 56 at
patch 14 (16 patches), 4 registers, seeded random weights with LayerScale's
gains drawn per channel.

serving.serving_forward in the default kernel mode (the kernels' plain
versions for CPU tensors) against the plain reference
(vit_pruning_tpu_torch/reference/dinov2.py), dense and with 8 of 16 patches
kept: both run float32, so they differ by the order of their sums alone
(atol 2e-5 on the logits, the f32 tolerance tests/test_pallas.py holds the
kernels to). Then the keep masks and scores, the head's mean, the gated
fc1 on interleaved weights, the planted faults that the comparison has to
catch, the parameter count and FLOP count of dinov2_giant_reg, the routes
that refuse the model (kernel B1 and layers_for a tree whose fc1 was not
interleaved at load among them), and the conversion from HF's
Dinov2WithRegisters names.
"""

import dataclasses

import pytest
import torch

from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig, dinov2_giant_reg, prefix_len
from vit_pruning_tpu_torch.models import convert, vit
from vit_pruning_tpu_torch.models.pruned_vit import (
    init_pruned_vit_params,
    progressive_topk_forward,
    pruned_vit_forward,
)
from vit_pruning_tpu_torch.ops import swiglu
from vit_pruning_tpu_torch.ops.cuda import gemm as kg
from vit_pruning_tpu_torch.ops.cuda import layer as kl
from vit_pruning_tpu_torch.ops.cuda.model import fused_vit_encoder
from vit_pruning_tpu_torch.ops.dispatch import kernel_mode
from vit_pruning_tpu_torch.ops.quant import attach_int8_weights
from vit_pruning_tpu_torch.reference import dinov2 as ref
from vit_pruning_tpu_torch.serving import serving_forward
from vit_pruning_tpu_torch.utils import flops

CFG = ViTConfig(image_size=56, patch_size=14, hidden_size=64, num_layers=3, num_heads=2,
                mlp_dim=128, num_labels=10, layernorm_eps=1e-6, mlp_kind="swiglu",
                layerscale=True, num_registers=4, head_pool="cls_mean")
ATOL = 2e-5  # float32 against float32: the order of the sums


def _pcfg(top_k):
    return PruneConfig(mode="topk_prog", predictor="cls_mlp", predictor_hidden=16, top_k=top_k)


def _model(seed=0):
    """Seeded weights (the layers' matrices at 1 / sqrt(fan-in), so that the
    logits depend on the layers' arithmetic; biases moved off 0,
    LayerScale's gains per channel) and a batch of uint8 images."""
    g = torch.Generator().manual_seed(seed)
    params = init_pruned_vit_params(CFG, _pcfg(8), g, device="cpu")
    lay = params["backbone"]["layers"]
    for key in ("ls1", "ls2"):
        lay[key] = 0.25 + torch.rand(lay[key].shape, generator=g)
    for lin in list(lay["attn"].values()) + list(lay["mlp"].values()):
        lin["w"] = torch.randn(lin["w"].shape, generator=g) / lin["w"].shape[-2] ** 0.5
        lin["b"] = 0.1 * torch.randn(lin["b"].shape, generator=g)
    pixels = torch.randint(0, 256, (3, 3, 56, 56), dtype=torch.uint8, generator=g)
    return params, pixels


def _serve(params, pixels, top_k=8, config=CFG):
    return serving_forward(params, pixels, config, _pcfg(top_k), logits_only=True, quant="none")


@pytest.mark.parametrize("top_k", [16, 8], ids=["dense", "kept8"])
def test_served_forward_matches_the_reference(top_k):
    params, pixels = _model()
    got = _serve(params, pixels, top_k)
    want = ref.forward(params, pixels, CFG, [top_k if top_k < 16 else 0, 0, 0])
    torch.testing.assert_close(got["logits"], want["logits"], atol=ATOL, rtol=0)
    assert torch.equal(got["keep_masks"], want["keep_masks"])
    live = torch.isfinite(want["scores"])
    assert torch.equal(torch.isfinite(got["scores"]), live)
    torch.testing.assert_close(got["scores"][live], want["scores"][live], atol=ATOL, rtol=0)


def test_keep_masks_hold_the_prefix_and_scores_cover_the_patches():
    params, pixels = _model(1)
    out = _serve(params, pixels, 8)
    masks, scores = out["keep_masks"], out["scores"]
    assert masks.shape == (3, 3, 21) and scores.shape == (3, 3, 16)
    assert masks[:, :, :5].all()
    assert (masks.sum(-1) == 13).all()  # 5 + 8 at every layer after the drop before layer 0
    assert torch.isfinite(scores[0]).all() and not torch.isfinite(scores[1:]).any()


def test_the_heads_mean_leaves_out_the_registers():
    params, pixels = _model(2)
    got = _serve(params, pixels, 8)["logits"]
    want = ref.forward(params, pixels, CFG, [8, 0, 0])
    x, head = want["last_hidden"], params["backbone"]["head"]
    with_regs = torch.cat([x[:, 0], x[:, 1:].mean(dim=1)], dim=-1) @ head["w"] + head["b"]
    torch.testing.assert_close(got, want["logits"], atol=ATOL, rtol=0)
    assert (with_regs - got).abs().max() > 100 * ATOL


def test_the_gated_fc1_on_interleaved_weights_is_silu_u1_times_u2():
    params, _ = _model(3)
    layers = params["backbone"]["layers"]
    lp = vit.layer_slice(layers, 0)
    gated = swiglu.with_gated_fc1(lp)
    assert swiglu.is_gated(gated) and not swiglu.is_gated(lp)
    assert gated["mlp"]["fc1"]["wg"].shape == (64, 256)
    h = torch.randn(5, 64, generator=torch.Generator().manual_seed(4))
    u1, u2 = (h @ lp["mlp"]["fc1"]["w"] + lp["mlp"]["fc1"]["b"]).chunk(2, dim=-1)
    want = torch.nn.functional.silu(u1) * u2
    fc1 = gated["mlp"]["fc1"]
    got = kg.gemm_bf16_ref(h, fc1["wg"], fc1["bg"], gate=True, out_dtype=torch.float32)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    x = torch.randn(2, 21, 64, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(kl.fused_vit_layer_ref(x, gated, 2, 1e-6),
                               kl.fused_vit_layer_ref(x, lp, 2, 1e-6), atol=1e-6, rtol=0)
    torch.testing.assert_close(kl.fused_vit_layer(x, gated, 2, 1e-6),
                               vit.vit_layer(x, lp, CFG, use_kernels=False), atol=ATOL, rtol=0)


def _halves_swapped(params):
    lay = params["backbone"]["layers"]
    fc1 = lay["mlp"]["fc1"]
    u1, u2 = fc1["w"].chunk(2, dim=-1)
    b1, b2 = fc1["b"].chunk(2, dim=-1)
    lay["mlp"]["fc1"] = {"w": torch.cat([u2, u1], -1), "b": torch.cat([b2, b1], -1)}


def _no_gain(key):
    def plant(params):
        lay = params["backbone"]["layers"]
        lay[key] = torch.ones_like(lay[key])
    return plant


def _gains_swapped(params):
    lay = params["backbone"]["layers"]
    lay["ls1"], lay["ls2"] = lay["ls2"], lay["ls1"]


@pytest.mark.parametrize("plant", [_halves_swapped, _no_gain("ls1"), _no_gain("ls2"),
                                   _gains_swapped],
                         ids=["gate_halves_swapped", "ls1_dropped", "ls2_dropped",
                              "gains_swapped"])
def test_a_planted_fault_fails_the_comparison(plant):
    params, pixels = _model(6)
    want = ref.forward(params, pixels, CFG)["logits"]
    plant(params)
    got = _serve(params, pixels, 16)["logits"]
    assert (got - want).abs().max() > 100 * ATOL


def test_dinov2_giant_reg_counts_its_published_parameters(monkeypatch):
    """1,136,485,376 in the backbone (without the mask token) and a
    3,073,000-parameter head at 1000 labels, counted on init's shapes."""
    monkeypatch.setattr(vit, "trunc_normal", lambda shape, g, std=0.02: torch.empty(
        shape, device="meta"))
    monkeypatch.setattr(vit, "tree_to", lambda tree, *a: tree)
    cfg = dinov2_giant_reg()
    assert (cfg.mlp_dim, cfg.seq_len, prefix_len(cfg)) == (4096, 1374, 5)
    params = vit.init_vit_params(cfg, torch.Generator(), "cpu")
    head = params.pop("head")
    assert vit.param_count(params) == 1_136_485_376
    assert vit.param_count(head) == 3_073_000
    assert ViTConfig.from_json(cfg.to_json()) == cfg


def _refuse_b2(params, x):
    lp = vit.layer_slice(params["backbone"]["layers"], 2)
    kl.fused_vit_layer_cls_logits(x, lp, params["backbone"]["ln_f"], params["backbone"]["head"],
                                  2, 1e-6)


def _refuse_b2_pooled_head(params, x):
    """A plain layer, but the pooled head: B2 computes the CLS row alone."""
    g = torch.Generator().manual_seed(0)
    plain = vit.init_vit_params(dataclasses.replace(CFG, mlp_kind="gelu", layerscale=False),
                                g, "cpu")
    kl.fused_vit_layer_cls_logits(x, vit.layer_slice(plain["layers"], 0), plain["ln_f"],
                                  plain["head"], 2, 1e-6)


def _refuse_b3(params, x):
    lp = vit.layer_slice(params["backbone"]["layers"], 0)
    kept = torch.ones(x.shape[:2], dtype=torch.bool)
    kl.fused_vit_layer_bucketed(x, lp, torch.arange(21).expand(3, 21), kept, 21, 2, 1e-6)


def _refuse_int8(params, x):
    serving_forward(params, torch.zeros(3, 3, 56, 56, dtype=torch.uint8), CFG, _pcfg(8),
                    logits_only=True, quant="int8")


def _refuse_attach_int8(params, x):
    attach_int8_weights(params["backbone"]["layers"])


def _refuse_b5(params, x):
    fused_vit_encoder(x, params["backbone"]["layers"], 2, 1e-6)


def _refuse_merge(params, x):
    pcfg = dataclasses.replace(_pcfg(8), merge_dropped=True)
    progressive_topk_forward(params, torch.zeros(3, 3, 56, 56, dtype=torch.uint8), CFG, pcfg)


def _refuse_redecide(params, x):
    pruned_vit_forward(params, torch.zeros(3, 3, 56, 56, dtype=torch.uint8), CFG,
                       PruneConfig(mode="topk", predictor="cls_mlp", predictor_hidden=16,
                                   top_k=8))


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=torch.bfloat16, device="meta")


def _refuse_b1_checkpoint_order(params, x):
    """B1 on shapes alone (mode 'kernel', meta tensors): fc1 is interleaved
    once at load, and a checkpoint-order tree is refused, not copied."""
    lp = _meta(vit.layer_slice(params["backbone"]["layers"], 0))
    with kernel_mode("kernel"):
        kl.fused_vit_layer(x.to(torch.bfloat16).to("meta"), lp, 2, 1e-6)


def _refuse_layers_for_checkpoint_order(params, x):
    with kernel_mode("kernel"):
        vit.layers_for(_meta(params["backbone"]["layers"]), "none")


PLAIN_BLOCK = "takes the plain ViT block alone"


@pytest.mark.parametrize("route,match", [
    (_refuse_b2, PLAIN_BLOCK), (_refuse_b2_pooled_head, "pooled head"), (_refuse_b3, PLAIN_BLOCK),
    (_refuse_int8, PLAIN_BLOCK), (_refuse_attach_int8, PLAIN_BLOCK), (_refuse_b5, PLAIN_BLOCK),
    (_refuse_merge, "merge_dropped with 4 register"), (_refuse_redecide, "register tokens"),
    (_refuse_b1_checkpoint_order, "checkpoint order"),
    (_refuse_layers_for_checkpoint_order, "checkpoint order")],
    ids=["b2", "b2_pooled_head", "b3", "int8", "attach_int8", "b5", "merge", "redecide",
         "b1_checkpoint_order", "layers_for_checkpoint_order"])
def test_routes_that_cannot_take_the_model_raise(route, match):
    params, _ = _model(7)
    x = torch.randn(3, 21, 64, generator=torch.Generator().manual_seed(8))
    with pytest.raises(ValueError, match=match):
        route(params, x)


def test_an_interleaved_tree_takes_b1_on_shapes_alone():
    """The same meta call as the refused one, with fc1 interleaved at load:
    the operator's fake implementation gives the layer's shape."""
    params, _ = _model(7)
    lp = _meta(swiglu.with_gated_fc1(vit.layer_slice(params["backbone"]["layers"], 0)))
    x = torch.empty(3, 21, 64, dtype=torch.bfloat16, device="meta")
    with kernel_mode("kernel"):
        assert kl.fused_vit_layer(x, lp, 2, 1e-6).shape == (3, 21, 64)


def test_flops_count_the_swiglu_mlp_the_registers_and_the_pooled_head():
    """utils/flops.py on dinov2_giant_reg: three D x M products in the MLP,
    S 1374 dense and 5 + 684 kept, the 2 D-wide head."""
    cfg = dinov2_giant_reg()
    d, m, n, h = 1536, 4096, 1369, 64

    def layer(s):
        return 8 * s * d * d + 4 * s * s * d + 6 * s * d * m

    patch, head = 2 * n * 588 * d, 2 * 2 * d * 1000
    assert flops.vit_flops(cfg) == patch + 40 * layer(1374) + head
    pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp", predictor_hidden=h, top_k=684)
    assert flops.pruned_vit_flops(cfg, pcfg) == \
        patch + head + 40 * (layer(689) + 2 * n * (2 * d * h + h))
    topk = PruneConfig(mode="topk", predictor="none", top_k=684)
    assert flops.pruned_vit_flops(cfg, topk) == patch + head + 40 * layer(689)


def test_the_encoder_route_is_not_taken():
    params, _ = _model(8)
    assert not vit.encoder_route(params["backbone"]["layers"], CFG)
    assert not vit.encoder_route(swiglu.with_gated_fc1(params["backbone"]["layers"]), CFG)


def _hf_state_dict(params):
    """The tiny model's weights under HF Dinov2WithRegistersForImageClassification's
    names: torch Linear [out, in], the patch projection as a conv."""
    bb = params["backbone"]

    def lin(name, p):
        return {f"{name}.weight": p["w"].t().contiguous(), f"{name}.bias": p["b"]}

    def ln(name, p):
        return {f"{name}.weight": p["g"], f"{name}.bias": p["b"]}

    pre = convert.DINOV2_PREFIX
    emb = bb["embed"]
    sd = {f"{pre}embeddings.cls_token": emb["cls"],
          f"{pre}embeddings.mask_token": torch.zeros(1, 64),
          f"{pre}embeddings.register_tokens": emb["registers"],
          f"{pre}embeddings.position_embeddings": emb["pos"],
          f"{pre}embeddings.patch_embeddings.projection.weight":
              emb["patch"]["w"].t().reshape(64, 3, 14, 14),
          f"{pre}embeddings.patch_embeddings.projection.bias": emb["patch"]["b"],
          **ln(f"{pre}layernorm", bb["ln_f"]), **lin("classifier", bb["head"])}
    lay = bb["layers"]
    for i in range(CFG.num_layers):
        li = vit.layer_slice(lay, i)
        p = f"{pre}encoder.layer.{i}"
        sd.update(**ln(f"{p}.norm1", li["ln1"]), **ln(f"{p}.norm2", li["ln2"]))
        for n, hf in (("q", "query"), ("k", "key"), ("v", "value")):
            sd.update(lin(f"{p}.attention.attention.{hf}", li["attn"][n]))
        sd.update(**lin(f"{p}.attention.output.dense", li["attn"]["o"]),
                  **lin(f"{p}.mlp.weights_in", li["mlp"]["fc1"]),
                  **lin(f"{p}.mlp.weights_out", li["mlp"]["fc2"]))
        sd[f"{p}.layer_scale1.lambda1"], sd[f"{p}.layer_scale2.lambda1"] = li["ls1"], li["ls2"]
    return sd


@pytest.mark.parametrize("interleave", [False, True], ids=["checkpoint_order", "interleaved"])
def test_the_hf_checkpoint_names_convert_to_the_ports_tree(interleave):
    """Checkpoint order in; the set-up interleave applied after it serves the
    same logits."""
    params, pixels = _model(9)
    bb = convert.load_dinov2_state_dict(_hf_state_dict(params), CFG, device="cpu")
    got_leaves = dict(convert.flatten_tree(bb))
    if interleave:
        bb = dict(bb, layers=swiglu.with_gated_fc1(bb["layers"]))
    want_leaves = dict(convert.flatten_tree(params["backbone"]))
    assert got_leaves.keys() == want_leaves.keys()
    for key, leaf in want_leaves.items():
        torch.testing.assert_close(got_leaves[key], leaf, atol=0, rtol=0)
    served = _serve(dict(params, backbone=bb), pixels, 8)["logits"]
    torch.testing.assert_close(served, ref.forward(params, pixels, CFG, [8, 0, 0])["logits"],
                               atol=ATOL, rtol=0)


def test_config_fields_are_checked_and_left_out_of_a_plain_vits_json():
    with pytest.raises(ValueError, match="mlp_kind"):
        ViTConfig(mlp_kind="geglu")
    with pytest.raises(ValueError, match="head_pool"):
        ViTConfig(head_pool="mean")
    assert "mlp_kind" not in ViTConfig().to_json() and "mlp_kind" in CFG.to_json()
    with pytest.raises(ValueError, match="MLP"):
        params, _ = _model(10)
        vit.vit_layer(torch.zeros(1, 21, 64), vit.layer_slice(params["backbone"]["layers"], 0),
                      dataclasses.replace(CFG, mlp_kind="gelu"))
