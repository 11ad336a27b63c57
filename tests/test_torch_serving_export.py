"""The port's serving export (vit_pruning_tpu_torch/serving.py:
export_serving / load_exported) and the kernels' registered operators
(ops/cuda/library.py), on the CPU.

Weights come from the JAX package's init, carried across by the bridge
(models/convert.py); pixels from a numpy seed. The round trips run the
CPU's plain path. The kernel route is traced on meta tensors in kernel mode
'kernel', where each vpt:: operator's fake implementation gives the shapes,
so the graph shows the kernels a program traced on the card holds
(chip_smoke.py phase 5i checks the same counts there at full depth). A CPU
build of torch cannot index a FakeTensorMode CUDA tensor, hence meta.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import init_pruned, jax_and_torch_params
from vit_pruning_tpu.configs import PruneConfig, deit_small, vit_tiny
from vit_pruning_tpu.serving import serving_forward as jax_serving_forward
from vit_pruning_tpu_torch.models.vit import layer_slice
from vit_pruning_tpu_torch.ops.cuda import attention as tatt
from vit_pruning_tpu_torch.ops.cuda import embed as temb
from vit_pruning_tpu_torch.ops.cuda import layer as tl
from vit_pruning_tpu_torch.ops.cuda import layer_int8 as t8
from vit_pruning_tpu_torch.ops.cuda import mlp as tmlp
from vit_pruning_tpu_torch.ops.cuda import model as tmod
from vit_pruning_tpu_torch.ops.cuda.library import OP_MODULES, load_ops
from vit_pruning_tpu_torch.ops.dispatch import kernel_mode, launch_kernel_for
from vit_pruning_tpu_torch.ops.quant import kmajor_int8_weights, quantize_layer_params
from vit_pruning_tpu_torch.serving import export_serving, load_exported, serving_forward

CFG = vit_tiny()
# spreads the predictor's scores so that the top-k cut is not a near tie
PREDICTOR_GAIN = 30.0
U8 = np.random.RandomState(1).randint(0, 256, (4, 3, CFG.image_size, CFG.image_size), np.uint8)
KERNEL_OPS = {"fused_vit_layer", "fused_vit_layer_cls_logits", "fused_vit_layer_bucketed",
              "fused_vit_layer_int8", "fused_vit_encoder", "fused_attention", "fused_mlp",
              "fused_patch_embed_u8", "fused_patch_embed_f", "fused_image_embed_u8"}


def _setup(cfg=CFG, top_k=8):
    pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp", top_k=top_k)
    params = init_pruned(cfg, pcfg)
    params["predictor"] = jax.tree.map(lambda a: a * PREDICTOR_GAIN, params["predictor"])
    jparams, tparams = jax_and_torch_params(params)
    return pcfg, jparams, tparams


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_meta(v) for v in tree]
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_export_round_trip_bit_exact(quant, tmp_path):
    """Export -> save -> load -> the direct call's logits bit for bit; a
    wrong batch or dtype is refused (as tests/test_serving.py's artifact)."""
    pcfg, _, tparams = _setup()
    path = str(tmp_path / "serving.pt2")
    export_serving(tparams, CFG, pcfg, batch_size=4, path=path, quant=quant)
    served = load_exported(path)
    u8 = torch.from_numpy(U8)
    direct = serving_forward(tparams, u8, CFG, pcfg, quant=quant)["logits"]
    np.testing.assert_array_equal(served(tparams, u8).numpy(), direct.numpy())
    with pytest.raises(Exception):
        served(tparams, u8[:1])
    with pytest.raises(Exception):
        served(tparams, u8.float())


def test_exported_logits_match_jax(tmp_path):
    """The reloaded program against the JAX package's serving_forward on
    the same weights and pixels (f32, its plain route)."""
    pcfg, jparams, tparams = _setup()
    want = jax_serving_forward(jparams, jnp.asarray(U8), CFG, pcfg, use_pallas=False,
                               quant="none")["logits"]
    path = str(tmp_path / "serving.pt2")
    export_serving(tparams, CFG, pcfg, batch_size=4, path=path)
    got = load_exported(path)(tparams, torch.from_numpy(U8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_export_keeps_no_weights(tmp_path):
    """The params are the program's inputs: the program holds none of them."""
    pcfg, _, tparams = _setup()
    program = export_serving(tparams, CFG, pcfg, batch_size=4)
    assert program.example_inputs is None
    assert not program.state_dict and not program.constants
    placeholders = [n for n in program.graph.nodes if n.op == "placeholder"]
    n_leaves = len(jax.tree.leaves(jax.tree.map(lambda t: 0, tparams)))
    assert len(placeholders) == n_leaves + 1  # every param leaf and the pixels


def _ops(program) -> dict:
    return dict(Counter(str(n.target) for n in program.graph.nodes
                        if n.op == "call_function" and str(n.target).startswith("vpt.")))


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("model", ["vit_tiny", "deit_s_3_layers"])
def test_kernel_route_traces_to_the_operators(model, quant):
    """export_serving in kernel mode 'kernel' on meta params: the program
    holds the embed as B8a on the image x 1, B1 x (L - 1) and B2 x 1 in
    float, B4 x (L - 1) and the float B2 under int8, and no plain version
    of them."""
    cfg = CFG if model == "vit_tiny" else deit_small(num_labels=100).replace(num_layers=3)
    pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp", top_k=cfg.num_patches // 2)
    _, _, tparams = _setup(cfg, pcfg.top_k)
    with kernel_mode("kernel"):
        program = export_serving(_meta(tparams), cfg, pcfg, batch_size=2, quant=quant)
    layer = "vpt.fused_vit_layer_int8.default" if quant == "int8" else "vpt.fused_vit_layer.default"
    assert _ops(program) == {"vpt.fused_image_embed_u8.default": 1, layer: cfg.num_layers - 1,
                             "vpt.fused_vit_layer_cls_logits.default": 1}
    out = [n for n in program.graph.nodes if n.op == "output"][0].args[0][0]
    assert tuple(out.meta["val"].shape) == (2, cfg.num_labels)


def test_meta_tensors_take_the_operator_only_in_kernel_mode():
    meta = torch.empty(2, device="meta")
    assert launch_kernel_for(meta) is False  # 'auto': meta runs the plain version
    with kernel_mode("kernel"):
        assert launch_kernel_for(meta) is True
        with pytest.raises(RuntimeError, match="CUDA"):
            launch_kernel_for(torch.empty(2))


def test_every_kernel_is_a_registered_operator():
    load_ops()
    names = {n for n in dir(torch.ops.vpt) if not n.startswith("_") and n != "name"}
    assert names == KERNEL_OPS
    assert set(OP_MODULES) == {"layer", "layer_int8", "model", "attention", "mlp", "embed"}
    with pytest.raises(NotImplementedError, match="vpt::fused_mlp"):  # no CPU implementation
        torch.ops.vpt.fused_mlp(*(torch.zeros(s) for s in ((2, 8), (8, 8), (8,), (8, 8), (8,))))


def _fake_and_plain(kernel: str, dt):
    """(the operator's outputs on meta tensors, the plain version's on the
    same CPU inputs), for each kernel at vit_tiny's geometry."""
    bb = jax.tree.map(lambda t: t.to(dt), _setup()[2]["backbone"])
    lp, lnf, head = layer_slice(bb["layers"], 0), bb["ln_f"], bb["head"]
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 17, 64).astype(np.float32)).to(dt)
    mask = torch.ones(2, 17, dtype=torch.bool)
    m = _meta
    heads = CFG.num_heads
    w = list(tl._layer_weights(lp).values())
    if kernel == "B1":
        return (torch.ops.vpt.fused_vit_layer(m(x), m(mask), m(w), heads, 64, 1e-12),
                tl.fused_vit_layer_ref(x, lp, heads, 1e-12, mask))
    if kernel == "B2":
        cw = list(tl._cls_weights(lp, lnf, head).values())
        return (torch.ops.vpt.fused_vit_layer_cls_logits(m(x), m(cw), heads, 64, 1e-12),
                tl.fused_vit_layer_cls_logits_ref(x, lp, lnf, head, heads))
    if kernel == "B3":
        dest = torch.arange(17).expand(2, 17).to(torch.int32).contiguous()
        return (torch.ops.vpt.fused_vit_layer_bucketed(m(x), m(dest), m(mask), m(w), 9, heads,
                                                       64, 1e-12),
                tl.fused_vit_layer_bucketed_ref(x, lp, dest, mask, 9, heads))
    if kernel == "B4":
        qp = quantize_layer_params(lp)
        nk = kmajor_int8_weights(qp)
        a, mlp = qp["attn"], qp["mlp"]
        w8 = [qp["ln1"]["g"], qp["ln1"]["b"], nk["qkv"]["wq"], nk["qkv"]["wscale"],
              nk["qkv"]["b"], nk["o"]["wq"], a["o"]["wscale"], a["o"]["b"], qp["ln2"]["g"],
              qp["ln2"]["b"], nk["fc1"]["wq"], mlp["fc1"]["wscale"], mlp["fc1"]["b"],
              nk["fc2"]["wq"], mlp["fc2"]["wscale"], mlp["fc2"]["b"]]
        out, *codes = torch.ops.vpt.fused_vit_layer_int8(m(x), m(mask), m(w8), heads, 64, 1e-12)
        ref, rc = t8.fused_vit_layer_int8_ref(x, qp, heads, 1e-12, mask, return_codes=True)
        flat = [t.reshape(34, -1) for k in t8.STAGES for t in rc[k]]
        return (out, *codes), (ref, *flat)
    if kernel == "B5":
        st = jax.tree.map(lambda t: t[:2], bb["layers"])
        sw = list(tl._layer_weights(st).values())
        return (torch.ops.vpt.fused_vit_encoder(m(x), m(mask), m(sw), heads, 64, 1e-12),
                tmod.fused_vit_encoder_ref(x, st, heads, 1e-12, mask))
    if kernel == "B6":
        q = x.reshape(2, 17, 4, 16).transpose(1, 2).contiguous()
        return (torch.ops.vpt.fused_attention(m(q), m(q), m(q), m(mask)),
                tatt.fused_attention_ref(q, q, q, mask))
    if kernel == "B7":
        f1, f2 = lp["mlp"]["fc1"], lp["mlp"]["fc2"]
        args = (x.reshape(34, 64), f1["w"], f1["b"], f2["w"], f2["b"])
        return torch.ops.vpt.fused_mlp(*map(m, args)), tmlp.fused_mlp_ref(*args)
    pw, pb = bb["embed"]["patch"]["w"], bb["embed"]["patch"]["b"]
    pos = bb["embed"]["pos"][0, 1:]
    if kernel == "B8a":
        u8 = torch.zeros(2, 16, 192, dtype=torch.uint8)
        return (torch.ops.vpt.fused_patch_embed_u8(m(u8), m(pw), m(pb), m(pos), 0.1, 0.2),
                temb.fused_patch_embed_u8_ref(u8, pw, pb, pos))
    if kernel == "B8a image":
        img = torch.zeros(2, 3, CFG.image_size, CFG.image_size, dtype=torch.uint8)
        cls, full = bb["embed"]["cls"].reshape(-1), bb["embed"]["pos"][0]
        reg = torch.zeros(4, 64, dtype=dt)
        return (torch.ops.vpt.fused_image_embed_u8(m(img), m(pw), m(pb), m(cls), m(full), m(reg),
                                                   CFG.patch_size, 0.1, 0.2),
                temb.fused_image_embed_u8_ref(img, pw, pb, cls, full, reg, CFG.patch_size))
    patches = torch.zeros(2, 16, 192, dtype=dt)
    return (torch.ops.vpt.fused_patch_embed_f(m(patches), m(pw), m(pb), m(pos), 1.0, 0.0),
            temb.fused_patch_embed_f_ref(patches, pw, pb, pos))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kernel", ["B1", "B2", "B3", "B4", "B5", "B6", "B7", "B8a", "B8a image",
                                    "B8b"])
def test_fake_implementation_matches_the_plain_version(kernel, dt):
    """Each operator on meta tensors (its fake implementation, no card)
    returns the plain version's shapes and dtypes."""
    got, want = _fake_and_plain(kernel, dt)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "meta"
        assert (tuple(g.shape), g.dtype) == (tuple(w.shape), w.dtype)
