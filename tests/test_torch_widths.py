"""Widths the CUDA kernels do not take (ROADMAP C.1), on the CPU.

The wrappers zero-pad D and M up to the kernels' multiple (8; 16 for B4)
and pass the true width to the layer norms (ops/cuda/widths.py). Here the
plain versions run that padded problem, with the layer norms over the true
width (`norm_width`, the kernels' DN), and must give the unpadded problem's
result: at M 1000 (DeiT-S with 1000 of 1536 MLP channels kept; a multiple
of 8, not of 16) and at D 100 (4 heads of 16, MLP 300). On the card
chip_smoke.py phase 3l holds the kernels themselves to the unpadded plain
versions at the same two shapes. Then the entry points at those widths
against the JAX package, weights carried across by the bridge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_numpy, init_pruned, jax_and_torch_params, randn
from vit_pruning_tpu.configs import PruneConfig, ViTConfig, deit_small
from vit_pruning_tpu.models.vit import vit_forward as jax_vit_forward
from vit_pruning_tpu.ops.structured import prune_mlp_channels
from vit_pruning_tpu.serving import serving_forward as jax_serving_forward
from vit_pruning_tpu_torch.models import vit as tvit
from vit_pruning_tpu_torch.ops.cuda import layer as tl
from vit_pruning_tpu_torch.ops.cuda import layer_int8 as t8
from vit_pruning_tpu_torch.ops.cuda import model as tmod
from vit_pruning_tpu_torch.ops.cuda.widths import (
    INT8_MULTIPLE,
    LAYER_MULTIPLE,
    PADDED,
    kernel_layer,
    pad_dim,
    with_kernel_weights,
)
from vit_pruning_tpu_torch.ops.dispatch import kernel_mode
from vit_pruning_tpu_torch.ops.masking import compact_dest
from vit_pruning_tpu_torch.ops.quant import KMAJOR, quantize_layer_params
from vit_pruning_tpu_torch.serving import serving_forward

EPS = 1e-12
M1000 = sorted(np.random.RandomState(7).permutation(1536)[:1000].tolist())
D100 = ViTConfig(image_size=32, patch_size=8, hidden_size=100, num_layers=2, num_heads=4,
                 attn_head_dim=16, mlp_dim=300, num_labels=10)


def _narrow_attention(layers: dict, kw: int) -> dict:
    """q, k, v project to their first kw columns and o reads them: the
    geometry of attn_head_dim, whose attention width is heads x head dim."""
    a = layers["attn"]
    attn = {n: {"w": a[n]["w"][..., :kw], "b": a[n]["b"][..., :kw]} for n in "qkv"}
    attn["o"] = {"w": a["o"]["w"][..., :kw, :], "b": a["o"]["b"]}
    return dict(layers, attn=attn)


def _jax_model(shape: str):
    """(JAX config, JAX params) of one of the two geometries; LN gains and
    biases perturbed so that a wrong normalisation width shows."""
    from vit_pruning_tpu.models.vit import init_vit_params

    if shape == "M 1000":
        cfg = deit_small(num_labels=10).replace(num_layers=2, image_size=64)
        params = init_vit_params(jax.random.PRNGKey(0), cfg)
        params = prune_mlp_channels(params, [M1000] * cfg.num_layers)
    else:
        cfg = D100
        params = init_vit_params(jax.random.PRNGKey(0), cfg.replace(attn_head_dim=None))
        params = dict(params, layers=_narrow_attention(params["layers"], cfg.attn_width))
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 64))

    def perturb(tree):
        if isinstance(tree, dict):
            return {k: (v + 0.1 * jax.random.normal(next(keys), v.shape)
                        if k in ("g", "b") and not isinstance(v, dict) else perturb(v))
                    for k, v in tree.items()}
        return tree

    return cfg, perturb(params)


def _padded(x: torch.Tensor, tree: dict, multiple: int):
    """(x, tree) as a wrapper hands them to its kernel."""
    kt = kernel_layer(tree, multiple)
    return pad_dim(x, -1, kt["ln1"]["g"].shape[-1]), kt


@pytest.mark.parametrize("kernel", ["B1", "B2", "B3", "B4", "B5"])
@pytest.mark.parametrize("shape", ["M 1000", "D 100"])
def test_padded_plain_layer_equals_unpadded(shape, kernel):
    cfg, jparams = _jax_model(shape)
    _, tparams = jax_and_torch_params(jparams)
    st = tparams["layers"]
    lp = tvit.layer_slice(st, 0)
    d, heads = cfg.hidden_size, cfg.num_heads
    x = torch.from_numpy(randn(3, (2, 17, d)))
    mask = torch.from_numpy(np.random.RandomState(4).rand(2, 17) > 0.3)
    mask[:, 0] = True
    if kernel == "B1":
        xk, kp = _padded(x, lp, LAYER_MULTIPLE)
        got = tl.fused_vit_layer_ref(xk, kp, heads, EPS, mask, norm_width=d)[..., :d]
        want = tl.fused_vit_layer_ref(x, lp, heads, EPS, mask)
    elif kernel == "B2":
        xk, kp = _padded(x, lp, LAYER_MULTIPLE)
        dp = xk.shape[-1]
        lnf = {k: pad_dim(v, -1, dp) for k, v in tparams["ln_f"].items()}
        head = {"w": pad_dim(tparams["head"]["w"], 0, dp), "b": tparams["head"]["b"]}
        got = tl.fused_vit_layer_cls_logits_ref(xk, kp, lnf, head, heads, EPS, norm_width=d)
        want = tl.fused_vit_layer_cls_logits_ref(x, lp, tparams["ln_f"], tparams["head"], heads)
    elif kernel == "B3":
        xk, kp = _padded(x, lp, LAYER_MULTIPLE)
        dest = compact_dest(mask)
        got = tl.fused_vit_layer_bucketed_ref(xk, kp, dest, mask, 13, heads, EPS,
                                              norm_width=d)[..., :d]
        want = tl.fused_vit_layer_bucketed_ref(x, lp, dest, mask, 13, heads)
    elif kernel == "B4":
        qp = quantize_layer_params(lp)
        xk, kq = _padded(x, qp, INT8_MULTIPLE)
        got, gc = t8.fused_vit_layer_int8_ref(xk, kq, heads, EPS, mask, return_codes=True,
                                              norm_width=d)
        want, wc = t8.fused_vit_layer_int8_ref(x, qp, heads, EPS, mask, return_codes=True)
        got = got[..., :d]
        for k in t8.STAGES:  # the padded columns' codes are 0, the rest the same
            codes, n = gc[k][0], wc[k][0].shape[-1]
            assert torch.equal(codes[..., :n], wc[k][0]) and not codes[..., n:].any()
            assert torch.equal(gc[k][1], wc[k][1])
    else:
        xk, ks = _padded(x, st, LAYER_MULTIPLE)
        got = tmod.fused_vit_encoder_ref(xk, ks, heads, EPS, mask, norm_width=d)[..., :d]
        want = tmod.fused_vit_encoder_ref(x, st, heads, EPS, mask)
    np.testing.assert_allclose(as_numpy(got), as_numpy(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape, multiple, want", [
    ("M 1000", LAYER_MULTIPLE, (384, 1000)), ("M 1000", INT8_MULTIPLE, (384, 1008)),
    ("D 100", LAYER_MULTIPLE, (104, 304)), ("D 100", INT8_MULTIPLE, (112, 304))])
def test_padded_widths(shape, multiple, want):
    """D and M round up to the multiple; the attention width (heads x head
    dim, a multiple of 16) keeps its size; padded LN gains, biases and
    weights are zeros, padded int8 column scales ones."""
    _, jparams = _jax_model(shape)
    _, tparams = jax_and_torch_params(jparams)
    layers = tparams["layers"]
    if multiple == INT8_MULTIPLE:
        layers = quantize_layer_params(layers)
    kp = kernel_layer(layers, multiple)
    w = "wq" if multiple == INT8_MULTIPLE else "w"
    d, m = layers["ln1"]["g"].shape[-1], layers["mlp"]["fc1"][w].shape[-1]
    assert (kp["ln1"]["g"].shape[-1], kp["mlp"]["fc1"][w].shape[-1]) == want
    assert kp["attn"]["q"][w].shape[-1] == layers["attn"]["q"][w].shape[-1]
    assert not kp["ln1"]["g"][..., d:].any() and not kp["mlp"]["fc1"][w][..., m:].any()
    assert not kp["mlp"]["fc2"][w][..., m:, :].any() and not kp["attn"]["o"]["b"][..., d:].any()
    if multiple == INT8_MULTIPLE:
        assert bool((kp["mlp"]["fc1"]["wscale"][..., m:] == 1).all())
    if want == (d, m):
        assert kp is layers  # nothing to pad: the tree itself


def test_layers_for_pads_once_per_forward():
    """With kernels on, layers_for attaches the padded tree (and, under int8,
    B4's K-major layout of it) once, beside the tree's own leaves; not in
    mode 'eager', not when autograd records through the leaves."""
    _, jparams = _jax_model("D 100")
    _, tparams = jax_and_torch_params(jparams)
    layers = tparams["layers"]
    with kernel_mode("eager"):
        assert tvit.layers_for(layers, "none") is layers
    float_tree = tvit.layers_for(layers, "none")
    assert float_tree[PADDED]["ln1"]["g"].shape[-1] == 104
    assert float_tree["ln1"] is layers["ln1"]  # the plain consumers' leaves unchanged
    assert kernel_layer(tvit.layer_slice(float_tree, 1), LAYER_MULTIPLE)["ln1"]["g"].shape == (104,)
    int8_tree = tvit.layers_for(layers, "int8")
    assert int8_tree[PADDED]["ln1"]["g"].shape[-1] == 112
    assert int8_tree[PADDED][KMAJOR]["fc1"]["wq"].shape == (2, 304, 112)
    grads = {k: v for k, v in layers.items()}
    grads["ln1"] = {k: v.clone().requires_grad_(True) for k, v in layers["ln1"].items()}
    assert PADDED not in with_kernel_weights(grads, LAYER_MULTIPLE)
    m1000 = jax_and_torch_params(_jax_model("M 1000")[1])[1]["layers"]
    assert PADDED not in tvit.layers_for(m1000, "none")  # M 1000: a multiple of 8
    assert tvit.layers_for(m1000, "int8")[PADDED][KMAJOR]["fc1"]["wq"].shape == (2, 1008, 384)


def test_kernel_route_pads_and_slices():
    """Traced on meta tensors in mode 'kernel', each layer wrapper hands its
    operator the padded problem and returns the model's width."""
    _, jparams = _jax_model("D 100")
    _, tparams = jax_and_torch_params(jparams)
    meta = jax.tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tparams)
    lp = tvit.layer_slice(meta["layers"], 0)
    x = torch.empty(2, 17, 100, device="meta")
    mask = torch.ones(2, 17, dtype=torch.bool, device="meta")
    with kernel_mode("kernel"):
        assert tl.fused_vit_layer(x, lp, 4, EPS, mask).shape == (2, 17, 100)
        assert tl.fused_vit_layer_cls_logits(x, lp, meta["ln_f"], meta["head"], 4).shape == (2, 10)
        dest = torch.empty(2, 17, dtype=torch.int32, device="meta")
        assert tl.fused_vit_layer_bucketed(x, lp, dest, mask, 9, 4).shape == (2, 17, 100)
        out, codes = t8.fused_vit_layer_int8(x, quantize_layer_params(lp), 4, EPS, mask,
                                             return_codes=True)
        assert out.shape == (2, 17, 100)
        assert [codes[k][0].shape[-1] for k in t8.STAGES] == [100, 64, 100, 300]
        assert tmod.fused_vit_encoder(x, meta["layers"], 4, EPS, mask).shape == (2, 17, 100)


def test_pruned_mlp_1000_serves_as_jax():
    """DeiT-S width with 1000 of 1536 MLP channels a layer kept (3 layers):
    the port's serving_forward against the JAX package's, the same weights
    and pixels, f32."""
    cfg = deit_small(num_labels=10).replace(num_layers=3, image_size=64)
    pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp", top_k=8)
    params = init_pruned(cfg, pcfg)
    params["predictor"] = jax.tree.map(lambda a: a * 30.0, params["predictor"])
    params["backbone"] = prune_mlp_channels(params["backbone"], [M1000] * cfg.num_layers)
    jparams, tparams = jax_and_torch_params(params)
    u8 = np.random.RandomState(5).randint(0, 256, (2, 3, 64, 64), np.uint8)
    want = jax_serving_forward(jparams, jnp.asarray(u8), cfg, pcfg, use_pallas=False,
                               quant="none")
    got = serving_forward(tparams, torch.from_numpy(u8), cfg, pcfg)
    np.testing.assert_array_equal(got["keep_masks"].numpy(), np.asarray(want["keep_masks"]))
    np.testing.assert_allclose(as_numpy(got["logits"]), np.asarray(want["logits"]), atol=2e-5)


def test_hidden_100_forward_as_jax():
    """D 100 with 4 heads of 16 (attn_head_dim): the dense forward against
    the JAX package's, f32."""
    cfg, jparams = _jax_model("D 100")
    _, tparams = jax_and_torch_params(jparams)
    x = randn(6, (2, 3, 32, 32))
    want = jax_vit_forward(jparams, jnp.asarray(x), cfg)["logits"]
    got = tvit.vit_forward(tparams, torch.from_numpy(x), cfg)["logits"]
    np.testing.assert_allclose(as_numpy(got), np.asarray(want), atol=2e-5)
