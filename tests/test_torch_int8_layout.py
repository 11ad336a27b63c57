"""Kernel B4's int8 weight layout and the plain version of its int8 product body.

B4's products run on wgmma's s8 form, which reads both operands K-major, so
the weights go to the kernel as [N, K] (ops/quant.py::kmajor_int8_weights).
The forwards build that layout once per call (models/vit.py::layers_for),
where the wrapper once built it on every launch with torch.cat([w.t() ...]).
These tests hold the layout to that per-launch construction, for one layer
and for the stacked layers, show that B4's plain version ignores it, and hold
the plain version of one product of the body (ops/cuda/layer_int8.py::
gemm_s8_ref, which chip_smoke.py holds the CUDA body to bit for bit) to an
int64 numpy product with the same f32 dequant steps. The CUDA body itself
runs only on a GPU (chip_smoke.py phases 3c, 3h, 3j).
"""

import numpy as np
import pytest
import torch

from vit_pruning_tpu_torch.configs import ViTConfig
from vit_pruning_tpu_torch.models.convert import tree_to
from vit_pruning_tpu_torch.models.vit import init_vit_params, layer_slice, layers_for
from vit_pruning_tpu_torch.ops import dispatch
from vit_pruning_tpu_torch.ops import quant as tq
from vit_pruning_tpu_torch.ops.cuda import layer_int8 as tl8

CFG = ViTConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=3, num_heads=2,
                mlp_dim=128, num_labels=10)


def _layers(dtype=torch.float32) -> dict:
    """The stacked layers of a small ViT, with random biases and LN params
    (the init leaves them 0 and 1), quantized."""
    params = init_vit_params(CFG, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)

    def perturb(tree, key=""):
        if isinstance(tree, dict):
            return {k: perturb(v, k) for k, v in tree.items()}
        return tree + 0.1 * torch.randn(tree.shape, generator=gen) if key in ("g", "b") else tree

    return tq.quantize_layer_params(tree_to(perturb(params["layers"]), "cpu", dtype))


def _per_launch(qp: dict) -> dict:
    """The layout as the B4 wrapper built it on every launch, one layer."""
    a, m = qp["attn"], qp["mlp"]
    return {
        "qkv": {"wq": torch.cat([a[n]["wq"].t() for n in "qkv"], dim=0),
                "wscale": torch.cat([a[n]["wscale"] for n in "qkv"]),
                "b": torch.cat([a[n]["b"] for n in "qkv"])},
        "o": {"wq": a["o"]["wq"].t().contiguous()},
        "fc1": {"wq": m["fc1"]["wq"].t().contiguous()},
        "fc2": {"wq": m["fc2"]["wq"].t().contiguous()},
    }


def _assert_layout_equal(got: dict, want: dict):
    for lin in want:
        for key, w in want[lin].items():
            g = got[lin][key]
            assert g.dtype == w.dtype and g.is_contiguous(), (lin, key)
            torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmajor_layout_of_one_layer_is_the_per_launch_one(dtype):
    qp = layer_slice(_layers(dtype), 1)
    nk = tq.kmajor_int8_weights(qp)
    _assert_layout_equal(nk, _per_launch(qp))
    assert tuple(nk["qkv"]["wq"].shape) == (3 * CFG.attn_width, CFG.hidden_size)
    assert tuple(nk["fc2"]["wq"].shape) == (CFG.hidden_size, CFG.mlp_dim)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kmajor_layout_of_stacked_layers_slices_to_each_layer(dtype):
    """Built once on the stacked [L, ...] tree, layer i's slice is what the
    wrapper built for layer i: a contiguous [N, K] view."""
    layers = _layers(dtype)
    nk = tq.kmajor_int8_weights(layers)
    assert nk["qkv"]["wq"].shape[0] == CFG.num_layers
    for i in range(CFG.num_layers):
        _assert_layout_equal(layer_slice(nk, i), _per_launch(layer_slice(layers, i)))


def test_the_forwards_lay_out_the_weights_once_per_call():
    """layers_for under int8 quantizes and, with kernels on, attaches the
    layout; the tree's own leaves stay the quantized tree's; an attached
    layout is kept, not rebuilt; mode 'eager' (the plain path) adds none."""
    params = init_vit_params(CFG, torch.Generator().manual_seed(0), "cpu")
    layers = layers_for(params["layers"], "int8")
    assert tq.KMAJOR in layers and tq.is_quantized(layers)
    _assert_layout_equal(layers[tq.KMAJOR], tq.kmajor_int8_weights(layers))
    assert tq.with_kmajor_int8_weights(layers) is layers
    assert layers_for(layers, "int8") is layers
    assert layers_for(params["layers"], "none") is params["layers"]
    with dispatch.kernel_mode("eager"):
        assert tq.KMAJOR not in layers_for(params["layers"], "int8")
    for group, name in tq.LINEARS:  # the tree's own weights: [K, N], as quantize_weight gives
        want = tq.quantize_weight(params["layers"][group][name]["w"])[0]
        torch.testing.assert_close(layers[group][name]["wq"], want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b4_plain_version_ignores_the_layout(dtype):
    """The plain version reads the tree's [K, N] weights: with the layout
    attached, or with a layout of zeros, its output and codes are the same
    bit for bit; so is the wrapper's on CPU tensors."""
    qp = layer_slice(tq.with_kmajor_int8_weights(_layers(dtype)), 0)
    bare = {k: v for k, v in qp.items() if k != tq.KMAJOR}
    zeros = dict(bare, **{tq.KMAJOR: {lin: {k: torch.zeros_like(v) for k, v in d.items()}
                                      for lin, d in qp[tq.KMAJOR].items()}})
    x = torch.randn(2, 9, CFG.hidden_size, generator=torch.Generator().manual_seed(2)).to(dtype)
    want, want_codes = tl8.fused_vit_layer_int8_ref(x, bare, CFG.num_heads, return_codes=True)
    for tree in (qp, zeros):
        got, codes = tl8.fused_vit_layer_int8_ref(x, tree, CFG.num_heads, return_codes=True)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        for k in tl8.STAGES:
            assert torch.equal(codes[k][0], want_codes[k][0])
            assert torch.equal(codes[k][1], want_codes[k][1])
        torch.testing.assert_close(tl8.fused_vit_layer_int8(x, tree, CFG.num_heads), want,
                                   rtol=0, atol=0)


def _numpy_product(codes, rs, wt, ws, bias):
    """The exact int64 product, then the dequant's f32 steps one by one."""
    acc = codes.numpy().astype(np.int64) @ wt.numpy().astype(np.int64).T
    y = acc.astype(np.float32) * rs.numpy()
    y = y * ws.numpy()[None, :]
    return y + bias.numpy()[None, :]


@pytest.mark.parametrize("m, k16, n8, seed", [(1, 1, 1, 0), (17, 4, 6, 1), (40, 12, 24, 2),
                                              (33, 10, 60, 3), (136, 4, 24, 4)])
def test_gemm_s8_plain_version_is_the_exact_int_product_dequantized(m, k16, n8, seed):
    """gemm_s8_ref (and gemm_s8 on CPU tensors) = int64 product of the
    codes, (acc * row scale) * column scale + bias in f32, bit for bit; K a
    multiple of 16 as the body takes (vit_tiny's QKV: 136 rows, K 64, N
    192), codes at the clip edges included."""
    k, n = 16 * k16, 8 * n8
    g = torch.Generator().manual_seed(seed)
    codes = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    codes[0, 0] = -127
    wt = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    wt[-1, -1] = 127
    rs = torch.rand(m, 1, generator=g) * 1e-2 + 1e-6
    ws = torch.rand(n, generator=g) * 1e-2 + 1e-6
    bias = torch.randn(n, generator=g)
    want = _numpy_product(codes, rs, wt, ws, bias)
    for fn in (tl8.gemm_s8_ref, tl8.gemm_s8):
        got = fn(codes, rs, wt, ws, bias)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("act", ["none", "gelu_tanh", "gelu_erf"])
def test_gemm_s8_plain_epilogue_order(act):
    """+ bias, activation, + residual (f32 or the epilogue dtype), one cast:
    the order of B4's epilogue; bf16 output is the f32 result rounded once."""
    g = torch.Generator().manual_seed(3)
    m, k, n = 24, 64, 40
    codes = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    wt = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    rs, ws = torch.rand(m, 1, generator=g) * 1e-2, torch.rand(n, generator=g) * 1e-2
    bias, res = torch.randn(n, generator=g), torch.randn(m, n, generator=g)
    y = torch.from_numpy(_numpy_product(codes, rs, wt, ws, bias))
    if act != "none":
        y = torch.nn.functional.gelu(y, approximate="tanh" if act == "gelu_tanh" else "none")
    y = y + res
    got = tl8.gemm_s8_ref(codes, rs, wt, ws, bias, act, res)
    torch.testing.assert_close(got, y, rtol=0, atol=0)
    got16 = tl8.gemm_s8(codes, rs, wt, ws, bias.bfloat16(), act, res, torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    torch.testing.assert_close(
        got16, tl8.gemm_s8_ref(codes, rs, wt, ws, bias.bfloat16(), act, res).bfloat16(),
        rtol=0, atol=0)


def test_gemm_s8_raises_for_cuda_work_in_kernel_mode_on_the_cpu():
    codes = torch.zeros(4, 16, dtype=torch.int8)
    wt = torch.zeros(8, 16, dtype=torch.int8)
    counts = tl8.gemm_s8.launches
    with dispatch.kernel_mode("kernel"):
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tl8.gemm_s8(codes, torch.ones(4, 1), wt, torch.ones(8))
    with pytest.raises(ValueError, match="codes"):
        tl8.gemm_s8(codes, torch.ones(4, 1), torch.zeros(8, 32, dtype=torch.int8), torch.ones(8))
    assert tl8.gemm_s8.launches == counts
