"""The port's int8 quantization (vit_pruning_tpu_torch/ops/quant.py), the
serving-quant switch, the weight bridge for quantized trees and the plain
version of kernel B4 (ops/cuda/layer_int8.py) against the JAX package: its
ops/quant.py and its Pallas int8 kernel in interpret mode.

Codes must be equal exactly. A code can only differ where an activation
sits within float noise of a rounding boundary (k + 0.5): the layer tests
count the codes of each quantized stage that differ between the packages
and report the count, so that such a flip is named, not hidden in a
tolerance. The CUDA kernel itself runs only on a GPU; chip_smoke.py holds
it to this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_numpy, as_torch, jax_and_torch_params, randn, to_numpy
from vit_pruning_tpu.configs import ViTConfig
from vit_pruning_tpu.models.vit import init_vit_params, layer_norm as jax_layer_norm
from vit_pruning_tpu.ops import quant as jq
from vit_pruning_tpu.ops.pallas.layer_int8 import _rowquant, fused_vit_layer_int8
from vit_pruning_tpu.ops.structured import prune_heads, prune_mlp_channels
from vit_pruning_tpu_torch.models.convert import params_from_jax, params_to_numpy, tree_to
from vit_pruning_tpu_torch.models.vit import layer_norm
from vit_pruning_tpu_torch.ops import dispatch
from vit_pruning_tpu_torch.ops import quant as tq
from vit_pruning_tpu_torch.ops.cuda import layer_int8 as tl8

# f32: the bound tests/test_pallas.py holds the Pallas int8 kernel to the jnp
# int8 layer with (:210-215). bf16: two bf16 steps at the output's largest
# magnitude (both sides round at the same places; an f32 sum in another
# order may land a value on the neighbouring bf16 number, once in an
# intermediate and once in the output).
F32_ATOL = 1e-4
CFG = ViTConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2, num_heads=2,
                mlp_dim=128, num_labels=10)


def _bf16_tol(ref: np.ndarray) -> float:
    top = max(float(np.abs(ref).max()), 1e-30)
    return 2.0 * 2.0 ** (np.floor(np.log2(top)) - 7)


def _layer(pruned=False, i=0):
    params = init_vit_params(jax.random.PRNGKey(0), CFG)
    cfg = CFG
    if pruned:  # composed geometry: half the heads (KW < D), half the MLP
        params, cfg = prune_heads(params, CFG, [[1]] * CFG.num_layers)
        params = prune_mlp_channels(params, [list(range(0, CFG.mlp_dim, 2))] * CFG.num_layers)
    lp = jax.tree.map(lambda a: a[i], params["layers"])
    # random LN gains and biases (init leaves them 1 and 0, hiding a bias bug)
    rs = np.random.RandomState(7)
    for path in (("ln1", "g"), ("ln1", "b"), ("ln2", "g"), ("ln2", "b"), ("attn", "q", "b"),
                 ("attn", "v", "b"), ("attn", "o", "b"), ("mlp", "fc1", "b"), ("mlp", "fc2", "b")):
        node = lp
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = node[path[-1]] + 0.1 * rs.randn(*node[path[-1]].shape).astype(np.float32)
    return cfg, lp, params


def _mask(b, s, seed=2):
    m = np.random.RandomState(seed).rand(b, s) > 0.3
    m[:, 0] = True
    return m


def _quantized(lp, dtype=jnp.float32):
    """(JAX quantized tree, port quantized tree) from the same float weights."""
    jlp, tlp = jax_and_torch_params(lp, dtype)
    return jq.quantize_layer_params(jlp), tq.quantize_layer_params(tlp)


def _assert_codes_equal(got, want, what, maxulp=1):
    """Codes equal; scales within `maxulp` (1 on the same inputs; an LN
    output computed by each package differs in its last bits, and its amax
    with it)."""
    q, s = got
    jqc, js = want
    flips = int((q.numpy().astype(np.int32) != np.asarray(jqc).astype(np.int32)).sum())
    assert flips == 0, f"{what}: {flips} of {q.numel()} int8 codes differ"
    np.testing.assert_array_max_ulp(as_numpy(s), np.asarray(js, np.float32), maxulp=maxulp)


# --- quantization ops ------------------------------------------------------------------

def test_quantize_weight_matches_jax():
    w = randn(3, (64, 48)) * 0.05
    w[:, 5] = 0.0  # an all-zero column: scale 1e-12 / 127, codes 0
    got = tq.quantize_weight(torch.from_numpy(w))
    _assert_codes_equal(got, jq.quantize_weight(jnp.asarray(w)), "quantize_weight")
    assert got[0].dtype == torch.int8 and got[1].dtype == torch.float32


def test_quantize_rows_matches_jax():
    x = randn(4, (3, 17, 64)) * 2.0
    got = tq.quantize_rows(torch.from_numpy(x))
    _assert_codes_equal(got, jq.quantize_rows(jnp.asarray(x)), "quantize_rows")
    assert got[1].shape == (3, 17, 1)


@pytest.mark.parametrize("stacked", [False, True], ids=["one_layer", "stacked"])
def test_quantize_layer_params_matches_jax(stacked):
    """The stacked [L, K, N] tree is quantized layer by layer (amax over K
    inside each layer), as JAX's vmap does; 'w' becomes 'wq' + 'wscale'."""
    _, lp, params = _layer()
    tree = params["layers"] if stacked else lp
    want = jq.quantize_layer_params(tree)
    got = tq.quantize_layer_params(params_from_jax(to_numpy(tree), "cpu"))
    for group, name in tq.LINEARS:
        g, w = got[group][name], want[group][name]
        assert set(g) == set(w) == {"wq", "wscale", "b"}
        _assert_codes_equal((g["wq"], g["wscale"]), (w["wq"], w["wscale"]), f"{group}.{name}")
    np.testing.assert_array_equal(as_numpy(got["ln1"]["g"]), np.asarray(want["ln1"]["g"]))


def test_round_half_to_even():
    """amax 127 makes the scale 1 (both the /127 and the *(1/127) forms), so
    the codes are the row's values rounded half to even."""
    row = np.array([[127.0, 0.5, 1.5, 2.5, 3.5, -0.5, -1.5, -2.5, 126.5, -126.5, 0.49, 2.51,
                     -127.0, 64.5, -64.5, 7.0]], np.float32)
    want = np.array([[127, 0, 2, 2, 4, 0, -2, -2, 126, -126, 0, 3, -127, 64, -64, 7]])
    for fn in (tq.quantize_rows, tl8.rowquant_ref, tl8.rowquant):
        q, s = fn(torch.from_numpy(row))
        assert float(s) == 1.0
        np.testing.assert_array_equal(q.numpy(), want)
    np.testing.assert_array_equal(np.asarray(_rowquant(jnp.asarray(row))[0]), want)


def test_rowquant_ref_follows_the_tpu_kernel():
    """B4's row quantization takes the scale as amax * (1/127), the TPU
    kernel's `_rowquant`; ops/quant.py divides by 127. The two scales differ
    in the last bit for some rows, and each side matches its own JAX
    counterpart exactly."""
    x = randn(5, (512, 64)) * 3.0
    q, s = tl8.rowquant_ref(torch.from_numpy(x))
    jqc, js = _rowquant(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqc))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    _, s_div = tq.quantize_rows(torch.from_numpy(x))
    assert (s_div != s).any()


def test_int8_linear_matches_jax():
    x = randn(6, (2, 9, 64))
    w = randn(7, (64, 32)) * 0.05
    b = randn(8, (32,)) * 0.1
    wq, ws = tq.quantize_weight(torch.from_numpy(w))
    got = tq.int8_linear(torch.from_numpy(x), wq, ws, torch.from_numpy(b))
    jwq, jws = jq.quantize_weight(jnp.asarray(w))
    want = jq.int8_linear(jnp.asarray(x), jwq, jws, jnp.asarray(b))
    np.testing.assert_allclose(as_numpy(got), np.asarray(want), atol=1e-6, rtol=1e-6)
    acc = tq.int_matmul(tq.quantize_rows(torch.from_numpy(x))[0], wq)
    assert acc.dtype == torch.int32 and acc.shape == (2, 9, 32)


# --- the int8 layers -------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_int8_layer_ref_matches_jax(masked):
    cfg, lp, _ = _layer()
    jqp, tqp = _quantized(lp)
    x = randn(1, (4, 17, cfg.hidden_size))
    mask = _mask(4, 17) if masked else None
    got = tq.int8_vit_layer_ref(as_torch(x), tqp, cfg,
                                None if mask is None else torch.from_numpy(mask))
    want = np.asarray(jq.int8_vit_layer_ref(jnp.asarray(x), jqp, cfg,
                                            None if mask is None else jnp.asarray(mask)))
    # the first quantized stage, LN1's output, from both packages
    h = layer_norm(as_torch(x), tqp["ln1"], cfg.layernorm_eps)
    jh = jax_layer_norm(jnp.asarray(x), jqp["ln1"], cfg.layernorm_eps)
    _assert_codes_equal(tq.quantize_rows(h), jq.quantize_rows(jh), "LN1 codes", maxulp=4)
    rows = np.ones((4, 17), bool) if mask is None else mask
    err = np.abs(as_numpy(got) - want)[rows]
    assert err.max() < F32_ATOL, err.max()


def _ln1_flips(codes, x: torch.Tensor, qp: dict, eps: float) -> int:
    """LN1 codes of B4's plain version that differ from the TPU kernel's own
    f32 LN and `_rowquant` on the same input: a flip counted where it
    happens, not where it propagates."""
    from vit_pruning_tpu.ops.pallas.layer_int8 import _layer_norm_f32

    g, b = (jnp.asarray(as_numpy(qp["ln1"][k])) for k in "gb")
    jqc, _ = _rowquant(_layer_norm_f32(jnp.asarray(as_numpy(x)), g, b, eps))
    return int((codes["ln1"][0].numpy() != np.asarray(jqc)).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("pruned", [False, True], ids=["deit", "composed"])
def test_b4_plain_matches_pallas_interpret(pruned, masked, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cfg, lp, _ = _layer(pruned)
    jqp, tqp = _quantized(lp, jdt)
    x = randn(1, (4, 17, cfg.hidden_size))
    mask = _mask(4, 17) if masked else None
    got, codes = tl8.fused_vit_layer_int8_ref(
        as_torch(x, tdt), tqp, cfg.num_heads, cfg.layernorm_eps,
        None if mask is None else torch.from_numpy(mask), return_codes=True)
    want = fused_vit_layer_int8(jnp.asarray(x, jdt), jqp, cfg.num_heads, eps=cfg.layernorm_eps,
                                token_mask=None if mask is None else jnp.asarray(mask),
                                interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    flips = _ln1_flips(codes, as_torch(x, tdt), tqp, cfg.layernorm_eps)
    assert flips == 0, f"{flips} LN1 codes differ from the TPU kernel's"
    assert set(codes) == set(tl8.STAGES)
    rows = np.ones((4, 17), bool) if mask is None else mask
    err = np.abs(as_numpy(got) - want)[rows]
    tol = F32_ATOL if dtype == "float32" else _bf16_tol(want)
    assert err.max() <= tol, (err.max(), tol)


def test_b4_plain_is_close_to_the_eager_int8_layer():
    """The TPU kernel's numerics and ops/quant.py's differ by float noise
    (the scale's last bit, staged2 against a normalised softmax): in f32
    the two int8 layers agree to the f32 bound."""
    cfg, lp, _ = _layer()
    _, tqp = _quantized(lp)
    x = as_torch(randn(3, (4, 17, cfg.hidden_size)))
    a = tl8.fused_vit_layer_int8_ref(x, tqp, cfg.num_heads, cfg.layernorm_eps)
    b = tq.int8_vit_layer_ref(x, tqp, cfg)
    assert (a - b).abs().max().item() < F32_ATOL


# --- wrappers on the CPU, the switch, the bridge -------------------------------------

def test_b4_wrapper_runs_its_plain_version_on_the_cpu():
    cfg, lp, _ = _layer()
    _, tqp = _quantized(lp)
    x = as_torch(randn(1, (2, 9, cfg.hidden_size)))
    counts = (tl8.fused_vit_layer_int8.launches, tl8.rowquant.launches)
    y = tl8.fused_vit_layer_int8(x, tqp, cfg.num_heads, cfg.layernorm_eps)
    torch.testing.assert_close(y, tl8.fused_vit_layer_int8_ref(x, tqp, cfg.num_heads,
                                                               cfg.layernorm_eps), rtol=0, atol=0)
    tl8.rowquant(x[0])
    assert (tl8.fused_vit_layer_int8.launches, tl8.rowquant.launches) == counts
    with dispatch.kernel_mode("kernel"):
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tl8.fused_vit_layer_int8(x, tqp, cfg.num_heads)
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tl8.rowquant(x[0])


def test_serving_quant_switch():
    assert dispatch.serving_quant() == "none"
    with dispatch.quant_mode("int8"):
        assert dispatch.serving_quant() == "int8"
        assert dispatch.resolve_quant(None) == "int8"
        assert dispatch.resolve_quant("none") == "none"
    assert dispatch.serving_quant() == "none"
    with pytest.raises(ValueError, match="serving quant"):
        dispatch.set_serving_quant("int4")
    with pytest.raises(ValueError, match="serving quant"):
        dispatch.resolve_quant("fp8")
    with pytest.raises(ValueError, match="serving quant"):
        with dispatch.quant_mode("bf16"):
            pass
    assert dispatch.serving_quant() == "none"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_carries_quantized_trees_unchanged(dtype):
    """int8 'wq' stays int8 and 'wscale' float32 through params_from_jax,
    tree_to and params_to_numpy; the float leaves take the dtype."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    _, lp, params = _layer()
    for tree in (lp, params["layers"]):
        jtree = jq.quantize_layer_params(jax.tree.map(lambda a: a.astype(jdt), tree))
        t = tree_to(params_from_jax(to_numpy(jtree), "cpu", tdt), "cpu", tdt)
        back = params_to_numpy(t)
        for group, name in tq.LINEARS:
            lin, jlin = t[group][name], jtree[group][name]
            assert lin["wq"].dtype == torch.int8 and lin["wscale"].dtype == torch.float32
            assert lin["b"].dtype == tdt
            np.testing.assert_array_equal(back[group][name]["wq"], np.asarray(jlin["wq"]))
            np.testing.assert_array_equal(back[group][name]["wscale"], np.asarray(jlin["wscale"]))
            assert back[group][name]["wq"].dtype == np.int8
            np.testing.assert_array_equal(back[group][name]["b"],
                                          np.asarray(jlin["b"].astype(jnp.float32)))
