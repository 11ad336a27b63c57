"""Kernel B2 (the last layer's CLS row, the final LayerNorm and the
classifier) on the CPU: its plain version, which the card holds the CUDA
kernel (vit_pruning_tpu_torch/csrc/cls_logits.cu) to, and a torch emulation
of the kernel's float32 arithmetic (tests/torch_parity.py::
cls_logits_f32_emulated: split-bf16 products with per-step sums), against
the JAX package's Pallas kernel in interpret mode where a broken softmax
would show, and the Python mirror of the kernel's launch plan.

The weights make the CLS softmax peaked: W_q and W_k are redrawn at std
1.6 / sqrt(D), so that q and k have about that std and the logits about
its square (~2.6). At the init's 0.02 the logits lie within ~0.15 of each
other and a uniform softmax would pass. Head dims 16, 32, 64 and 80 (narrow
models: D 64 / 128 / 128 / 160), S at the edges of the bf16 kernel's 64-row
tiles, its 128-row passes and where it keeps V (registers up to 128 tokens,
shared memory, recomputed past 512 at hd 64), float32 and bfloat16. Each
case retraces the Pallas kernel (~1-3 s), so the cases are chosen, not
crossed.

Tolerances: tests/test_torch_layer.py's for f32 (atol 2e-5, rtol 1e-4, as
tests/test_pallas.py holds the Pallas kernel to the jnp layer); bf16: two
bf16 steps at the logits' largest magnitude (both sides round at the same
places, but their f32 sums run in another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_numpy, as_torch, cls_logits_f32_emulated, jax_and_torch_params, randn
from vit_pruning_tpu.configs import ViTConfig, deit_small, vit_huge, vit_tiny
from vit_pruning_tpu.models.vit import init_vit_params
from vit_pruning_tpu.ops.pallas.layer import fused_vit_layer_cls_logits
from vit_pruning_tpu_torch.ops.cuda import layer as tl

F32_ATOL, F32_RTOL = 2e-5, 1e-4
QK_STD = 1.6  # W_q, W_k at this std / sqrt(D): logits spread ~QK_STD ** 2
BATCH = 3
GEOMETRIES = {  # head dim -> a narrow model at it (10 labels: no multiple of 8)
    16: vit_tiny(num_labels=10),
    32: ViTConfig(image_size=32, patch_size=4, hidden_size=128, num_layers=1, num_heads=4,
                  mlp_dim=256, num_labels=10),
    64: deit_small(num_labels=10).replace(hidden_size=128, num_heads=2, mlp_dim=256),
    80: vit_huge(num_labels=10).replace(hidden_size=160, num_heads=2, mlp_dim=320),
}


def _cases(*groups):
    """pytest params (hd, s, dtype) from (hd, lengths, dtype) groups."""
    return [pytest.param(hd, s, dt, id=f"{hd}-{s}-{dt}") for hd, lengths, dt in groups
            for s in lengths]


def _bf16_tol(ref: np.ndarray) -> float:
    return 2.0 * 2.0 ** (np.floor(np.log2(max(float(np.abs(ref).max()), 1e-30))) - 7)


@functools.lru_cache(maxsize=None)
def _model(hd: int):
    """(config, the last layer, ln_f, head): random LN gains / biases and
    linear biases (the init leaves them 1 and 0), W_q and W_k spread."""
    cfg = GEOMETRIES[hd]
    p = init_vit_params(jax.random.PRNGKey(hd), cfg.replace(num_layers=1))
    layer = jax.tree.map(lambda a: np.array(a[0]), p["layers"])  # writable copies
    rs = np.random.RandomState(hd)
    d = cfg.hidden_size
    for path in (("ln1", "g"), ("ln1", "b"), ("ln2", "g"), ("ln2", "b"), ("attn", "q", "b"),
                 ("attn", "k", "b"), ("attn", "v", "b"), ("attn", "o", "b"), ("mlp", "fc1", "b"),
                 ("mlp", "fc2", "b")):
        node = layer
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = node[path[-1]] + 0.1 * rs.randn(*node[path[-1]].shape).astype(np.float32)
    for n in "qk":
        w = layer["attn"][n]["w"]
        layer["attn"][n]["w"] = (QK_STD / np.sqrt(d) * rs.randn(*w.shape)).astype(np.float32)
    lnf = {k: np.asarray(v) + 0.1 * rs.randn(d).astype(np.float32) for k, v in p["ln_f"].items()}
    head = {"w": np.array(p["head"]["w"]),
            "b": 0.1 * rs.randn(cfg.num_labels).astype(np.float32)}
    return cfg, layer, lnf, head


def _cls_probs(x: torch.Tensor, lp: dict, num_heads: int, eps: float) -> torch.Tensor:
    """The CLS row's softmax [B, H, S] as the plain version forms it."""
    h1 = tl._ln_f32(x.float(), lp["ln1"], eps)
    a = lp["attn"]
    k = tl._heads(tl._linear_f32(h1, a["k"]["w"], a["k"]["b"]), num_heads)
    q = tl._heads(tl._linear_f32(h1[:, :1], a["q"]["w"], a["q"]["b"]), num_heads)
    return torch.softmax((q @ k.transpose(-1, -2))[:, :, 0] / k.shape[-1] ** 0.5, -1)


@functools.lru_cache(maxsize=None)
def _pallas(hd: int, s: int, dtype: str):
    """(x [B, S, D] from a numpy seed, the Pallas kernel's logits in interpret
    mode as f32 numpy), once a case: both tests below read them."""
    cfg, layer, lnf, head = _model(hd)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jlp, _ = jax_and_torch_params(layer, jdt)
    jf, _ = jax_and_torch_params({"ln_f": lnf, "head": head}, jdt)
    x = randn(s, (BATCH, s, cfg.hidden_size))
    want = np.asarray(fused_vit_layer_cls_logits(
        jnp.asarray(x, jdt), jlp, jf["ln_f"], jf["head"], cfg.num_heads, eps=cfg.layernorm_eps,
        interpret=True).astype(jnp.float32))
    return x, want


@pytest.mark.parametrize("hd, s, dtype", _cases(
    (80, (2, 17, 63, 64, 65, 128, 129, 257, 289), "float32"),
    (16, (17, 65, 129), "float32"), (32, (33, 65), "float32"), (64, (99, 128, 129, 577), "float32"),
    (80, (65, 129), "bfloat16"), (64, (99,), "bfloat16"), (16, (17,), "bfloat16"),
    (32, (33,), "bfloat16")))
def test_b2_plain_matches_pallas_with_a_peaked_softmax(hd, s, dtype):
    cfg, layer, lnf, head = _model(hd)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    _, tlp = jax_and_torch_params(layer, jdt)
    _, tf = jax_and_torch_params({"ln_f": lnf, "head": head}, jdt)
    x, want = _pallas(hd, s, dtype)
    got = as_numpy(tl.fused_vit_layer_cls_logits_ref(
        as_torch(x, tdt), tlp, tf["ln_f"], tf["head"], cfg.num_heads, cfg.layernorm_eps))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)
    else:
        assert np.abs(got - want).max() <= _bf16_tol(want)
    if s >= 17:  # the inputs exercise the softmax: far from uniform
        p = _cls_probs(as_torch(x), jax_and_torch_params(layer)[1], cfg.num_heads,
                       cfg.layernorm_eps)
        assert float(p.amax(-1).median()) >= 5.0 / s


def _logits64(x, lp, lnf, head, num_heads, eps):
    """B2's function in float64: LN1, K and V of every token, q of the CLS row,
    the softmax, P V, then O + residual, LN2, erf GELU MLP + residual, LN_f,
    the classifier."""
    def ln(t, p):
        mean = t.mean(-1, keepdim=True)
        return (t - mean) / torch.sqrt(((t - mean) ** 2).mean(-1, keepdim=True) + eps) * p["g"] + p["b"]

    a, mlp = lp["attn"], lp["mlp"]
    b, s, _ = x.shape
    h = ln(x, lp["ln1"])
    k, v = ((h @ a[n]["w"] + a[n]["b"]).reshape(b, s, num_heads, -1).transpose(1, 2) for n in "kv")
    q = (h[:, :1] @ a["q"]["w"] + a["q"]["b"]).reshape(b, 1, num_heads, -1).transpose(1, 2)
    p = torch.softmax((q @ k.transpose(-1, -2)) / k.shape[-1] ** 0.5, -1)
    x1 = x[:, 0] + (p @ v).transpose(1, 2).reshape(b, -1) @ a["o"]["w"] + a["o"]["b"]
    m1 = torch.nn.functional.gelu(ln(x1, lp["ln2"]) @ mlp["fc1"]["w"] + mlp["fc1"]["b"])
    x2 = x1 + m1 @ mlp["fc2"]["w"] + mlp["fc2"]["b"]
    return ln(x2, lnf) @ head["w"] + head["b"]


@pytest.mark.parametrize("hd, s", [
    (16, 1), (16, 17), (16, 65), (16, 129), (32, 65), (64, 99), (64, 129), (80, 17), (80, 65),
    (80, 129), (80, 257)])
def test_b2_f32_route_emulated_matches_pallas(hd, s):
    """The CUDA kernel's float32 arithmetic (split-bf16 K / V / q and tail
    products with 32-deep per-step sums, f32 logits, softmax and P V),
    emulated in torch, against the Pallas kernel in f32 interpret mode at the
    plain version's tolerance. Against the same function in float64 its
    error (the norm of the difference over the reference's) is at most twice
    the plain f32 version's, as phase 4 of chip_smoke.py holds the kernel;
    with every weight's lo plane zeroed (a fault kernel_variants.py plants)
    it is not."""
    cfg, layer, lnf, head = _model(hd)
    _, tlp = jax_and_torch_params(layer)
    _, tf = jax_and_torch_params({"ln_f": lnf, "head": head})
    x, want = _pallas(hd, s, "float32")
    args = (as_torch(x), tlp, tf["ln_f"], tf["head"], cfg.num_heads, cfg.layernorm_eps)
    got = cls_logits_f32_emulated(*args)
    np.testing.assert_allclose(as_numpy(got), want, atol=F32_ATOL, rtol=F32_RTOL)
    exact = _logits64(*jax.tree.map(lambda a: a.double(), args[:4]), cfg.num_heads,
                      cfg.layernorm_eps)

    def err(t):
        return float(torch.linalg.vector_norm(t.double() - exact) / torch.linalg.vector_norm(exact))

    plain = err(tl.fused_vit_layer_cls_logits_ref(*args))
    assert err(got) <= 2.0 * plain
    assert err(cls_logits_f32_emulated(*args, lo_planes=False)) > 2.0 * plain


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_b2_padded_labels_change_no_logit(dtype):
    """The wrapper zero-pads the classifier to a multiple of 8 labels for the
    kernel and slices the logits back: the padded call's first labels are
    the unpadded call's, bit for bit."""
    cfg, layer, lnf, head = _model(64)
    _, tlp = jax_and_torch_params(layer)
    tlp = jax.tree.map(lambda t: t.to(dtype), tlp)
    x = as_torch(randn(5, (BATCH, 99, cfg.hidden_size)), dtype)
    f = {k: torch.from_numpy(v).to(dtype) for k, v in lnf.items()}
    h = {k: torch.from_numpy(v).to(dtype) for k, v in head.items()}
    padded = {n: torch.nn.functional.pad(t, (0, 6)) for n, t in h.items()}
    want = tl.fused_vit_layer_cls_logits_ref(x, tlp, f, h, cfg.num_heads, cfg.layernorm_eps)
    got = tl.fused_vit_layer_cls_logits_ref(x, tlp, f, padded, cfg.num_heads, cfg.layernorm_eps)
    assert got.shape == (BATCH, 16)
    assert torch.equal(got[:, :10], want)
    assert torch.equal(got[:, 10:], torch.zeros_like(got[:, 10:]))


BF16_KV = ("kv_attention_v_registers", "kv_attention_v_shared", "kv_attention_v_recomputed")


@pytest.mark.parametrize("hd, s, kv", [
    (64, 1, 0), (64, 17, 0), (64, 33, 0), (64, 64, 0), (64, 65, 0), (64, 99, 0), (64, 128, 0),
    (64, 129, 1), (64, 197, 1), (64, 512, 1), (64, 513, 2), (64, 577, 2), (16, 128, 0),
    (16, 129, 1), (32, 289, 1), (80, 17, 0), (80, 128, 0), (80, 129, 1), (80, 257, 1),
    (80, 384, 1), (80, 385, 2), (80, 577, 2), (80, 785, 2)])
def test_b2_bf16_plan_is_three_launches(hd, s, kv):
    """In bf16 every call is cls_ln1_stats, one cls_kv_attention (V in the
    accumulators while the image is one 128-row pass, in shared memory while
    its 64-row tiles of V fit 64 KB, else recomputed) and cls_tail: three
    launches where PR 1's design made ten."""
    plan = tl.cls_logits_launches(torch.bfloat16, hd, s, 384)
    want = dict.fromkeys(tl.CLS_LAUNCH_KINDS, 0)
    want.update({"ln1_stats": 1, BF16_KV[kv]: 1, "tail": 1})
    assert plan == want
    assert sum(plan.values()) == 3
    assert tl.cls_v_mode(hd, s) == kv


F32_KINDS = {"f32_split_planes": 1, "ln1_stats": 1, "f32_kv_attention_k_then_v": 1, "f32_tail": 1}


@pytest.mark.parametrize("hd, s", [
    (64, 1), (64, 17), (64, 33), (64, 64), (64, 65), (64, 99), (64, 128), (64, 129), (64, 197),
    (64, 512), (64, 513), (64, 577), (16, 128), (16, 129), (32, 289), (80, 17), (80, 128),
    (80, 129), (80, 257), (80, 384), (80, 385), (80, 577), (80, 785)])
def test_b2_f32_plan_is_four_launches(hd, s):
    """In f32 every call is the weights' split into planes, cls_ln1_stats, one
    cls_kv_attention_f32 (V recomputed by a sweep of its own at every
    length, wherever bf16 keeps it) and cls_tail_f32: four launches where
    the first design made sixteen kernels; taken at every shape the bf16
    plan takes, at any width, at least two stages of its ring at these
    lengths."""
    for width in (104, 384, 1280):
        plan = tl.cls_logits_launches(torch.float32, hd, s, width)
        assert plan == {**dict.fromkeys(tl.CLS_LAUNCH_KINDS, 0), **F32_KINDS}
        assert tl.cls_logits_launches(torch.bfloat16, hd, s, width) is not None
    assert sum(plan.values()) == 4
    stages, size = tl.cls_kv_smem_f32(hd, s)
    assert 2 <= stages <= tl.CLS_F32_MAX_STAGES and size <= tl.CLS_MAX_SMEM


@pytest.mark.parametrize("dtype, hd, s", [
    (torch.bfloat16, 48, 99), (torch.bfloat16, 128, 99), (torch.bfloat16, 64, 0),
    (torch.float16, 64, 99), (torch.bfloat16, 16, 9000), (torch.bfloat16, 80, 30000),
    (torch.float32, 48, 99), (torch.float32, 128, 99), (torch.float32, 64, 0),
    (torch.float32, 16, 20000), (torch.float32, 80, 60000)])
def test_b2_plan_refuses(dtype, hd, s):
    """A head dim the layer kernels do not take, no token, another dtype, or
    logits past the block's shared memory: no plan (the wrapper raises)."""
    assert tl.cls_logits_launches(dtype, hd, s, 1280) is None


def test_b2_f32_plan_covers_the_bf16_plan():
    """No shape that the bf16 plan takes is refused in f32: every head dim, S
    from 1 to 799 and past the limits, the widths of D 100, DeiT-S and
    ViT-H."""
    for hd in (16, 32, 64, 80):
        for s in list(range(1, 800)) + [4000, 4600, 8000, 9000, 11500, 11700, 16000, 30000]:
            for width in (104, 384, 1280):
                if tl.cls_logits_launches(torch.bfloat16, hd, s, width) is not None:
                    assert tl.cls_logits_launches(torch.float32, hd, s, width) is not None


def test_b2_f32_kv_launch_shared_memory():
    """The f32 K/V launch's ring: four 48 KB stages (A's three planes [128][32]
    and three planes of K or V and of q.w, one 4 KB box each) at hd <= 64,
    three of 72 KB at hd 80 (two boxes each), beside 256 bytes of barriers,
    the logits [images][heads][tiles * 64] f32, the P V partials [8][W] and
    sums [2][W], q [2][W] and the biases [3][W]; no term of the width; one
    stage where no more fits."""
    # DeiT-S, S 99: one image an item, one head of 64, two 64-row tiles
    assert tl.cls_kv_smem_f32(64, 99) == (4, 1024 + 4 * (3 * 8192 + 6 * 4096) + 256
                                          + 128 * 4 + 15 * 64 * 4)
    # ViT-H, S 257: W 80 in two 64-column boxes, five tiles
    assert tl.cls_kv_smem_f32(80, 257) == (3, 1024 + 3 * (3 * 8192 + 12 * 4096) + 256
                                           + 320 * 4 + 15 * 80 * 4)
    # vit_tiny, S 17: two images an item, four heads of 16
    assert tl.cls_kv_smem_f32(16, 17) == (4, 1024 + 4 * 49152 + 256 + 2 * 4 * 64 * 4
                                          + 15 * 64 * 4)
    assert tl.cls_kv_smem_f32(80, 30000)[0] == 1


@pytest.mark.parametrize("width", [8, 384, 1280, 4096])
def test_b2_plan_at_any_width(width):
    """The plan takes any width whose LN1 g and b leave room for the ring;
    past that, none."""
    stages, size = tl.cls_kv_smem(64, 99, width)
    plan = tl.cls_logits_launches(torch.bfloat16, 64, 99, width)
    assert (plan is not None) == (stages >= 2 and size <= tl.CLS_MAX_SMEM)


def test_b2_kv_launch_ring_depth():
    """The persistent K/V launch (one block an SM) takes as many stages as the
    227 KB a block may have leave: five at DeiT-S's lengths (six would not
    fit: 40 KB a stage), at least two at every length the main paths give
    it, V in shared memory at ViT-H's S 129 and 257."""
    for s in (17, 33, 99, 128):
        assert tl.cls_kv_smem(64, s, 384)[0] == 5
    for s in (129, 257, 289, 577):
        stages, size = tl.cls_kv_smem(80, s, 1280)
        assert stages >= 2 and size <= tl.CLS_MAX_SMEM
    # 5 stages of two x boxes and one K, one V and one q.w box of 8 KB and two 640-byte
    # slots of LN1 statistics; 256 bytes of barriers; the logits [2][1][128]; the P V
    # partials [8][64] and sums [2][64]; q [2][64]; the biases [3][64]; LN1's g and b
    # [384] in bf16
    assert tl.cls_kv_smem(64, 99, 384) == (5, 1024 + 5 * (5 * 8192 + 1280) + 256 + 2 * 128 * 4
                                           + 10 * 64 * 4 + 5 * 64 * 4 + 384 * 4)


def test_b2_tally_has_every_kind():
    assert set(tl.cls_launches) == set(tl.CLS_LAUNCH_KINDS)
    assert len(tl.CLS_LAUNCH_KINDS) == 8
    assert [k for k in tl.CLS_LAUNCH_KINDS if k.startswith("f32_")] == [
        "f32_split_planes", "f32_kv_attention_k_then_v", "f32_tail"]
