"""The port's fused patch embedding (vit_pruning_tpu_torch/ops/cuda/embed.py,
kernels B8a and B8b) and the serving embed against the JAX package.

The plain versions of B8a / B8b are held to the Pallas kernels in interpret
mode on the same numpy inputs, at vit_tiny's patch width (3*8*8 = 192) and
at ViT-H's (3*14*14 = 588, a K that is no multiple of the CUDA kernel's
32-wide step, at a narrow D 160). Tolerances are tests/test_pallas.py's
(:347-360 and :501-521): f32 atol 2e-5 + rtol 1e-4 against the same
function, and atol 2e-4 where embed_u8 meets embed_from_u8, which rounds
the normalisation differently ((x / 255 - mean) / std against one affine).
bf16: one bf16 step at the output's largest magnitude (both sides round at
the same places; an f32 sum in another order may land a value on the
neighbouring bf16 number).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_numpy, jax_and_torch_params
from vit_pruning_tpu.configs import vit_huge, vit_tiny
from vit_pruning_tpu.data import preprocess as jax_preprocess
from vit_pruning_tpu.models.vit import init_vit_params
from vit_pruning_tpu.ops.pallas import embed as jax_embed
from vit_pruning_tpu.ops.patch_embed import extract_patches as jax_extract_patches
from vit_pruning_tpu.serving import embed_from_u8 as jax_embed_from_u8
from vit_pruning_tpu_torch.data import preprocess
from vit_pruning_tpu_torch.models.vit import embed
from vit_pruning_tpu_torch.ops.cuda import embed as te
from vit_pruning_tpu_torch.ops.dispatch import kernel_mode
from vit_pruning_tpu_torch.ops.patch_embed import extract_patches, patch_embed
from vit_pruning_tpu_torch.serving import embed_from_u8

F32_ATOL, F32_RTOL = 2e-5, 1e-4
U8_ATOL = 2e-4
# patch width, N, D: vit_tiny's, and ViT-H/14's patches at a narrow width
GEOMETRIES = {"tiny": (192, 16, 64), "vit_h_pd588": (588, 256, 160)}
CONFIGS = {"tiny": vit_tiny(), "vit_h_pd588": vit_huge(num_labels=10).replace(
    hidden_size=160, num_heads=2, mlp_dim=320, num_layers=1)}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bf16_step(ref: np.ndarray) -> float:
    return 2.0 ** (np.floor(np.log2(max(float(np.abs(ref).max()), 1e-30))) - 7)


def _assert_close(got: np.ndarray, want: np.ndarray, dtype: str):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)
    else:
        np.testing.assert_allclose(got, want, atol=_bf16_step(want), rtol=0)


def _weights(geometry: str, dtype: str, seed: int = 0):
    """(JAX w, b, pos; port w, b, pos) from the same numpy draws."""
    pd, n, d = GEOMETRIES[geometry]
    rs = np.random.RandomState(seed)
    tree = {"w": 0.02 * rs.randn(pd, d), "b": 0.1 * rs.randn(d), "pos": 0.02 * rs.randn(n, d)}
    jt, tt = jax_and_torch_params({k: v.astype(np.float32) for k, v in tree.items()},
                                  DTYPES[dtype][0])
    return (jt["w"], jt["b"], jt["pos"]), (tt["w"], tt["b"], tt["pos"])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_b8a_plain_matches_pallas_interpret(geometry, dtype):
    pd, n, _ = GEOMETRIES[geometry]
    (jw, jb, jpos), (tw, tb, tpos) = _weights(geometry, dtype)
    u8 = np.random.RandomState(1).randint(0, 256, (2, n, pd), dtype=np.uint8)
    got = te.fused_patch_embed_u8_ref(torch.from_numpy(u8), tw, tb, tpos)
    want = jax_embed.fused_patch_embed_u8(jnp.asarray(u8), jw, jb, jpos, interpret=True)
    assert got.dtype == DTYPES[dtype][1] and got.shape == want.shape
    _assert_close(as_numpy(got), np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_b8b_plain_matches_pallas_interpret(geometry, dtype):
    pd, n, _ = GEOMETRIES[geometry]
    (jw, jb, jpos), (tw, tb, tpos) = _weights(geometry, dtype)
    jdt, tdt = DTYPES[dtype]
    x = np.random.RandomState(2).randn(2, n, pd).astype(np.float32)
    xj = jnp.asarray(x, jdt)  # the patches in the weights' dtype, as embed_fused feeds them
    got = te.fused_patch_embed_f_ref(torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt),
                                     tw, tb, tpos)
    want = jax_embed.fused_patch_embed_f(xj, jw, jb, jpos, interpret=True)
    _assert_close(as_numpy(got), np.asarray(want.astype(jnp.float32)), dtype)


def _embed_params(name: str, dtype: str):
    cfg = CONFIGS[name]
    params = init_vit_params(jax.random.PRNGKey(0), cfg)
    tree = params["embed"]
    rs = np.random.RandomState(3)  # a non-zero bias: init leaves it 0
    tree = dict(tree, patch=dict(tree["patch"], b=tree["patch"]["b"] + 0.1 * rs.randn(
        cfg.hidden_size).astype(np.float32)))
    jt, tt = jax_and_torch_params(tree, DTYPES[dtype][0])
    return cfg, jt, tt


def _u8_images(cfg, b=2, seed=4):
    return np.random.RandomState(seed).randint(
        0, 256, (b, 3, cfg.image_size, cfg.image_size), dtype=np.uint8)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", list(CONFIGS))
def test_embed_u8_matches_jax(name, dtype):
    cfg, jt, tt = _embed_params(name, dtype)
    u8 = _u8_images(cfg)
    got = te.embed_u8(torch.from_numpy(u8), tt, cfg)
    want = jax_embed.embed_u8(jnp.asarray(u8), jt, cfg, interpret=True)
    assert got.shape == (2, cfg.seq_len, cfg.hidden_size) == want.shape
    _assert_close(as_numpy(got), np.asarray(want.astype(jnp.float32)), dtype)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_embed_fused_matches_jax_and_embed(name):
    cfg, jt, tt = _embed_params(name, "float32")
    x = np.random.RandomState(5).randn(2, 3, cfg.image_size, cfg.image_size).astype(np.float32)
    got = as_numpy(te.embed_fused(torch.from_numpy(x), tt, cfg))
    want = np.asarray(jax_embed.embed_fused(jnp.asarray(x), jt, cfg, interpret=True))
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)
    np.testing.assert_allclose(got, as_numpy(embed(torch.from_numpy(x), tt, cfg)),
                               atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_embed_u8_matches_embed_from_u8(name):
    """The fused u8 entry against the serving embed: one function, two
    roundings of the normalisation (test_pallas.py:501-521's bound)."""
    cfg, _, tt = _embed_params(name, "float32")
    u8 = torch.from_numpy(_u8_images(cfg))
    got, want = te.embed_u8(u8, tt, cfg), embed_from_u8(u8, tt, cfg)
    np.testing.assert_allclose(as_numpy(got), as_numpy(want), atol=U8_ATOL, rtol=F32_RTOL)


def test_normalisation_constants_equal_jax():
    assert (preprocess.VIT_MEAN, preprocess.VIT_STD) == (jax_preprocess.VIT_MEAN,
                                                         jax_preprocess.VIT_STD)


@pytest.mark.parametrize("patch", [8, 14])
def test_extract_patches_on_uint8(patch):
    u8 = np.random.RandomState(6).randint(0, 256, (2, 3, 4 * patch, 2 * patch), dtype=np.uint8)
    got = extract_patches(torch.from_numpy(u8), patch)
    assert got.dtype == torch.uint8 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_extract_patches(jnp.asarray(u8),
                                                                              patch)))


@pytest.mark.parametrize("impl", ["auto", "matmul", "conv"])
def test_embed_from_u8_impl_matches_jax(impl):
    """JAX's `auto` takes matmul off its TPU; the port's takes matmul on
    every device. conv is the same function summed in another order."""
    cfg, jt, tt = _embed_params("vit_h_pd588", "float32")
    u8 = _u8_images(cfg)
    got = embed_from_u8(torch.from_numpy(u8), tt, cfg, impl=impl)
    want = jax_embed_from_u8(jnp.asarray(u8), jt, cfg, impl=impl)
    np.testing.assert_allclose(as_numpy(got), np.asarray(want), atol=F32_ATOL, rtol=F32_RTOL)
    if impl == "auto":
        torch.testing.assert_close(got, embed_from_u8(torch.from_numpy(u8), tt, cfg,
                                                      impl="matmul"), rtol=0, atol=0)


def test_patch_embed_rejects_unknown_impl():
    with pytest.raises(ValueError, match="impl"):
        patch_embed(torch.zeros(1, 3, 16, 16), {"w": torch.zeros(768, 8), "b": torch.zeros(8)},
                    16, impl="pallas")


def test_wrappers_on_the_cpu_check_types_and_launch_nothing():
    _, (tw, tb, tpos) = _weights("vit_h_pd588", "float32")
    u8 = torch.randint(0, 256, (1, 256, 588), dtype=torch.uint8)
    counts = (te.fused_patch_embed_u8.launches, te.fused_patch_embed_f.launches)
    torch.testing.assert_close(te.fused_patch_embed_u8(u8, tw, tb, tpos),
                               te.fused_patch_embed_u8_ref(u8, tw, tb, tpos), rtol=0, atol=0)
    xf = u8.float()
    torch.testing.assert_close(te.fused_patch_embed_f(xf, tw, tb, tpos),
                               te.fused_patch_embed_f_ref(xf, tw, tb, tpos), rtol=0, atol=0)
    assert (te.fused_patch_embed_u8.launches, te.fused_patch_embed_f.launches) == counts
    with pytest.raises(TypeError, match="patches"):
        te.fused_patch_embed_u8(xf, tw, tb, tpos)
    with pytest.raises(TypeError, match="patches"):
        te.fused_patch_embed_f(u8, tw, tb, tpos)
    with pytest.raises(ValueError, match="do not fit"):
        te.fused_patch_embed_u8(u8[..., :-1], tw, tb, tpos)
    with kernel_mode("kernel"), pytest.raises(RuntimeError, match="CUDA tensors"):
        te.fused_patch_embed_u8(u8, tw, tb, tpos)
