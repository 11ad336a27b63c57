"""The float32 routes of kernels B7 (fused MLP) and B8a / B8b (fused patch
embedding) on the split body (vit_pruning_tpu_torch/csrc/split6.cuh), on the
CPU.

On the card B7 in f32 is two products on the split body, x W1 with + b1 and
the erf GELU in its epilogue into an f32 h, then h W2 + b2; B8 with f32
weights is one product whose A source applies the affine to the patches
before the split, with + b + pos[t % N] in its epilogue. Each product splits
both f32 operands into three bf16 planes and sums six plane products a
32-deep step. tests/torch_parity.py's split6_product mirrors that
arithmetic; here the routes built on the mirror are held to the JAX
package's Pallas kernels in interpret mode on the same numpy inputs, at the
tolerances the port's plain versions are held to (tests/test_torch_mlp.py,
tests/test_torch_embed.py: f32 atol 2e-5, rtol 1e-4). The kernels run only
on a GPU, where chip_smoke.py phases 3e and 3g hold them to their plain
versions. The operators still trace whole under torch.export on meta
tensors.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_pruning_tpu.ops.pallas.mlp as pallas_mlp
from torch_parity import as_numpy, randn, split6_product
from vit_pruning_tpu.ops.pallas import embed as jax_embed
from vit_pruning_tpu_torch.ops.cuda import embed as te
from vit_pruning_tpu_torch.ops.cuda import mlp as tm
from vit_pruning_tpu_torch.ops.dispatch import kernel_mode

F32_ATOL, F32_RTOL = 2e-5, 1e-4
STEP = 32  # the split body's k-step (csrc/split6.cuh, f3::BK)


def _erf_gelu(v: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(v)  # the exact (erf) form, as the kernel's erff


def b7_split_route(x, w1, b1, w2, b2) -> torch.Tensor:
    """B7's f32 route as the card runs it: fc1 on the split body, + b1 and
    the erf GELU in its epilogue (h in f32, unrounded), fc2 on the split
    body, + b2."""
    h = _erf_gelu(split6_product(x, w1, STEP) + b1)
    return split6_product(h, w2, STEP) + b2


def b8_split_route(patches, w, b, pos, scale: float, shift: float) -> torch.Tensor:
    """B8's f32-weight route as the card runs it: the affine on the patches
    (a multiply, then an add, each rounded in f32), the product on the
    split body, + b, + pos[t % N] in f32."""
    bsz, n, k = patches.shape
    a = patches.reshape(bsz * n, k).float() * scale + shift
    y = split6_product(a, w, STEP) + b
    return (y.reshape(bsz, n, -1) + pos).float()


def _mlp_inputs(t: int, d: int, m: int, seed: int = 0):
    return (randn(seed, (t, d)), randn(seed + 1, (d, m)) * 0.05, randn(seed + 2, (m,)) * 0.05,
            randn(seed + 3, (m, d)) * 0.05, randn(seed + 4, (d,)) * 0.1)


# DeiT-S's width (D 384, MLP 1536) and widths no multiple of 8 (the split body pads
# W's planes to a multiple of 8 columns), each at a ragged row count
MLP_SHAPES = {"deit_s": (37, 384, 1536), "ragged widths": (45, 100, 300)}


@pytest.mark.parametrize("variant", ["resident", "blocked"])
@pytest.mark.parametrize("shape", list(MLP_SHAPES))
def test_b7_split_route_matches_pallas(shape, variant):
    """The mirror of B7's f32 route against the Pallas kernel's resident
    and M-blocked variants (block_m 128: every M here is over it)."""
    t, d, m = MLP_SHAPES[shape]
    args = _mlp_inputs(t, d, m)
    want = np.asarray(pallas_mlp.fused_mlp(*map(jnp.asarray, args),
                                           block_m=0 if variant == "resident" else 128,
                                           interpret=True))
    got = as_numpy(b7_split_route(*map(torch.from_numpy, args)))
    assert got.shape == (t, d)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)
    # and the port's plain version (what a CPU tensor runs) at the same tolerance
    plain = as_numpy(tm.fused_mlp_ref(*map(torch.from_numpy, args)))
    np.testing.assert_allclose(got, plain, atol=F32_ATOL, rtol=F32_RTOL)


# patches a image, patch width K, D: DeiT-S's K 768 at D 384; ViT-H/14's K 588 (rows
# 4-byte but not 16-byte multiples in uint8) at a narrow D 160
EMBED_SHAPES = {"deit_s": (196, 768, 384), "vit_h_pd588": (256, 588, 160)}


def _embed_weights(shape: str, seed: int = 0):
    n, k, d = EMBED_SHAPES[shape]
    rs = np.random.RandomState(seed)
    return tuple(a.astype(np.float32) for a in
                 (0.02 * rs.randn(k, d), 0.1 * rs.randn(d), 0.02 * rs.randn(n, d)))


@pytest.mark.parametrize("shape", list(EMBED_SHAPES))
def test_b8a_split_route_matches_pallas(shape):
    """uint8 patches, f32 weights: the affine folded into the split body's A
    source against fused_patch_embed_u8 in interpret mode."""
    n, k, _ = EMBED_SHAPES[shape]
    w, b, pos = _embed_weights(shape)
    u8 = np.random.RandomState(1).randint(0, 256, (2, n, k), dtype=np.uint8)
    scale, shift = te._affine(te.VIT_MEAN, te.VIT_STD)
    got = b8_split_route(torch.from_numpy(u8), *map(torch.from_numpy, (w, b, pos)), scale, shift)
    want = jax_embed.fused_patch_embed_u8(jnp.asarray(u8), *map(jnp.asarray, (w, b, pos)),
                                          interpret=True)
    np.testing.assert_allclose(as_numpy(got), np.asarray(want), atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("patch_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(EMBED_SHAPES))
def test_b8b_split_route_matches_pallas(shape, patch_dtype):
    """f32 or bf16 patches, f32 weights (scale 1, shift 0: the split is of
    the patches themselves) against fused_patch_embed_f in interpret mode."""
    n, k, _ = EMBED_SHAPES[shape]
    w, b, pos = _embed_weights(shape)
    jdt = jnp.bfloat16 if patch_dtype == "bfloat16" else jnp.float32
    xj = jnp.asarray(np.random.RandomState(2).randn(2, n, k).astype(np.float32), jdt)
    x = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    if patch_dtype == "bfloat16":
        x = x.to(torch.bfloat16)
    got = b8_split_route(x, *map(torch.from_numpy, (w, b, pos)), 1.0, 0.0)
    want = jax_embed.fused_patch_embed_f(xj, *map(jnp.asarray, (w, b, pos)), interpret=True)
    np.testing.assert_allclose(as_numpy(got), np.asarray(want), atol=F32_ATOL, rtol=F32_RTOL)
    plain = te.fused_patch_embed_f_ref(x, *map(torch.from_numpy, (w, b, pos)))
    np.testing.assert_allclose(as_numpy(got), as_numpy(plain), atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("dtype,widths,body", [
    (torch.float32, (384, 1536), "split"), (torch.float32, (100, 300), "split"),
    (torch.bfloat16, (384, 1536), "wgmma"), (torch.bfloat16, (100, 300), "fma")])
def test_b7_body_rule(dtype, widths, body):
    """B7's body by dtype and shape (csrc/mlp.cu's rule): every f32 call on
    the split body, bf16 on the tensor cores where D and M are multiples of
    8, else the FMA body."""
    d, m = widths
    x, w1, w2 = (torch.zeros(s, dtype=dtype) for s in ((4, d), (d, m), (m, d)))
    assert tm.body(x, w1, w2) == body


class _Call(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _ops(program) -> dict:
    return {str(n.target): n for n in program.graph.nodes
            if n.op == "call_function" and str(n.target).startswith("vpt.")}


@pytest.mark.parametrize("kernel", ["B7", "B8a", "B8b"])
def test_f32_operators_export_whole(kernel):
    """torch.export in kernel mode 'kernel' on f32 meta tensors: each
    wrapper traces to its one vpt:: operator (the split body's workspaces
    are allocated inside it), with the output's shape and dtype."""
    meta = {"device": "meta", "dtype": torch.float32}
    if kernel == "B7":
        fn, args, op = tm.fused_mlp, [torch.empty(s, **meta) for s in
                                      ((197, 384), (384, 1536), (1536,), (1536, 384), (384,))], \
            "vpt.fused_mlp.default"
        shape = (197, 384)
    else:
        patches = torch.empty(2, 196, 768, device="meta",
                              dtype=torch.uint8 if kernel == "B8a" else torch.float32)
        args = [patches] + [torch.empty(s, **meta) for s in ((768, 384), (384,), (196, 384))]
        fn = te.fused_patch_embed_u8 if kernel == "B8a" else te.fused_patch_embed_f
        op = f"vpt.{fn.__name__}.default"
        shape = (2, 196, 384)
    with kernel_mode("kernel"):
        program = torch.export.export(_Call(fn), tuple(args))
    ops = _ops(program)
    assert list(ops) == [op]
    val = ops[op].meta["val"]
    assert tuple(val.shape) == shape and val.dtype == torch.float32
