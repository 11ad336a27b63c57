"""Kernels B1, B2 and B3: a whole ViT layer, the last layer's CLS row through
the classifier, and the bucketed layer of the re-decide modes. Wrappers
around csrc/layer.cu (B1, B3) and csrc/cls_logits.cu (B2), each beside its
plain PyTorch version.

B1 `fused_vit_layer` replaces vit_pruning_tpu/ops/pallas/layer.py::
fused_vit_layer (the staged2 whole-layer kernel). B2
`fused_vit_layer_cls_logits` replaces ::fused_vit_layer_cls_logits. B3
`fused_vit_layer_bucketed` replaces ::fused_vit_layer_bucketed: gather the
kept-first rows to a static capacity, run the B1 layer there with keys
masked past each image's kept count, scatter the kept rows back and pass
the skipped ones through unchanged. What bounds them on an H100 and what
the CUDA design does about it is in the head of csrc/layer.cu: the layer
products dominate and are tensor-core bound at batch 512, so each runs as
one tiled GEMM with its bias / GELU / residual / cast fused into the
epilogue, and the residual stream stays f32 between the attention and MLP
halves as it stayed in VMEM on the TPU. The attention of B1, B3, B4 and B5
is csrc/layer_attention.cu's: in bf16 a wgmma + TMA body, one pass with the
logits in registers up to 256 keys ('wgmma_resident') and two passes over
streamed K and V past it ('wgmma_streamed'); in f32 csrc/split_attention.cuh's
body, the same design on exact three-way bf16 splits of q, k, v and P (six
bf16 passes a product: f32 accuracy), one pass up to 256 keys at hd <= 64
('split_resident'), two past it ('split_streamed'). `attention_body`
mirrors the C rule that picks the body, and `attention_body_counts` reads
the launches per body. B2 in bf16 is three
launches (csrc/cls_logits.cu: LN1's row statistics; LN1, the K/V product, q
and the CLS attention fused on wgmma + TMA with K and V kept out of device
memory, V in registers, shared memory or recomputed; the tail on the B rows
in one cluster launch), in f32 four (the six weights split into bf16 planes
in one launch; the same statistics; LN1, K, q and the CLS attention, then
V, in one persistent launch on split-bf16 wgmma, K and V kept out of device
memory; the tail with split products in one cluster launch);
`cls_logits_launches` mirrors the C plan and `cls_launch_counts` reads the
launches by kind.

A wrapper launches its kernel for CUDA tensors, through the registered
operator vpt::<name> (ops/cuda/library.py), whose implementation counts the
launch in the wrapper's `launches` attribute; for CPU tensors it runs the
plain version (mode 'auto') or raises (mode 'kernel'). It never falls back
from a CUDA tensor. Widths the kernels do not take (D or M not a multiple of
8) are zero-padded on the way in and sliced on the way out
(ops/cuda/widths.py).

Gradients. The kernels have no backward, and the JAX package has none
either: it trains through B1 (and B5, ops/cuda/model.py) with a custom VJP
whose backward recomputes its jnp reference layer from the saved inputs and
differentiates that (ops/pallas/layer.py::differentiable_fused_layer). Here
`RecomputedBackward` is that VJP: when autograd records (grad enabled and x
or a weight requiring grad), `fused_vit_layer` runs its forward, the
kernel (or, on the CPU, its plain version), through it, and the backward is
`eager_layer`'s. The weights go to the Function as a flat list of tensors
(autograd does not see tensors inside a dict). The other kernels (B2, B3,
B4 here, B6, B7, B8a, B8b) have no VJP in the JAX package, and their
wrappers raise for a CUDA input that requires grad (`refuse_grad`) instead
of returning a result without a graph.

DINOv2's block (ops/swiglu.py) runs on B1 in bf16: LayerScale's gains
scale the O and fc2 products in their epilogues, and a SwiGLU fc1,
interleaved once at load (or here, per call, where the caller did not),
runs the gated epilogue, which writes silu(u1) * u2 and never the [rows,
2M] product (csrc/layer.cu, csrc/gemm.cu). B2, B3, B5 and the f32 products
refuse it.

The plain versions keep the TPU kernels' numerics, which differ from the
jnp reference layer (models/vit.py) in three places: products take operands
in the weight dtype and accumulate in f32 before the bias and the cast; the
GELU is the tanh form when x is bf16; B1 rounds the softmax numerators to
x's dtype, sums the rounded values and divides after the PV product, B2
normalises first and keeps the context in f32 until the O product.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from vit_pruning_tpu_torch.models.convert import flatten_tree, unflatten_tree
from vit_pruning_tpu_torch.models.vit import layer_norm, mlp_block
from vit_pruning_tpu_torch.ops.attention import NEG_INF, mha
from vit_pruning_tpu_torch.ops.cuda.gemm import F32_PRODUCTS, count_f32_products
from vit_pruning_tpu_torch.ops.cuda.library import check_aligned, kernel_op, ptr, run
from vit_pruning_tpu_torch.ops.cuda.widths import LAYER_MULTIPLE, kernel_layer, pad_dim, round_up
from vit_pruning_tpu_torch.ops.dispatch import launch_kernel_for
from vit_pruning_tpu_torch.ops.swiglu import (
    fc1_linear,
    gate,
    has_layerscale,
    is_swiglu,
    mlp_width,
    refuse_dinov2,
    require_interleaved,
    weight,
)
from vit_pruning_tpu_torch.utils.profiling import span

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims B1-B5 take: csrc/common.cuh::layer_head_dim_ok, which gates
# every call in C; the wrappers check this copy, so that a trace without a
# card needs no library (chip_smoke.py holds the two equal)
LAYER_HEAD_DIMS = (16, 32, 64, 80)
# the bodies of their attention, in the order of csrc/layer_attention.cu's
# counters, and the most 64-key chunks the resident bodies take (la::kLogitChunks;
# csrc/common.cuh::split_attention_resident, where hd <= 64 too)
ATTENTION_BODIES = ("wgmma_resident", "wgmma_streamed", "split_resident", "split_streamed")
ATTENTION_LOGIT_CHUNKS = 4
# B2's launch kinds, in the order of csrc/cls_logits.cu's counters: bf16 makes
# one ln1_stats, one kv_attention_* (by where it keeps V) and one tail launch;
# f32 one f32_split_planes (its six weights' bf16 planes), one ln1_stats, one
# f32_kv_attention_k_then_v (V recomputed by a sweep of its own) and one f32_tail
CLS_LAUNCH_KINDS = ("ln1_stats", "kv_attention_v_registers", "kv_attention_v_shared",
                    "kv_attention_v_recomputed", "tail", "f32_split_planes",
                    "f32_kv_attention_k_then_v", "f32_tail")
# cls_logits.cu's constants the plan depends on: the box bytes, the most bytes
# of V kept in shared memory, the shared memory a block may have, the most
# stages of the K/V launch's ring
CLS_BOX = 64 * 128
CLS_V_RESIDENT = 64 * 1024
CLS_MAX_SMEM = 232448
CLS_MAX_STAGES = 6
# and of its f32 K/V launch: a 32-deep stage of A's three planes [128 rows][32 k]
# and the three planes of K or V and of q.w (boxes [32 k][64 n]), up to four stages
CLS_F32_PLANE_A = 128 * 32 * 2
CLS_F32_WBOX = 32 * 64 * 2
CLS_F32_MAX_STAGES = 4
# the rows past B * S that B2's bf16 statistics buffer holds: the K/V launch
# copies each tile's 64 rows of statistics from the even row at or before its
# first, 528 bytes (cls_logits.cu's kStatBytes), and must stay inside it
CLS_STAT_PAD = 72


# --- plain versions ---------------------------------------------------------------

def _ln_f32(x: torch.Tensor, p: dict, eps: float, norm_width: Optional[int] = None
            ) -> torch.Tensor:
    """LN in f32. norm_width: the statistics run over the first norm_width
    columns only, as the kernels' do on a row zero-padded past the model's
    width (ops/cuda/widths.py); None = every column."""
    g, b = p["g"].float(), p["b"].float()
    if norm_width is None or norm_width == x.shape[-1]:
        return layer_norm(x.float(), {"g": g, "b": b}, eps)
    xf = x.float()
    t = xf[..., :norm_width]
    mean = t.mean(-1, keepdim=True)
    var = ((t - mean) ** 2).mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * g + b


def _linear_f32(a: torch.Tensor, p_w: torch.Tensor, p_b: torch.Tensor) -> torch.Tensor:
    """a cast to the weight dtype, product accumulated in f32, + bias (f32)."""
    return a.to(p_w.dtype).float() @ p_w.float() + p_b.float()


def _gelu_for(dtype: torch.dtype):
    approximate = "tanh" if dtype == torch.bfloat16 else "none"
    return lambda t: F.gelu(t, approximate=approximate)


def _heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, w = t.shape
    return t.reshape(b, s, num_heads, w // num_heads).transpose(1, 2)


def staged2_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    token_mask: Optional[torch.Tensor] = None,
    normalized: bool = False,
) -> torch.Tensor:
    """The TPU kernels' attention core on q, k, v [B, S, KW] in the serving
    dtype: f32 logits, masked keys -1e30; staged2 (B1, B3, B4): unnormalised
    numerators rounded to the dtype, PV in f32 divided by the sum of the
    rounded numerators; normalized (B5): P = exp / sum rounded to the dtype,
    then PV in f32. Returns ctx [B, S, KW] in the dtype."""
    dt = q.dtype
    b, s, kw = q.shape
    q, k, v = (_heads(t, num_heads) for t in (q, k, v))
    logits = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(kw // num_heads))
    if token_mask is not None:
        logits = torch.where(token_mask[:, None, None, :], logits, NEG_INF)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    if normalized:
        ctx = (p / p.sum(-1, keepdim=True)).to(dt).float() @ v.float()
    else:
        p = p.to(dt).float()
        ctx = (p @ v.float()) * (1.0 / p.sum(-1, keepdim=True))
    return ctx.to(dt).transpose(1, 2).reshape(b, s, kw)


def fused_vit_layer_ref(
    x: torch.Tensor,
    params: dict,
    num_heads: int,
    eps: float = 1e-12,
    token_mask: Optional[torch.Tensor] = None,
    norm_width: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of kernel B1 (staged2 numerics). norm_width:
    the layer norms' width, for x and weights zero-padded past it (the
    kernel's DN); None = D. DINOv2's block as B1 computes it: the O and fc2
    products times LayerScale's gains before their residuals, and a SwiGLU
    MLP's silu(u1) * u2 in f32, rounded to x's dtype (in either order of
    fc1's columns)."""
    dt = x.dtype
    a = params["attn"]
    xf = x.float()
    h1 = _ln_f32(xf, params["ln1"], eps, norm_width)
    q, k, v = (_linear_f32(h1, a[n]["w"], a[n]["b"]).to(dt) for n in "qkv")
    ctx = staged2_attention(q, k, v, num_heads, token_mask)
    scale = has_layerscale(params)
    o = _linear_f32(ctx, a["o"]["w"], a["o"]["b"])
    x1 = xf + (params["ls1"].float() * o if scale else o)
    h2 = _ln_f32(x1, params["ln2"], eps, norm_width)
    mlp = params["mlp"]
    if is_swiglu(params):
        w1, b1, interleaved = fc1_linear(params)
        m1 = gate(_linear_f32(h2, w1, b1), interleaved).to(dt)
    else:
        m1 = _gelu_for(dt)(_linear_f32(h2, mlp["fc1"]["w"], mlp["fc1"]["b"]))
    y = _linear_f32(m1, mlp["fc2"]["w"], mlp["fc2"]["b"])
    return (x1 + (params["ls2"].float() * y if scale else y)).to(dt)


def cls_context_ref(
    x: torch.Tensor,
    params: dict,
    num_heads: int,
    eps: float = 1e-12,
    norm_width: Optional[int] = None,
) -> torch.Tensor:
    """B2's CLS attention as its plain version forms it: LN1 in f32, K and V
    of every token and q of the CLS row rounded to x's dtype, the logits in
    f32, the softmax normalised and rounded to x's dtype, then P V in f32.
    Returns the CLS context [B, KW] in f32."""
    dt = x.dtype
    b = x.shape[0]
    a = params["attn"]
    kw = a["q"]["w"].shape[1]
    h1 = _ln_f32(x.float(), params["ln1"], eps, norm_width)
    k, v = (_heads(_linear_f32(h1, a[n]["w"], a[n]["b"]).to(dt), num_heads) for n in "kv")
    q = _heads(_linear_f32(h1[:, :1], a["q"]["w"], a["q"]["b"]).to(dt), num_heads)  # [B,H,1,hd]
    logits = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(kw // num_heads))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).to(dt).float()
    return (p @ v.float()).transpose(1, 2).reshape(b, kw)


def fused_vit_layer_cls_logits_ref(
    x: torch.Tensor,
    params: dict,
    lnf: dict,
    head: dict,
    num_heads: int,
    eps: float = 1e-12,
    norm_width: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of kernel B2: logits [B, labels] in x's dtype.
    norm_width as fused_vit_layer_ref's (the final LN's too)."""
    dt = x.dtype
    a = params["attn"]
    xf = x.float()
    ctx = cls_context_ref(x, params, num_heads, eps, norm_width)
    x1 = xf[:, 0] + _linear_f32(ctx, a["o"]["w"], a["o"]["b"])
    h2 = _ln_f32(x1, params["ln2"], eps, norm_width)
    mlp = params["mlp"]
    m1 = _gelu_for(dt)(_linear_f32(h2, mlp["fc1"]["w"], mlp["fc1"]["b"]))
    x2 = x1 + _linear_f32(m1, mlp["fc2"]["w"], mlp["fc2"]["b"])
    yn = _ln_f32(x2, lnf, eps, norm_width)
    return _linear_f32(yn, head["w"], head["b"]).to(dt)


def bucket_compact(x: torch.Tensor, dest: torch.Tensor, kept: torch.Tensor, cap: int):
    """The first `cap` rows of the kept-first order, by index.

    dest [B, S]: compacted row of every token (kept first, then skipped,
    each in token order: a permutation of 0..S-1 per image). Returns
    (xc [B, cap, D], key_ok [B, cap] bool = row < the image's kept count).
    Rows at or past the count hold skipped tokens; they are masked as keys
    and their outputs are dropped by bucket_expand.
    """
    b, s, d = x.shape
    pos = torch.arange(s, device=x.device).expand(b, s)
    src = torch.zeros((b, s), dtype=torch.int64, device=x.device).scatter_(1, dest.long(), pos)
    xc = torch.gather(x, 1, src[:, :cap, None].expand(-1, -1, d))
    key_ok = torch.arange(cap, device=x.device) < kept.sum(-1, keepdim=True)
    return xc, key_ok


def bucket_expand(
    x: torch.Tensor, yc: torch.Tensor, dest: torch.Tensor, kept: torch.Tensor, cap: int
) -> torch.Tensor:
    """out[b, t] = yc[b, dest[b, t]] where token t is kept (and its row is
    below cap), else x[b, t]: the scatter back with x as the passthrough."""
    take = kept & (dest < cap)
    rows = dest.long().clamp(max=cap - 1)
    back = torch.gather(yc, 1, rows[..., None].expand(-1, -1, x.shape[-1]))
    return torch.where(take[..., None], back, x)


def fused_vit_layer_bucketed_ref(
    x: torch.Tensor,
    params: dict,
    dest: torch.Tensor,
    kept: torch.Tensor,
    cap: int,
    num_heads: int,
    eps: float = 1e-12,
    norm_width: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of kernel B3: gather, B1's plain layer at `cap`
    with the count key mask, scatter + identity passthrough. norm_width as
    fused_vit_layer_ref's."""
    xc, key_ok = bucket_compact(x, dest, kept, cap)
    yc = fused_vit_layer_ref(xc, params, num_heads, eps, key_ok, norm_width)
    return bucket_expand(x, yc, dest, kept, cap)


# --- the attention body ------------------------------------------------------------

def attention_body(dtype: torch.dtype, head_dim: int, seq_len: int) -> Optional[str]:
    """The body that B1-B5's attention takes on the card for this dtype, head
    dim and sequence length (the rule of csrc/layer_attention.cu::
    layer_attention_body, which chip_smoke.py holds equal), or None where
    the kernels refuse the call."""
    if head_dim not in LAYER_HEAD_DIMS or seq_len < 1 or dtype not in _DTYPES:
        return None
    resident = -(-seq_len // 64) <= ATTENTION_LOGIT_CHUNKS
    if dtype == torch.float32:
        return "split_resident" if resident and head_dim <= 64 else "split_streamed"
    return "wgmma_resident" if resident else "wgmma_streamed"


# B1-B5's attention launches since the last reset_attention_body_counts(),
# by kernel ('b1', 'b3', 'b4', 'b5') and by the body attention_body names:
# each op adds its calls where it launches, so that a run can hold the
# mirror against the C counters and tell the kernels' launches apart
attention_launches: dict = {}


def count_attention(kernel: str, dtype: torch.dtype, head_dim: int, seq_len: int,
                    calls: int = 1):
    per = attention_launches.setdefault(kernel, dict.fromkeys(ATTENTION_BODIES, 0))
    per[attention_body(dtype, head_dim, seq_len)] += calls


def attention_body_counts() -> dict:
    """Launches of each body of B1-B5's attention since the last
    reset_attention_body_counts(), by ATTENTION_BODIES' names, as the C
    library counted them."""
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    counts = (ctypes.c_longlong * len(ATTENTION_BODIES))()
    load_library().vpt_layer_attention_body_counts(counts)
    return dict(zip(ATTENTION_BODIES, counts))


def reset_attention_body_counts():
    """Zero the C counters and attention_launches."""
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    load_library().vpt_layer_attention_body_reset()
    attention_launches.clear()


# --- B2's launches -------------------------------------------------------------------

def cls_v_mode(head_dim: int, seq_len: int) -> int:
    """Where B2's bf16 K/V launch keeps V (csrc/cls_logits.cu::cls::v_mode):
    0 in the accumulators (the image is one pass of 128 rows: S <= 128), 1
    in shared memory (its 64-row tiles x 64 or 80 columns of bf16 within
    CLS_V_RESIDENT bytes), 2 recomputed by a second sweep."""
    tiles = -(-seq_len // 64)
    if (tiles + 1) // 2 == 1:
        return 0
    width = 64 if head_dim <= 64 else 80
    return 1 if tiles * 64 * width * 2 <= CLS_V_RESIDENT else 2


def cls_kv_smem(head_dim: int, seq_len: int, width: int) -> tuple:
    """(stages, bytes) of B2's bf16 K/V launch at hidden width `width` (the
    kernel's, padded; cls_logits.cu's KvSmem): a ring of as many stages of two
    x boxes and the K, V and q.w boxes (8 KB each) and two 640-byte slots of
    LN1 statistics as fit beside the rest, up to CLS_MAX_STAGES; 256 bytes of
    barriers, the logits, V or the P V partials, q, the biases, LN1's g and
    b. Fewer than two stages: the kernel refuses the shape."""
    cols = 64 if head_dim <= 64 else 80
    nbh, heads = -(-cols // 64), (64 // head_dim if head_dim <= 64 else 1)
    spad = -(-seq_len // 64) * 64
    stage = (2 + 3 * nbh) * CLS_BOX
    vbytes = spad * cols * 2 if cls_v_mode(head_dim, seq_len) == 1 else 10 * cols * 4
    fixed = 1024 + 256 + 2 * heads * spad * 4 + vbytes + 5 * cols * 4 + width * 4
    stages = min(CLS_MAX_STAGES, max(0, CLS_MAX_SMEM - fixed) // (stage + 2 * 640))
    return stages, fixed + stages * (stage + 2 * 640)


def cls_kv_smem_f32(head_dim: int, seq_len: int) -> tuple:
    """(stages, bytes) of B2's f32 K/V launch (cls_logits.cu's KvF32Smem): a
    ring of as many 32-deep stages as fit beside the rest, up to
    CLS_F32_MAX_STAGES, each A's three planes and three planes of one operand
    (K or V) and of q.w, one or two 64-column boxes each (hd 80: two); 256
    bytes of barriers, the logits [images][heads][tiles * 64] f32 (two images
    an item where S <= 64), the P V partials [8][W] and sums [2][W], q [2][W]
    and the biases [3][W] in f32. No stage: the kernel refuses the shape. No
    term depends on the width: the producers read x, LN1's g and b from
    device memory."""
    cols = 64 if head_dim <= 64 else 80
    nbh, heads = -(-cols // 64), (64 // head_dim if head_dim <= 64 else 1)
    tiles = -(-seq_len // 64)
    images = 2 if tiles == 1 else 1
    stage = 3 * CLS_F32_PLANE_A + 2 * 3 * nbh * CLS_F32_WBOX
    fixed = 1024 + 256 + images * heads * tiles * 64 * 4 + 15 * cols * 4
    stages = min(CLS_F32_MAX_STAGES, max(0, CLS_MAX_SMEM - fixed) // stage)
    return stages, fixed + stages * stage


def cls_logits_launches(dtype: torch.dtype, head_dim: int, seq_len: int,
                        width: int) -> Optional[dict]:
    """The launches one B2 call makes on the card at hidden width `width`
    (the kernel's, padded), by CLS_LAUNCH_KINDS (the rule of
    csrc/cls_logits.cu::vpt_cls_logits_plan, which chip_smoke.py holds
    equal), or None where the kernel refuses the call."""
    if head_dim not in LAYER_HEAD_DIMS or seq_len < 1 or dtype not in _DTYPES:
        return None
    plan = dict.fromkeys(CLS_LAUNCH_KINDS, 0)
    if dtype == torch.float32:
        stages, size = cls_kv_smem_f32(head_dim, seq_len)
        if stages < 1 or size > CLS_MAX_SMEM:
            return None
        plan.update(f32_split_planes=1, ln1_stats=1, f32_kv_attention_k_then_v=1, f32_tail=1)
        return plan
    stages, size = cls_kv_smem(head_dim, seq_len, width)
    if stages < 2 or size > CLS_MAX_SMEM:
        return None
    plan["ln1_stats"] = plan["tail"] = 1
    plan[CLS_LAUNCH_KINDS[1 + cls_v_mode(head_dim, seq_len)]] = 1
    return plan


# B2's launches since the last reset_cls_launch_counts(), by kind, as the op
# tallies them from cls_logits_launches where it launches
cls_launches: dict = dict.fromkeys(CLS_LAUNCH_KINDS, 0)


def cls_launch_counts() -> dict:
    """B2's launches of each kind since the last reset_cls_launch_counts(),
    as the C library counted them."""
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    counts = (ctypes.c_longlong * len(CLS_LAUNCH_KINDS))()
    load_library().vpt_cls_logits_launch_counts(counts)
    return dict(zip(CLS_LAUNCH_KINDS, counts))


def reset_cls_launch_counts():
    """Zero the C counters and cls_launches."""
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    load_library().vpt_cls_logits_launch_reset()
    cls_launches.update(dict.fromkeys(CLS_LAUNCH_KINDS, 0))


# --- gradients ----------------------------------------------------------------------

def grad_needed(*trees) -> bool:
    """Does autograd record through these tensors (or trees of them) now?"""
    return torch.is_grad_enabled() and any(
        t.requires_grad for tree in trees for _, t in flatten_tree(tree))


def refuse_grad(who: str, *trees):
    """Raise where autograd would record through a kernel without a backward
    (its result would carry no graph, and the weights behind it would get no
    gradient without a word)."""
    if grad_needed(*trees):
        raise RuntimeError(
            f"{who}: this kernel has no backward (nor has its TPU counterpart); call it "
            f"under torch.no_grad(), or train through kernel_mode('eager')")


def eager_layer(x: torch.Tensor, params: dict, num_heads: int, eps: float,
                token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain layer whose gradient B1's backward takes, as the JAX
    package's differentiable_fused_layer does: LN -> mha -> LN -> mlp_block
    (erf GELU, or SwiGLU) in x's dtype, LayerScale's gains where the layer
    has them."""
    scale = has_layerscale(params)
    a = mha(layer_norm(x, params["ln1"], eps), params["attn"], num_heads, token_mask=token_mask)
    x1 = x + (params["ls1"] * a if scale else a)
    y = mlp_block(layer_norm(x1, params["ln2"], eps), params["mlp"])
    return x1 + (params["ls2"] * y if scale else y)


class RecomputedBackward(torch.autograd.Function):
    """Forward: kernel(x, params, token_mask), a launch (or its plain
    version on the CPU); backward: eager(x, params, token_mask) recomputed
    from the saved x and weights and differentiated for the upstream
    gradient. The weights come as the flat `leaves` at `paths`; token_mask
    gets no gradient."""

    @staticmethod
    def forward(ctx, kernel, eager, token_mask, paths, x, *leaves):
        ctx.eager, ctx.token_mask, ctx.paths = eager, token_mask, paths
        ctx.save_for_backward(x, *leaves)
        return kernel(x, unflatten_tree(paths, leaves), token_mask)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        need = ctx.needs_input_grad[4:]
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, need)]
        with torch.enable_grad():
            y = ctx.eager(inputs[0], unflatten_tree(ctx.paths, inputs[1:]), ctx.token_mask)
        wrt = [t for t, n in zip(inputs, need) if n]
        grads = iter(torch.autograd.grad(y, wrt, g) if wrt else ())
        return (None, None, None, None) + tuple(next(grads) if n else None for n in need)


def recomputed(kernel, eager, x: torch.Tensor, params: dict,
               token_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """kernel(x, params, token_mask) through RecomputedBackward."""
    paths, leaves = zip(*flatten_tree(params))
    return RecomputedBackward.apply(kernel, eager, token_mask, paths, x, *leaves)


# --- wrappers -----------------------------------------------------------------------

def _check(x: torch.Tensor, tensors: dict, shapes: dict, who: str,
           dtypes: Optional[dict] = None) -> int:
    """Device, dtype, shape and contiguity checks shared by the wrappers
    (alignment is checked where the memory is, in the ops); returns the
    kernel's dtype code. A tensor named in `dtypes` must have that dtype,
    every other one x's."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{who}: dtype {x.dtype} not supported (float32, bfloat16)")
    for name, t in {"x": x, **tensors}.items():
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{who}: {name} has shape {tuple(t.shape)}, want {shapes[name]}")
        want = (dtypes or {}).get(name, x.dtype)
        if t.device != x.device or t.dtype != want:
            raise ValueError(
                f"{who}: {name} is {t.dtype} on {t.device}; it must be {want} on {x.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous")
    return _DTYPES[x.dtype]


def _check_token_mask(token_mask: Optional[torch.Tensor], x: torch.Tensor, b: int, s: int,
                      who: str):
    if token_mask is None:
        return
    if token_mask.shape != (b, s) or token_mask.dtype != torch.bool:
        raise ValueError(f"{who}: token_mask must be bool [{b}, {s}]")
    if token_mask.device != x.device or not token_mask.is_contiguous():
        raise ValueError(f"{who}: token_mask must be contiguous on {x.device}")


def _geometry(x: torch.Tensor, params: dict, num_heads: int, who: str):
    """(B, S, D, hd, KW, M) of a layer call, at the model's widths."""
    if x.dim() != 3:
        raise ValueError(f"{who}: x must be [B, S, D], got {tuple(x.shape)}")
    b, s, d = x.shape
    kw = weight(params["attn"]["q"]).shape[-1]
    m = mlp_width(params)
    hd = kw // num_heads
    if kw % num_heads or hd not in LAYER_HEAD_DIMS:
        raise ValueError(f"{who}: head dim {kw}/{num_heads} not supported (the kernel takes "
                         f"{', '.join(map(str, LAYER_HEAD_DIMS))})")
    if s < 1 or b < 1:
        raise ValueError(f"{who}: x must have a batch and a sequence, got {tuple(x.shape)}")
    if params["ln1"]["g"].shape[-1] != d:
        raise ValueError(f"{who}: x has width {d}, the layer {params['ln1']['g'].shape[-1]}")
    return b, s, d, hd, kw, m


# the names of _layer_weights' twelve, in the C entries' order
LAYER_WEIGHTS = ("ln1.g", "ln1.b", "qkv.w", "qkv.b", "o.w", "o.b", "ln2.g", "ln2.b", "fc1.w",
                 "fc1.b", "fc2.w", "fc2.b")


def _layer_shapes(d: int, kw: int, m: int, gated: bool = False, scaled: bool = False) -> dict:
    """The layer weights' shapes: a gated fc1 is 2M wide, LayerScale adds
    its two gains."""
    f = 2 * m if gated else m
    return {"ln1.g": (d,), "ln1.b": (d,), "o.w": (kw, d), "o.b": (d,), "ln2.g": (d,),
            "ln2.b": (d,), "fc1.w": (d, f), "fc1.b": (f,), "fc2.w": (m, d), "fc2.b": (d,),
            **({"ls1": (d,), "ls2": (d,)} if scaled else {})}


def _layer_weights(params: dict, qkv: bool = True) -> dict:
    """A float layer tree's (or stacked tree's) weights in the C entries'
    order, by name: LN1, the fused QKV (`qkv`; B2 takes Q and the fused KV
    in its place, see _cls_weights), O, LN2, fc1 (a SwiGLU tree's
    interleaved fc1), fc2, then LayerScale's two gains where the tree has
    them (B1 alone takes them). The concatenations are copies, made where
    the kernel is called (in an export, graph ops)."""
    a, mlp = params["attn"], params["mlp"]
    w = {"ln1.g": params["ln1"]["g"], "ln1.b": params["ln1"]["b"]}
    if qkv:
        w["qkv.w"] = torch.cat([a[n]["w"] for n in "qkv"], dim=-1)
        w["qkv.b"] = torch.cat([a[n]["b"] for n in "qkv"], dim=-1)
    w1, b1, _ = fc1_linear(params)
    w.update({"o.w": a["o"]["w"], "o.b": a["o"]["b"], "ln2.g": params["ln2"]["g"],
              "ln2.b": params["ln2"]["b"], "fc1.w": w1, "fc1.b": b1,
              "fc2.w": mlp["fc2"]["w"], "fc2.b": mlp["fc2"]["b"]})
    if has_layerscale(params):
        w.update({"ls1": params["ls1"], "ls2": params["ls2"]})
    return w


def _padded_call(x: torch.Tensor, params: dict, multiple: int):
    """(x, the layer tree the kernel reads, D at the kernel): both padded to
    `multiple` where the widths need it (ops/cuda/widths.py)."""
    kp = kernel_layer(params, multiple)
    dp = kp["ln1"]["g"].shape[-1]
    return pad_dim(x, -1, dp), kp, dp


def _unpad(y: torch.Tensor, d: int) -> torch.Tensor:
    return y if y.shape[-1] == d else y[..., :d]


def _workspaces(x: torch.Tensor, rows: int, d: int, kw: int, m: int, qkv_cols: int) -> list:
    """h [rows, D], qkv [rows, qkv_cols], ctx [rows, KW], x1 [rows, D] f32,
    m1 [rows, M]: the buffers of B1's launch sequence."""
    return [x.new_empty((rows, d)), x.new_empty((rows, qkv_cols)), x.new_empty((rows, kw)),
            torch.empty((rows, d), dtype=torch.float32, device=x.device), x.new_empty((rows, m))]


def _weight_planes(x: torch.Tensor, *sizes: int) -> Optional[torch.Tensor]:
    """f32 only (else None): room for the three bf16 planes of the largest
    of `sizes`: the call's weights (K * N each), into which csrc/gemm.cu's
    split body splits each f32 weight before its product, and q, k and v
    (3 rows KW), which the f32 attention (csrc/split_attention.cuh) splits
    between the QKV and O products."""
    if x.dtype != torch.float32:
        return None
    return torch.empty(3 * max(sizes), dtype=torch.bfloat16, device=x.device)


def _b1_fake(x, token_mask, weights, num_heads, norm_width, eps, gated=False):
    return torch.empty_like(x)


@kernel_op("fused_vit_layer", _b1_fake)
def _b1_op(x: torch.Tensor, token_mask: Optional[torch.Tensor], weights: list[torch.Tensor],
           num_heads: int, norm_width: int, eps: float, gated: bool = False) -> torch.Tensor:
    """B1's launch. weights: _layer_weights' twelve, in their order, and
    LayerScale's two gains where the layer has them; gated: fc1 is SwiGLU's,
    interleaved, 2M wide."""
    who = "fused_vit_layer"
    b, s, d = x.shape
    kw, m = weights[4].shape[0], weights[10].shape[0]
    check_aligned(who, x=x, **dict(zip(LAYER_WEIGHTS + ("ls1", "ls2"), weights)))
    out = torch.empty_like(x)
    ws = _workspaces(x, b * s, d, kw, m, 3 * kw)
    planes = _weight_planes(x, 3 * d * kw, d * m, 3 * b * s * kw)
    ls1, ls2 = weights[12:14] if len(weights) == 14 else (None, None)
    run(who, x.device, "vpt_vit_layer_forward", _DTYPES[x.dtype], ptr(x), ptr(token_mask),
        *map(ptr, weights[:12]), ptr(ls1), ptr(ls2), ptr(out), *map(ptr, ws), ptr(planes), b, s,
        d, num_heads, kw // num_heads, m, norm_width, int(gated), eps)
    fused_vit_layer.launches += 1
    count_attention("b1", x.dtype, kw // num_heads, s)
    if x.dtype == torch.float32:
        count_f32_products("b1", F32_PRODUCTS["b1"])
    return out


def fused_vit_layer(
    x: torch.Tensor,
    params: dict,
    num_heads: int,
    eps: float = 1e-12,
    token_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel B1: one pre-LN ViT block, x [B, S, D] -> [B, S, D].

    params: one layer's dict {'ln1','attn','ln2','mlp'}; token_mask [B, S]
    bool or None (False = key masked with -1e30). hd = q width / num_heads.
    Differentiable: under autograd the call runs through
    RecomputedBackward, whose backward is eager_layer's. DINOv2's block
    (LayerScale's gains, a SwiGLU fc1 in either order; ops/swiglu.py) in
    bf16 on the card, or in its plain version.
    """
    if grad_needed(x, params):
        return recomputed(
            lambda x_, p_, m_: _fused_vit_layer(x_, p_, num_heads, eps, m_),
            lambda x_, p_, m_: eager_layer(x_, p_, num_heads, eps, m_),
            x, params, token_mask)
    return _fused_vit_layer(x, params, num_heads, eps, token_mask)


def _fused_vit_layer(x, params, num_heads, eps, token_mask):
    """B1's operator, or its plain version for a CPU tensor."""
    if not launch_kernel_for(x):
        return fused_vit_layer_ref(x, params, num_heads, eps, token_mask)
    who = "fused_vit_layer"
    b, s, d, hd, kw, m = _geometry(x, params, num_heads, who)
    swiglu, scaled = is_swiglu(params), has_layerscale(params)
    if (swiglu or scaled) and x.dtype != torch.bfloat16:
        raise ValueError(f"{who}: a SwiGLU or LayerScale layer runs in bfloat16 alone (the f32 "
                         f"split body has no gated or LayerScale epilogue), got {x.dtype}")
    require_interleaved(who, params)
    with span("prep"):
        xk, kp, dp = _padded_call(x, params, LAYER_MULTIPLE)
        mp = mlp_width(kp)
        w = _layer_weights(kp)
    _check(xk, w, {"qkv.w": (dp, 3 * kw), "qkv.b": (3 * kw,),
                   **_layer_shapes(dp, kw, mp, swiglu, scaled)}, who)
    _check_token_mask(token_mask, x, b, s, who)
    return _unpad(torch.ops.vpt.fused_vit_layer(xk, token_mask, list(w.values()), num_heads, d,
                                                eps, swiglu), d)


fused_vit_layer.launches = 0


def _cls_weights(params: dict, lnf: dict, head: dict) -> dict:
    """B2's eighteen weights in its C entry's order: LN1, Q, the fused KV,
    O, LN2, fc1, fc2, the final LN, the classifier."""
    a = params["attn"]
    w = _layer_weights(params, qkv=False)
    return {"ln1.g": w.pop("ln1.g"), "ln1.b": w.pop("ln1.b"), "q.w": a["q"]["w"],
            "q.b": a["q"]["b"], "kv.w": torch.cat([a["k"]["w"], a["v"]["w"]], dim=-1),
            "kv.b": torch.cat([a["k"]["b"], a["v"]["b"]], dim=-1), **w,
            "ln_f.g": lnf["g"], "ln_f.b": lnf["b"], "head.w": head["w"], "head.b": head["b"]}


def _b2_fake(x, weights, num_heads, norm_width, eps):
    return x.new_empty((x.shape[0], weights[16].shape[1]))


@kernel_op("fused_vit_layer_cls_logits", _b2_fake)
def _b2_op(x: torch.Tensor, weights: list[torch.Tensor], num_heads: int, norm_width: int,
           eps: float) -> torch.Tensor:
    """B2's launch. weights: _cls_weights' eighteen, in their order; the
    classifier's labels a multiple of 8."""
    who = "fused_vit_layer_cls_logits"
    b, s, d = x.shape
    kw, m, labels = weights[2].shape[1], weights[10].shape[1], weights[16].shape[1]
    check_aligned(who, x=x, **{f"weight {i}": t for i, t in enumerate(weights)})
    logits = x.new_empty((b, labels))
    f32 = {"dtype": torch.float32, "device": x.device}
    stats = torch.empty((b * s + CLS_STAT_PAD, 2), **f32)  # LN1's statistics
    if x.dtype == torch.bfloat16:  # h [B, D] (LN2's, then LN_f's), ctx [B, KW], m1 [B, M]
        h, ctx, m1, partial = x.new_empty((b, d)), x.new_empty((b, kw)), x.new_empty((b, m)), None
        planes = None
    else:  # h, ctx and m1 as their three bf16 planes; the tail's partial sums (64 units of
        # [64, 128] a 64-row tile); the six weights' planes (q, kv, o, fc1, fc2, the
        # classifier), each 3 K round_up(N, 8)
        bf = {"dtype": torch.bfloat16, "device": x.device}
        h, ctx, m1 = (torch.empty(3 * b * n, **bf) for n in (d, kw, m))
        partial = torch.empty(-(-b // 64) * 64 * 64 * 128, **f32)
        planes = torch.empty(3 * sum(k * round_up(n, 8) for k, n in (
            (d, kw), (d, 2 * kw), (kw, d), (d, m), (m, d), (d, labels))), **bf)
    ws = [h, stats, partial, ctx, torch.empty((b, d), **f32), m1, torch.empty((b, d), **f32)]
    run(who, x.device, "vpt_vit_cls_logits_forward", _DTYPES[x.dtype], ptr(x),
        *map(ptr, weights), ptr(logits), *map(ptr, ws), ptr(planes), b, s, d, num_heads,
        kw // num_heads, m, norm_width, labels, eps)
    fused_vit_layer_cls_logits.launches += 1
    for kind, n in cls_logits_launches(x.dtype, kw // num_heads, s, d).items():
        cls_launches[kind] += n
    return logits


def fused_vit_layer_cls_logits(
    x: torch.Tensor,
    params: dict,
    lnf: dict,
    head: dict,
    num_heads: int,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Kernel B2: the last layer on the CLS row + final LN + classifier.

    x [B, S, D] is the last layer's input; K/V come from every token, Q,
    attention, MLP, LN and head from CLS alone. Returns [B, labels] in x's
    dtype, equal to vit_layer -> layer_norm -> head on CLS. The classifier
    is zero-padded to a multiple of 8 labels for the kernel (its W rows are
    TMA boxes) and the logits sliced back.
    """
    who = "fused_vit_layer_cls_logits"
    refuse_dinov2(who, params)
    if head["w"].shape[0] != x.shape[-1]:
        raise ValueError(f"{who}: the classifier reads {head['w'].shape[0]} features, the CLS row "
                         f"has {x.shape[-1]}: a pooled head (CLS ⊕ the patch mean) needs every "
                         f"row of the last layer, which B2 does not compute")
    if not launch_kernel_for(x):
        return fused_vit_layer_cls_logits_ref(x, params, lnf, head, num_heads, eps)
    refuse_grad(who, x, params, lnf, head)
    b, s, d, hd, kw, m = _geometry(x, params, num_heads, who)
    with span("prep"):
        xk, kp, dp = _padded_call(x, params, LAYER_MULTIPLE)
        if x.dtype in _DTYPES and cls_logits_launches(x.dtype, hd, s, dp) is None:
            dname = "f32" if x.dtype == torch.float32 else "bf16"
            need = "one stage" if x.dtype == torch.float32 else "two stages"
            raise ValueError(f"{who}: S {s} at head dim {hd} and width {dp} leaves no room for "
                             f"{need} of the {dname} kernel's ring in {CLS_MAX_SMEM} bytes of "
                             f"shared memory")
        mp = kp["mlp"]["fc1"]["w"].shape[-1]
        labels = head["w"].shape[1]
        lp = round_up(labels, LAYER_MULTIPLE)
        lnf = {k: pad_dim(v, -1, dp) for k, v in lnf.items()}
        head = {"w": pad_dim(pad_dim(head["w"], 0, dp), 1, lp), "b": pad_dim(head["b"], 0, lp)}
        w = _cls_weights(kp, lnf, head)
    shapes = {"q.w": (dp, kw), "q.b": (kw,), "kv.w": (dp, 2 * kw), "kv.b": (2 * kw,),
              **_layer_shapes(dp, kw, mp), "ln_f.g": (dp,), "ln_f.b": (dp,),
              "head.w": (dp, lp), "head.b": (lp,)}
    _check(xk, w, shapes, who)
    logits = torch.ops.vpt.fused_vit_layer_cls_logits(xk, list(w.values()), num_heads, d, eps)
    return logits if lp == labels else logits[:, :labels]


fused_vit_layer_cls_logits.launches = 0


def _b3_fake(x, dest, kept, weights, cap, num_heads, norm_width, eps):
    return torch.empty_like(x)


@kernel_op("fused_vit_layer_bucketed", _b3_fake)
def _b3_op(x: torch.Tensor, dest: torch.Tensor, kept: torch.Tensor, weights: list[torch.Tensor],
           cap: int, num_heads: int, norm_width: int, eps: float) -> torch.Tensor:
    """B3's launch. weights: _layer_weights' twelve, in their order."""
    who = "fused_vit_layer_bucketed"
    b, s, d = x.shape
    kw, m = weights[4].shape[0], weights[8].shape[1]
    check_aligned(who, x=x, **dict(zip(LAYER_WEIGHTS, weights)))
    out = torch.empty_like(x)
    rows = b * cap
    src = torch.empty((b, cap), dtype=torch.int32, device=x.device)
    counts = torch.empty((b,), dtype=torch.int32, device=x.device)
    xc, yc = x.new_empty((rows, d)), x.new_empty((rows, d))
    h, qkv, ctx, x1, m1 = _workspaces(x, rows, d, kw, m, 3 * kw)
    planes = _weight_planes(x, 3 * d * kw, d * m, 3 * rows * kw)
    run(who, x.device, "vpt_vit_layer_bucketed_forward", _DTYPES[x.dtype], ptr(x), ptr(dest),
        ptr(kept), *map(ptr, weights), ptr(out), ptr(src), ptr(counts), ptr(xc), ptr(yc),
        ptr(h), ptr(qkv), ptr(ctx), ptr(x1), ptr(m1), ptr(planes), b, s, cap, d, num_heads,
        kw // num_heads, m, norm_width, eps)
    fused_vit_layer_bucketed.launches += 1
    count_attention("b3", x.dtype, kw // num_heads, cap)
    if x.dtype == torch.float32:
        count_f32_products("b3", F32_PRODUCTS["b3"])
    return out


def fused_vit_layer_bucketed(
    x: torch.Tensor,
    params: dict,
    dest: torch.Tensor,
    kept: torch.Tensor,
    cap: int,
    num_heads: int,
    eps: float = 1e-12,
) -> torch.Tensor:
    """Kernel B3: the bucketed mask-mode layer, x [B, S, D] -> [B, S, D].

    dest [B, S] integer compacted row ids (kept first, stable; see
    bucket_compact), kept [B, S] bool, cap a static bound on every image's
    kept count (1 <= cap <= S). Kept tokens get the layer output computed
    over the kept keys only, skipped tokens are x unchanged. The counts and
    the key mask are made on the card: nothing here reads the device.
    """
    who = "fused_vit_layer_bucketed"
    refuse_dinov2(who, params)
    if not launch_kernel_for(x):
        return fused_vit_layer_bucketed_ref(x, params, dest, kept, cap, num_heads, eps)
    refuse_grad(who, x, params)
    b, s, d, hd, kw, m = _geometry(x, params, num_heads, who)
    if not 1 <= cap <= s:
        raise ValueError(f"{who}: cap {cap} not in [1, S={s}]")
    with span("prep"):
        xk, kp, dp = _padded_call(x, params, LAYER_MULTIPLE)
        mp = kp["mlp"]["fc1"]["w"].shape[-1]
        w = _layer_weights(kp)
    _check(xk, w, {"qkv.w": (dp, 3 * kw), "qkv.b": (3 * kw,), **_layer_shapes(dp, kw, mp)}, who)
    dest = dest.to(torch.int32)
    for name, t, want in (("dest", dest, torch.int32), ("kept", kept, torch.bool)):
        if t.shape != (b, s) or t.dtype != want:
            raise ValueError(f"{who}: {name} must be {want} [{b}, {s}]")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous on {x.device}")
    return _unpad(torch.ops.vpt.fused_vit_layer_bucketed(xk, dest, kept, list(w.values()), cap,
                                                         num_heads, d, eps), d)


fused_vit_layer_bucketed.launches = 0
