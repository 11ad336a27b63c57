"""Kernels B1, B2 and B3: a whole ViT layer, the last layer's CLS row through
the classifier, and the bucketed layer of the re-decide modes. Wrappers
around csrc/layer.cu, each beside its plain PyTorch version.

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
halves as it stayed in VMEM on the TPU.

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

The plain versions keep the TPU kernels' numerics, which differ from the
jnp reference layer (models/vit.py) in three places: products take operands
in the weight dtype and accumulate in f32 before the bias and the cast; the
GELU is the tanh form when x is bf16; B1 rounds the softmax numerators to
x's dtype, sums the rounded values and divides after the PV product, B2
normalises first and keeps the context in f32 until the O product.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from vit_pruning_tpu_torch.models.convert import flatten_tree, unflatten_tree
from vit_pruning_tpu_torch.models.vit import layer_norm, mlp_block
from vit_pruning_tpu_torch.ops.attention import NEG_INF, mha
from vit_pruning_tpu_torch.ops.cuda.library import check_aligned, kernel_op, ptr, run
from vit_pruning_tpu_torch.ops.cuda.widths import LAYER_MULTIPLE, kernel_layer, pad_dim
from vit_pruning_tpu_torch.ops.dispatch import launch_kernel_for

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims B1-B5 take: csrc/common.cuh::layer_head_dim_ok, which gates
# every call in C; the wrappers check this copy, so that a trace without a
# card needs no library (chip_smoke.py holds the two equal)
LAYER_HEAD_DIMS = (16, 32, 64, 80)


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
    kernel's DN); None = D."""
    dt = x.dtype
    a = params["attn"]
    xf = x.float()
    h1 = _ln_f32(xf, params["ln1"], eps, norm_width)
    q, k, v = (_linear_f32(h1, a[n]["w"], a[n]["b"]).to(dt) for n in "qkv")
    ctx = staged2_attention(q, k, v, num_heads, token_mask)
    x1 = xf + _linear_f32(ctx, a["o"]["w"], a["o"]["b"])
    h2 = _ln_f32(x1, params["ln2"], eps, norm_width)
    mlp = params["mlp"]
    m1 = _gelu_for(dt)(_linear_f32(h2, mlp["fc1"]["w"], mlp["fc1"]["b"]))
    return (x1 + _linear_f32(m1, mlp["fc2"]["w"], mlp["fc2"]["b"])).to(dt)


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
    b, s, d = x.shape
    a = params["attn"]
    kw = a["q"]["w"].shape[1]
    hd = kw // num_heads
    xf = x.float()
    h1 = _ln_f32(xf, params["ln1"], eps, norm_width)
    k, v = (_heads(_linear_f32(h1, a[n]["w"], a[n]["b"]).to(dt), num_heads) for n in "kv")
    q = _heads(_linear_f32(h1[:, :1], a["q"]["w"], a["q"]["b"]).to(dt), num_heads)  # [B,H,1,hd]
    logits = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).to(dt).float()
    ctx = (p @ v.float()).transpose(1, 2).reshape(b, kw)  # f32
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
    (erf GELU) in x's dtype."""
    x1 = x + mha(layer_norm(x, params["ln1"], eps), params["attn"], num_heads,
                 token_mask=token_mask)
    return x1 + mlp_block(layer_norm(x1, params["ln2"], eps), params["mlp"])


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


def _weight(linear: dict) -> torch.Tensor:
    """A linear's weight matrix: the float 'w', or the int8 'wq' of a
    quantized tree."""
    return linear["w"] if "w" in linear else linear["wq"]


def _geometry(x: torch.Tensor, params: dict, num_heads: int, who: str):
    """(B, S, D, hd, KW, M) of a layer call, at the model's widths."""
    if x.dim() != 3:
        raise ValueError(f"{who}: x must be [B, S, D], got {tuple(x.shape)}")
    b, s, d = x.shape
    kw = _weight(params["attn"]["q"]).shape[-1]
    m = _weight(params["mlp"]["fc1"]).shape[-1]
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


def _layer_shapes(d: int, kw: int, m: int) -> dict:
    return {"ln1.g": (d,), "ln1.b": (d,), "o.w": (kw, d), "o.b": (d,), "ln2.g": (d,),
            "ln2.b": (d,), "fc1.w": (d, m), "fc1.b": (m,), "fc2.w": (m, d), "fc2.b": (d,)}


def _layer_weights(params: dict, qkv: bool = True) -> dict:
    """A float layer tree's (or stacked tree's) weights in the C entries'
    order, by name: LN1, the fused QKV (`qkv`; B2 takes Q and the fused KV
    in its place, see _cls_weights), O, LN2, fc1, fc2. The concatenations
    are copies, made where the kernel is called (in an export, graph ops)."""
    a, mlp = params["attn"], params["mlp"]
    w = {"ln1.g": params["ln1"]["g"], "ln1.b": params["ln1"]["b"]}
    if qkv:
        w["qkv.w"] = torch.cat([a[n]["w"] for n in "qkv"], dim=-1)
        w["qkv.b"] = torch.cat([a[n]["b"] for n in "qkv"], dim=-1)
    w.update({"o.w": a["o"]["w"], "o.b": a["o"]["b"], "ln2.g": params["ln2"]["g"],
              "ln2.b": params["ln2"]["b"], "fc1.w": mlp["fc1"]["w"], "fc1.b": mlp["fc1"]["b"],
              "fc2.w": mlp["fc2"]["w"], "fc2.b": mlp["fc2"]["b"]})
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


def _b1_fake(x, token_mask, weights, num_heads, norm_width, eps):
    return torch.empty_like(x)


@kernel_op("fused_vit_layer", _b1_fake)
def _b1_op(x: torch.Tensor, token_mask: Optional[torch.Tensor], weights: list[torch.Tensor],
           num_heads: int, norm_width: int, eps: float) -> torch.Tensor:
    """B1's launch. weights: _layer_weights' twelve, in their order."""
    who = "fused_vit_layer"
    b, s, d = x.shape
    kw, m = weights[4].shape[0], weights[8].shape[1]
    check_aligned(who, x=x, **dict(zip(LAYER_WEIGHTS, weights)))
    out = torch.empty_like(x)
    ws = _workspaces(x, b * s, d, kw, m, 3 * kw)
    run(who, x.device, "vpt_vit_layer_forward", _DTYPES[x.dtype], ptr(x), ptr(token_mask),
        *map(ptr, weights), ptr(out), *map(ptr, ws), b, s, d, num_heads, kw // num_heads, m,
        norm_width, eps)
    fused_vit_layer.launches += 1
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
    RecomputedBackward, whose backward is eager_layer's.
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
    xk, kp, dp = _padded_call(x, params, LAYER_MULTIPLE)
    mp = kp["mlp"]["fc1"]["w"].shape[-1]
    w = _layer_weights(kp)
    _check(xk, w, {"qkv.w": (dp, 3 * kw), "qkv.b": (3 * kw,), **_layer_shapes(dp, kw, mp)}, who)
    _check_token_mask(token_mask, x, b, s, who)
    return _unpad(torch.ops.vpt.fused_vit_layer(xk, token_mask, list(w.values()), num_heads, d,
                                                eps), d)


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
    """B2's launch. weights: _cls_weights' eighteen, in their order."""
    who = "fused_vit_layer_cls_logits"
    b, s, d = x.shape
    kw, m, labels = weights[2].shape[1], weights[10].shape[1], weights[16].shape[1]
    check_aligned(who, x=x, **{f"weight {i}": t for i, t in enumerate(weights)})
    logits = x.new_empty((b, labels))
    ws = [x.new_empty((b * s, d)), x.new_empty((b * s, 2 * kw)), x.new_empty((b, kw)),
          x.new_empty((b, kw)), torch.empty((b, d), dtype=torch.float32, device=x.device),
          x.new_empty((b, m)), torch.empty((b, d), dtype=torch.float32, device=x.device)]
    run(who, x.device, "vpt_vit_cls_logits_forward", _DTYPES[x.dtype], ptr(x),
        *map(ptr, weights), ptr(logits), *map(ptr, ws), b, s, d, num_heads, kw // num_heads, m,
        norm_width, labels, eps)
    fused_vit_layer_cls_logits.launches += 1
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
    dtype, equal to vit_layer -> layer_norm -> head on CLS.
    """
    if not launch_kernel_for(x):
        return fused_vit_layer_cls_logits_ref(x, params, lnf, head, num_heads, eps)
    who = "fused_vit_layer_cls_logits"
    refuse_grad(who, x, params, lnf, head)
    b, s, d, hd, kw, m = _geometry(x, params, num_heads, who)
    xk, kp, dp = _padded_call(x, params, LAYER_MULTIPLE)
    mp = kp["mlp"]["fc1"]["w"].shape[-1]
    lnf = {k: pad_dim(v, -1, dp) for k, v in lnf.items()}
    head = {"w": pad_dim(head["w"], 0, dp), "b": head["b"]}
    w = _cls_weights(kp, lnf, head)
    labels = head["w"].shape[1]
    shapes = {"q.w": (dp, kw), "q.b": (kw,), "kv.w": (dp, 2 * kw), "kv.b": (2 * kw,),
              **_layer_shapes(dp, kw, mp), "ln_f.g": (dp,), "ln_f.b": (dp,),
              "head.w": (dp, labels), "head.b": (labels,)}
    _check(xk, w, shapes, who)
    return torch.ops.vpt.fused_vit_layer_cls_logits(xk, list(w.values()), num_heads, d, eps)


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
    run(who, x.device, "vpt_vit_layer_bucketed_forward", _DTYPES[x.dtype], ptr(x), ptr(dest),
        ptr(kept), *map(ptr, weights), ptr(out), ptr(src), ptr(counts), ptr(xc), ptr(yc),
        ptr(h), ptr(qkv), ptr(ctx), ptr(x1), ptr(m1), b, s, cap, d, num_heads,
        kw // num_heads, m, norm_width, eps)
    fused_vit_layer_bucketed.launches += 1
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
    if not launch_kernel_for(x):
        return fused_vit_layer_bucketed_ref(x, params, dest, kept, cap, num_heads, eps)
    who = "fused_vit_layer_bucketed"
    refuse_grad(who, x, params)
    b, s, d, hd, kw, m = _geometry(x, params, num_heads, who)
    if not 1 <= cap <= s:
        raise ValueError(f"{who}: cap {cap} not in [1, S={s}]")
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
