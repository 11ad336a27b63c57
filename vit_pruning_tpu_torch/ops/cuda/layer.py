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

A wrapper launches its kernel for CUDA tensors and counts the launch in its
`launches` attribute; for CPU tensors it runs the plain version (mode
'auto') or raises (mode 'kernel'). It never falls back from a CUDA tensor.

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
from vit_pruning_tpu_torch.ops.dispatch import launch_kernel_for

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the head dims B1-B5 take: csrc/common.cuh::layer_head_dim_ok, which gates
# every call; this copy only words the error
LAYER_HEAD_DIMS = (16, 32, 64, 80)


# --- plain versions ---------------------------------------------------------------

def _ln_f32(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    return layer_norm(x.float(), {"g": p["g"].float(), "b": p["b"].float()}, eps)


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
) -> torch.Tensor:
    """Plain PyTorch version of kernel B1 (staged2 numerics)."""
    dt = x.dtype
    a = params["attn"]
    xf = x.float()
    h1 = _ln_f32(xf, params["ln1"], eps)
    q, k, v = (_linear_f32(h1, a[n]["w"], a[n]["b"]).to(dt) for n in "qkv")
    ctx = staged2_attention(q, k, v, num_heads, token_mask)
    x1 = xf + _linear_f32(ctx, a["o"]["w"], a["o"]["b"])
    h2 = _ln_f32(x1, params["ln2"], eps)
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
) -> torch.Tensor:
    """Plain PyTorch version of kernel B2: logits [B, labels] in x's dtype."""
    dt = x.dtype
    b, s, d = x.shape
    a = params["attn"]
    kw = a["q"]["w"].shape[1]
    hd = kw // num_heads
    xf = x.float()
    h1 = _ln_f32(xf, params["ln1"], eps)
    k, v = (_heads(_linear_f32(h1, a[n]["w"], a[n]["b"]).to(dt), num_heads) for n in "kv")
    q = _heads(_linear_f32(h1[:, :1], a["q"]["w"], a["q"]["b"]).to(dt), num_heads)  # [B,H,1,hd]
    logits = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = (p / p.sum(-1, keepdim=True)).to(dt).float()
    ctx = (p @ v.float()).transpose(1, 2).reshape(b, kw)  # f32
    x1 = xf[:, 0] + _linear_f32(ctx, a["o"]["w"], a["o"]["b"])
    h2 = _ln_f32(x1, params["ln2"], eps)
    mlp = params["mlp"]
    m1 = _gelu_for(dt)(_linear_f32(h2, mlp["fc1"]["w"], mlp["fc1"]["b"]))
    x2 = x1 + _linear_f32(m1, mlp["fc2"]["w"], mlp["fc2"]["b"])
    yn = _ln_f32(x2, lnf, eps)
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
) -> torch.Tensor:
    """Plain PyTorch version of kernel B3: gather, B1's plain layer at `cap`
    with the count key mask, scatter + identity passthrough."""
    xc, key_ok = bucket_compact(x, dest, kept, cap)
    yc = fused_vit_layer_ref(xc, params, num_heads, eps, key_ok)
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
    """Device, dtype, shape, contiguity and alignment checks shared by the
    wrappers; returns the kernel's dtype code. A tensor named in `dtypes`
    must have that dtype, every other one x's."""
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
        if t.data_ptr() % 16:
            raise ValueError(f"{who}: {name} must be 16-byte aligned")
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


def _geometry(lib, x: torch.Tensor, params: dict, num_heads: int, who: str):
    if x.dim() != 3:
        raise ValueError(f"{who}: x must be [B, S, D], got {tuple(x.shape)}")
    b, s, d = x.shape
    kw = _weight(params["attn"]["q"]).shape[1]
    m = _weight(params["mlp"]["fc1"]).shape[1]
    hd = kw // num_heads
    if kw % num_heads or not lib.vpt_layer_head_dim_ok(hd):
        raise ValueError(f"{who}: head dim {kw}/{num_heads} not supported (the kernel takes "
                         f"{', '.join(map(str, LAYER_HEAD_DIMS))})")
    if s < 1 or b < 1:
        raise ValueError(f"{who}: x must have a batch and a sequence, got {tuple(x.shape)}")
    if d % 8 or m % 8:
        raise ValueError(f"{who}: hidden {d} and MLP width {m} must be multiples of 8")
    return b, s, d, hd, kw, m


def _layer_shapes(d: int, kw: int, m: int) -> dict:
    return {"ln1.g": (d,), "ln1.b": (d,), "o.w": (kw, d), "o.b": (d,), "ln2.g": (d,),
            "ln2.b": (d,), "fc1.w": (d, m), "fc1.b": (m,), "fc2.w": (m, d), "fc2.b": (d,)}


def _layer_weights(params: dict) -> dict:
    a, mlp = params["attn"], params["mlp"]
    return {
        "ln1.g": params["ln1"]["g"], "ln1.b": params["ln1"]["b"],
        "o.w": a["o"]["w"], "o.b": a["o"]["b"],
        "ln2.g": params["ln2"]["g"], "ln2.b": params["ln2"]["b"],
        "fc1.w": mlp["fc1"]["w"], "fc1.b": mlp["fc1"]["b"],
        "fc2.w": mlp["fc2"]["w"], "fc2.b": mlp["fc2"]["b"],
    }


def _raise_on(lib, rc: int, who: str):
    if rc != 0:
        raise RuntimeError(f"{who}: CUDA error {rc}: {lib.vpt_error_string(rc).decode()}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
    """B1's launch, or its plain version for a CPU tensor."""
    if not launch_kernel_for(x):
        return fused_vit_layer_ref(x, params, num_heads, eps, token_mask)
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    who = "fused_vit_layer"
    lib = load_library()
    a = params["attn"]
    wqkv = torch.cat([a["q"]["w"], a["k"]["w"], a["v"]["w"]], dim=1)
    bqkv = torch.cat([a["q"]["b"], a["k"]["b"], a["v"]["b"]])
    b, s, d, hd, kw, m = _geometry(lib, x, params, num_heads, who)
    shapes = {"qkv.w": (d, 3 * kw), "qkv.b": (3 * kw,), **_layer_shapes(d, kw, m)}
    w = _layer_weights(params)
    dtype = _check(x, {"qkv.w": wqkv, "qkv.b": bqkv, **w}, shapes, who)
    _check_token_mask(token_mask, x, b, s, who)

    out = torch.empty_like(x)
    rows = b * s
    h = x.new_empty((rows, d))
    qkv = x.new_empty((rows, 3 * kw))
    ctx = x.new_empty((rows, kw))
    x1 = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    m1 = x.new_empty((rows, m))
    with torch.cuda.device(x.device):
        rc = lib.vpt_vit_layer_forward(
            dtype, x.data_ptr(), None if token_mask is None else token_mask.data_ptr(),
            w["ln1.g"].data_ptr(), w["ln1.b"].data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            w["o.w"].data_ptr(), w["o.b"].data_ptr(), w["ln2.g"].data_ptr(), w["ln2.b"].data_ptr(),
            w["fc1.w"].data_ptr(), w["fc1.b"].data_ptr(), w["fc2.w"].data_ptr(), w["fc2.b"].data_ptr(),
            out.data_ptr(), h.data_ptr(), qkv.data_ptr(), ctx.data_ptr(), x1.data_ptr(), m1.data_ptr(),
            b, s, d, num_heads, hd, m, eps, _stream(x),
        )
    _raise_on(lib, rc, who)
    fused_vit_layer.launches += 1
    return out


fused_vit_layer.launches = 0


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
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    a = params["attn"]
    wkv = torch.cat([a["k"]["w"], a["v"]["w"]], dim=1)
    bkv = torch.cat([a["k"]["b"], a["v"]["b"]])
    w = _layer_weights(params)
    tensors = {"q.w": a["q"]["w"], "q.b": a["q"]["b"], "kv.w": wkv, "kv.b": bkv, **w,
               "ln_f.g": lnf["g"], "ln_f.b": lnf["b"], "head.w": head["w"], "head.b": head["b"]}
    b, s, d, hd, kw, m = _geometry(lib, x, params, num_heads, who)
    labels = head["w"].shape[1]
    shapes = {"q.w": (d, kw), "q.b": (kw,), "kv.w": (d, 2 * kw), "kv.b": (2 * kw,),
              **_layer_shapes(d, kw, m), "ln_f.g": (d,), "ln_f.b": (d,),
              "head.w": (d, labels), "head.b": (labels,)}
    dtype = _check(x, tensors, shapes, who)

    logits = x.new_empty((b, labels))
    h = x.new_empty((b * s, d))
    kv = x.new_empty((b * s, 2 * kw))
    q = x.new_empty((b, kw))
    ctx = x.new_empty((b, kw))
    x1 = torch.empty((b, d), dtype=torch.float32, device=x.device)
    m1 = x.new_empty((b, m))
    x2 = torch.empty((b, d), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.vpt_vit_cls_logits_forward(
            dtype, x.data_ptr(),
            w["ln1.g"].data_ptr(), w["ln1.b"].data_ptr(), a["q"]["w"].data_ptr(),
            a["q"]["b"].data_ptr(), wkv.data_ptr(), bkv.data_ptr(),
            w["o.w"].data_ptr(), w["o.b"].data_ptr(), w["ln2.g"].data_ptr(), w["ln2.b"].data_ptr(),
            w["fc1.w"].data_ptr(), w["fc1.b"].data_ptr(), w["fc2.w"].data_ptr(), w["fc2.b"].data_ptr(),
            lnf["g"].data_ptr(), lnf["b"].data_ptr(), head["w"].data_ptr(), head["b"].data_ptr(),
            logits.data_ptr(), h.data_ptr(), kv.data_ptr(), q.data_ptr(), ctx.data_ptr(),
            x1.data_ptr(), m1.data_ptr(), x2.data_ptr(),
            b, s, d, num_heads, hd, m, labels, eps, _stream(x),
        )
    _raise_on(lib, rc, who)
    fused_vit_layer_cls_logits.launches += 1
    return logits


fused_vit_layer_cls_logits.launches = 0


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
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    a = params["attn"]
    wqkv = torch.cat([a["q"]["w"], a["k"]["w"], a["v"]["w"]], dim=1)
    bqkv = torch.cat([a["q"]["b"], a["k"]["b"], a["v"]["b"]])
    b, s, d, hd, kw, m = _geometry(lib, x, params, num_heads, who)
    if not 1 <= cap <= s:
        raise ValueError(f"{who}: cap {cap} not in [1, S={s}]")
    shapes = {"qkv.w": (d, 3 * kw), "qkv.b": (3 * kw,), **_layer_shapes(d, kw, m)}
    w = _layer_weights(params)
    dtype = _check(x, {"qkv.w": wqkv, "qkv.b": bqkv, **w}, shapes, who)
    dest = dest.to(torch.int32)
    for name, t, want in (("dest", dest, torch.int32), ("kept", kept, torch.bool)):
        if t.shape != (b, s) or t.dtype != want:
            raise ValueError(f"{who}: {name} must be {want} [{b}, {s}]")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{who}: {name} must be contiguous on {x.device}")

    out = torch.empty_like(x)
    rows = b * cap
    src = torch.empty((b, cap), dtype=torch.int32, device=x.device)
    counts = torch.empty((b,), dtype=torch.int32, device=x.device)
    xc, yc, h = (x.new_empty((rows, d)) for _ in range(3))
    qkv = x.new_empty((rows, 3 * kw))
    ctx = x.new_empty((rows, kw))
    x1 = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    m1 = x.new_empty((rows, m))
    with torch.cuda.device(x.device):
        rc = lib.vpt_vit_layer_bucketed_forward(
            dtype, x.data_ptr(), dest.data_ptr(), kept.data_ptr(),
            w["ln1.g"].data_ptr(), w["ln1.b"].data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            w["o.w"].data_ptr(), w["o.b"].data_ptr(), w["ln2.g"].data_ptr(), w["ln2.b"].data_ptr(),
            w["fc1.w"].data_ptr(), w["fc1.b"].data_ptr(), w["fc2.w"].data_ptr(), w["fc2.b"].data_ptr(),
            out.data_ptr(), src.data_ptr(), counts.data_ptr(), xc.data_ptr(), yc.data_ptr(),
            h.data_ptr(), qkv.data_ptr(), ctx.data_ptr(), x1.data_ptr(), m1.data_ptr(),
            b, s, cap, d, num_heads, hd, m, eps, _stream(x),
        )
    _raise_on(lib, rc, who)
    fused_vit_layer_bucketed.launches += 1
    return out


fused_vit_layer_bucketed.launches = 0
