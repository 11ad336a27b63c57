"""Kernel B5: every encoder layer in one call, with the residual stream in
f32 from the first layer to the last.

`fused_vit_encoder` replaces vit_pruning_tpu/ops/pallas/model.py::
fused_vit_encoder. Its numerics differ from B1's (ops/cuda/layer.py) in
three places, as the TPU kernels do: the softmax is normalised and P is
rounded to x's dtype before PV; the GELU is the erf form in every dtype; x
stays f32 between layers and is rounded once at the end. The CUDA entry is
csrc/encoder.cu, which runs B1's LN, GEMM and attention launchers layer
after layer from C, with no Python between layers.

Models take this route (models/vit.py::encoder_route) for a stretch of
layers at a fixed sequence length when kernels are on, encoder fusion is on
(ops/dispatch.py) and `encoder_weights_fit` holds. The wrapper launches the
kernel for CUDA tensors through the registered operator
vpt::fused_vit_encoder (ops/cuda/library.py), which counts the launch in
the wrapper's `launches` attribute; for CPU tensors it runs the plain
version (mode 'auto') or raises (mode 'kernel'). Widths that are not
multiples of 8 are zero-padded as B1's (ops/cuda/widths.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vit_pruning_tpu_torch.ops.cuda.layer import (
    _DTYPES,
    LAYER_WEIGHTS,
    _check,
    _check_token_mask,
    _geometry,
    _layer_shapes,
    _layer_weights,
    _linear_f32,
    _ln_f32,
    _padded_call,
    _unpad,
    _workspaces,
    eager_layer,
    grad_needed,
    recomputed,
    staged2_attention,
)
from vit_pruning_tpu_torch.ops.cuda.library import check_aligned, kernel_op, ptr, run
from vit_pruning_tpu_torch.ops.cuda.widths import LAYER_MULTIPLE
from vit_pruning_tpu_torch.ops.dispatch import launch_kernel_for


def _layer(layers: dict, i: int) -> dict:
    """Layer i of the stacked [L, ...] tree (views)."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


def encoder_weights_fit(num_layers: int, d: int, m: int, itemsize: int = 2,
                        budget_bytes: int = 96 * 1024 * 1024) -> bool:
    """The JAX package's rule for taking the whole-encoder route: all layer
    weights (QKV + O + fc1 + fc2, biases left out) under the 96 MB budget
    its kernel kept resident in VMEM. The port keeps the rule, and not a
    budget of its own, so that both packages route the same configs alike."""
    per_layer = 4 * d * d + 2 * d * m
    return num_layers * per_layer * itemsize < budget_bytes


def fused_vit_encoder_ref(
    x: torch.Tensor,
    layers: dict,
    num_heads: int,
    eps: float = 1e-12,
    token_mask: Optional[torch.Tensor] = None,
    norm_width: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of kernel B5 (the TPU kernel's numerics).
    norm_width as layer.py::fused_vit_layer_ref's."""
    dt = x.dtype
    xf = x.float()
    for i in range(layers["ln1"]["g"].shape[0]):
        p = _layer(layers, i)
        a, mlp = p["attn"], p["mlp"]
        h1 = _ln_f32(xf, p["ln1"], eps, norm_width)
        q, k, v = (_linear_f32(h1, a[n]["w"], a[n]["b"]).to(dt) for n in "qkv")
        ctx = staged2_attention(q, k, v, num_heads, token_mask, normalized=True)
        x1 = xf + _linear_f32(ctx, a["o"]["w"], a["o"]["b"])
        m1 = F.gelu(_linear_f32(_ln_f32(x1, p["ln2"], eps, norm_width), mlp["fc1"]["w"],
                                mlp["fc1"]["b"]))
        xf = x1 + _linear_f32(m1, mlp["fc2"]["w"], mlp["fc2"]["b"])  # m1 rounded to the dtype
    return xf.to(dt)


def eager_encoder(x: torch.Tensor, layers: dict, num_heads: int, eps: float,
                  token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain layer loop whose gradient B5's backward takes, as the JAX
    package's differentiable_fused_encoder does."""
    for i in range(layers["ln1"]["g"].shape[0]):
        x = eager_layer(x, _layer(layers, i), num_heads, eps, token_mask)
    return x


def fused_vit_encoder(
    x: torch.Tensor,
    layers: dict,
    num_heads: int,
    eps: float = 1e-12,
    token_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel B5: x [B, S, D] through every layer of `layers`, the float
    layer tree stacked on a leading [L] axis (a slice [l0:l1] of a model's
    layers runs those layers). token_mask [B, S] bool or None masks keys at
    every layer. Returns [B, S, D] in x's dtype. B1's limits: head dim 16,
    32, 64 or 80; any S, D and M. Differentiable: under
    autograd the call runs through ops/cuda/layer.py::RecomputedBackward,
    whose backward is eager_encoder's."""
    if grad_needed(x, layers):
        return recomputed(
            lambda x_, p_, m_: _fused_vit_encoder(x_, p_, num_heads, eps, m_),
            lambda x_, p_, m_: eager_encoder(x_, p_, num_heads, eps, m_),
            x, layers, token_mask)
    return _fused_vit_encoder(x, layers, num_heads, eps, token_mask)


def _b5_fake(x, token_mask, weights, num_heads, norm_width, eps):
    return torch.empty_like(x)


@kernel_op("fused_vit_encoder", _b5_fake)
def _b5_op(x: torch.Tensor, token_mask: Optional[torch.Tensor], weights: list[torch.Tensor],
           num_heads: int, norm_width: int, eps: float) -> torch.Tensor:
    """B5's launch. weights: B1's twelve (layer.py::LAYER_WEIGHTS), stacked
    on a leading [L] axis."""
    who = "fused_vit_encoder"
    b, s, d = x.shape
    n_layers, kw, m = weights[4].shape[0], weights[4].shape[1], weights[8].shape[2]
    check_aligned(who, x=x, **dict(zip(LAYER_WEIGHTS, weights)))
    out = torch.empty_like(x)
    h, qkv, ctx, x1, m1 = _workspaces(x, b * s, d, kw, m, 3 * kw)
    xr = torch.empty_like(x1)
    run(who, x.device, "vpt_vit_encoder_forward", _DTYPES[x.dtype], ptr(x), ptr(token_mask),
        *map(ptr, weights), ptr(out), ptr(h), ptr(qkv), ptr(ctx), ptr(x1), ptr(m1), ptr(xr),
        n_layers, b, s, d, num_heads, kw // num_heads, m, norm_width, eps)
    fused_vit_encoder.launches += 1
    return out


def _fused_vit_encoder(x, layers, num_heads, eps, token_mask):
    """B5's operator, or its plain version for a CPU tensor."""
    if not launch_kernel_for(x):
        return fused_vit_encoder_ref(x, layers, num_heads, eps, token_mask)
    who = "fused_vit_encoder"
    n_layers = layers["attn"]["q"]["w"].shape[0]
    b, s, d, hd, kw, m = _geometry(x, _layer(layers, 0), num_heads, who)
    xk, kl, dp = _padded_call(x, layers, LAYER_MULTIPLE)
    mp = kl["mlp"]["fc1"]["w"].shape[-1]
    w = _layer_weights(kl)
    shapes = {"qkv.w": (n_layers, dp, 3 * kw), "qkv.b": (n_layers, 3 * kw),
              **{k: (n_layers, *v) for k, v in _layer_shapes(dp, kw, mp).items()}}
    _check(xk, w, shapes, who)
    _check_token_mask(token_mask, x, b, s, who)
    return _unpad(torch.ops.vpt.fused_vit_encoder(xk, token_mask, list(w.values()), num_heads, d,
                                                  eps), d)


fused_vit_encoder.launches = 0
