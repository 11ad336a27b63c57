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
kernel for CUDA tensors and counts the launch in its `launches` attribute;
for CPU tensors it runs the plain version (mode 'auto') or raises (mode
'kernel').
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vit_pruning_tpu_torch.ops.cuda.layer import (
    _check,
    _check_token_mask,
    _geometry,
    _layer_shapes,
    _layer_weights,
    _linear_f32,
    _ln_f32,
    _raise_on,
    _stream,
    eager_layer,
    grad_needed,
    recomputed,
    staged2_attention,
)
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
) -> torch.Tensor:
    """Plain PyTorch version of kernel B5 (the TPU kernel's numerics)."""
    dt = x.dtype
    xf = x.float()
    for i in range(layers["ln1"]["g"].shape[0]):
        p = _layer(layers, i)
        a, mlp = p["attn"], p["mlp"]
        h1 = _ln_f32(xf, p["ln1"], eps)
        q, k, v = (_linear_f32(h1, a[n]["w"], a[n]["b"]).to(dt) for n in "qkv")
        ctx = staged2_attention(q, k, v, num_heads, token_mask, normalized=True)
        x1 = xf + _linear_f32(ctx, a["o"]["w"], a["o"]["b"])
        m1 = F.gelu(_linear_f32(_ln_f32(x1, p["ln2"], eps), mlp["fc1"]["w"], mlp["fc1"]["b"]))
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
    32, 64 or 80, D and M multiples of 8; any S. Differentiable: under
    autograd the call runs through ops/cuda/layer.py::RecomputedBackward,
    whose backward is eager_encoder's."""
    if grad_needed(x, layers):
        return recomputed(
            lambda x_, p_, m_: _fused_vit_encoder(x_, p_, num_heads, eps, m_),
            lambda x_, p_, m_: eager_encoder(x_, p_, num_heads, eps, m_),
            x, layers, token_mask)
    return _fused_vit_encoder(x, layers, num_heads, eps, token_mask)


def _fused_vit_encoder(x, layers, num_heads, eps, token_mask):
    """B5's launch, or its plain version for a CPU tensor."""
    if not launch_kernel_for(x):
        return fused_vit_encoder_ref(x, layers, num_heads, eps, token_mask)
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    who = "fused_vit_encoder"
    lib = load_library()
    a = layers["attn"]
    n_layers = a["q"]["w"].shape[0]
    b, s, d, hd, kw, m = _geometry(lib, x, _layer(layers, 0), num_heads, who)
    wqkv = torch.cat([a["q"]["w"], a["k"]["w"], a["v"]["w"]], dim=2)
    bqkv = torch.cat([a["q"]["b"], a["k"]["b"], a["v"]["b"]], dim=1)
    shapes = {"qkv.w": (n_layers, d, 3 * kw), "qkv.b": (n_layers, 3 * kw),
              **{k: (n_layers, *v) for k, v in _layer_shapes(d, kw, m).items()}}
    w = _layer_weights(layers)
    dtype = _check(x, {"qkv.w": wqkv, "qkv.b": bqkv, **w}, shapes, who)
    _check_token_mask(token_mask, x, b, s, who)

    out = torch.empty_like(x)
    rows = b * s
    h = x.new_empty((rows, d))
    qkv = x.new_empty((rows, 3 * kw))
    ctx = x.new_empty((rows, kw))
    m1 = x.new_empty((rows, m))
    x1, xr = (torch.empty((rows, d), dtype=torch.float32, device=x.device) for _ in range(2))
    with torch.cuda.device(x.device):
        rc = lib.vpt_vit_encoder_forward(
            dtype, x.data_ptr(), None if token_mask is None else token_mask.data_ptr(),
            w["ln1.g"].data_ptr(), w["ln1.b"].data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
            w["o.w"].data_ptr(), w["o.b"].data_ptr(), w["ln2.g"].data_ptr(), w["ln2.b"].data_ptr(),
            w["fc1.w"].data_ptr(), w["fc1.b"].data_ptr(), w["fc2.w"].data_ptr(), w["fc2.b"].data_ptr(),
            out.data_ptr(), h.data_ptr(), qkv.data_ptr(), ctx.data_ptr(), x1.data_ptr(),
            m1.data_ptr(), xr.data_ptr(), n_layers, b, s, d, num_heads, hd, m, eps, _stream(x),
        )
    _raise_on(lib, rc, who)
    fused_vit_encoder.launches += 1
    return out


fused_vit_encoder.launches = 0
