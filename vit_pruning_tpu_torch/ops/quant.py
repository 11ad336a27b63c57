"""int8 serving quantization: the plain ops and param preparation.

Mirrors vit_pruning_tpu/ops/quant.py, the scheme's ground truth:
  * weights: symmetric per-output-channel int8 (scale = amax / 127 per
    column), quantized once per forward, not once per layer call;
  * activations: symmetric dynamic per-row int8, quantized right before
    each weight product;
  * products: int8 x int8 -> exact int32, dequantized as
    acc * row_scale * col_scale + bias in f32;
  * attention, the layer norms, GELU and the residuals stay in the serving
    dtype.

Rounding is half to even (torch.round, as jnp.round), clipped to +-127.
`int8_vit_layer_ref` is the eager int8 layer (kernel mode 'eager'); kernel
B4 (ops/cuda/layer_int8.py) follows the TPU kernel's numerics instead, which
differ in three places listed there. B4 reads its weights K-major
(`kmajor_int8_weights`), a layout the forwards build once per call beside
the tree's own leaves (`with_kmajor_int8_weights`).

Every function keeps its input's device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vit_pruning_tpu_torch.configs import ViTConfig
from vit_pruning_tpu_torch.ops.swiglu import refuse_dinov2

LINEARS = (("attn", "q"), ("attn", "k"), ("attn", "v"), ("attn", "o"), ("mlp", "fc1"),
           ("mlp", "fc2"))


def quantize_weight(w: torch.Tensor):
    """Per-output-channel symmetric int8. w [..., K, N] -> (int8 [..., K, N],
    f32 [..., N]); the amax runs over K alone, so a stacked [L, K, N] tree is
    quantized layer by layer, as the JAX package's vmap does."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2).clamp_min(1e-12) / 127.0
    q = torch.round(wf / scale.unsqueeze(-2)).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8. x [..., K] -> (int8 [..., K], f32 [..., 1])."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


# cuBLASLt's int8 GEMM finds no algorithm for K 32 or 64 on an H100
# (CUBLAS_STATUS_NOT_SUPPORTED, vit_tiny's K 64 among them) and ran every
# product tried from K 128 up (128, 192, 256, 384; 136 to 1,576 rows)
INT_MM_MIN_K = 128


def int_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product, a [..., K] @ w [K, N].

    On the CPU an int32 product. On the card torch._int_mm (cuBLASLt int8)
    where its shape rules hold (more than 16 rows, K and N multiples of 8)
    and K is at least INT_MM_MIN_K, else a float64 product, exact here since
    |sum| <= 127^2 * K < 2^53.
    """
    lead, k = a.shape[:-1], a.shape[-1]
    a2 = a.reshape(-1, k)
    if not a.is_cuda:
        acc = a2.int() @ w.int()
    elif a2.shape[0] > 16 and k % 8 == 0 and w.shape[1] % 8 == 0 and k >= INT_MM_MIN_K:
        acc = torch._int_mm(a2.contiguous(), w.contiguous())
    else:
        acc = (a2.double() @ w.double()).int()
    return acc.reshape(*lead, w.shape[1])


def int8_linear(
    x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor, b: Optional[torch.Tensor]
) -> torch.Tensor:
    """Dynamic-activation int8 linear: returns f32 [..., N]."""
    xq, xs = quantize_rows(x)
    out = int_matmul(xq, wq).float() * xs * wscale
    if b is not None:
        out = out + b.float()
    return out


def attach_int8_weights(params: dict, keep_float: bool = True) -> dict:
    """A copy of one layer's (or the stacked layers') tree whose six linears
    also carry 'wq' (int8) and 'wscale' (f32). With keep_float the float 'w'
    stays beside them, so the same tree serves the float consumers (the
    predictors, the float B2 tail) and the int8 layers. The plain ViT block
    alone: a SwiGLU or LayerScale tree raises (int8 serving has neither)."""
    refuse_dinov2("attach_int8_weights", params)
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in params.items()}
    for group, name in LINEARS:
        lin = dict(out[group][name])
        lin["wq"], lin["wscale"] = quantize_weight(lin["w"] if keep_float else lin.pop("w"))
        out[group][name] = lin
    return out


def quantize_layer_params(params: dict) -> dict:
    """Quantize one layer's weight matrices (q/k/v/o, fc1/fc2): 'w' becomes
    'wq' + 'wscale'; biases and layer norms stay float. Works on the stacked
    [L, K, N] weights too (each layer its own scales)."""
    return attach_int8_weights(params, keep_float=False)


# the key of a layer tree under which a forward keeps kernel B4's weight
# layout (kmajor_int8_weights) beside the tree's own leaves
KMAJOR = "int8_kmajor"


def _kmajor(wq: torch.Tensor) -> torch.Tensor:
    return wq.transpose(-1, -2).contiguous()


def kmajor_int8_weights(qparams: dict) -> dict:
    """Kernel B4's weights for one layer's (or the stacked layers') quantized
    tree. 8-bit wgmma reads both operands K-major, so each int8 [..., K, N]
    'wq' becomes [..., N, K], and the three QKV products are one:
    {'qkv': {'wq' [..., 3KW, D], 'wscale' [..., 3KW], 'b' [..., 3KW]},
    'o' / 'fc1' / 'fc2': {'wq' [..., N, K]}}. New tensors; the tree's own
    leaves, which the plain versions read, are left as they are."""
    a, m = qparams["attn"], qparams["mlp"]
    return {
        "qkv": {"wq": torch.cat([a[n]["wq"].transpose(-1, -2) for n in "qkv"], dim=-2),
                "wscale": torch.cat([a[n]["wscale"] for n in "qkv"], dim=-1),
                "b": torch.cat([a[n]["b"] for n in "qkv"], dim=-1)},
        "o": {"wq": _kmajor(a["o"]["wq"])},
        "fc1": {"wq": _kmajor(m["fc1"]["wq"])},
        "fc2": {"wq": _kmajor(m["fc2"]["wq"])},
    }


def with_kmajor_int8_weights(qparams: dict) -> dict:
    """A shallow copy of a quantized layer tree (one layer or stacked) with
    kmajor_int8_weights under KMAJOR; the tree itself if it has them."""
    if KMAJOR in qparams:
        return qparams
    return {**qparams, KMAJOR: kmajor_int8_weights(qparams)}


def is_quantized(params: dict) -> bool:
    """Does this layer tree carry int8 weights?"""
    return "wq" in params["attn"]["q"]


def int8_vit_layer_ref(
    x: torch.Tensor,
    qparams: dict,
    config: ViTConfig,
    token_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The eager int8 serving layer: models/vit.py::vit_layer with every
    weight product int8. LN runs in x's dtype (so in bf16 its output is
    rounded before it is quantized), the softmax is normalised before PV,
    GELU is the tanh form for bf16 and erf otherwise. The three QKV
    products share one row quantization and run as one product, which is
    the same arithmetic column by column."""
    from vit_pruning_tpu_torch.models.vit import layer_norm

    refuse_dinov2("int8_vit_layer_ref", qparams)
    from vit_pruning_tpu_torch.ops.attention import _merge_heads, _split_heads, attention_probs

    dt = x.dtype
    a = qparams["attn"]
    h = layer_norm(x, qparams["ln1"], config.layernorm_eps)
    wqkv = torch.cat([a[n]["wq"] for n in "qkv"], dim=1)
    sqkv = torch.cat([a[n]["wscale"] for n in "qkv"])
    bqkv = torch.cat([a[n]["b"] for n in "qkv"])
    qkv = int8_linear(h, wqkv, sqkv, bqkv).to(dt)
    q, k, v = (_split_heads(t, config.num_heads) for t in qkv.chunk(3, dim=-1))
    ctx = _merge_heads(attention_probs(q, k, token_mask) @ v)
    x1 = x + int8_linear(ctx, a["o"]["wq"], a["o"]["wscale"], a["o"]["b"]).to(dt)
    h2 = layer_norm(x1, qparams["ln2"], config.layernorm_eps)
    m = qparams["mlp"]
    h1 = int8_linear(h2, m["fc1"]["wq"], m["fc1"]["wscale"], m["fc1"]["b"])
    g = F.gelu(h1, approximate="tanh" if dt == torch.bfloat16 else "none")
    m2 = int8_linear(g.to(dt), m["fc2"]["wq"], m["fc2"]["wscale"], m["fc2"]["b"])
    return x1 + m2.to(dt)
