"""Kernel B4: the whole ViT layer with int8 weight products. A wrapper around
csrc/layer_int8.cu beside its plain PyTorch version.

`fused_vit_layer_int8` replaces vit_pruning_tpu/ops/pallas/layer_int8.py::
fused_vit_layer_int8: B1's block (ops/cuda/layer.py) with QKV, O, fc1 and
fc2 as int8 x int8 -> int32 products on per-row quantized activations and
per-column quantized weights (ops/quant.py::quantize_layer_params), on the
wgmma s8 + TMA body (csrc/wgmma_s8.cuh). What bounds it on an H100 and what
the CUDA design does about it is in the head of csrc/layer_int8.cu. The
kernel reads the weights K-major (ops/quant.py::kmajor_int8_weights): from
the tree's KMAJOR entry, which the forwards build once per call, or built
here for a tree without one.

The plain version keeps the TPU kernel's numerics, which differ from the
eager int8 layer (ops/quant.py::int8_vit_layer_ref) in three places:
  * the row scale is max(amax, 1e-12) * (1/127) in f32 (its `_rowquant`),
    where ops/quant.py divides by 127;
  * LN1 and LN2 run in f32 and their f32 output is quantized (the eager
    layer's LN runs in x's dtype, so in bf16 it is rounded first);
  * attention is B1's staged2 core (unnormalised numerators in x's dtype,
    divided after PV); ctx and the GELU output are rounded to x's dtype
    before they are quantized, as in the eager layer.

The wrapper launches for CUDA tensors and counts the launch in `launches`;
for CPU tensors it runs the plain version (mode 'auto') or raises (mode
'kernel'). It never falls back from a CUDA tensor.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vit_pruning_tpu_torch.ops.cuda.gemm import ACTS
from vit_pruning_tpu_torch.ops.cuda.layer import (
    _check,
    _check_token_mask,
    _gelu_for,
    _geometry,
    _ln_f32,
    _raise_on,
    _stream,
    refuse_grad,
    staged2_attention,
)
from vit_pruning_tpu_torch.ops.dispatch import launch_kernel_for
from vit_pruning_tpu_torch.ops.quant import KMAJOR, int_matmul, kmajor_int8_weights

# the activations quantized inside the layer, in order: LN1's output (QKV
# input), the attention context (O input), LN2's output (fc1 input) and the
# GELU output (fc2 input)
STAGES = ("ln1", "ctx", "ln2", "gelu")


# --- plain versions ---------------------------------------------------------------

def rowquant_ref(x: torch.Tensor):
    """The TPU kernel's `_rowquant`: per-row symmetric int8 of x in f32, the
    scale max(amax, 1e-12) * (1/127) as an f32 product, x / scale rounded
    half to even and clipped to +-127. Returns (int8 [..., K], f32 [..., 1])."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True).clamp_min(1e-12) * (1.0 / 127.0)
    return torch.round(xf / scale).clamp(-127, 127).to(torch.int8), scale


def _dequant(q8, rs, wq, ws, b) -> torch.Tensor:
    """(acc * row scale) * column scale + bias, in f32, as the TPU kernel."""
    return int_matmul(q8, wq).float() * rs * ws + b.float()


def fused_vit_layer_int8_ref(
    x: torch.Tensor,
    qparams: dict,
    num_heads: int,
    eps: float = 1e-12,
    token_mask: Optional[torch.Tensor] = None,
    return_codes: bool = False,
):
    """Plain PyTorch version of kernel B4. qparams: one layer's tree with
    'wq' / 'wscale' per linear. With return_codes, also returns {stage:
    (int8 codes, f32 row scales)} for every stage of STAGES."""
    dt = x.dtype
    a, mlp = qparams["attn"], qparams["mlp"]
    xf = x.float()
    codes = {"ln1": rowquant_ref(_ln_f32(xf, qparams["ln1"], eps))}
    qkv = _dequant(*codes["ln1"], torch.cat([a[n]["wq"] for n in "qkv"], 1),
                   torch.cat([a[n]["wscale"] for n in "qkv"]),
                   torch.cat([a[n]["b"] for n in "qkv"])).to(dt)
    ctx = staged2_attention(*qkv.chunk(3, dim=-1), num_heads, token_mask)
    codes["ctx"] = rowquant_ref(ctx)
    x1 = xf + _dequant(*codes["ctx"], a["o"]["wq"], a["o"]["wscale"], a["o"]["b"])
    codes["ln2"] = rowquant_ref(_ln_f32(x1, qparams["ln2"], eps))
    m1 = _dequant(*codes["ln2"], mlp["fc1"]["wq"], mlp["fc1"]["wscale"], mlp["fc1"]["b"])
    codes["gelu"] = rowquant_ref(_gelu_for(dt)(m1).to(dt))
    out = (x1 + _dequant(*codes["gelu"], mlp["fc2"]["wq"], mlp["fc2"]["wscale"],
                         mlp["fc2"]["b"])).to(dt)
    return (out, codes) if return_codes else out


# --- wrappers -----------------------------------------------------------------------

def rowquant(x: torch.Tensor):
    """The row-quantization kernel of B4 on its own: x [R, K] float32 or
    bfloat16 -> (int8 [R, K], f32 [R, 1]), as rowquant_ref."""
    if not launch_kernel_for(x):
        return rowquant_ref(x)
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    who = "rowquant"
    lib = load_library()
    if x.dim() != 2 or x.shape[1] % 16:
        raise ValueError(f"{who}: x must be [R, K] with K a multiple of 16, got {tuple(x.shape)}")
    dtype = _check(x, {}, {}, who)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((x.shape[0], 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.vpt_rowquant(dtype, x.data_ptr(), q.data_ptr(), s.data_ptr(), x.shape[0],
                              x.shape[1], _stream(x))
    _raise_on(lib, rc, who)
    rowquant.launches += 1
    return q, s


rowquant.launches = 0


def fused_vit_layer_int8(
    x: torch.Tensor,
    qparams: dict,
    num_heads: int,
    eps: float = 1e-12,
    token_mask: Optional[torch.Tensor] = None,
    return_codes: bool = False,
):
    """Kernel B4: one pre-LN ViT block with int8 weight products, x [B, S, D]
    -> [B, S, D] in x's dtype.

    qparams: one layer's tree from quantize_layer_params (int8 'wq' [K, N],
    f32 'wscale' [N], biases and LN params in x's dtype; a float 'w' beside
    them is ignored), with or without its KMAJOR layout. token_mask [B, S] bool or None (False = key masked
    with -1e30). With return_codes, also returns the int8 codes and row
    scales of every stage of STAGES, as the plain version does.
    """
    if not launch_kernel_for(x):
        return fused_vit_layer_int8_ref(x, qparams, num_heads, eps, token_mask, return_codes)
    who = "fused_vit_layer_int8"
    refuse_grad(who, x, qparams)
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    a, mlp = qparams["attn"], qparams["mlp"]
    b, s, d, hd, kw, m = _geometry(lib, x, qparams, num_heads, who)
    if d % 16 or m % 16:
        raise ValueError(f"{who}: hidden {d} and MLP width {m} must be multiples of 16")
    # the int8 products read both operands K-major: weights as [N, K]
    nk = qparams.get(KMAJOR) or kmajor_int8_weights(qparams)
    w = {
        "ln1.g": qparams["ln1"]["g"], "ln1.b": qparams["ln1"]["b"],
        "qkv.wq": nk["qkv"]["wq"], "qkv.ws": nk["qkv"]["wscale"], "qkv.b": nk["qkv"]["b"],
        "o.wq": nk["o"]["wq"], "o.ws": a["o"]["wscale"], "o.b": a["o"]["b"],
        "ln2.g": qparams["ln2"]["g"], "ln2.b": qparams["ln2"]["b"],
        "fc1.wq": nk["fc1"]["wq"], "fc1.ws": mlp["fc1"]["wscale"], "fc1.b": mlp["fc1"]["b"],
        "fc2.wq": nk["fc2"]["wq"], "fc2.ws": mlp["fc2"]["wscale"], "fc2.b": mlp["fc2"]["b"],
    }
    shapes = {"ln1.g": (d,), "ln1.b": (d,), "qkv.wq": (3 * kw, d), "qkv.ws": (3 * kw,),
              "qkv.b": (3 * kw,), "o.wq": (d, kw), "o.ws": (d,), "o.b": (d,), "ln2.g": (d,),
              "ln2.b": (d,), "fc1.wq": (m, d), "fc1.ws": (m,), "fc1.b": (m,),
              "fc2.wq": (d, m), "fc2.ws": (d,), "fc2.b": (d,)}
    dtypes = {k: torch.int8 for k in w if k.endswith(".wq")}
    dtypes.update({k: torch.float32 for k in w if k.endswith(".ws")})
    dtype = _check(x, w, shapes, who, dtypes)
    _check_token_mask(token_mask, x, b, s, who)

    rows = b * s
    out = torch.empty_like(x)
    widths = {"ln1": d, "ctx": kw, "ln2": d, "gelu": m}
    codes = {k: (torch.empty((rows, n), dtype=torch.int8, device=x.device),
                 torch.empty((rows, 1), dtype=torch.float32, device=x.device))
             for k, n in widths.items()}
    qkv = x.new_empty((rows, 3 * kw))
    ctx = x.new_empty((rows, kw))
    x1 = torch.empty((rows, d), dtype=torch.float32, device=x.device)
    m1 = x.new_empty((rows, m))
    with torch.cuda.device(x.device):
        rc = lib.vpt_vit_layer_int8_forward(
            dtype, x.data_ptr(), None if token_mask is None else token_mask.data_ptr(),
            *(t.data_ptr() for t in w.values()), out.data_ptr(),
            *(t.data_ptr() for k in STAGES for t in codes[k]),
            qkv.data_ptr(), ctx.data_ptr(), x1.data_ptr(), m1.data_ptr(),
            b, s, d, num_heads, hd, m, eps, _stream(x),
        )
    _raise_on(lib, rc, who)
    fused_vit_layer_int8.launches += 1
    if not return_codes:
        return out
    return out, {k: (q.reshape(b, s, -1), sc.reshape(b, s, 1)) for k, (q, sc) in codes.items()}


fused_vit_layer_int8.launches = 0


# --- one product of the body, for tests of it ------------------------------------------


def gemm_s8_ref(codes: torch.Tensor, rs: torch.Tensor, wt: torch.Tensor, ws: torch.Tensor,
                bias: Optional[torch.Tensor] = None, act: str = "none",
                residual: Optional[torch.Tensor] = None,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of one of B4's products: int8 codes [M, K] with their
    f32 row scales rs [M, 1], wt int8 [N, K] (the K-major weight), ws f32
    [N]. The exact int32 product, (acc * rs) * ws in f32, + bias, activation,
    + residual, one cast."""
    y = int_matmul(codes, wt.t()).float() * rs * ws
    if bias is not None:
        y = y + bias.float()
    if act != "none":
        y = F.gelu(y, approximate="tanh" if act == "gelu_tanh" else "none")
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def gemm_s8(codes: torch.Tensor, rs: torch.Tensor, wt: torch.Tensor, ws: torch.Tensor,
            bias: Optional[torch.Tensor] = None, act: str = "none",
            residual: Optional[torch.Tensor] = None,
            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """One product on B4's wgmma s8 + TMA body, as the layer runs each of its
    four: arguments and result as gemm_s8_ref. The epilogue's dtype is
    bias's (float32 or bfloat16; float32 without a bias), out_dtype it or
    float32, residual it or float32. Not exported: chip_smoke.py and the
    tests hold the body to gemm_s8_ref with it."""
    who = "gemm_s8"
    if codes.dim() != 2 or wt.dim() != 2 or codes.shape[1] != wt.shape[1]:
        raise ValueError(f"{who}: codes [M, K] and wt [N, K], got {tuple(codes.shape)} and "
                         f"{tuple(wt.shape)}")
    m, k = codes.shape
    n = wt.shape[0]
    if not launch_kernel_for(codes):
        return gemm_s8_ref(codes, rs, wt, ws, bias, act, residual, out_dtype)
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    dt = torch.float32 if bias is None else bias.dtype
    if act not in ACTS or dt not in (torch.float32, torch.bfloat16) or \
            out_dtype not in (dt, torch.float32) or k % 16 or n % 8:
        raise ValueError(f"{who}: act {act!r}, epilogue dtype {dt}, out {out_dtype}, K {k}, N "
                         f"{n} not taken (K a multiple of 16, N of 8)")
    tensors = {"codes": (codes, (m, k), torch.int8), "rs": (rs, (m, 1), torch.float32),
               "wt": (wt, (n, k), torch.int8), "ws": (ws, (n,), torch.float32)}
    if bias is not None:
        tensors["bias"] = (bias, (n,), dt)
    if residual is not None:
        tensors["residual"] = (residual, (m, n), residual.dtype)
        if residual.dtype not in (dt, torch.float32):
            raise ValueError(f"{who}: residual is {residual.dtype}; it takes {dt} or float32")
    for name, (t_, shape, dtype) in tensors.items():
        if (tuple(t_.shape) != shape or t_.dtype != dtype or t_.device != codes.device
                or not t_.is_contiguous() or t_.data_ptr() % 16):
            raise ValueError(f"{who}: {name} must be contiguous 16-byte aligned {dtype} "
                             f"{shape} on {codes.device}, got {t_.dtype} {tuple(t_.shape)}")
    out = torch.empty((m, n), dtype=out_dtype, device=codes.device)
    with torch.cuda.device(codes.device):
        rc = lib.vpt_gemm_s8(
            int(dt == torch.bfloat16), codes.data_ptr(), k, rs.data_ptr(), wt.data_ptr(),
            ws.data_ptr(), m, n, k, None if bias is None else bias.data_ptr(), ACTS[act],
            None if residual is None else residual.data_ptr(), n,
            int(residual is not None and residual.dtype == torch.float32), out.data_ptr(), n,
            int(out_dtype == torch.float32), _stream(codes))
    _raise_on(lib, rc, who)
    gemm_s8.launches += 1
    return out


gemm_s8.launches = 0


def body_launches() -> int:
    """Launches of the wgmma s8 body since the last reset_body_launches():
    B4's four products a layer, and gemm_s8's one."""
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    return int(load_library().vpt_int8_body_launches())


def reset_body_launches():
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    load_library().vpt_int8_body_reset()
