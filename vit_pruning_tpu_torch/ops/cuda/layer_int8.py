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

The wrapper launches for CUDA tensors, through the registered operator
vpt::fused_vit_layer_int8 (ops/cuda/library.py), which counts the launch in
`launches`; for CPU tensors it runs the plain version (mode 'auto') or
raises (mode 'kernel'). It never falls back from a CUDA tensor. D and M that
are not multiples of 16 (the products' K step) are zero-padded on the way
in, and the output and codes sliced on the way out (ops/cuda/widths.py).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from vit_pruning_tpu_torch.ops.cuda.gemm import ACTS
from vit_pruning_tpu_torch.ops.cuda.layer import (
    _DTYPES,
    _check,
    _check_token_mask,
    _gelu_for,
    _geometry,
    _ln_f32,
    _padded_call,
    _unpad,
    refuse_grad,
    staged2_attention,
)
from vit_pruning_tpu_torch.ops.cuda.library import check_aligned, kernel_op, ptr, run
from vit_pruning_tpu_torch.ops.cuda.widths import INT8_MULTIPLE
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
    norm_width: Optional[int] = None,
):
    """Plain PyTorch version of kernel B4. qparams: one layer's tree with
    'wq' / 'wscale' per linear. With return_codes, also returns {stage:
    (int8 codes, f32 row scales)} for every stage of STAGES. norm_width as
    layer.py::fused_vit_layer_ref's."""
    dt = x.dtype
    a, mlp = qparams["attn"], qparams["mlp"]
    xf = x.float()
    codes = {"ln1": rowquant_ref(_ln_f32(xf, qparams["ln1"], eps, norm_width))}
    qkv = _dequant(*codes["ln1"], torch.cat([a[n]["wq"] for n in "qkv"], 1),
                   torch.cat([a[n]["wscale"] for n in "qkv"]),
                   torch.cat([a[n]["b"] for n in "qkv"])).to(dt)
    ctx = staged2_attention(*qkv.chunk(3, dim=-1), num_heads, token_mask)
    codes["ctx"] = rowquant_ref(ctx)
    x1 = xf + _dequant(*codes["ctx"], a["o"]["wq"], a["o"]["wscale"], a["o"]["b"])
    codes["ln2"] = rowquant_ref(_ln_f32(x1, qparams["ln2"], eps, norm_width))
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
    who = "rowquant"
    if x.dim() != 2 or x.shape[1] % 16:
        raise ValueError(f"{who}: x must be [R, K] with K a multiple of 16, got {tuple(x.shape)}")
    dtype = _check(x, {}, {}, who)
    check_aligned(who, x=x)
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((x.shape[0], 1), dtype=torch.float32, device=x.device)
    run(who, x.device, "vpt_rowquant", dtype, ptr(x), ptr(q), ptr(s), x.shape[0], x.shape[1])
    rowquant.launches += 1
    return q, s


rowquant.launches = 0


# the names of B4's sixteen weights, in its C entry's order
INT8_WEIGHTS = ("ln1.g", "ln1.b", "qkv.wq", "qkv.ws", "qkv.b", "o.wq", "o.ws", "o.b", "ln2.g",
                "ln2.b", "fc1.wq", "fc1.ws", "fc1.b", "fc2.wq", "fc2.ws", "fc2.b")


def _stage_buffers(x: torch.Tensor, rows: int, widths: tuple) -> list:
    """The int8 codes [rows, n] and f32 row scales [rows, 1] of each stage
    of STAGES, flat: codes, scales, codes, scales, ..."""
    return [t for n in widths for t in (x.new_empty((rows, n), dtype=torch.int8),
                                        x.new_empty((rows, 1), dtype=torch.float32))]


def _b4_fake(x, token_mask, weights, num_heads, norm_width, eps):
    b, s, d = x.shape
    kw, m = weights[5].shape[1], weights[10].shape[0]
    return (torch.empty_like(x), *_stage_buffers(x, b * s, (d, kw, d, m)))


@kernel_op("fused_vit_layer_int8", _b4_fake)
def _b4_op(x: torch.Tensor, token_mask: Optional[torch.Tensor], weights: list[torch.Tensor],
           num_heads: int, norm_width: int, eps: float
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """B4's launch: (out, then the codes and row scales of every stage of
    STAGES). weights: INT8_WEIGHTS, in their order."""
    who = "fused_vit_layer_int8"
    b, s, d = x.shape
    kw, m = weights[5].shape[1], weights[10].shape[0]
    check_aligned(who, x=x, **dict(zip(INT8_WEIGHTS, weights)))
    rows = b * s
    out = torch.empty_like(x)
    codes = _stage_buffers(x, rows, (d, kw, d, m))
    ws = [x.new_empty((rows, 3 * kw)), x.new_empty((rows, kw)),
          torch.empty((rows, d), dtype=torch.float32, device=x.device), x.new_empty((rows, m))]
    run(who, x.device, "vpt_vit_layer_int8_forward", _DTYPES[x.dtype], ptr(x), ptr(token_mask),
        *map(ptr, weights), ptr(out), *map(ptr, codes), *map(ptr, ws), b, s, d, num_heads,
        kw // num_heads, m, norm_width, eps)
    fused_vit_layer_int8.launches += 1
    return (out, *codes)


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
    b, s, d, hd, kw, m = _geometry(x, qparams, num_heads, who)
    xk, kp, dp = _padded_call(x, qparams, INT8_MULTIPLE)
    mp = kp["mlp"]["fc1"]["wq"].shape[-1]
    a, mlp = kp["attn"], kp["mlp"]
    # the int8 products read both operands K-major: weights as [N, K]
    nk = kp.get(KMAJOR) or kmajor_int8_weights(kp)
    w = {
        "ln1.g": kp["ln1"]["g"], "ln1.b": kp["ln1"]["b"],
        "qkv.wq": nk["qkv"]["wq"], "qkv.ws": nk["qkv"]["wscale"], "qkv.b": nk["qkv"]["b"],
        "o.wq": nk["o"]["wq"], "o.ws": a["o"]["wscale"], "o.b": a["o"]["b"],
        "ln2.g": kp["ln2"]["g"], "ln2.b": kp["ln2"]["b"],
        "fc1.wq": nk["fc1"]["wq"], "fc1.ws": mlp["fc1"]["wscale"], "fc1.b": mlp["fc1"]["b"],
        "fc2.wq": nk["fc2"]["wq"], "fc2.ws": mlp["fc2"]["wscale"], "fc2.b": mlp["fc2"]["b"],
    }
    shapes = {"ln1.g": (dp,), "ln1.b": (dp,), "qkv.wq": (3 * kw, dp), "qkv.ws": (3 * kw,),
              "qkv.b": (3 * kw,), "o.wq": (dp, kw), "o.ws": (dp,), "o.b": (dp,), "ln2.g": (dp,),
              "ln2.b": (dp,), "fc1.wq": (mp, dp), "fc1.ws": (mp,), "fc1.b": (mp,),
              "fc2.wq": (dp, mp), "fc2.ws": (dp,), "fc2.b": (dp,)}
    dtypes = {k: torch.int8 for k in w if k.endswith(".wq")}
    dtypes.update({k: torch.float32 for k in w if k.endswith(".ws")})
    _check(xk, w, shapes, who, dtypes)
    _check_token_mask(token_mask, x, b, s, who)
    out, *codes = torch.ops.vpt.fused_vit_layer_int8(xk, token_mask, [w[k] for k in INT8_WEIGHTS],
                                                     num_heads, d, eps)
    out = _unpad(out, d)
    if not return_codes:
        return out
    widths = {"ln1": d, "ctx": kw, "ln2": d, "gelu": m}
    return out, {k: (codes[2 * i][:, :widths[k]].reshape(b, s, -1),
                     codes[2 * i + 1].reshape(b, s, 1)) for i, k in enumerate(STAGES)}


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
    run(who, codes.device, "vpt_gemm_s8", int(dt == torch.bfloat16), ptr(codes), k, ptr(rs),
        ptr(wt), ptr(ws), m, n, k, ptr(bias), ACTS[act], ptr(residual), n,
        int(residual is not None and residual.dtype == torch.float32), ptr(out), n,
        int(out_dtype == torch.float32))
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
