"""The GEMM under kernels B1, B3 and B5, called on its own: wrappers
around csrc/gemm.cu's gemm() beside their plain PyTorch versions.

The layer kernels run this product from C for every projection (QKV, O,
fc1, fc2; B2's products run inside its own launches, csrc/cls_logits.cu,
on the same split arithmetic in f32). It is not
exported from the package: it exists so that chip_smoke.py and the tests
can hold the GEMM bodies against their plain versions at every product
shape of the main paths, one product at a time.

    out[M, N] = cast(residual + act(A[M, K] @ W[K, N] + bias))

gemm_bf16: A and W bf16; A may be a row-strided view (rows of [B, S, D]
with row stride S*D); bias bf16 [N]; act 'none', 'gelu_erf' or
'gelu_tanh' (in f32); residual [M, N] bf16 or float32, rows contiguous
(or row-strided the same way); out bf16 or float32. DINOv2's two epilogue
variants (persistent body alone): gamma bf16 [N], LayerScale's gain before
the residual, out = residual + gamma * (A W + bias); gate, SwiGLU's fc1 on
W's interleaved (u1, u2) column pairs (ops/swiglu.py), out [M, N / 2] bf16
= silu(u1 + b) * (u2 + b).
On the card gemm() takes the persistent wgmma + TMA body where TMA can
describe A and W (16-byte aligned, lda, N and K multiples of 8) and the
WMMA body otherwise, by shape alone. The persistent body launches one block
an SM, at most one a tile, and each block walks its share of the 128 x 128
output tiles (`wgmma_walk` mirrors the rule).

gemm_f32: A, W, bias, residual and out float32, N a multiple of 8, any M,
K and row stride of A: on the card the split body (W split into three bf16
planes in a workspace, A split in the producer; wgmma on the exact
three-way splits of both operands, six passes, f32 sums).

`body_counts()` reads the launches per body and the wgmma body's tiles and
blocks. For CPU tensors the wrappers run their plain versions; for CUDA
tensors they launch or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from vit_pruning_tpu_torch.ops.cuda.library import ptr, run
from vit_pruning_tpu_torch.ops.dispatch import launch_kernel_for

ACTS = {"none": 0, "gelu_erf": 1, "gelu_tanh": 2}
_OUT = (torch.bfloat16, torch.float32)


def gemm_bf16_ref(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  act: str = "none", residual: Optional[torch.Tensor] = None,
                  out_dtype: torch.dtype = torch.bfloat16, gamma: Optional[torch.Tensor] = None,
                  gate: bool = False) -> torch.Tensor:
    """Plain PyTorch version: the product in f32, then the epilogue in the
    TPU kernels' order (+ bias, activation, x gamma, + residual) in f32, or
    the gate on the interleaved pairs, one cast."""
    y = a.float() @ w.float()
    if bias is not None:
        y = y + bias.float()
    if gate:
        return (F.silu(y[:, 0::2]) * y[:, 1::2]).to(out_dtype)
    if act != "none":
        y = F.gelu(y, approximate="tanh" if act == "gelu_tanh" else "none")
    if gamma is not None:
        y = y * gamma.float()
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def gemm_f32_ref(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
                 act: str = "none", residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of the f32 split body: the f32 product (full
    f32 where the caller keeps TF32 off, as chip_smoke.py does), then the
    epilogue in f32."""
    return gemm_bf16_ref(a, w, bias, act, residual, torch.float32)


def _check(a, w, bias, act, residual, out_dtype, who="gemm_bf16") -> tuple:
    """The shapes, dtypes and layouts the kernel takes; (M, N, K, lda).
    gemm_bf16: bf16 operands, TMA's alignment; gemm_f32: f32 throughout."""
    dt = torch.float32 if who == "gemm_f32" else torch.bfloat16
    if a.dtype != dt or w.dtype != dt:
        raise ValueError(f"{who}: a and w must be {dt}, got {a.dtype} and {w.dtype}")
    if a.dim() != 2 or w.dim() != 2 or a.shape[1] != w.shape[0]:
        raise ValueError(f"{who}: a [M, K] and w [K, N], got {tuple(a.shape)} and {tuple(w.shape)}")
    m, k = a.shape
    n = w.shape[1]
    if min(m, n, k) < 1:
        raise ValueError(f"{who}: empty product {m} x {k} x {n}")
    if act not in ACTS:
        raise ValueError(f"{who}: act {act!r} not in {tuple(ACTS)}")
    if out_dtype not in _OUT:
        raise ValueError(f"{who}: out_dtype {out_dtype} not in {_OUT}")
    lda = a.stride(0)
    if a.stride(1) != 1 or lda < k:
        raise ValueError(f"{who}: a's rows must be contiguous (strides {a.stride()})")
    if dt == torch.bfloat16 and (k % 8 or lda % 8 or a.data_ptr() % 16):
        raise ValueError(f"{who}: K {k} and a's row stride {lda} must be multiples of 8 and a "
                         f"16-byte aligned")
    if dt == torch.float32 and n % 8:
        raise ValueError(f"{who}: N {n} must be a multiple of 8 (the row stride of W's planes "
                         f"for TMA)")
    if not w.is_contiguous() or (dt == torch.bfloat16 and w.data_ptr() % 16):
        raise ValueError(f"{who}: w must be contiguous" +
                         (" and 16-byte aligned" if dt == torch.bfloat16 else ""))
    if bias is not None and (bias.dtype != dt or tuple(bias.shape) != (n,)
                             or not bias.is_contiguous()):
        raise ValueError(f"{who}: bias must be contiguous {dt} [{n}]")
    res_dtypes = _OUT if dt == torch.bfloat16 else (torch.float32,)
    if residual is not None and (residual.dtype not in res_dtypes
                                 or tuple(residual.shape) != (m, n)
                                 or residual.stride(1) != 1 or residual.stride(0) < n):
        raise ValueError(f"{who}: residual must be {' or '.join(map(str, res_dtypes))} "
                         f"[{m}, {n}] with contiguous rows")
    for name, t in (("w", w), ("bias", bias), ("residual", residual)):
        if t is not None and t.device != a.device:
            raise ValueError(f"{who}: {name} is on {t.device}, a on {a.device}")
    return m, n, k, lda


def gemm_bf16(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
              act: str = "none", residual: Optional[torch.Tensor] = None,
              out_dtype: torch.dtype = torch.bfloat16, gamma: Optional[torch.Tensor] = None,
              gate: bool = False) -> torch.Tensor:
    """One bf16 product through the layer kernels' GEMM: [M, N] in out_dtype
    ([M, N / 2] bf16 with gate)."""
    m, n, k, lda = _check(a, w, bias, act, residual, out_dtype)
    if gamma is not None and (gamma.dtype != torch.bfloat16 or tuple(gamma.shape) != (n,)
                              or gamma.device != a.device or not gamma.is_contiguous()):
        raise ValueError(f"gemm_bf16: gamma must be contiguous bf16 [{n}] on {a.device}")
    if (gamma is not None or gate) and act != "none":
        raise ValueError("gemm_bf16: gamma and gate take no activation")
    if gate and (gamma is not None or residual is not None or out_dtype != torch.bfloat16
                 or n % 16):
        raise ValueError("gemm_bf16: gate takes N a multiple of 16, no gamma or residual, and a "
                         "bf16 output")
    if not launch_kernel_for(a):
        return gemm_bf16_ref(a, w, bias, act, residual, out_dtype, gamma, gate)
    out = torch.empty((m, n // 2 if gate else n), dtype=out_dtype, device=a.device)
    run("gemm_bf16", a.device, "vpt_gemm_bf16", ptr(a), lda, ptr(w), m, n, k, ptr(bias),
        ACTS[act], ptr(residual), n if residual is None else residual.stride(0),
        int(residual is not None and residual.dtype == torch.float32), ptr(out), out.shape[1],
        int(out_dtype == torch.float32), ptr(gamma), int(gate))
    gemm_bf16.launches += 1
    return out


gemm_bf16.launches = 0


def gemm_f32(a: torch.Tensor, w: torch.Tensor, bias: Optional[torch.Tensor] = None,
             act: str = "none", residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One f32 product through the layer kernels' GEMM (the split body):
    [M, N] float32."""
    m, n, k, lda = _check(a, w, bias, act, residual, torch.float32, "gemm_f32")
    if not launch_kernel_for(a):
        return gemm_f32_ref(a, w, bias, act, residual)
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    planes = torch.empty(3 * k * n, dtype=torch.bfloat16, device=a.device)
    run("gemm_f32", a.device, "vpt_gemm_f32", ptr(a), lda, ptr(w), m, n, k, ptr(bias),
        ACTS[act], ptr(residual), n if residual is None else residual.stride(0), ptr(out), n,
        ptr(planes))
    gemm_f32.launches += 1
    count_f32_products("gemm_f32", 1)
    return out


gemm_f32.launches = 0

# f32 products launched since the last reset_body_counts(), by the caller
# that launched them: the mirror of the C counter 'f32_split' (every f32
# product of gemm() takes the split body), filled where each op launches: B1
# and B3 four a call, B5 four a layer, gemm_f32 one (B2's f32 products run in
# its own launches, counted by kind in ops/cuda/layer.py::cls_launches)
F32_PRODUCTS = {"b1": 4, "b3": 4, "b5": 4}
f32_products: dict = {}


def count_f32_products(caller: str, n: int):
    f32_products[caller] = f32_products.get(caller, 0) + n


def takes_wgmma(a: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether gemm() runs a product that gemm_bf16 accepts on the wgmma +
    TMA body (the C rule, wgmma.cuh::wgmma_takes): N a multiple of 8, the
    rest being gemm_bf16's own conditions."""
    return w.shape[1] % 8 == 0


WGMMA_TILE = 128  # the persistent body's output tile, rows and columns


def wgmma_walk(m: int, n: int, sms: int) -> dict:
    """The persistent body's launch for an [m, n] output on a card of `sms`
    SMs (wgmma.cuh::wgmma_walk): its 128 x 128 output tiles and the blocks
    that walk them, one an SM and at most one a tile."""
    tiles = -(-m // WGMMA_TILE) * -(-n // WGMMA_TILE)
    return {"tiles": tiles, "blocks": min(tiles, sms)}


def body_counts() -> dict:
    """Launches of each GEMM body since the last reset_body_counts(), from
    every caller of gemm() (the layer kernels included): the bf16 'wgmma'
    and 'wmma' bodies, the f32 'f32_split' body; the output tiles the wgmma
    body walked ('wgmma_tiles') and the blocks it launched to walk them
    ('wgmma_blocks'), so tiles over blocks is how many tiles a block walked
    on average; of those tiles, the ones through SwiGLU's gated epilogue
    ('gated_tiles') and through LayerScale's ('scaled_tiles'); and the
    distinct (M, N, K) that took the WMMA body."""
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    counts = (ctypes.c_longlong * 7)()
    lib.vpt_gemm_body_counts(counts)
    shapes = (ctypes.c_int * 192)()
    n = lib.vpt_gemm_wmma_shapes(shapes, 64)
    return {"wgmma": counts[0], "wmma": counts[1], "f32_split": counts[2],
            "wgmma_tiles": counts[3], "wgmma_blocks": counts[4], "gated_tiles": counts[5],
            "scaled_tiles": counts[6],
            "wmma_shapes": [tuple(shapes[3 * i:3 * i + 3]) for i in range(min(n, 64))]}


def reset_body_counts():
    """Zero the C counters and f32_products."""
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    load_library().vpt_gemm_body_reset()
    f32_products.clear()
