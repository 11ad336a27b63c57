"""Kernels B8a and B8b: the fused patch embedding, from uint8 or float
patches, and the two entry points that run them.

`fused_patch_embed_u8` (B8a) replaces vit_pruning_tpu/ops/pallas/embed.py::
fused_patch_embed_u8: uint8 patches [B, N, C*P*P] -> ((x as f32) * scale +
shift, rounded to w's dtype) @ w + b + pos, cast to w's dtype, with scale =
1/(255 std) and shift = -mean/std, the image normalisation folded into the
product's input. `fused_patch_embed_f` (B8b) replaces ::fused_patch_embed_f,
the same body on float patches with scale 1 and shift 0. `embed_u8` and
`embed_fused` mirror the JAX entry points of the same names: extract the
patches, run the kernel, prepend the CLS row with its position embedding.
The CUDA source is csrc/embed.cu; its head says what bounds the kernels on
an H100 and how the design meets it.

Neither kernel is on a model's forward path, in the port as in the JAX
package: serving.embed_from_u8 and models/vit.py::embed stay plain PyTorch
(the JAX package's are XLA), so the fused embed is reached only through
these entry points.

The plain versions (`*_ref`) follow the TPU kernel step by step: the affine
as a multiply, then an add, each rounded in f32; the result rounded to w's
dtype; an f32 product; + b in f32, + pos in f32, one cast. They are not
embed_from_u8, which computes (x / 255 - mean) / std and rounds elsewhere.

A wrapper launches its kernel for CUDA tensors and counts the launch in its
`launches` attribute; for CPU tensors it runs the plain version (mode
'auto') or raises (mode 'kernel'). It never falls back from a CUDA tensor.
"""

from __future__ import annotations

import ctypes

import torch

from vit_pruning_tpu_torch.data.preprocess import VIT_MEAN, VIT_STD
from vit_pruning_tpu_torch.ops.cuda.layer import _check, _raise_on, _stream, refuse_grad
from vit_pruning_tpu_torch.ops.dispatch import launch_kernel_for
from vit_pruning_tpu_torch.ops.patch_embed import extract_patches

_IN_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_FLOAT = (torch.float32, torch.bfloat16)


def _affine(mean: float, std: float):
    """(scale, shift) of the folded normalisation, in Python double as the
    TPU wrapper computes them."""
    return 1.0 / (255.0 * std), -mean / std


def _embed_ref(patches, w, b, pos, scale: float, shift: float) -> torch.Tensor:
    x = patches.float() * scale + shift  # two f32 ops, each rounded
    y = x.to(w.dtype).float() @ w.float() + b.float()
    return (y + pos.float()).to(w.dtype)


def fused_patch_embed_u8_ref(patches_u8, w, b, pos, mean: float = VIT_MEAN,
                             std: float = VIT_STD) -> torch.Tensor:
    """Plain PyTorch version of kernel B8a."""
    return _embed_ref(patches_u8, w, b, pos, *_affine(mean, std))


def fused_patch_embed_f_ref(patches, w, b, pos) -> torch.Tensor:
    """Plain PyTorch version of kernel B8b."""
    return _embed_ref(patches, w, b, pos, 1.0, 0.0)


def _embed(who: str, in_dtypes: tuple, patches, w, b, pos, scale: float, shift: float,
           ref, counter) -> torch.Tensor:
    """Checks shared by both wrappers, then the kernel (CUDA) or `ref` (CPU)."""
    if patches.dim() != 3:
        raise ValueError(f"{who}: patches must be [B, N, C*P*P], got {tuple(patches.shape)}")
    if patches.dtype not in in_dtypes:
        raise TypeError(f"{who}: patches are {patches.dtype}; it takes {in_dtypes}")
    if w.dtype not in _FLOAT:
        raise TypeError(f"{who}: w is {w.dtype}; it takes {_FLOAT}")
    bsz, n, k = patches.shape
    d = w.shape[-1]
    if tuple(w.shape) != (k, d) or tuple(b.shape) != (d,) or tuple(pos.shape) != (n, d):
        raise ValueError(f"{who}: w {tuple(w.shape)}, b {tuple(b.shape)}, pos "
                         f"{tuple(pos.shape)} do not fit patches {tuple(patches.shape)}")
    if not launch_kernel_for(patches):
        return ref()
    refuse_grad(who, patches, w, b, pos)
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    lib = load_library()
    if d % 8:
        raise ValueError(f"{who}: embedding width {d} must be a multiple of 8")
    if pos.dtype not in (w.dtype, torch.float32):
        raise ValueError(f"{who}: pos is {pos.dtype}; it must be {w.dtype} or float32")
    w_dtype = _check(w, {"b": b, "pos": pos}, {}, who, {"pos": pos.dtype})
    if patches.device != w.device or not patches.is_contiguous():
        raise ValueError(f"{who}: patches must be contiguous on {w.device}")

    out = torch.empty((bsz, n, d), dtype=w.dtype, device=w.device)
    with torch.cuda.device(w.device):
        rc = lib.vpt_patch_embed_forward(
            _IN_DTYPES[patches.dtype], w_dtype, int(pos.dtype == torch.float32),
            patches.data_ptr(), w.data_ptr(), b.data_ptr(), pos.data_ptr(), out.data_ptr(),
            bsz * n, n, k, d, scale, shift, _stream(w),
        )
    _raise_on(lib, rc, who)
    counter.launches += 1
    return out


def fused_patch_embed_u8(patches_u8: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         pos: torch.Tensor, mean: float = VIT_MEAN,
                         std: float = VIT_STD) -> torch.Tensor:
    """Kernel B8a: uint8 patches [B, N, C*P*P] -> [B, N, D] in w's dtype.

    w [C*P*P, D] and b [D] in float32 or bfloat16; pos [N, D] the position
    embeddings of the patch tokens (the caller handles CLS), in w's dtype or
    float32."""
    scale, shift = _affine(mean, std)
    return _embed("fused_patch_embed_u8", (torch.uint8,), patches_u8, w, b, pos, scale, shift,
                  lambda: fused_patch_embed_u8_ref(patches_u8, w, b, pos, mean, std),
                  fused_patch_embed_u8)


fused_patch_embed_u8.launches = 0


def fused_patch_embed_f(patches: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        pos: torch.Tensor) -> torch.Tensor:
    """Kernel B8b: float32 or bfloat16 patches [B, N, C*P*P] -> [B, N, D] in
    w's dtype; w, b and pos as for fused_patch_embed_u8."""
    return _embed("fused_patch_embed_f", _FLOAT, patches, w, b, pos, 1.0, 0.0,
                  lambda: fused_patch_embed_f_ref(patches, w, b, pos), fused_patch_embed_f)


fused_patch_embed_f.launches = 0


def body_counts() -> dict:
    """Launches of B8a's and B8b's bodies since the last reset_body_counts():
    'wgmma' (bf16 weights) and 'fma' (f32 weights)."""
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    counts = (ctypes.c_longlong * 2)()
    load_library().vpt_embed_body_counts(counts)
    return {"wgmma": counts[0], "fma": counts[1]}


def reset_body_counts():
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    load_library().vpt_embed_body_reset()


def _with_cls(x: torch.Tensor, embed_params: dict, pos: torch.Tensor) -> torch.Tensor:
    """Prepend (cls + pos[0]) cast to x's dtype to every image's patch rows."""
    cls = (embed_params["cls"][0] + pos[:1]).to(x.dtype)  # [1, D]
    return torch.cat([cls[None].expand(x.shape[0], 1, x.shape[-1]), x], dim=1)


def embed_u8(pixel_values_u8: torch.Tensor, embed_params: dict, config) -> torch.Tensor:
    """Raw uint8 images [B, C, H, W] -> embeddings [B, S, D]: extract the
    patches (a uint8 shuffle), kernel B8a (normalise + project + position),
    prepend CLS with its position embedding."""
    patches = extract_patches(pixel_values_u8, config.patch_size)
    pos = embed_params["pos"][0]  # [S, D]
    x = fused_patch_embed_u8(patches, embed_params["patch"]["w"], embed_params["patch"]["b"],
                             pos[1:])
    return _with_cls(x, embed_params, pos)


def embed_fused(pixel_values: torch.Tensor, embed_params: dict, config) -> torch.Tensor:
    """Float pixels [B, C, H, W] (already normalised, as models/vit.py::embed
    takes them) -> embeddings [B, S, D]: extract, kernel B8b (project +
    position, pos cast to w's dtype first), prepend CLS."""
    patches = extract_patches(pixel_values, config.patch_size)
    pos = embed_params["pos"][0]
    w = embed_params["patch"]["w"]
    x = fused_patch_embed_f(patches, w, embed_params["patch"]["b"], pos[1:].to(w.dtype))
    return _with_cls(x, embed_params, pos)
