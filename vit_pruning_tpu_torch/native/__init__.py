"""Native (C++) host-side input pipeline: build and ctypes bindings.

Mirrors vit_pruning_tpu/native/__init__.py over the port's own copy of the
C++ source (`preprocess.cpp` beside this file): PIL-bit-exact fixed-point
bilinear resampling, fused with the normalise + CHW epilogue, multithreaded
over images. This is host preprocessing, not a device kernel.

Build model: compiled at first use with g++ (-O3, no external deps) into a
shared library keyed by the hash of the source, under
`vit_pruning_tpu_torch/native/_build/` (or VIT_PRUNING_TORCH_NATIVE_CACHE);
a changed source rebuilds and removes the previous build. Binding is
ctypes. Everything degrades gracefully, as in the reference: `available()`
is False when g++ or the build fails (a one-time warning says why), and
data/preprocess.py::pil_preprocess falls back to the PIL loop, whose
numbers are the same. VIT_PRUNING_NO_NATIVE=1 forces the fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import warnings
from typing import Optional

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "preprocess.cpp")

_lib: Optional[ctypes.CDLL] = None
_tried = False


def build_dir() -> str:
    return os.environ.get("VIT_PRUNING_TORCH_NATIVE_CACHE") or os.path.join(
        os.path.dirname(__file__), "_build")


def _build_and_load() -> ctypes.CDLL:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out_dir = build_dir()
    so_path = os.path.join(out_dir, f"libvitpre_{tag}.so")
    if not os.path.exists(so_path):
        os.makedirs(out_dir, exist_ok=True)
        tmp = so_path + f".tmp{os.getpid()}"
        cmd = ["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", _SRC, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)  # atomic under concurrent builds
        for stale in glob.glob(os.path.join(out_dir, "libvitpre_*.so")):
            if stale != so_path:
                try:
                    os.remove(stale)
                except OSError:
                    pass
    lib = ctypes.CDLL(so_path)
    lib.resize_bilinear_u8.restype = ctypes.c_int
    lib.resize_bilinear_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
    ]
    lib.preprocess_u8.restype = ctypes.c_int
    lib.preprocess_u8.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int,
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("VIT_PRUNING_NO_NATIVE"):
        return None
    try:
        _lib = _build_and_load()
    except Exception as e:  # degrade to the PIL path, but say why once
        detail = getattr(e, "stderr", b"")
        detail = f": {detail.decode(errors='replace').strip()}" if detail else ""
        warnings.warn(
            f"native preprocessing unavailable, falling back to PIL "
            f"({type(e).__name__}: {e}{detail})",
            RuntimeWarning,
        )
        _lib = None
    return _lib


def available() -> bool:
    """True when the native library built (or was cached) successfully."""
    return _get_lib() is not None


def _check_u8_batch(images: np.ndarray) -> np.ndarray:
    images = np.ascontiguousarray(images)
    if images.dtype != np.uint8 or images.ndim != 4:
        raise ValueError(f"expected [N,H,W,C] uint8, got {images.dtype} {images.shape}")
    return images


def _lib_or_raise() -> ctypes.CDLL:
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native preprocessing unavailable (g++/build failed)")
    return lib


def resize_bilinear(images: np.ndarray, height: int, width: int, nthreads: int = 0) -> np.ndarray:
    """[N,H,W,C] uint8 -> [N,height,width,C] uint8, PIL-BILINEAR-bit-exact.
    nthreads=0 uses the host's hardware concurrency."""
    lib = _lib_or_raise()
    images = _check_u8_batch(images)
    n, h, w, c = images.shape
    out = np.empty((n, height, width, c), np.uint8)
    rc = lib.resize_bilinear_u8(images.ctypes.data, n, h, w, c, out.ctypes.data, height, width,
                                nthreads)
    if rc != 0:
        raise RuntimeError(f"resize_bilinear_u8 failed (rc={rc})")
    return out


def preprocess(images: np.ndarray, size: int = 224, mean: float = 0.5, std: float = 0.5,
               nthreads: int = 0) -> np.ndarray:
    """Fused ViT preprocess: [N,H,W,3] uint8 -> [N,3,size,size] float32,
    bit-identical to data/preprocess.py::pil_preprocess's PIL loop (PIL
    resize, /255, -mean, /std, CHW) in one native pass."""
    lib = _lib_or_raise()
    try:
        mean, std = float(mean), float(std)  # per-channel stats: use the PIL path
    except (TypeError, ValueError) as e:
        raise ValueError(f"native preprocess takes scalar mean/std, got {mean!r}/{std!r}") from e
    images = _check_u8_batch(images)
    n, h, w, c = images.shape
    if c != 3:
        raise ValueError(f"preprocess expects 3 channels, got {c}")
    out = np.empty((n, 3, size, size), np.float32)
    rc = lib.preprocess_u8(images.ctypes.data, n, h, w, out.ctypes.data, size,
                           ctypes.c_float(mean), ctypes.c_float(std), nthreads)
    if rc != 0:
        raise RuntimeError(f"preprocess_u8 failed (rc={rc})")
    return out
