"""Build and load the package's CUDA kernels (csrc/*.cu) at first use.

nvcc compiles every source into one shared library with a plain C
interface, which is loaded with ctypes: no PyTorch headers are compiled, so
a build takes seconds rather than the minutes of
torch.utils.cpp_extension.load. The library lands in the package's _build/
directory, named by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one is loaded as it is. Nothing here runs at
import: the CPU-only test host has no nvcc and never builds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of the entry points in csrc/layer.cu
SIGNATURES = {
    "vpt_error_string": ([I], ctypes.c_char_p),
    "vpt_max_seq_len": ([], I),
    "vpt_head_dim": ([], I),
    # dtype, x, mask, 12 layer weights, out, 5 workspaces, B S D H HD M, eps, stream
    "vpt_vit_layer_forward": ([I] + [P] * 20 + [I] * 6 + [F, P], I),
    # dtype, x, 18 weights, logits, 7 workspaces, B S D H HD M labels, eps, stream
    "vpt_vit_cls_logits_forward": ([I] + [P] * 27 + [I] * 7 + [F, P], I),
    # dtype, x, dest, kept, 12 layer weights, out, src, counts, 7 workspaces,
    # B S cap D H HD M, eps, stream
    "vpt_vit_layer_bucketed_forward": ([I] + [P] * 25 + [I] * 7 + [F, P], I),
}


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return nvcc


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into _build/ unless a library of the same hash is
    there already. Returns the library's path."""
    lib = BUILD_DIR / f"libvpt_kernels_{source_hash()}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, *[str(p) for p in CSRC_DIR.glob("*.cu")]]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib
