"""Build and load the package's CUDA kernels (csrc/*.cu) at first use.

nvcc compiles each source into an object, all of them at once in parallel
processes, and links the objects into one shared library with a plain C
interface (and libcuda, for the TMA descriptors' encoder
cuTensorMapEncodeTiled), which is loaded with ctypes: no PyTorch headers are compiled, so
a build takes seconds rather than the minutes of
torch.utils.cpp_extension.load. The library lands in the package's _build/
directory, named by a hash of the sources (headers included) and flags, so
an edited source rebuilds and an unchanged one is loaded as it is. Nothing
here runs at import: the CPU-only test host has no nvcc and never builds.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
]

P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_long
# C signatures of the entry points in csrc/*.cu
SIGNATURES = {
    "vpt_error_string": ([I], ctypes.c_char_p),
    "vpt_layer_head_dim_ok": ([I], I),
    # dtype, x, mask, 12 layer weights, out, 5 workspaces, B S D H HD M, eps, stream
    "vpt_vit_layer_forward": ([I] + [P] * 20 + [I] * 6 + [F, P], I),
    # dtype, x, 18 weights, logits, 7 workspaces, B S D H HD M labels, eps, stream
    "vpt_vit_cls_logits_forward": ([I] + [P] * 27 + [I] * 7 + [F, P], I),
    # dtype, x, dest, kept, 12 layer weights, out, src, counts, 7 workspaces,
    # B S cap D H HD M, eps, stream
    "vpt_vit_layer_bucketed_forward": ([I] + [P] * 25 + [I] * 7 + [F, P], I),
    # dtype, x, mask, 16 layer weights (int8 products with f32 scales), out,
    # 8 code / scale buffers, 4 workspaces, B S D H HD M, eps, stream
    "vpt_vit_layer_int8_forward": ([I] + [P] * 31 + [I] * 6 + [F, P], I),
    # dtype, x, codes, scales, rows, k, stream
    "vpt_rowquant": ([I, P, P, P, I, I, P], I),
    # dtype, codes, lda, row scales, Wt, ws, M N K, bias, act, residual, ldr,
    # residual in f32, out, ldc, out in f32, stream
    "vpt_gemm_s8": ([I, P, L, P, P, P, I, I, I, P, I, P, L, I, P, L, I, P], I),
    "vpt_int8_body_launches": ([], ctypes.c_longlong),
    "vpt_int8_body_reset": ([], None),
    # dtype, x, mask, 12 stacked layer weights, out, 6 workspaces,
    # L B S D H HD M, eps, stream
    "vpt_vit_encoder_forward": ([I] + [P] * 21 + [I] * 7 + [F, P], I),
    "vpt_attention_max_head_dim": ([], I),
    # dtype, q, k, v, mask, out, B H S HD, stream
    "vpt_attention_forward": ([I] + [P] * 5 + [I] * 4 + [P], I),
    "vpt_attention_body_counts": ([P], None),
    "vpt_attention_body_reset": ([], None),
    "vpt_mlp_max_hidden": ([], I),
    # dtype, x, w1, b1, w2, b2, out, T D M, stream
    "vpt_mlp_forward": ([I] + [P] * 6 + [I] * 3 + [P], I),
    "vpt_mlp_body_counts": ([P], None),
    "vpt_mlp_body_reset": ([], None),
    # input dtype, weight dtype, pos in f32, patches, w, b, pos, out, T N K D,
    # scale, shift, stream
    "vpt_patch_embed_forward": ([I] * 3 + [P] * 5 + [I] * 4 + [F, F, P], I),
    "vpt_embed_body_counts": ([P], None),
    "vpt_embed_body_reset": ([], None),
    # A, lda, W, M N K, bias, act, residual, ldr, residual in f32, out, ldc,
    # out in f32, stream
    "vpt_gemm_bf16": ([P, L, P, I, I, I, P, I, P, L, I, P, L, I, P], I),
    "vpt_gemm_body_counts": ([P], None),
    "vpt_gemm_body_reset": ([], None),
    "vpt_gemm_wmma_shapes": ([P, I], I),
}


def find_nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels cannot be built")
    return nvcc


def cuda_stub_dirs(nvcc: str) -> list:
    """Where the toolkit keeps the libcuda.so stub to link against (the
    card's own libcuda is loaded at run time)."""
    root = Path(nvcc).resolve().parents[1]
    return [str(d) for d in (root / "lib64" / "stubs", root / "targets" / "x86_64-linux" / "lib" /
                             "stubs") if d.is_dir()]


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list):
    """Start every command at once, wait for all of them, raise if any
    failed (after all have ended: no process is left running)."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> Path:
    """Compile csrc/*.cu into _build/ unless a library of the same hash is
    there already. Returns the library's path."""
    lib = BUILD_DIR / f"libvpt_kernels_{source_hash()}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sorted(CSRC_DIR.glob("*.cu"))]
        _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC_DIR / f"{obj.stem}.cu")]
                  for obj in objs])
        so = Path(tmp) / "lib.so"
        links = [f"-L{d}" for d in cuda_stub_dirs(nvcc)] + ["-lcuda"]
        _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(so), *map(str, objs), *links]])
        os.replace(so, lib)  # atomic: a concurrent build sees all or nothing
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, declare every signature."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib
