#!/usr/bin/env python3
"""Where the tensor-core bodies of kernels B6 and B7 spend their time, on one GPU.

    python3 kernel_variants.py

Each kernel is built again from its source (vit_pruning_tpu_torch/csrc) with one
stage taken out or swapped: a diagnostic variant, not a kernel of the port. Each
variant is built into a library of its own, the libraries are loaded side by side,
and every variant is timed at the main path's shapes in bf16 (B7: DeiT-S's MLP on
100,864 rows; B6: 512 x 6 heads of 64 at S 197, masked), the real kernel first and
last (CUDA events, mean of 20 after 3 warm-ups). Each line gives the variant's time
and its largest distance from the real kernel's output: 0 where a variant computes
the same numbers another way. Needs one CUDA card and nvcc (CUDA_HOME or
/usr/local/cuda), like chip_smoke.py; the last line is the card's name and power
limit.
"""

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

# (name, what it shows, [(text of the source, its replacement)])
B7_VARIANTS = [
    ("kernel", "the kernel as it is", []),
    ("no GELU", "h + b1 split as it is: the cost of the erf GELU",
     [("gelu(h[2 * p + t] + __bfloat162float(b1[m + t]), ACT_GELU_ERF)",
       "h[2 * p + t] + __bfloat162float(b1[m + t])")]),
    ("hi pass only", "one bf16 pass of the second product instead of three",
     [("    for (int pl = 2; pl >= 0; --pl)  // lo, mid, hi\n",
       "    for (int pl = 0; pl >= 0; --pl)  // hi\n")]),
    ("no second product", "the output warpgroups wait and release, no wgmma",
     [("        wgmma_out<NB>(acc,", "        if (ch < 0) wgmma_out<NB>(acc,")]),
    ("no first product", "h = 0, no x W1 wgmma",
     [("          wgmma_m64n64k16<1>(h, gmma_desc(xa + kk * 32, 16, 1024),",
       "          if (kb < 0) wgmma_m64n64k16<1>(h, gmma_desc(xa + kk * 32, 16, 1024),")]),
]
B6_DIVIDE = """      const float e = expf(v - mx[r]), q = e * rc[r];
      return __fmaf_rn(__fmaf_rn(-q, sum[r], e), rc[r], q);"""
B6_VARIANTS = [
    ("kernel", "the kernel as it is (P by Markstein's correction)", []),
    ("IEEE division", "P = __fdiv_rn(e, sum): the same quotient",
     [(B6_DIVIDE, "      return __fdiv_rn(expf(v - mx[r]), sum[r]);")]),
    ("reciprocal multiply", "P = e * (1 / sum): not the division's quotient",
     [(B6_DIVIDE, "      return expf(v - mx[r]) * rc[r];")]),
    ("fast exp", "__expf in pass 2: not expf's value",
     [(B6_DIVIDE, B6_DIVIDE.replace("expf(", "__expf("))]),
]
# every variant of a source is loaded into one process: a static local of an
# inline function is one symbol across the libraries, so the attribute call
# must run in each
SHARED_STATIC = ("static const cudaError_t attr", "const cudaError_t attr")


def build_variants(build, src: str, variants, out_dir: Path) -> dict:
    csrc = build.CSRC_DIR
    nvcc = build.find_nvcc()
    links = [f"-L{d}" for d in build.cuda_stub_dirs(nvcc)] + ["-lcuda"]
    text = (csrc / f"{src}.cu").read_text()
    procs = {}
    for i, (name, _, reps) in enumerate(variants):
        t = text
        for old, new in reps + ([SHARED_STATIC] if SHARED_STATIC[0] in text else []):
            if t.count(old) != 1:
                raise RuntimeError(f"{src}.cu variant {name!r}: the text to replace is not "
                                   f"there once: {old[:60]!r}")
            t = t.replace(old, new)
        cu, so = out_dir / f"{src}_{i}.cu", out_dir / f"{src}_{i}.so"
        cu.write_text(t)
        procs[name] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-I", str(csrc), "-shared", "-o", str(so), str(cu), *links],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs, failed = {}, []
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{src}.cu variant {name!r}:\n{out[-2000:]}")
        else:
            libs[name] = ctypes.CDLL(str(so))
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs


def time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def report(kernel: str, variants, calls: dict, out: torch.Tensor):
    """Time each variant, the real kernel first and last; print time and the
    largest distance of its output from the real kernel's."""
    calls["kernel"]()
    torch.cuda.synchronize()
    ref = out.clone()
    times = {"kernel": [time_ms(calls["kernel"])]}
    for name, what, _ in variants[1:]:
        out.zero_()
        calls[name]()
        torch.cuda.synchronize()
        d = (out.float() - ref.float()).abs().max().item()
        times[name] = [time_ms(calls[name])]
        print(f"{kernel} {name}: {times[name][0]:.4f} ms, max |out - kernel's| {d:.3e} ({what})",
              flush=True)
    times["kernel"].append(time_ms(calls["kernel"]))
    print(f"{kernel} kernel: {times['kernel'][0]:.4f} ms before, {times['kernel'][1]:.4f} ms "
          f"after the variants", flush=True)


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: no CUDA device (torch.cuda.is_available() is False)")
    from vit_pruning_tpu_torch.ops.cuda import build

    P, I = ctypes.c_void_p, ctypes.c_int
    with tempfile.TemporaryDirectory() as tmp:
        b7 = build_variants(build, "mlp", B7_VARIANTS, Path(tmp))
        b6 = build_variants(build, "attention", B6_VARIANTS, Path(tmp))
        for lib in b7.values():
            lib.vpt_mlp_forward.argtypes = [I] + [P] * 6 + [I] * 3 + [P]
        for lib in b6.values():
            lib.vpt_attention_forward.argtypes = [I] + [P] * 5 + [I] * 4 + [P]
        dev, gen, bf = "cuda", torch.Generator().manual_seed(0), torch.bfloat16
        stream = torch.cuda.current_stream().cuda_stream

        t, d, m = 100864, 384, 1536
        x = torch.randn(t, d, generator=gen).to(dev, bf)
        w1, b1, w2, b2 = ((s * torch.randn(shape, generator=gen)).to(dev, bf)
                          for s, shape in ((0.05, (d, m)), (0.05, (m,)), (0.05, (m, d)),
                                           (0.1, (d,))))
        out = torch.empty_like(x)
        report("B7", B7_VARIANTS, {
            name: (lambda lib=lib: lib.vpt_mlp_forward(
                1, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                out.data_ptr(), t, d, m, stream)) for name, lib in b7.items()}, out)
        del x, out

        b, h, s, hd = 512, 6, 197, 64
        q, k, v = (torch.randn(b, h, s, hd, generator=gen).to(dev, bf) for _ in range(3))
        mask = torch.rand(b, s, generator=gen) > 0.3
        mask[:, 0] = True
        mask = mask.to(dev)
        out = torch.empty_like(q)
        report("B6", B6_VARIANTS, {
            name: (lambda lib=lib: lib.vpt_attention_forward(
                1, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
                b, h, s, hd, stream)) for name, lib in b6.items()}, out)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
