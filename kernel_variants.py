#!/usr/bin/env python3
"""Where the hand-written bodies of kernels B4, B6, B7 and B8a spend their time, on one GPU.

    python3 kernel_variants.py [b7] [b6] [b4] [b8a]    (no argument: all four)

Each kernel is built again from its sources (vit_pruning_tpu_torch/csrc) with one
stage taken out or swapped: a diagnostic variant, not a kernel of the port. Each
variant is built into a library of its own, the libraries are loaded side by side,
and every variant is timed at the main path's shapes in bf16, the real kernel first
and last (CUDA events, mean of 20 after 3 warm-ups):
  - B7: DeiT-S's MLP on 100,864 rows;
  - B6: 512 x 6 heads of 64 at S 197, masked;
  - B4: the whole int8 layer at DeiT-S, batch 512, S 197, unmasked;
  - B8a: the uint8 patch embedding at DeiT-S batch 512 (K 768) and ViT-H batch 64
    (K 588).
Each line gives the variant's time and its largest distance from the real kernel's
output: 0 where a variant computes the same numbers another way. Needs one CUDA
card and nvcc (CUDA_HOME or /usr/local/cuda), like chip_smoke.py; the last line is
the card's name and power limit.
"""

import ctypes
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

# (name, what it shows, [(source file, its text, the replacement)])
B7_VARIANTS = [
    ("kernel", "the kernel as it is", []),
    ("no GELU", "h + b1 split as it is: the cost of the erf GELU",
     [("mlp.cu", "gelu(h[2 * p + t] + __bfloat162float(b1[m + t]), ACT_GELU_ERF)",
       "h[2 * p + t] + __bfloat162float(b1[m + t])")]),
    ("hi pass only", "one bf16 pass of the second product instead of three",
     [("mlp.cu", "    for (int pl = 2; pl >= 0; --pl)  // lo, mid, hi\n",
       "    for (int pl = 0; pl >= 0; --pl)  // hi\n")]),
    ("no second product", "the output warpgroups wait and release, no wgmma",
     [("mlp.cu", "        wgmma_out<NB>(acc,", "        if (ch < 0) wgmma_out<NB>(acc,")]),
    ("no first product", "h = 0, no x W1 wgmma",
     [("mlp.cu", "          wgmma_m64n64k16<1>(h, gmma_desc(xa + kk * 32, 16, 1024),",
       "          if (kb < 0) wgmma_m64n64k16<1>(h, gmma_desc(xa + kk * 32, 16, 1024),")]),
]
B6_DIVIDE = """      const float e = expf(v - mx[r]), q = e * rc[r];
      return __fmaf_rn(__fmaf_rn(-q, sum[r], e), rc[r], q);"""
B6_VARIANTS = [
    ("kernel", "the kernel as it is (P by Markstein's correction)", []),
    ("IEEE division", "P = __fdiv_rn(e, sum): the same quotient",
     [("attention.cu", B6_DIVIDE, "      return __fdiv_rn(expf(v - mx[r]), sum[r]);")]),
    ("reciprocal multiply", "P = e * (1 / sum): not the division's quotient",
     [("attention.cu", B6_DIVIDE, "      return expf(v - mx[r]) * rc[r];")]),
    ("fast exp", "__expf in pass 2: not expf's value",
     [("attention.cu", B6_DIVIDE, B6_DIVIDE.replace("expf(", "__expf("))]),
]
B4_VARIANTS = [
    ("kernel", "the kernel as it is", []),
    ("no products", "every wgmma of the four int8 products left out (the sums stay 0)",
     [("wgmma_s8.cuh", "      wgmma_m64n128k32_s8(acc, gmma_desc(a0",
       "      if (kk < 0) wgmma_m64n128k32_s8(acc, gmma_desc(a0")]),
    ("no row passes", "ctx's and the GELU output's row quantization left out (O and fc2 "
     "read the codes an earlier call left)",
     [("layer_int8.cu", "  VPT_TRY(rowquant<T>(ctx, KW, q_ctx, s_ctx, rows, KW, st));\n", ""),
      ("layer_int8.cu", "  VPT_TRY(rowquant<T>(m1, M, q_gelu, s_gelu, rows, M, st));\n", "")]),
    ("no attention", "ctx left as it was",
     [("layer_int8.cu", "  VPT_TRY(attention(qkv, mask, nullptr, ctx, B, S, H, KW, st));\n", "")]),
    ("no product epilogues", "the four products' dequant, bias, GELU, residual and stores left "
     "out",
     [("layer_int8.cu", "    if (m >= M || n >= N) return;\n    const float r = __ldg(rs + m);",
       "    if (m >= M || n >= N || M > 0) return;\n    const float r = __ldg(rs + m);")]),
]
B8A_VARIANTS = [
    ("kernel", "the kernel as it is", []),
    ("no affine", "the uint8 value rounded to bf16 as it is, no x * scale + shift",
     [("wgmma.cuh", "        return __fadd_rn(__fmul_rn(x, scale), shift);",
       "        return x;")]),
]
# Every variant of a source is loaded into one process: a static local of an
# inline or template function is one symbol across the libraries, so the
# attribute call must run in each.
SHARED_STATIC = ("static const cudaError_t attr", "const cudaError_t attr")


def build_variants(build, src: str, variants, out_dir: Path, extra=()) -> dict:
    """One library per variant: csrc/{src}.cu (and every source it includes)
    with the variant's replacements, linked with the objects of `extra`
    (csrc sources the main one calls into), built once for all variants."""
    nvcc = build.find_nvcc()
    links = [f"-L{d}" for d in build.cuda_stub_dirs(nvcc)] + ["-lcuda"]

    def copy_tree(dst: Path, reps=()) -> Path:
        dst.mkdir(parents=True)
        for f in sorted(build.CSRC_DIR.iterdir()):
            if f.suffix in (".cu", ".cuh"):
                (dst / f.name).write_text(f.read_text().replace(*SHARED_STATIC))
        for name, old, new in reps:
            text = (dst / name).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text to replace is not there once: {old[:60]!r}")
            (dst / name).write_text(text.replace(old, new))
        return dst

    def nvcc_proc(args):
        return subprocess.Popen([nvcc, *build.NVCC_FLAGS, *args], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def wait(procs: dict):
        failed = []
        for what, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode:
                failed.append(f"{what}:\n{out[-2000:]}")
        if failed:
            raise RuntimeError("\n".join(failed))

    common = copy_tree(out_dir / f"{src}_common")
    extra_objs = [common / f"{e}.o" for e in extra]
    procs = {f"{e}.cu": nvcc_proc(["-c", "-o", str(common / f"{e}.o"), str(common / f"{e}.cu")])
             for e in extra}
    objs = {}
    for i, (name, _, reps) in enumerate(variants):
        d = copy_tree(out_dir / f"{src}_{i}", reps)
        objs[name] = d / f"{src}.o"
        procs[f"{src}.cu variant {name!r}"] = nvcc_proc(["-c", "-o", str(objs[name]),
                                                        str(d / f"{src}.cu")])
    wait(procs)
    sos = {name: obj.with_suffix(".so") for name, obj in objs.items()}
    wait({f"link {name!r}": nvcc_proc(["-shared", "-o", str(sos[name]), str(obj),
                                       *map(str, extra_objs), *links])
          for name, obj in objs.items()})
    libs = {}
    for name, so in sos.items():
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in build.SIGNATURES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
        libs[name] = lib
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
    rc = calls["kernel"]()
    if rc:
        raise RuntimeError(f"{kernel}: the kernel returned CUDA error {rc}")
    torch.cuda.synchronize()
    ref = out.clone()
    times = {"kernel": [time_ms(calls["kernel"])]}
    for name, what, _ in variants[1:]:
        out.zero_()
        rc = calls[name]()
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f"{kernel} {name}: CUDA error {rc}")
        d = (out.float() - ref.float()).abs().max().item()
        times[name] = [time_ms(calls[name])]
        print(f"{kernel} {name}: {times[name][0]:.4f} ms, max |out - kernel's| {d:.3e} ({what})",
              flush=True)
    times["kernel"].append(time_ms(calls["kernel"]))
    print(f"{kernel} kernel: {times['kernel'][0]:.4f} ms before, {times['kernel'][1]:.4f} ms "
          f"after the variants", flush=True)


def b4_calls(libs: dict, gen, dev, stream):
    """B4's C entry at DeiT-S, batch 512, S 197, bf16, random weights: one
    call per variant library, and the output they write."""
    from vit_pruning_tpu_torch.configs import deit_small
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models.vit import init_vit_params, layer_slice
    from vit_pruning_tpu_torch.ops.quant import kmajor_int8_weights, quantize_layer_params

    cfg = deit_small(num_labels=100)
    lp = layer_slice(init_vit_params(cfg.replace(num_layers=1), gen, "cpu")["layers"], 0)
    qp = quantize_layer_params(tree_to(lp, dev, torch.bfloat16))
    nk = kmajor_int8_weights(qp)
    a, mlp = qp["attn"], qp["mlp"]
    w = [qp["ln1"]["g"], qp["ln1"]["b"], nk["qkv"]["wq"], nk["qkv"]["wscale"], nk["qkv"]["b"],
         nk["o"]["wq"], a["o"]["wscale"], a["o"]["b"], qp["ln2"]["g"], qp["ln2"]["b"],
         nk["fc1"]["wq"], mlp["fc1"]["wscale"], mlp["fc1"]["b"], nk["fc2"]["wq"],
         mlp["fc2"]["wscale"], mlp["fc2"]["b"]]
    b, s, d, h, m = 512, 197, cfg.hidden_size, cfg.num_heads, cfg.mlp_dim
    kw, rows = cfg.attn_width, 512 * 197
    x = torch.randn(b, s, d, generator=gen).to(dev, torch.bfloat16)
    out = torch.empty_like(x)
    bufs = []
    for n in (d, kw, d, m):  # the codes and row scales of LN1, ctx, LN2, GELU
        bufs += [torch.empty((rows, n), dtype=torch.int8, device=dev),
                 torch.empty(rows, dtype=torch.float32, device=dev)]
    bufs += [torch.empty((rows, 3 * kw), dtype=x.dtype, device=dev),
             torch.empty((rows, kw), dtype=x.dtype, device=dev),
             torch.empty((rows, d), dtype=torch.float32, device=dev),
             torch.empty((rows, m), dtype=x.dtype, device=dev)]

    def call(lib):
        return lib.vpt_vit_layer_int8_forward(
            1, x.data_ptr(), None, *(t.data_ptr() for t in w), out.data_ptr(),
            *(t.data_ptr() for t in bufs), b, s, d, h, kw // h, m, d, cfg.layernorm_eps,
            stream)

    return {name: (lambda lib=lib: call(lib)) for name, lib in libs.items()}, out


def main():
    if not torch.cuda.is_available():
        sys.exit("kernel_variants: no CUDA device (torch.cuda.is_available() is False)")
    from vit_pruning_tpu_torch.ops.cuda import build

    chosen = sys.argv[1:] or ["b7", "b6", "b4", "b8a"]
    plans = {"b7": ("mlp", B7_VARIANTS, ()), "b6": ("attention", B6_VARIANTS, ()),
             "b4": ("layer_int8", B4_VARIANTS, ("layer", "gemm")),
             "b8a": ("embed", B8A_VARIANTS, ())}
    if not set(chosen) <= set(plans):
        sys.exit(f"kernel_variants: kernels {chosen}; it knows {sorted(plans)}")
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(chosen)) as pool:  # every nvcc process at once
            futures = {key: pool.submit(build_variants, build, src, variants, Path(tmp), extra)
                       for key, (src, variants, extra) in plans.items() if key in chosen}
            libs = {key: f.result() for key, f in futures.items()}
        dev, gen = "cuda", torch.Generator().manual_seed(0)
        stream = torch.cuda.current_stream().cuda_stream

        if "b7" in libs:
            b7_report(libs["b7"], gen, dev, stream)
        if "b6" in libs:
            b6_report(libs["b6"], gen, dev, stream)
        if "b4" in libs:
            calls, out = b4_calls(libs["b4"], gen, dev, stream)
            report("B4", B4_VARIANTS, calls, out)
            del calls, out
        if "b8a" in libs:
            b8a_report(libs["b8a"], gen, dev, stream)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])


def b7_report(libs: dict, gen, dev, stream):
    bf = torch.bfloat16
    t, d, m = 100864, 384, 1536
    x = torch.randn(t, d, generator=gen).to(dev, bf)
    w1, b1, w2, b2 = ((s * torch.randn(shape, generator=gen)).to(dev, bf)
                      for s, shape in ((0.05, (d, m)), (0.05, (m,)), (0.05, (m, d)), (0.1, (d,))))
    out = torch.empty_like(x)
    report("B7", B7_VARIANTS, {
        name: (lambda lib=lib: lib.vpt_mlp_forward(
            1, x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            out.data_ptr(), t, d, m, stream)) for name, lib in libs.items()}, out)


def b6_report(libs: dict, gen, dev, stream):
    bf = torch.bfloat16
    b, h, s, hd = 512, 6, 197, 64
    q, k, v = (torch.randn(b, h, s, hd, generator=gen).to(dev, bf) for _ in range(3))
    mask = torch.rand(b, s, generator=gen) > 0.3
    mask[:, 0] = True
    mask = mask.to(dev)
    out = torch.empty_like(q)
    report("B6", B6_VARIANTS, {
        name: (lambda lib=lib: lib.vpt_attention_forward(
            1, q.data_ptr(), k.data_ptr(), v.data_ptr(), mask.data_ptr(), out.data_ptr(),
            b, h, s, hd, stream)) for name, lib in libs.items()}, out)


def b8a_report(libs: dict, gen, dev, stream):
    """B8a's uint8 patches with bf16 weights, the affine of the serving
    normalisation, at DeiT-S's and ViT-H's patch widths."""
    from vit_pruning_tpu_torch.data.preprocess import VIT_MEAN, VIT_STD

    bf = torch.bfloat16
    scale, shift = 1.0 / (255.0 * VIT_STD), -VIT_MEAN / VIT_STD
    for tag, bsz, n_p, kk, dd in (("DeiT-S batch 512", 512, 196, 768, 384),
                                  ("ViT-H batch 64", 64, 256, 588, 1280)):
        patches = torch.randint(0, 256, (bsz, n_p, kk), generator=gen, dtype=torch.uint8).to(dev)
        w = (0.02 * torch.randn(kk, dd, generator=gen)).to(dev, bf)
        bias, pos = torch.zeros(dd, device=dev, dtype=bf), torch.zeros(n_p, dd, device=dev, dtype=bf)
        out = torch.empty((bsz, n_p, dd), device=dev, dtype=bf)
        report(f"B8a {tag} (K {kk}, D {dd})", B8A_VARIANTS, {
            name: (lambda lib=lib: lib.vpt_patch_embed_forward(
                2, 1, 0, patches.data_ptr(), w.data_ptr(), bias.data_ptr(), pos.data_ptr(),
                out.data_ptr(), bsz * n_p, n_p, kk, dd, scale, shift, stream))
            for name, lib in libs.items()}, out)


if __name__ == "__main__":
    main()
