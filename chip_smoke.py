#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (vit_pruning_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda); builds the
kernels from csrc/ itself. Phases:

  1. the card's name and power limit (nvidia-smi)
  2. build the kernels, print the seconds
  3. kernel B1 (fused_vit_layer) against its plain version: DeiT-S and
     composed geometry, S in {197, 131, 99, 66, 33, 17}, masked and not,
     float32 and bfloat16, batch 8
  4. kernel B2 (fused_vit_layer_cls_logits) against its plain version
  5. end to end, DeiT-S @224 with 100 labels at batch 64: dense vit_forward
     and headline / composed / ultra through serving_forward, kernels
     (mode 'auto') against plain PyTorch (mode 'eager'), with the launch
     counts of every forward
  6. times at batch 512 in bfloat16, kernel path and plain path (info only)

Any failed check raises, so the exit code is non-zero. The line before the
last is the kernels' JSON record; the last line is the device record.
Weights are random, from a torch.Generator seed; images from a numpy seed.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
# the cls_mlp predictor's random init puts every score within ~1e-3 of 0.5;
# this gain on its weights spreads the scores (sigmoid inputs of a few
# units at DeiT-S width) so that the f32 top-k cuts are not near ties
PREDICTOR_GAIN = 10.0
F32_ATOL = 1e-4  # kernel vs plain, both f32-accumulated; sums in another order


def log(msg: str):
    print(msg, flush=True)


def bf16_tol(ref) -> float:
    """Two bf16 steps at the reference's largest magnitude: kernel and plain
    version round to bf16 at the same places, but an f32 sum taken in
    another order can land a value on the neighbouring bf16 number, once in
    an intermediate and once in the output."""
    top = max(float(ref.abs().max()), 1e-30)
    return 2.0 * 2.0 ** (math.floor(math.log2(top)) - 7)


class Checks:
    """Collects failures of one phase and raises them together."""

    def __init__(self, phase: str):
        self.phase, self.failed = phase, []

    def __call__(self, ok: bool, msg: str):
        if not ok:
            self.failed.append(msg)
            log(f"  FAIL {msg}")

    def done(self):
        if self.failed:
            raise AssertionError(f"{self.phase}: {len(self.failed)} check(s) failed: "
                                 + "; ".join(self.failed))
        log(f"{self.phase}: ok")


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def perturbed_layer(lp: dict, gen: torch.Generator) -> dict:
    """Random LN gains/biases and linear biases (the init leaves them 1 and
    0, which would hide a bias or gain bug)."""
    out = {}
    for k, v in lp.items():
        if isinstance(v, dict):
            out[k] = perturbed_layer(v, gen)
        elif k in ("g", "b"):
            out[k] = v + 0.1 * torch.randn(v.shape, generator=gen)
        else:
            out[k] = v
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vit_pruning_tpu_torch.configs import (
        PruneConfig, composed_schedule, deit_small, ultra_schedule)
    from vit_pruning_tpu_torch.models.convert import tree_to
    from vit_pruning_tpu_torch.models.pruned_vit import init_pruned_vit_params
    from vit_pruning_tpu_torch.models.vit import layer_slice, vit_forward, vit_layer
    from vit_pruning_tpu_torch.ops.cuda import layer as kl
    from vit_pruning_tpu_torch.ops.cuda.build import load_library
    from vit_pruning_tpu_torch.ops.dispatch import kernel_mode
    from vit_pruning_tpu_torch.ops.structured import prune_heads, prune_mlp_channels
    from vit_pruning_tpu_torch.serving import serving_forward

    dev = torch.device("cuda", 0)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}

    # --- 1. device ---------------------------------------------------------------
    smi = device_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} x{torch.cuda.device_count()}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # --- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    load_library()
    log(f"build: kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    # --- models (CPU init from one seed, then to the card) -------------------------
    gen = torch.Generator().manual_seed(SEED)
    cfg = deit_small(num_labels=100)
    n, L = cfg.num_patches, cfg.num_layers
    base = init_pruned_vit_params(cfg, PruneConfig(mode="topk_prog", predictor="cls_mlp"), gen)
    base["predictor"]["mlp"] = {
        name: {"w": p["w"] * PREDICTOR_GAIN, "b": p["b"]}
        for name, p in base["predictor"]["mlp"].items()
    }
    bb, c_cfg = prune_heads(base["backbone"], cfg, [list(range(0, cfg.num_heads, 2))] * L)
    pruned = dict(base, backbone=prune_mlp_channels(
        bb, [list(range(0, cfg.mlp_dim, 2))] * L))

    def prune_cfg(sched):
        return PruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention",
                           top_k=sched[0], keep_schedule=sched)

    presets = {  # name -> (config, prune config or None for dense, CPU params)
        "dense": (cfg, None, base),
        "headline": (cfg, PruneConfig(mode="topk_prog", predictor="cls_mlp",
                                      loss="mse_attention", top_k=98), base),
        "composed": (c_cfg, prune_cfg(composed_schedule(n, L)), pruned),
        "ultra": (c_cfg, prune_cfg(ultra_schedule(n, L)), pruned),
    }
    geometries = {  # kernel phases: (config, one perturbed layer on the CPU)
        "deit_s": (cfg, perturbed_layer(layer_slice(base["backbone"]["layers"], 0), gen)),
        "composed": (c_cfg, perturbed_layer(layer_slice(pruned["backbone"]["layers"], 0), gen)),
    }
    lnf = perturbed_layer(base["backbone"]["ln_f"], gen)
    head = {"w": base["backbone"]["head"]["w"],
            "b": base["backbone"]["head"]["b"] + 0.1 * torch.randn(100, generator=gen)}
    err = {"b1": 0.0, "b2": 0.0}

    # --- 3. B1 against its plain version ------------------------------------------------
    check = Checks("phase 3 (B1 vs plain)")
    for gname, (gcfg, lp_cpu) in geometries.items():
        for dname, dt in dtypes.items():
            lp = tree_to(lp_cpu, dev, dt)
            for s in (197, 131, 99, 66, 33, 17):
                x = torch.randn(8, s, gcfg.hidden_size, generator=gen).to(dev, dt)
                m = torch.rand(8, s, generator=gen) > 0.3
                m[:, 0] = True
                for mask in (None, m.to(dev)):
                    got = kl.fused_vit_layer(x, lp, gcfg.num_heads, gcfg.layernorm_eps, mask)
                    ref = kl.fused_vit_layer_ref(x, lp, gcfg.num_heads, gcfg.layernorm_eps, mask)
                    torch.cuda.synchronize()
                    rows = torch.ones_like(m) if mask is None else m  # masked rows: don't care
                    d = (got.float() - ref.float()).abs()[rows.to(dev)].max().item()
                    tol = F32_ATOL if dt == torch.float32 else bf16_tol(ref.float())
                    if dt == torch.float32:
                        err["b1"] = max(err["b1"], d)
                    tag = f"B1 {gname} {dname} S={s} {'mask' if mask is not None else 'nomask'}"
                    log(f"  {tag}: max_abs_err {d:.3e} (tol {tol:.1e})")
                    check(bool(torch.isfinite(got).all()) and d <= tol, tag)
    # what the kernel does not take must raise, not run
    gcfg, lp_cpu = geometries["deit_s"]
    lp = tree_to(lp_cpu, dev, torch.bfloat16)
    bad = {
        "S=257 (ViT-H)": torch.zeros(2, 257, gcfg.hidden_size, device=dev, dtype=torch.bfloat16),
        "float16": torch.zeros(2, 17, gcfg.hidden_size, device=dev, dtype=torch.float16),
        "non-contiguous": torch.zeros(2, gcfg.hidden_size, 17, device=dev,
                                      dtype=torch.bfloat16).transpose(1, 2),
    }
    for what, x in bad.items():
        try:
            kl.fused_vit_layer(x, lp, gcfg.num_heads)
            check(False, f"B1 accepted {what}")
        except (TypeError, ValueError) as e:
            log(f"  B1 rejects {what}: {e}")
    check.done()

    # --- 4. B2 against its plain version ------------------------------------------------
    check = Checks("phase 4 (B2 vs plain)")
    for gname, (gcfg, lp_cpu) in geometries.items():
        for dname, dt in dtypes.items():
            lp, f, h = (tree_to(t, dev, dt) for t in (lp_cpu, lnf, head))
            for s in (197, 99, 33, 17):
                x = torch.randn(8, s, gcfg.hidden_size, generator=gen).to(dev, dt)
                got = kl.fused_vit_layer_cls_logits(x, lp, f, h, gcfg.num_heads,
                                                    gcfg.layernorm_eps)
                ref = kl.fused_vit_layer_cls_logits_ref(x, lp, f, h, gcfg.num_heads,
                                                        gcfg.layernorm_eps)
                torch.cuda.synchronize()
                d = (got.float() - ref.float()).abs().max().item()
                tol = F32_ATOL if dt == torch.float32 else bf16_tol(ref.float())
                if dt == torch.float32:
                    err["b2"] = max(err["b2"], d)
                tag = f"B2 {gname} {dname} S={s}"
                log(f"  {tag}: max_abs_err {d:.3e} (tol {tol:.1e})")
                check(got.shape == (8, 100) and bool(torch.isfinite(got).all()) and d <= tol, tag)
    check.done()

    # --- 5. end to end: kernels vs plain PyTorch, launch counts -------------------------
    rs = np.random.RandomState(SEED)

    def images(batch):
        u8 = torch.from_numpy(rs.randint(0, 256, (batch, 3, 224, 224), dtype=np.uint8)).to(dev)
        return u8

    def forward_fn(name, params, dt, u8):
        pcfg_cfg, pcfg, _ = presets[name]
        if pcfg is None:
            pix = ((u8.float() / 255.0 - 0.5) / 0.5).to(dt)
            return lambda: {"logits": vit_forward(params["backbone"], pix, pcfg_cfg)["logits"]}
        return lambda: serving_forward(params, u8, pcfg_cfg, pcfg)

    def cut_gap(out, pcfg):
        """Smallest gap between the k-th and (k+1)-th live score at any drop."""
        gaps = []
        for i, k in enumerate(pcfg.keep_schedule or (pcfg.top_k,)):
            sc = out["scores"][i].float()
            live = torch.isfinite(sc)
            if not k or not live.any():
                continue
            top = sc.masked_fill(~live, float("-inf")).topk(k + 1, dim=-1).values
            gaps.append((top[:, k - 1] - top[:, k]).min().item())
        return min(gaps, default=float("inf"))

    check = Checks("phase 5 (end to end)")
    u8 = images(64)
    kl.fused_vit_layer.launches = kl.fused_vit_layer_cls_logits.launches = 0
    for dname, dt in dtypes.items():
        for name, (pc, pcfg, cpu_params) in presets.items():
            params = tree_to(cpu_params, dev, dt)
            fwd = forward_fn(name, params, dt, u8)
            n1, n2 = kl.fused_vit_layer.launches, kl.fused_vit_layer_cls_logits.launches
            with kernel_mode("auto"):
                got = fwd()
            torch.cuda.synchronize()
            l1 = kl.fused_vit_layer.launches - n1
            l2 = kl.fused_vit_layer_cls_logits.launches - n2
            with kernel_mode("eager"):
                ref = fwd()
            torch.cuda.synchronize()
            tag = f"{name} {dname}"
            want = (L, 0) if pcfg is None else (L - 1, 1)
            check((l1, l2) == want, f"{tag}: launches B1={l1} B2={l2}, want {want}")
            lg, lr = got["logits"].float(), ref["logits"].float()
            check(lg.shape == (64, 100) and bool(torch.isfinite(lg).all()),
                  f"{tag}: logits not finite [64, 100]")
            d = (lg - lr).abs().max().item()
            agree = (lg.argmax(-1) == lr.argmax(-1)).float().mean().item()
            line = (f"  {tag}: launches B1={l1} B2={l2}; logits max_abs_err {d:.3e} "
                    f"(max|ref| {lr.abs().max().item():.3f}), argmax agree {agree:.3f}")
            same_masks = True
            if pcfg is not None:
                km, em = got["keep_masks"], ref["keep_masks"]
                same_masks = bool(torch.equal(km, em))
                frac = (km == em).all(-1).float().mean().item()
                line += (f"; keep masks equal {same_masks} (images x layers agreeing "
                         f"{frac:.4f}); min cut gap (plain) {cut_gap(ref, pcfg):.2e}")
            log(line)
            if dt == torch.float32:
                check(same_masks, f"{tag}: keep masks differ")
                check(d <= F32_ATOL + 1e-4 * lr.abs().max().item(), f"{tag}: logits differ")
            elif name == "headline":
                # the only drop comes before any kernel runs: masks must agree
                check(same_masks, f"{tag}: keep masks differ")
    launches = {"b1": kl.fused_vit_layer.launches, "b2": kl.fused_vit_layer_cls_logits.launches}
    log(f"  main-path launches: B1 {launches['b1']}, B2 {launches['b2']}")
    check(launches["b1"] > 0 and launches["b2"] > 0, "a kernel of the path never launched")
    check.done()

    # --- 6. times at batch 512, bf16 (info) --------------------------------------------
    def time_ms(fn, iters=10, warmup=3) -> float:
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

    def abba(kernel_fn, plain_fn):
        """plain, kernel, kernel, plain; mean of each pair (ms)."""
        p1 = time_ms(plain_fn)
        k1, k2 = time_ms(kernel_fn), time_ms(kernel_fn)
        p2 = time_ms(plain_fn)
        return (k1 + k2) / 2, (p1 + p2) / 2

    log(f"phase 6 (bf16, batch 512, CUDA events, mean of 10 after 3 warm-up; {smi})")
    bf = torch.bfloat16
    u8 = images(512)
    for name, (pc, pcfg, cpu_params) in presets.items():
        fwd = forward_fn(name, tree_to(cpu_params, dev, bf), bf, u8)

        def run(mode, fwd=fwd):
            with kernel_mode(mode):
                fwd()

        k_ms, p_ms = abba(lambda: run("auto"), lambda: run("eager"))
        log(f"  {name}: kernel path {k_ms:.3f} ms/batch ({512 / k_ms * 1e3:.0f} img/s), "
            f"plain path {p_ms:.3f} ms/batch ({512 / p_ms * 1e3:.0f} img/s)")

    kernel_ms = {}
    lp = tree_to(geometries["deit_s"][1], dev, bf)
    f, h = tree_to(lnf, dev, bf), tree_to(head, dev, bf)
    for gname, s in (("deit_s", 197), ("deit_s", 99), ("composed", 131), ("composed", 33)):
        gcfg = geometries[gname][0]
        glp = tree_to(geometries[gname][1], dev, bf)
        x = torch.randn(512, s, gcfg.hidden_size, generator=gen).to(dev, bf)
        k_ms, p_ms = abba(lambda: kl.fused_vit_layer(x, glp, gcfg.num_heads),
                          lambda: kl.fused_vit_layer_ref(x, glp, gcfg.num_heads))
        with kernel_mode("eager"):
            e_ms = time_ms(lambda: vit_layer(x, glp, gcfg))
        log(f"  B1 {gname} S={s}: kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, "
            f"eager layer (bf16 cuBLAS) {e_ms:.3f} ms")
        if (gname, s) == ("deit_s", 197):
            kernel_ms["b1"] = (k_ms, p_ms)
    for s in (99, 197):
        x = torch.randn(512, s, cfg.hidden_size, generator=gen).to(dev, bf)
        k_ms, p_ms = abba(
            lambda: kl.fused_vit_layer_cls_logits(x, lp, f, h, cfg.num_heads),
            lambda: kl.fused_vit_layer_cls_logits_ref(x, lp, f, h, cfg.num_heads))
        log(f"  B2 deit_s S={s}: kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms")
        if s == 99:
            kernel_ms["b2"] = (k_ms, p_ms)

    # --- 7. records ------------------------------------------------------------------
    jax_loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.split(".")[0] in ("jax", "vit_pruning_tpu"))
    if jax_loaded:
        raise AssertionError(f"the port imported jax or the JAX package: {jax_loaded[:5]}")
    pkg = "vit_pruning_tpu_torch"
    kernels = [
        {"name": "fused_vit_layer", "route": "cuda", "source": f"{pkg}/csrc/layer.cu",
         "replaces": "vit_pruning_tpu/ops/pallas/layer.py:359", "launches": launches["b1"],
         "max_abs_err": err["b1"], "ms": kernel_ms["b1"][0], "plain_ms": kernel_ms["b1"][1]},
        {"name": "fused_vit_layer_cls_logits", "route": "cuda", "source": f"{pkg}/csrc/layer.cu",
         "replaces": "vit_pruning_tpu/ops/pallas/layer.py:561", "launches": launches["b2"],
         "max_abs_err": err["b2"], "ms": kernel_ms["b2"][0], "plain_ms": kernel_ms["b2"][1]},
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
