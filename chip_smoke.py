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
  4b. kernel B3 (fused_vit_layer_bucketed) against its plain version: S 197
     with cap 99 / 131 / 197 and S 99 with cap 50, random kept counts up to
     the cap and an image with only CLS kept; skipped rows must be x
     bit for bit
  5. end to end, DeiT-S @224 with 100 labels at batch 64: dense vit_forward
     and headline / composed / ultra through serving_forward, kernels
     (mode 'auto') against plain PyTorch (mode 'eager'), with the launch
     counts of every forward
  5b. the re-decide path end to end, same model and batch: pruned_vit_forward
     in modes topk (top_k 98), mask with mask_budget 98, mask without a
     budget (per-layer median thresholds from a measure_only probe) and
     random (top_k 98, a seeded generator), kernels against plain PyTorch
  6. times at batch 512 in bfloat16, kernel path and plain path, and each
     kernel beside its plain version and its eager PyTorch equivalent
     (info only); each kernel's bound from its shapes; the device time of the
     dense, headline, topk50 and mask forwards by kernel family
     (torch.profiler)
  7. records: nothing of jax or of the JAX package was loaded (by module
     name or by file), the kernels' JSON line, the device line

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
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): bf16 tensor
# cores and device memory; a kernel's bound is the larger of its operations
# and its bytes over these
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


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
    from vit_pruning_tpu_torch.models import pruned_vit as tp
    from vit_pruning_tpu_torch.models.pruned_vit import init_pruned_vit_params, pruned_vit_forward
    from vit_pruning_tpu_torch.models.vit import layer_norm, layer_slice, vit_forward, vit_layer
    from vit_pruning_tpu_torch.ops.cuda import layer as kl
    from vit_pruning_tpu_torch.ops.cuda.build import load_library
    from vit_pruning_tpu_torch.ops.dispatch import kernel_mode
    from vit_pruning_tpu_torch.ops.masking import compact_dest
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
    base = init_pruned_vit_params(cfg, PruneConfig(mode="topk_prog", predictor="cls_mlp"), gen,
                                  "cpu")
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
    err = {"b1": 0.0, "b2": 0.0, "b3": 0.0}

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

    # --- 4b. B3 against its plain version -----------------------------------------------
    def random_mask(b, s, counts):
        """CLS + counts[i] - 1 random patches of image i, on the card."""
        rank = torch.rand(b, s - 1, generator=gen).argsort(-1).argsort(-1)
        keep = rank < (counts[:, None] - 1)
        return torch.cat([torch.ones(b, 1, dtype=torch.bool), keep], 1).to(dev)

    check = Checks("phase 4b (B3 vs plain)")
    for gname, (gcfg, lp_cpu) in geometries.items():
        for dname, dt in dtypes.items():
            lp = tree_to(lp_cpu, dev, dt)
            for s, cap in ((197, 99), (197, 131), (197, 197), (99, 50)):
                x = torch.randn(8, s, gcfg.hidden_size, generator=gen).to(dev, dt)
                counts = torch.randint(1, cap + 1, (8,), generator=gen)
                counts[0], counts[1] = 1, cap  # only CLS kept; a full bucket
                mask = random_mask(8, s, counts)
                dest = compact_dest(mask)
                got = kl.fused_vit_layer_bucketed(x, lp, dest, mask, cap, gcfg.num_heads,
                                                  gcfg.layernorm_eps)
                ref = kl.fused_vit_layer_bucketed_ref(x, lp, dest, mask, cap, gcfg.num_heads,
                                                      gcfg.layernorm_eps)
                torch.cuda.synchronize()
                d = (got.float() - ref.float()).abs()[mask].max().item()
                skipped_exact = bool(torch.equal(got[~mask], x[~mask]))
                tol = F32_ATOL if dt == torch.float32 else bf16_tol(ref.float())
                if dt == torch.float32:
                    err["b3"] = max(err["b3"], d)
                tag = f"B3 {gname} {dname} S={s} cap={cap}"
                log(f"  {tag}: kept rows max_abs_err {d:.3e} (tol {tol:.1e}); skipped rows "
                    f"bit-identical to x: {skipped_exact}")
                check(bool(torch.isfinite(got).all()) and d <= tol and skipped_exact, tag)
    gcfg, lp_cpu = geometries["deit_s"]
    lp = tree_to(lp_cpu, dev, torch.bfloat16)
    m17 = random_mask(2, 17, torch.tensor([5, 9]))
    x17 = torch.zeros(2, 17, gcfg.hidden_size, device=dev, dtype=torch.bfloat16)
    bad = {  # what the kernel does not take must raise, not run
        "cap 18 > S 17": (x17, 18, gcfg.num_heads),
        "head dim 96": (x17, 9, 4),
        "float16": (x17.half(), 9, gcfg.num_heads),
    }
    for what, (x, cap, heads) in bad.items():
        try:
            kl.fused_vit_layer_bucketed(x, lp, compact_dest(m17), m17, cap, heads)
            check(False, f"B3 accepted {what}")
        except (TypeError, ValueError) as e:
            log(f"  B3 rejects {what}: {e}")
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
    wrappers = (kl.fused_vit_layer, kl.fused_vit_layer_cls_logits, kl.fused_vit_layer_bucketed)
    for k in wrappers:  # the counts of this path's run only
        k.launches = 0
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
    log(f"  progressive path launches: B1 {launches['b1']}, B2 {launches['b2']}, "
        f"B3 {kl.fused_vit_layer_bucketed.launches}")
    check(launches["b1"] > 0 and launches["b2"] > 0, "a kernel of the path never launched")
    check.done()

    # --- 5b. re-decide path end to end: kernels vs plain PyTorch, launch counts ----------
    redecide = {  # name -> (prune config, kernel that runs each layer)
        "topk50": (PruneConfig(mode="topk", predictor="cls_mlp", top_k=98), "b3"),
        "mask_budget50": (PruneConfig(mode="mask", predictor="cls_mlp", mask_budget=98), "b3"),
        "mask": (PruneConfig(mode="mask", predictor="cls_mlp"), "b1"),
        "random50": (PruneConfig(mode="random", predictor="cls_mlp", top_k=98), "b3"),
    }

    def calibrated(params, pix):
        """Per-layer median-score thresholds from a measure_only probe on the
        plain path (dense execution, masks and scores per layer)."""
        probe = PruneConfig(mode="mask", predictor="cls_mlp", measure_only=True)
        with kernel_mode("eager"):
            scores = pruned_vit_forward(params, pix, cfg, probe)["scores"]
        return tuple(float(np.median(sc.float().cpu().numpy())) for sc in scores)

    def redecide_fn(name, params, pix, thresholds):
        pcfg = redecide[name][0]
        if pcfg.mode == "mask":
            pcfg = pcfg.replace(mlp_threshold=thresholds)

        def fwd():
            gen_r = torch.Generator(device=dev).manual_seed(SEED)  # the same noise every run
            return pruned_vit_forward(params, pix, cfg, pcfg, generator=gen_r)
        return fwd, pcfg

    def rank_gap(sc, k):
        """Smallest gap between the k-th and (k+1)-th largest finite score."""
        top = sc.topk(k + 1, dim=-1).values
        live = torch.isfinite(top[:, k])
        return (top[:, k - 1] - top[:, k])[live].min().item() if live.any() else float("inf")

    def decision_gap(out, pcfg):
        """Smallest gap between a score and its threshold or rank cut."""
        gaps = [float("inf")]
        for i, sc in enumerate(out["scores"].float()):
            if pcfg.mode == "topk":
                gaps.append(rank_gap(sc, pcfg.top_k))
            elif pcfg.mode == "mask":
                thr = pcfg.mlp_threshold[i]
                gaps.append((sc - thr).abs().min().item())
                if pcfg.mask_budget is not None:
                    gaps.append(rank_gap(sc.masked_fill(sc < thr, float("-inf")),
                                         pcfg.mask_budget))
        return min(gaps)

    check = Checks("phase 5b (re-decide end to end)")
    for k in wrappers:  # the counts of this path's run only
        k.launches = 0
    for dname, dt in dtypes.items():
        params = tree_to(base, dev, dt)
        pix = ((u8.float() / 255.0 - 0.5) / 0.5).to(dt)
        thresholds = calibrated(params, pix)
        log(f"  {dname} calibrated mlp_threshold per layer: "
            + ", ".join(f"{t:.4f}" for t in thresholds))
        for name, (_, kname) in redecide.items():
            fwd, pcfg = redecide_fn(name, params, pix, thresholds)
            n1, n3 = kl.fused_vit_layer.launches, kl.fused_vit_layer_bucketed.launches
            with kernel_mode("auto"):
                got = fwd()
            torch.cuda.synchronize()
            l1 = kl.fused_vit_layer.launches - n1
            l3 = kl.fused_vit_layer_bucketed.launches - n3
            with kernel_mode("eager"):
                ref = fwd()
            torch.cuda.synchronize()
            tag = f"{name} {dname}"
            want = (L, 0) if kname == "b1" else (0, L)
            check((l1, l3) == want, f"{tag}: launches B1={l1} B3={l3}, want {want}")
            lg, lr = got["logits"].float(), ref["logits"].float()
            check(lg.shape == (64, 100) and bool(torch.isfinite(lg).all()),
                  f"{tag}: logits not finite [64, 100]")
            d = (lg - lr).abs().max().item()
            km, em = got["keep_masks"], ref["keep_masks"]
            same_masks = bool(torch.equal(km, em))
            kept = km[:, :, 1:].float().mean().item()
            log(f"  {tag}: launches B1={l1} B3={l3}; logits max_abs_err {d:.3e} (max|ref| "
                f"{lr.abs().max().item():.3f}); keep masks equal {same_masks} (images x layers "
                f"agreeing {(km == em).all(-1).float().mean().item():.4f}); patches kept "
                f"{kept:.3f}; min threshold/cut gap (plain) {decision_gap(ref, pcfg):.2e}")
            if dt == torch.float32:
                check(same_masks, f"{tag}: keep masks differ")
                check(d <= F32_ATOL + 1e-4 * lr.abs().max().item(), f"{tag}: logits differ")
            else:
                # layer 0 decides from the embedding, before any kernel; the
                # random masks never depend on a layer's output
                check(bool(torch.equal(km[0], em[0])), f"{tag}: layer-0 keep masks differ")
                if name == "random50":
                    check(same_masks, f"{tag}: keep masks differ")
            if pcfg.mode in ("topk", "random") or pcfg.mask_budget is not None:
                budget = pcfg.mask_budget if pcfg.mode == "mask" else pcfg.top_k
                most = int(km.sum(-1).max())
                check(most <= budget + 1, f"{tag}: {most} kept, over the budget {budget} + 1")
    launches["b1_redecide"] = kl.fused_vit_layer.launches
    launches["b3"] = kl.fused_vit_layer_bucketed.launches
    log(f"  re-decide path launches: B1 {launches['b1_redecide']}, "
        f"B2 {kl.fused_vit_layer_cls_logits.launches}, B3 {launches['b3']}")
    check(launches["b3"] > 0 and launches["b1_redecide"] > 0, "a kernel of the path never launched")
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

    def device_breakdown(tag, fn, wall_ms, reps=3):
        """Device time per forward by kernel family (torch.profiler, CUDA
        activity only), and the idle share against the CUDA-event wall time."""
        from torch.profiler import ProfilerActivity, profile

        families = (("GEMM", ("gemm_bf16", "gemm_f32")), ("attention", ("attention",)),
                    ("LN", ("layer_norm_kernel",)),
                    ("B3 rows", ("bucket_invert", "gather_rows", "expand_rows")))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        sums, other = {name: 0.0 for name, _ in families}, {}
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", 0.0) or 0.0
            fam = next((n for n, keys in families if any(k in ev.key for k in keys)), None)
            if fam:
                sums[fam] += us / 1e3 / reps
            elif us:
                other[ev.key[:48]] = us / 1e3 / reps
        busy = sum(sums.values()) + sum(other.values())
        if not busy:
            log(f"  {tag} device breakdown: not measured (the profiler saw no device time)")
            return
        top = sorted(other.items(), key=lambda kv: -kv[1])[:4]
        log(f"  {tag} device ms/forward: " + ", ".join(f"{k} {v:.3f}" for k, v in sums.items())
            + f", other {sum(other.values()):.3f} (top: "
            + "; ".join(f"{k} {v:.3f}" for k, v in top) + f"); busy {busy:.3f} of wall "
            f"{wall_ms:.3f}, idle share {max(0.0, 1 - busy / wall_ms):.3f}")

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
        if name in ("dense", "headline"):
            device_breakdown(name, lambda: run("auto"), k_ms)
    params = tree_to(base, dev, bf)
    pix = ((u8.float() / 255.0 - 0.5) / 0.5).to(bf)
    thresholds = calibrated(params, pix)  # at the timed shape, as bench.py probes
    for name in redecide:
        fwd, _ = redecide_fn(name, params, pix, thresholds)

        def run(mode, fwd=fwd):
            with kernel_mode(mode):
                fwd()

        k_ms, p_ms = abba(lambda: run("auto"), lambda: run("eager"))
        log(f"  re-decide {name}: kernel path {k_ms:.3f} ms/batch ({512 / k_ms * 1e3:.0f} "
            f"img/s), plain path {p_ms:.3f} ms/batch ({512 / p_ms * 1e3:.0f} img/s)")
        if name in ("topk50", "mask"):
            device_breakdown(f"re-decide {name}", lambda: run("auto"), k_ms)

    def bound(flops: float, nbytes: float):
        """(least ms for the work on this card, what bounds it)."""
        t_op, t_mem = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
        return (t_op, "operations") if t_op >= t_mem else (t_mem, "bytes")

    def layer_work(gcfg, rows: int, attn_rows2: int) -> float:
        """Operations of the layer's four products over `rows` rows and of
        QK^T and PV over sum_b(H * S_b^2) query-key pairs."""
        d, kw, m = gcfg.hidden_size, gcfg.attn_width, gcfg.mlp_dim
        return 2.0 * rows * (3 * d * kw + kw * d + 2 * d * m) + 4.0 * attn_rows2 * gcfg.head_dim

    def weight_bytes(tree) -> int:
        if isinstance(tree, dict):
            return sum(weight_bytes(v) for v in tree.values())
        return tree.numel() * tree.element_size()

    kernel_ms, bounds = {}, {}
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
        b_ms, b_by = bound(layer_work(gcfg, 512 * s, 512 * gcfg.num_heads * s * s),
                           2 * x.numel() * x.element_size() + weight_bytes(glp))
        log(f"  B1 {gname} S={s}: kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, "
            f"eager layer (bf16 cuBLAS) {e_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by})")
        if (gname, s) == ("deit_s", 197):
            kernel_ms["b1"], bounds["b1"] = (k_ms, p_ms, e_ms), (b_ms, b_by)
    for s in (99, 197):
        x = torch.randn(512, s, cfg.hidden_size, generator=gen).to(dev, bf)
        k_ms, p_ms = abba(
            lambda: kl.fused_vit_layer_cls_logits(x, lp, f, h, cfg.num_heads),
            lambda: kl.fused_vit_layer_cls_logits_ref(x, lp, f, h, cfg.num_heads))

        def eager_cls():  # the plain path's tail: whole last layer, LN_f, head on CLS
            y = layer_norm(vit_layer(x, lp, cfg), f, cfg.layernorm_eps)[:, 0]
            return y @ h["w"] + h["b"]

        with kernel_mode("eager"):
            e_ms = time_ms(eager_cls)
        d, kw, m = cfg.hidden_size, cfg.attn_width, cfg.mlp_dim
        flops = (2.0 * 512 * s * d * 2 * kw + 2.0 * 512 * (d * kw + kw * d + 2 * d * m + d * 100)
                 + 4.0 * 512 * cfg.num_heads * s * cfg.head_dim)
        nbytes = (x.numel() * x.element_size() + 512 * 100 * 2 + weight_bytes(lp)
                  + weight_bytes(f) + weight_bytes(h))
        b_ms, b_by = bound(flops, nbytes)
        log(f"  B2 deit_s S={s}: kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, eager "
            f"last layer + LN_f + head {e_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by})")
        if s == 99:
            kernel_ms["b2"], bounds["b2"] = (k_ms, p_ms, e_ms), (b_ms, b_by)
    x = torch.randn(512, 197, cfg.hidden_size, generator=gen).to(dev, bf)
    mask = random_mask(512, 197, torch.full((512,), 99))  # topk50's bucket, every image full
    dest = compact_dest(mask)
    k_ms, p_ms = abba(
        lambda: kl.fused_vit_layer_bucketed(x, lp, dest, mask, 99, cfg.num_heads),
        lambda: kl.fused_vit_layer_bucketed_ref(x, lp, dest, mask, 99, cfg.num_heads))
    with kernel_mode("eager"):  # index gather, cuBLAS bf16 masked layer at 99, scatter
        e_ms = time_ms(lambda: tp.bucketed_masked_layer(x, lp, mask, cfg, cap_hint=99))
    counts = mask.sum(-1).long()
    b_ms, b_by = bound(layer_work(cfg, int(counts.sum()), cfg.num_heads * int((counts ** 2).sum())),
                       2 * x.numel() * x.element_size() + dest.numel() * 5 + weight_bytes(lp))
    log(f"  B3 deit_s S=197 cap=99: kernel {k_ms:.3f} ms, plain version {p_ms:.3f} ms, eager "
        f"bucketed layer {e_ms:.3f} ms; bound {b_ms:.4f} ms ({b_by})")
    kernel_ms["b3"], bounds["b3"] = (k_ms, p_ms, e_ms), (b_ms, b_by)

    # --- 7. records ------------------------------------------------------------------
    import importlib
    import pkgutil
    from pathlib import Path

    import vit_pruning_tpu_torch as port

    for mod in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
        importlib.import_module(mod.name)
    port_dir = Path(port.__file__).resolve().parent
    jax_dir = port_dir.parent / "vit_pruning_tpu"
    jax_loaded = sorted(m for m in sys.modules
                        if m == "jax" or m.split(".")[0] in ("jax", "vit_pruning_tpu"))
    jax_files = sorted(n for n, m in list(sys.modules.items())
                       if jax_dir in Path(getattr(m, "__file__", None) or "/").resolve().parents)
    if jax_loaded or jax_files:
        raise AssertionError(f"the port loaded jax or the JAX package: {(jax_loaded + jax_files)[:5]}")
    for src in sorted(port_dir.rglob("*.py")):
        text = src.read_text()
        for needle in ('"vit_pruning_tpu"', "'vit_pruning_tpu'", '"vit_pruning_tpu/',
                       "spec_from_file_location", "exec_module"):
            if needle in text:
                raise AssertionError(f"{src}: builds a path into the JAX package ({needle})")
    pkg = "vit_pruning_tpu_torch"
    rows = (("b1", "fused_vit_layer", 359, launches["b1"] + launches["b1_redecide"]),
            ("b2", "fused_vit_layer_cls_logits", 561, launches["b2"]),
            ("b3", "fused_vit_layer_bucketed", 761, launches["b3"]))
    kernels = [
        {"name": name, "route": "cuda", "source": f"{pkg}/csrc/layer.cu",
         "replaces": f"vit_pruning_tpu/ops/pallas/layer.py:{line}", "launches": n,
         "max_abs_err": err[key], "ms": kernel_ms[key][0], "plain_ms": kernel_ms[key][1],
         "bound_ms": bounds[key][0], "bound_by": bounds[key][1], "library_ms": kernel_ms[key][2]}
        for key, name, line, n in rows
    ]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
