"""Accuracy-delta quality gate of the PyTorch/CUDA port (vit_pruning_tpu_torch).

The port's counterpart of quality.py, with the same flags, gates, presets,
JSON line and exit code, run through the port's training and evaluation on
the card (`--device cuda`, the default) or the CPU (`--device cpu`).
`--kernels eager` (the default, the counterpart of quality.py's `xla`) pins
the plain PyTorch path; `--kernels auto` runs the CUDA kernels (B1 / B5
under autograd in training; B1-B4 in evaluation). The synthetic datasets
are cached under the temp directory (or --cache_dir) with keys of their own.

    python quality_torch.py [--preset headline|composed|mask|ultra|both|all]
                            [--kernels eager|auto] [--device cuda|cpu]

What follows is quality.py's own description of the gate.

Accuracy-delta quality gate (SURVEY §7 step 8, VERDICT r1 item 4).

Round-1's gate compared two models that both sat at 100% on a separable
synthetic task — a delta gate at the accuracy ceiling can't fail. This gate
uses `synthetic_localized_dataset`: 128 classes, irreducible label noise, and
class evidence localized in a few patch cells on a noise background, so the
dense model converges strictly below 95% and pruning the wrong tokens costs
real accuracy.

Gates per pruned preset (reference anchors in BASELINE.md):
  (a) headline: top-1 delta vs the dense baseline <= --max_drop (0.5%
      default, the north-star budget), for both bf16 and int8 serving;
  (b) predictor-vs-oracle accuracy >= --min_predictor_acc (reference runs
      land at ~85-91%, himanshu/stats.csv col 3) — headline preset only
      (the composed preset's deep schedule keeps far fewer tokens than the
      oracle marks, so executed-mask-vs-oracle accuracy is not comparable);
  (c) measured skip within --skip_tol of the configured target;
  (d) composed: TOKEN-SKIP cost (vs the same recovered weights with token
      skip off) <= --composed_max_drop; the structural capacity cost is
      reported (structural_top1/capacity_cost) but not gated — a tiny
      from-scratch gate model wildly overstates what a pretrained DeiT-S
      pays for halving heads/channels, while the token mechanism's cost
      transfers.

Presets: 'headline' = 50% top-k token skip (the bench.py default config);
'composed' = structured pruning (half heads, half MLP channels, trained from
init) + the aggressive keep schedule — the 3x+ throughput configuration whose
accuracy budget round 1 left unvalidated; 'mask' = the headline's trained
predictor SERVED through the thresholded mask path with the per-image budget
cap (the exact config of bench.py's `--mode mask --mask_budget --mask_calibrate`
row) — same weights, different serving semantics, so it reuses the in-run
headline or --headline_ckpt instead of retraining. 'both' runs
headline+composed; 'all' runs all three.

--data_path <dir with cifar-100-python/> runs the same gate flow on real
CIFAR-100 at the gate-model scale (32x32 inputs). The full reference
reproduction (ViT-B/16 @224 from the pretrained checkpoint, anchor 89.85%
dense / 88.91% pruned, BASELINE.md) goes through `cli.py train --model
vit_base --dataset cifar100 --torch_checkpoint ...` — this file gates
presets, it does not fine-tune ViT-B.

Prints one JSON line on stdout; detail on stderr. Exit 0 iff every gate of
every requested preset passes.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile

import numpy as np
import torch

from vit_pruning_tpu_torch.checkpoint import _clone
from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
from vit_pruning_tpu_torch.data.datasets import (
    DeviceBatches,
    load_cifar100,
    synthetic_distributed_dataset,
    synthetic_localized_dataset,
)
from vit_pruning_tpu_torch.models.convert import check_device, flatten_tree
from vit_pruning_tpu_torch.models.pruned_vit import (
    init_pruned_vit_params,
    pruned_vit_forward,
)
from vit_pruning_tpu_torch.train.harness import _device_of, evaluate


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _init_params(config, pcfg, device, seed: int = 42) -> dict:
    """init_pruned_vit_params from a torch.Generator seeded `seed` (the
    reference's PRNGKey(42) inits)."""
    return init_pruned_vit_params(config, pcfg, torch.Generator().manual_seed(seed), device)


def _generator(params: dict, seed: int = 0) -> torch.Generator:
    """The reference's rng=PRNGKey(0) for mode 'random'."""
    return torch.Generator(device=_device_of(params)).manual_seed(seed)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0):
    """optax.warmup_cosine_decay_schedule as a function of the step count
    (0 at the first update), what the port's Adam takes as its lr: a linear
    ramp init -> peak over warmup_steps, then a cosine decay to end_value at
    decay_steps, held there. optax's formulas in Python floats (float64)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1.0 - alpha) * decay ** exponent + alpha)

    return schedule


# Bumped whenever the gate adds/renames recorded fields. Sections written by
# --merge_into are stamped and VALIDATED against this version, so a section
# half-regenerated under an older gate (e.g. round 4's ultra row, which
# predated the predictor_capture gate and silently lacked its fields —
# VERDICT r4 weak #5) can no longer land in quality_results.json.
SCHEMA_VERSION = 2


def validate_section(section: dict, name: str = "<top>") -> list[str]:
    """Current-schema check for one results section. Returns a list of
    problems (empty = valid). Enforced at --merge_into time and by
    tests/test_artifacts.py on the committed quality_results.json."""
    problems = []
    if section.get("schema_version") != SCHEMA_VERSION:
        problems.append(
            f"{name}: schema_version {section.get('schema_version')} != "
            f"current {SCHEMA_VERSION} (regenerate with this quality.py)")
    for key in ("dense_top1", "dense_top1_int8", "dataset", "gate_model",
                "image_size", "gate_max_drop", "presets", "pass"):
        if key not in section:
            problems.append(f"{name}: missing field {key!r}")
    for pname, row in (section.get("presets") or {}).items():
        where = f"{name}.presets.{pname}"
        for key in ("serving_config", "pruned_top1", "pruned_top1_int8",
                    "delta", "delta_int8", "dense_top1", "budget",
                    "measured_skip", "target_skip", "gates", "pass"):
            if key not in row:
                problems.append(f"{where}: missing field {key!r}")
        sc = row.get("serving_config") or {}
        # every structured/deep-schedule mse_attention preset must carry the
        # per-layer capture fields its gate reads
        if (sc.get("mode") == "topk_prog" and sc.get("keep_schedule")
                and sc.get("loss") == "mse_attention"):
            for key in ("predictor_capture_min", "predictor_capture_per_layer"):
                if key not in row:
                    problems.append(f"{where}: structured preset missing "
                                    f"{key!r} (capture gate fields)")
            if "predictor_capture" not in (row.get("gates") or {}):
                problems.append(f"{where}: gates missing 'predictor_capture'")
    return problems


def _cached_synthetic(n, image_size, num_labels, *, seed, label_noise,
                      signal_patches, cell, task="localized", directory=None):
    """Disk-cached synthetic_{localized,distributed}_dataset. The 224-scale
    build is pure host numpy (minutes for the 8192-image train split) and
    fully determined by its arguments, so caching is byte-exact. The cache
    lives in `directory` (--cache_dir), else the temp directory (ephemeral by
    design), under keys of the port's own ('torch-v1:' prefix, 'torch_synth_'
    file names)."""
    import hashlib

    key = hashlib.sha1(
        f"torch-v1:{n}:{image_size}:{num_labels}:{seed}:{label_noise}:"
        f"{signal_patches}:{cell}:{task}".encode()
    ).hexdigest()[:16]
    path = os.path.join(directory or tempfile.gettempdir(), f"torch_synth_{task}_{key}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["images"], z["labels"]
    gen = (synthetic_distributed_dataset if task == "distributed"
           else synthetic_localized_dataset)
    images, labels = gen(
        n, image_size, num_labels, seed=seed, label_noise=label_noise,
        signal_patches=signal_patches, cell=cell,
    )
    try:
        # atomic publish: a run killed mid-savez (the 224-scale npz is
        # ~1 GB) must not leave a half-written file that a later run's
        # os.path.exists check would trust
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path[:-len('.npz')]}.tmp.{os.getpid()}.npz"
        np.savez(tmp, images=images, labels=labels)
        os.replace(tmp, path)
    except OSError as e:  # disk-full etc. — cache is an optimization only
        log(f"dataset cache write failed ({e}); continuing uncached")
    return images, labels


def build_task(args):
    if args.gate_model != "gate":
        # bench scale (VERDICT r2 #1): the EXACT geometry bench.py measures —
        # DeiT-S/B and ViT-L @224 — so the accuracy gates and the composed
        # throughput claims attach to the same model
        from vit_pruning_tpu_torch.configs import (
            deit_base, deit_small, vit_huge, vit_large)

        factory = {"deit_small": deit_small, "deit_base": deit_base,
                   "vit_large": vit_large, "vit_huge": vit_huge}
        labels = getattr(args, "num_labels", None) or 128
        config = factory[args.gate_model](num_labels=labels).replace(
            image_size=args.image_size or 224
        )
    else:
        config = ViTConfig(
            image_size=args.image_size or 32, patch_size=4, hidden_size=128,
            num_layers=6, num_heads=4, mlp_dim=256,
            num_labels=getattr(args, "num_labels", None) or 128,
        )  # 64 patches; big enough for pruning to matter, small enough to train fast
    if args.data_path:
        config = config.replace(num_labels=100)
        tr = load_cifar100(args.data_path, train=True, size=args.train_size)
        te = load_cifar100(args.data_path, train=False, size=args.test_size)
    else:
        # signal cells sized/counted to the model's patch grid so the task
        # structure (1 cell == 1 ViT patch, ~12.5% of patches carry class
        # evidence) is scale-invariant; at the gate default (patch 4, 64
        # patches) these resolve to the round-2 values (cell=4, 8 cells)
        cell = config.patch_size
        task = getattr(args, "task", "localized")
        default_signal = (8 if task == "distributed"
                          else max(8, config.num_patches // 8))
        signal = getattr(args, "signal_patches", None) or default_signal
        tr = _cached_synthetic(
            args.train_size, config.image_size, config.num_labels,
            seed=0, label_noise=args.label_noise,
            signal_patches=signal, cell=cell, task=task,
            directory=getattr(args, "cache_dir", None),
        )
        te = _cached_synthetic(
            args.test_size, config.image_size, config.num_labels,
            seed=1, label_noise=args.label_noise,
            signal_patches=signal, cell=cell, task=task,
            directory=getattr(args, "cache_dir", None),
        )
    # device-resident batches: the uint8 images are uploaded once and each
    # batch is gathered and preprocessed on the card
    device = getattr(args, "device", "cuda")
    train_b = DeviceBatches(*tr, batch_size=args.batch, image_size=config.image_size,
                            shuffle=True, seed=42, device=device)
    test_b = DeviceBatches(*te, batch_size=args.batch, image_size=config.image_size,
                           device=device)
    return config, train_b, test_b


def calibrate_sim_threshold(params, batch, config, pcfg):
    """PER-LAYER median oracle similarity over one probe batch — puts every
    layer's oracle keep-rate near 50%, making the predictor-vs-oracle
    accuracy gate meaningful on a from-scratch backbone. A single global
    threshold (the reference's fixed 0.9 assumes a pretrained CIFAR-100
    checkpoint) gives wildly skewed per-layer base rates here (early layers
    ~98% keep, late layers ~3%), which caps agreement with the executed
    top-k mask (exactly 50% keep per layer) at the base-rate overlap no
    matter how good the predictor is."""
    with torch.no_grad():
        out = pruned_vit_forward(
            params, batch["pixel_values"], config, pcfg, compute_oracle=True,
            generator=_generator(params),
        )
    sim = out["aux"]["similarity"].float().cpu().numpy()  # [L, B, N]
    return tuple(float(v) for v in np.median(sim, axis=(1, 2)))


def calibrate_mlp_threshold(params, batch, config, pcfg):
    """Per-layer predictor thresholds matched to each layer's oracle
    keep-rate on a probe batch. BCE-trained scores are not calibrated
    probabilities (the double-sigmoid quirk, losses.py) — at a fixed 0.5
    threshold the M19 tables show e.g. skip_acc 50% / keep_acc 94%, i.e.
    the predictor ranks well but keeps far too much. Matching predicted and
    oracle keep-rates per layer is the reference's mlp_threshold
    hyperparameter tuned the systematic way."""
    with torch.no_grad():
        out = pruned_vit_forward(
            params, batch["pixel_values"], config, pcfg.replace(mode="mask"),
            compute_oracle=True, generator=_generator(params),
        )
    scores = out["scores"].float().cpu().numpy()            # [L, B, N]
    keep = out["aux"]["oracle_keep"].float().cpu().numpy()  # [L, B, N]
    return tuple(
        float(np.quantile(scores[l], 1.0 - keep[l].mean()))
        for l in range(scores.shape[0])
    )


def calibrate_serving_mask_threshold(params, batch, config, pcfg, keep_rate):
    """Per-layer SCORE quantiles that pin the thresholded keep-rate near
    keep_rate — bench.py's `--mask_calibrate` semantics (bench.py:269-288),
    at the gate's target rate instead of the fixed median. Probed on a
    dense measure_only pass (M13 semantics: masks/scores computed, dense
    execution); cascade drift from re-thresholding upstream layers is
    accepted — the skip gate (c) verifies the measured density."""
    probe_cfg = pcfg.replace(mode="mask", mlp_threshold=0.5, mask_budget=None,
                             keep_schedule=None, measure_only=True)
    with torch.no_grad():
        out = pruned_vit_forward(params, batch["pixel_values"], config, probe_cfg)
    scores = out["scores"].float().cpu().numpy()  # [L, B, N]
    return tuple(float(np.quantile(scores[l], 1.0 - keep_rate))
                 for l in range(scores.shape[0]))


def attention_topk_agreement(params, test_b, config, pcfg):
    """Predictor fidelity for M7-recipe (mse_attention) predictors.

    Measured at the layers where the serving schedule actually DECIDES
    (keep_schedule drop points; layer 0 for a plain top_k config) — grading
    re-decisions at layers the deployed config never re-decides would mix in
    deep layers whose CLS-attention is near-uniform, where top-k set
    membership is tie-noise with no accuracy consequence.

    Primary metric: attention-MASS capture — the fraction of the true
    CLS-attention mass captured by the predictor's kept set, relative to the
    mass the true top-k set captures (1.0 = the kept tokens carry as much
    attention as an oracle top-k selection; the quantity the reference's
    selection maximizes, pradeep/using_attention.py:136-147). Also returns
    top-k SET agreement at those layers for reference — |pred ∩ true| / k
    (NOT positionwise mask equality, which counts true negatives and reads
    ~0.9 for disjoint sets at k << N).

    Returns (mass_capture, set_agreement, capture_by_layer) — the third is
    {layer_index: mean capture at that decide layer}, so deep-schedule
    presets can be GATED on their weakest drop layer instead of a mean that
    a strong layer 0 can mask (VERDICT r3 #2).
    """
    from vit_pruning_tpu_torch.models.pruned_vit import _is_active
    from vit_pruning_tpu_torch.ops.masking import rank_keep_mask

    L = config.num_layers
    sched = pcfg.keep_schedule or tuple([pcfg.top_k] + [0] * (L - 1))
    # only layers where the serving schedule actually decides: a drop entry
    # at a layer active_layers disables never re-decides, and the eval
    # forward's inactive branch returns dummy scores that would grade as 0
    decide_layers = [i for i, k in enumerate(sched)
                     if k and _is_active(pcfg, i)]
    if not decide_layers:
        # np.mean([]) would put NaN into predictor_accuracy and the JSON
        # (json.dumps emits non-standard NaN); fail loudly instead — a
        # config whose schedule never decides has no predictor fidelity to
        # measure
        raise ValueError(
            "attention_topk_agreement: the serving schedule has no active "
            f"decide layers (keep_schedule={sched}, "
            f"active_layers={pcfg.active_layers}); predictor fidelity is "
            "undefined for this config")

    p_eval = pcfg.replace(mode="topk", keep_schedule=None)
    capture = {i: [] for i in decide_layers}
    agree = []
    for batch in test_b:
        with torch.no_grad():
            out = pruned_vit_forward(params, batch["pixel_values"], config, p_eval,
                                     compute_oracle=True, generator=_generator(params))
        for i in decide_layers:
            k = sched[i]
            t_dev = out["aux"]["attn_target"][i]  # [B, N]
            t = t_dev.double().cpu().numpy()
            pred = rank_keep_mask(out["scores"][i], k).cpu().numpy()
            true = rank_keep_mask(t_dev, k).cpu().numpy()
            capture[i].append(float(np.mean(
                (t * pred).sum(-1) / np.maximum((t * true).sum(-1), 1e-12))))
            agree.append(float(np.mean((pred & true).sum(-1) / k)))
    by_layer = {i: float(np.mean(v)) for i, v in capture.items()}
    return (float(np.mean(list(by_layer.values()))), float(np.mean(agree)),
            by_layer)


def _same_tree_shapes(a, b) -> bool:
    """True when two pytrees have identical structure and leaf shapes (the
    predictor-inheritance precondition in train_and_eval)."""
    fa, fb = flatten_tree(a), flatten_tree(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        return False
    return all(x.shape == y.shape for (_, x), (_, y) in zip(fa, fb))


def margin_sweep(params, dense_acc, config, test_b, args, log):
    """Serve the TRAINED headline weights through progressively deeper
    schedules until the delta gate fails (VERDICT r3 #2): every preset
    passing with exactly 0.0 delta is consistent with both 'presets are
    accurate' and 'task saturated at this scale' — the margin curve
    distinguishes them by locating where the task starts charging for
    skipping. Two families:

      single_drop  — the headline family at shrinking budgets: one drop to
                     top-k at layer 0 (reference M7 semantics at depth).
      progressive  — the ultra_schedule shape scaled m× deeper.

    Same weights, same predictor scores; only the kept-set size changes.
    Returns the gate_margin record for quality_results.json.
    """
    from vit_pruning_tpu_torch.configs import schedule_live

    n, L = config.num_patches, config.num_layers
    rows = []
    fails = 0
    for frac in (0.5, 0.375, 0.25, 0.1875, 0.125, 0.09,
                 0.0625, 0.045, 0.03, 0.015):
        k = max(1, int(round(n * frac)))
        pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp",
                           loss="mse_attention", top_k=k,
                           predictor_hidden=args.predictor_hidden)
        acc, _, _ = evaluate(params, test_b, config, pcfg, full_testing=False)
        row = {"family": "single_drop", "top_k": k,
               "skip": round(1.0 - (k + 1) / (n + 1), 4),
               "top1": round(acc, 4), "delta": round(dense_acc - acc, 4),
               "pass": bool(dense_acc - acc <= args.max_drop)}
        rows.append(row)
        log(f"margin {row}")
        fails += 0 if row["pass"] else 1
        if fails >= 3:
            break  # curve has clearly crossed; deeper points add nothing
    for m in (1, 2, 4, 8):
        # ultra_schedule shape at m x depth (m=1 IS the ultra schedule)
        sched = tuple(
            [max(1, n // (2 * m))] + [max(1, n // (6 * m))] * min(4, L - 1)
            + [max(1, n // (12 * m))] * max(0, L - 5))
        pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp",
                           loss="mse_attention", top_k=sched[0],
                           keep_schedule=sched,
                           predictor_hidden=args.predictor_hidden)
        live = [v - 1 for v in schedule_live(sched, n)]
        acc, _, _ = evaluate(params, test_b, config, pcfg, full_testing=False)
        row = {"family": "progressive", "schedule": list(sched),
               "skip": round(1.0 - sum(live) / len(live) / n, 4),
               "top1": round(acc, 4), "delta": round(dense_acc - acc, 4),
               "pass": bool(dense_acc - acc <= args.max_drop)}
        rows.append(row)
        log(f"margin {row}")
    single = [r for r in rows if r["family"] == "single_drop"]
    passing = [r["skip"] for r in single if r["pass"]]
    failing = [r["skip"] for r in single if not r["pass"]]
    return {
        "max_drop": args.max_drop,
        "dense_top1": round(dense_acc, 4),
        "rows": rows,
        "deepest_passing_skip": max(passing) if passing else None,
        "first_failing_skip": min(failing) if failing else None,
        "gate_can_fail": bool(any(not r["pass"] for r in rows)),
    }


def train_and_eval(config, pcfg, train_b, test_b, args, log,
                   base_params=None, structured=False, teacher=None):
    """The reference's phased recipe (hi_main.py:161-168) on a trained
    backbone: predictor phase ('cosine') against the converged backbone's
    oracle, THEN backbone fine-tune under the now-trained masks
    ('classification'). Training the backbone under an UNTRAINED predictor's
    masks first and the predictor after inverts the dependency — the masks
    shift under the adapted backbone and serving accuracy collapses
    (measured: 35% vs 90% dense).

    base_params: the trained model to start from — the dense baseline for
    the headline preset, the trained headline model for the composed preset
    (which physically prunes it and fine-tunes). None = dense from-scratch
    training (the baseline itself)."""
    from vit_pruning_tpu_torch.train import harness

    compute_dtype = torch.bfloat16 if args.bf16 else None
    device = getattr(args, "device", "cuda")
    # rematerialized training for the wide gate models (ViT-L / ViT-H): with
    # remat the residuals held for the backward are per-layer inputs only
    remat = getattr(args, "remat", "auto")
    use_remat = remat == "on" or (
        remat == "auto" and args.gate_model in ("vit_large", "vit_huge"))
    eval_cfg = config
    inherit_pred = False
    if base_params is not None:
        params = _clone(base_params)
        if pcfg.predictor != "none":
            fresh = _init_params(config, pcfg, _device_of(base_params))
            inherited = base_params.get("predictor")
            if (structured and inherited is not None
                    and not getattr(args, "fresh_structured_predictor", False)
                    and _same_tree_shapes(inherited, fresh["predictor"])):
                # INHERIT the base's trained predictor for structured
                # presets instead of re-training fresh heads at the deep
                # schedule. Measured on the distributed task (DeiT-S @224,
                # r5, quality_results.json::deit_small_224_distributed):
                # fresh re-training at composed/ultra depth collapses
                # attention-mass capture (min 0.42/0.43) and serves
                # 0.776/0.714; inheriting the headline's trained predictor
                # serves 0.857/0.804 at the same depths (+8.1/+9.0 points)
                # — the deep-schedule mse_attention signal (CLS attention
                # of a just-recovered structured backbone) is a worse
                # teacher than the converged dense model's. Predictor heads
                # read token content only (input dim D is unchanged by
                # head/channel pruning), so the weights transfer as-is; the
                # recovery fine-tune then adapts the backbone UNDER the
                # trained masks (the reference's phase-2 order,
                # hi_main.py:167-168).
                params = {**fresh, "backbone": params["backbone"],
                          "predictor": _clone(inherited)}
                inherit_pred = True
                log("structured preset: inheriting the trained predictor "
                    "(predictor re-training phase skipped; "
                    "--fresh_structured_predictor restores the old recipe)")
            else:
                # fresh predictor heads over the inherited backbone
                # (hi_main.py:130-137 strict=False load: heads start random)
                params = {**fresh, "backbone": params["backbone"]}
    else:
        params = _init_params(config, pcfg, device)
    if structured:
        from vit_pruning_tpu_torch.ops.structured import (
            channel_importance,
            head_importance,
            prune_heads,
            prune_mlp_channels,
        )

        # importance-guided selection (keep the strongest half), not
        # arbitrary every-other indices: heads by CLS-attention mass on a
        # probe batch, channels by weight-magnitude gain
        probe = next(iter(train_b))
        with torch.no_grad():
            hi = head_importance(params["backbone"], probe["pixel_values"],
                                 config).cpu().numpy()
            ci = channel_importance(params["backbone"]).cpu().numpy()
            keep_h = [
                sorted(np.argsort(-hi[l], kind="stable")[: config.num_heads // 2].tolist())
                for l in range(config.num_layers)
            ]
            keep_c = [
                sorted(np.argsort(-ci[l], kind="stable")[: config.mlp_dim // 2].tolist())
                for l in range(config.num_layers)
            ]
            bb, eval_cfg = prune_heads(params["backbone"], config, keep_h)
            params["backbone"] = prune_mlp_channels(bb, keep_c)

    if base_params is None:
        # dense baseline: plain from-scratch classification training. At
        # gate scale a constant lr converges fast; a from-scratch DeiT-S
        # @224 sits at chance without warmup (measured: 0.88% after 5
        # epochs at constant 3e-4), so the bench-scale gate uses the
        # standard ViT recipe piece — linear warmup + cosine decay.
        clip = None
        if args.gate_model != "gate":
            # the standard DeiT-from-scratch stabilizers: batch-scaled peak
            # lr (5e-4 x bs/512), 5-epoch linear warmup, cosine decay,
            # global-norm-1 gradient clipping
            steps = args.epochs * len(train_b)
            peak = 5e-4 * args.batch / 512
            lr_dense = warmup_cosine_decay_schedule(
                0.0, peak, max(1, min(5 * len(train_b), steps // 3)),
                steps, peak * 0.01
            )
            clip = 1.0
        else:
            lr_dense = 3e-4
        params = harness.train(
            params, train_b, test_b, eval_cfg, pcfg,
            num_epochs=args.epochs, loss_type="classification", lr=lr_dense,
            full_testing=False, log=log, compute_dtype=compute_dtype,
            clip_norm=clip, remat=use_remat,
        )
    if pcfg.predictor != "none" and not inherit_pred:
        # phase 1: calibrate the oracle on the trained backbone, train the
        # predictor only (reference 'cosine' phase, hi_main.py:164-165).
        # Keep the BEST-serving-accuracy epoch, not the last (the reference
        # checkpoints best, main_model_utils.py:179-185): at deep composed
        # schedules, late predictor epochs over-fit the oracle and serving
        # accuracy sinks 78% -> 42% while oracle agreement keeps climbing.
        from vit_pruning_tpu_torch.checkpoint import BestCheckpoint

        probe = next(iter(train_b))
        st = calibrate_sim_threshold(params, probe, eval_cfg, pcfg)
        pcfg = pcfg.replace(sim_threshold=st)
        log("calibrated per-layer sim_threshold = "
            + ", ".join(f"{v:.3f}" for v in st))
        # oracle-forced (M3) serving accuracy at the calibrated thresholds:
        # the ceiling for any predictor that matches THIS oracle. If this is
        # far below dense, the similarity oracle itself is misaligned with
        # class evidence at this scale and a different training signal
        # (--headline_loss mse_attention) is needed, not a better predictor.
        oracle_acc, _, _ = evaluate(params, test_b, eval_cfg,
                                    pcfg.replace(mode="oracle"),
                                    full_testing=False)
        log(f"oracle-forced (M3) serving top-1 at calibrated thresholds: "
            f"{oracle_acc:.4f}")
        best = BestCheckpoint()
        params = harness.train(
            params, train_b, test_b, eval_cfg, pcfg,
            num_epochs=args.pred_epochs, loss_type="cosine", lr=args.pred_lr,
            full_testing=False, log=log, best=best,
            compute_dtype=compute_dtype, remat=use_remat,
        )
        # Fall back to the best epoch only on SEVERE degradation: the
        # fully-trained (last-epoch) predictor has the best oracle
        # agreement, and mild serving-accuracy sag is recovered by the
        # fine-tune phase; the composed schedules' 78%->42% collapse is not.
        last_acc, _, _ = evaluate(params, test_b, eval_cfg, pcfg,
                                  full_testing=False)
        if best.best_params is not None and best.best_accuracy - last_acc > 0.03:
            log(f"predictor phase degraded {best.best_accuracy:.2%} -> "
                f"{last_acc:.2%}; reverting to the best epoch")
            params = best.best_params
    if base_params is not None:
        # phase 2: backbone fine-tune under the trained masks (reference
        # 'classification' phase at a lower lr, hi_main.py:167-168); also
        # the recovery phase after physical head/channel removal. The dense
        # teacher distills its logits into the pruned student; best epoch
        # kept, as in the reference.
        from vit_pruning_tpu_torch.checkpoint import BestCheckpoint

        distill = None
        if teacher is not None:
            t_params, t_config = teacher
            distill = (t_params, t_config, 0.5, 2.0)
        best = BestCheckpoint()
        params = harness.train(
            params, train_b, test_b, eval_cfg, pcfg,
            num_epochs=(args.recover_epochs if structured
                        else max(2, args.epochs // 2)),
            loss_type="classification",
            lr=1e-4,
            full_testing=False, log=log, distill=distill, best=best,
            compute_dtype=compute_dtype, remat=use_remat,
        )
        if best.best_params is not None:
            params = best.best_params

    return measure_preset(params, eval_cfg, pcfg, train_b, test_b, args,
                          log, structured)


def measure_preset(params, eval_cfg, pcfg, train_b, test_b, args, log,
                   structured):
    """All post-training measurements for a trained preset: serving-path
    accuracy (bf16 + int8), measured skip, predictor fidelity, and the
    structured capacity control. Split from train_and_eval so a preset
    restored from --headline_ckpt can be re-measured (e.g. after a fidelity
    -metric change) without retraining."""
    # serving-semantics accuracy + measured skip (progressive path for
    # topk_prog — the configuration the throughput claims are made on)
    acc, _, a0 = evaluate(params, test_b, eval_cfg, pcfg, full_testing=False)
    # int8 serving accuracy (kernel B4 under --kernels auto on the card,
    # ops/quant.py's plain int8 layer under eager)
    from vit_pruning_tpu_torch.ops.dispatch import quant_mode

    with quant_mode("int8"):
        acc_i8, _, _ = evaluate(params, test_b, eval_cfg, pcfg, full_testing=False)
    mlp_acc, skip, pred_extra = None, None, {}
    if pcfg.mode != "none":
        skip = float(a0.measured_skip_per_layer.mean())
        # Predictor-vs-oracle accuracy measured the REFERENCE's way: the
        # thresholded predictor mask vs oracle labels (mask mode,
        # model_utils.py:109-113 / stats.csv col 3). Under top-k the
        # executed mask is forced to exactly k keeps per image, so
        # per-image oracle-count mismatch caps agreement regardless of
        # predictor quality — that cap is a property of the serving
        # config, not of the predictor the gate is grading. Thresholds are
        # calibrated per layer first (see calibrate_mlp_threshold).
        if pcfg.loss == "mse_attention":
            # M7-recipe predictors are trained to rank by CLS-attention
            # mass, not to label the similarity oracle — measure fidelity
            # against the signal they were trained on, at the layers the
            # schedule actually decides: attention-mass capture (primary)
            # + top-k set agreement (reported)
            mlp_acc, set_agree, by_layer = attention_topk_agreement(
                params, test_b, eval_cfg, pcfg)
            pred_extra["predictor_set_agreement"] = round(set_agree, 4)
            pred_extra["predictor_capture_per_layer"] = {
                str(i): round(v, 4) for i, v in by_layer.items()}
            pred_extra["predictor_capture_min"] = round(min(by_layer.values()), 4)
            log(f"predictor fidelity: attention-mass capture {mlp_acc:.4f} "
                f"(per-layer min {min(by_layer.values()):.4f} at layer "
                f"{min(by_layer, key=by_layer.get)}), "
                f"top-k set agreement {set_agree:.4f} "
                f"(decide layers of the serving schedule)")
        else:
            probe = next(iter(train_b))
            mt = calibrate_mlp_threshold(params, probe, eval_cfg, pcfg)
            log("calibrated per-layer mlp_threshold = "
                + ", ".join(f"{v:.3f}" for v in mt))
            _, mlp_acc, _ = evaluate(
                params, test_b, eval_cfg,
                pcfg.replace(mode="mask", mlp_threshold=mt),
                full_testing=True,
            )
    if pcfg.mode == "topk_prog" and (
        pcfg.merge_dropped or getattr(args, "merge_ablation", False)
    ):
        # merge ablation: the SAME trained weights served with the merge
        # setting flipped (identical selection; only the kept tokens'
        # values change) — merge_gain = merged - unmerged is what would
        # justify merge's +2-14% serving cost (RESULTS.md §merge_dropped;
        # at gate scale it measures NEGATIVE: the synthetic task's dropped
        # background patches are noise by construction). Runs here, not in
        # main(), because structured presets physically prune heads and
        # only this scope has the pruned eval_cfg.
        acc_var, _, _ = evaluate(
            params, test_b, eval_cfg,
            pcfg.replace(merge_dropped=not pcfg.merge_dropped),
            full_testing=False)
        merged_acc, unmerged_acc = (
            (acc, acc_var) if pcfg.merge_dropped else (acc_var, acc))
        if pcfg.merge_dropped:
            pred_extra["pruned_top1_nomerge"] = round(unmerged_acc, 4)
        else:
            pred_extra["pruned_top1_merged"] = round(merged_acc, 4)
        pred_extra["merge_gain"] = round(merged_acc - unmerged_acc, 4)
        log(f"merge ablation — merged {merged_acc:.4f} vs unmerged "
            f"{unmerged_acc:.4f} (gain {merged_acc - unmerged_acc:+.4f})")
    acc_structural = None
    if structured:
        # capacity control: the SAME recovered weights evaluated without
        # token skipping — separates the structural-halving capacity cost
        # (paid by any head/channel pruning, heavily overstated on a tiny
        # from-scratch gate model) from the token-skip mechanism's own cost,
        # which is what this framework adds and what the composed gate holds
        # to budget
        acc_structural, _, _ = evaluate(
            params, test_b, eval_cfg,
            PruneConfig(mode="none", predictor="none"), full_testing=False,
        )
    return acc, acc_i8, mlp_acc, skip, acc_structural, params, pred_extra


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset",
                    choices=["headline", "composed", "mask", "ultra",
                             "both", "all"],
                    default="headline",
                    help="'both' = headline+composed (round-2 surface); "
                    "'all' = headline+mask+composed+ultra (every serving "
                    "preset in one section — current-schema rows for all "
                    "four); 'ultra' alone = the deeper ultra_schedule "
                    "(passes the gate unmerged; add --merge_dropped to "
                    "measure the merge-compaction variant and its ablation)")
    ap.add_argument("--skip", type=float, default=0.5)
    ap.add_argument("--max_drop", type=float, default=0.005)
    ap.add_argument("--min_predictor_acc", type=float, default=0.85)
    ap.add_argument("--min_layer_capture", type=float, default=0.70,
                    help="deep-schedule (composed/ultra) predictor gate: "
                    "attention-mass capture at EVERY drop layer of the "
                    "serving schedule must be at least this (VERDICT r3 #2 "
                    "— promotes the previously-informational fidelity "
                    "numbers to a gated bar)")
    ap.add_argument("--signal_patches", type=int, default=None,
                    help="synthetic-task hardness override: number of patch "
                    "cells carrying class evidence (default: "
                    "max(8, num_patches//8) localized, 8 distributed); "
                    "shrink it to make the margin sweep bite earlier")
    ap.add_argument("--num_labels", type=int, default=None,
                    help="synthetic-task class-count override (default 128). "
                    "For --task distributed this sets the integration "
                    "threshold: identifying one of C classes needs "
                    "~log2(C)/log2(vocab) evidence cells kept through the "
                    "drop layer — and bounds learnability (train_size/C "
                    "samples per class); 128 classes at the default 8192 "
                    "train images measured 7%% dense top-1 after 10 epochs "
                    "(unlearnable at this budget), 16 classes converge")
    ap.add_argument("--task", choices=["localized", "distributed"],
                    default="localized",
                    help="synthetic gate task: 'localized' (class-unique "
                    "patterns — single-cell separable, so the depth sweep "
                    "measures 0.0 delta through 98%% skip) or 'distributed' "
                    "(class = a codeword across shared evidence cells — "
                    "needs ~log2(C) cells kept through the drop layer, so "
                    "deep budgets genuinely lose information and the margin "
                    "sweep locates the breaking point)")
    ap.add_argument("--margin_sweep", action="store_true",
                    help="after the headline preset, serve its trained "
                    "weights through progressively deeper schedules until "
                    "the accuracy gate FAILS; records the delta-vs-depth "
                    "curve as results['gate_margin'] (VERDICT r3 #2 — "
                    "proves the gate can fail at this scale)")
    ap.add_argument("--fresh_structured_predictor", action="store_true",
                    help="structured presets re-train fresh predictor heads "
                    "at the deep schedule (the pre-r5 recipe) instead of "
                    "inheriting the headline's trained predictor. Measured "
                    "on the distributed task (DeiT-S @224): fresh "
                    "re-training serves composed/ultra at 0.776/0.714 vs "
                    "dense 0.903; the inherited predictor serves 0.857/"
                    "0.804 at the same depths "
                    "(quality_results.json::deit_small_224_distributed)")
    ap.add_argument("--remat", choices=["auto", "on", "off"],
                    default="auto",
                    help="rematerialized (gradient-checkpointed) training "
                    "phases: 'auto' enables it for the wide gate models "
                    "(vit_large/vit_huge), 'on'/'off' force")
    ap.add_argument("--skip_tol", type=float, default=0.08)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--pred_epochs", type=int, default=30)
    ap.add_argument("--recover_epochs", type=int, default=12,
                    help="fine-tune epochs after structured pruning")
    ap.add_argument("--composed_max_drop", type=float, default=0.03,
                    help="top-1 budget for the composed preset — it removes "
                    "half the heads and MLP channels on top of a 64%% token "
                    "skip; the reference's own aggressive configs cost 2.3%% "
                    "top-1 at far milder pruning (ImageNet 82.45->80.16, "
                    "BASELINE.md), so the 0.5%% north-star budget binds the "
                    "headline preset only")
    ap.add_argument("--pred_lr", type=float, default=3e-3)
    ap.add_argument("--train_size", type=int, default=8192)
    ap.add_argument("--test_size", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--label_noise", type=float, default=0.1)
    ap.add_argument("--sim_threshold", type=float, default=0.9)
    ap.add_argument("--data_path", default=None, help="CIFAR-100 dir (else synthetic)")
    ap.add_argument("--gate_model",
                    choices=["gate", "deit_small", "deit_base", "vit_large",
                             "vit_huge"],
                    default="gate",
                    help="'gate' = the fast 32x32 gate model; 'deit_small'/"
                    "'deit_base'/'vit_large'/'vit_huge' = the exact @224 "
                    "geometries bench.py measures (VERDICT r2 #1)")
    ap.add_argument("--image_size", type=int, default=None,
                    help="input resolution (default: 32 for gate, 224 for "
                    "deit_small)")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 mixed-precision training (recommended at "
                    "deit_small scale; the 32x32 gate default stays fp32 for "
                    "byte-reproducibility with round 2)")
    ap.add_argument("--headline_loss", choices=["bce_oracle", "mse_attention"],
                    default=None,
                    help="predictor training signal for the headline preset: "
                    "bce_oracle (M2, similarity-oracle labels — the gate-scale "
                    "default) or mse_attention (M7, CLS-attention regression — "
                    "the reference's recipe for top-k serving configs, "
                    "pradeep/using_attention.py; REQUIRED at bench scale "
                    "(deit_small/base @224) where the similarity oracle "
                    "anti-aligns with class evidence and serving collapses as "
                    "BCE training sharpens — so the default resolves to "
                    "mse_attention for --gate_model != gate, bce_oracle at "
                    "gate scale, making the documented invocation reproduce "
                    "the recorded results without extra flags)")
    ap.add_argument("--predictor_hidden", type=int, default=64,
                    help="predictor MLP hidden width (PruneConfig default 64; "
                    "the reference uses ~500 on 768-dim ViT-B tokens)")
    ap.add_argument("--headline_ckpt", default=None,
                    help="cache the trained headline preset here (a checkpoint file): "
                    "restore + re-measure if present (no retraining), else "
                    "train and save")
    ap.add_argument("--dense_ckpt", default=None,
                    help="cache the trained dense baseline here (a checkpoint file): "
                    "restore if present, else train and save — makes preset "
                    "iteration at bench scale cheap")
    ap.add_argument("--kernels", choices=["eager", "auto"], default="eager",
                    help="compute-path pin: 'eager' (default — plain PyTorch, "
                    "the gate is independent of kernel dispatch; quality.py's "
                    "'xla') or 'auto' (the port's CUDA kernels: B1 / B5 under "
                    "autograd in training, B1-B4 in evaluation)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' asks for the CPU)")
    ap.add_argument("--cache_dir", default=None,
                    help="directory of the synthetic-dataset cache (default: "
                    "the temp directory)")
    ap.add_argument("--merge_dropped", action="store_true",
                    help="serve topk_prog presets with ToMe-flavored merge "
                    "compaction (PruneConfig.merge_dropped — dropped tokens "
                    "merge into their most similar kept token instead of "
                    "vanishing): training is unchanged (the re-decide train "
                    "path never physically drops), the trained weights are "
                    "re-measured with merge on, and the usual accuracy gates "
                    "apply to the merged serving config; a merged-vs-"
                    "unmerged ablation (pruned_top1_nomerge / merge_gain) "
                    "is recorded. NOTE: at gate scale the ablation measures "
                    "NEGATIVE (the synthetic task's dropped background "
                    "patches are noise by construction) — gate merge on "
                    "your real data before serving with it")
    ap.add_argument("--merge_ablation", action="store_true",
                    help="without --merge_dropped: gate the UNMERGED "
                    "serving config (the default) but also measure the "
                    "merged variant from the same trained weights "
                    "(pruned_top1_merged / merge_gain fields) — one "
                    "training, both numbers")
    ap.add_argument("--merge_into", default=None,
                    help="merge results into this JSON file under --section "
                    "(e.g. quality_results.json)")
    ap.add_argument("--section", default=None,
                    help="section key for --merge_into (e.g. deit_small_224)")
    args = ap.parse_args(argv)
    if args.headline_loss is None:
        # bench-scale gates need the M7 recipe (see the flag's help text)
        args.headline_loss = (
            "mse_attention" if args.gate_model != "gate" else "bce_oracle"
        )

    device = check_device(args.device)

    # quality measures ACCURACY, not speed: by default pin the plain PyTorch
    # compute path so the gate is independent of kernel dispatch
    from vit_pruning_tpu_torch.ops.dispatch import set_kernel_mode

    set_kernel_mode(args.kernels)

    config, train_b, test_b = build_task(args)
    n = config.num_patches

    dense_params = None
    if args.dense_ckpt:
        from vit_pruning_tpu_torch.checkpoint import restore_checkpoint, save_checkpoint
        from vit_pruning_tpu_torch.train.harness import evaluate as _eval

        if os.path.exists(args.dense_ckpt):
            log(f"restoring dense baseline from {args.dense_ckpt}")
            like = _init_params(config, PruneConfig(mode="none", predictor="none"), device)
            dense_params = restore_checkpoint(args.dense_ckpt, like)
            dense_acc, _, _ = _eval(dense_params, test_b, config,
                                    PruneConfig(mode="none", predictor="none"),
                                    full_testing=False)
            from vit_pruning_tpu_torch.ops.dispatch import quant_mode

            with quant_mode("int8"):
                dense_acc_i8, _, _ = _eval(
                    dense_params, test_b, config,
                    PruneConfig(mode="none", predictor="none"),
                    full_testing=False)
    if dense_params is None:
        log("training dense baseline…")
        dense_acc, dense_acc_i8, _, _, _, dense_params, _ = train_and_eval(
            config, PruneConfig(mode="none", predictor="none"), train_b, test_b,
            args, log,
        )
        if args.dense_ckpt:
            save_checkpoint(args.dense_ckpt, dense_params)
            log(f"saved dense baseline to {args.dense_ckpt}")
    log(f"dense top-1: {dense_acc:.4f}")
    chance = 1.0 / config.num_labels
    if dense_acc < 5 * chance:
        # an untrained baseline makes every delta gate vacuously pass —
        # refuse to certify anything (the round-1 lesson, inverted)
        log(f"FATAL: dense baseline {dense_acc:.4f} is within noise of "
            f"chance ({chance:.4f}); the gate would be vacuous. Fix the "
            "training recipe (epochs/lr/warmup) before gating.")
        print(json.dumps({"pass": False, "error": "dense_baseline_at_chance",
                          "dense_top1": round(dense_acc, 4)}))
        return 2

    presets = {}
    if args.preset in ("headline", "both", "all"):
        k = max(1, int(round(n * (1.0 - args.skip))))
        # at bench scale the headline preset IS the benched serving config
        # (bench.py default: mode='topk_prog', top_k=98, no schedule); the
        # 32x32 gate keeps round 2's per-layer re-decide (mode='topk') for
        # byte-reproducibility. Training semantics are identical either way
        # (pruned_vit_forward trains topk_prog as topk).
        headline_mode = "topk_prog" if args.gate_model != "gate" else "topk"
        presets["headline"] = dict(
            pcfg=PruneConfig(mode=headline_mode, predictor="cls_mlp",
                             loss=args.headline_loss, top_k=k,
                             sim_threshold=args.sim_threshold,
                             predictor_hidden=args.predictor_hidden),
            target_skip=1.0 - (k + 1) / (n + 1),
            structured=False, check_predictor=True,
        )
    if args.preset in ("mask", "all"):
        k = max(1, int(round(n * (1.0 - args.skip))))
        headline_mode = "topk_prog" if args.gate_model != "gate" else "topk"
        presets["mask"] = dict(
            # TRAINING config = the headline recipe (same predictor, same
            # signal); the serving config is swapped to the thresholded mask
            # path (mode='mask' + calibrated per-layer thresholds +
            # mask_budget cap) after training — the exact configuration the
            # bench.py mask-mode throughput row measures
            pcfg=PruneConfig(mode=headline_mode, predictor="cls_mlp",
                             loss=args.headline_loss, top_k=k,
                             sim_threshold=args.sim_threshold,
                             predictor_hidden=args.predictor_hidden),
            target_skip=1.0 - (k + 1) / (n + 1),
            structured=False,
            # the predictor itself is gated by the headline preset (same
            # weights); the mask preset's own fidelity number is reported
            # (mse_attention: layer-0 attention-mass capture; bce_oracle:
            # calibrated mask-vs-oracle accuracy) but gates only when the
            # bce metric applies
            check_predictor=(args.headline_loss == "bce_oracle"),
            serve_mask_budget=k,
        )
    if args.preset in ("composed", "both", "all"):
        from vit_pruning_tpu_torch.configs import composed_schedule, schedule_live

        schedule = composed_schedule(n, config.num_layers)
        live = schedule_live(schedule, n)
        presets["composed"] = dict(
            # loss matches the bench composed preset: CLS-attention
            # regression (M7) ranks tokens by evidence mass, the right
            # signal for deep top-k budgets — the similarity oracle ranks by
            # "changes most", which at 1/6 keep drops informative tokens
            # (measured: serving accuracy sinks as bce_oracle training
            # sharpens at deep schedules)
            pcfg=PruneConfig(mode="topk_prog", predictor="cls_mlp",
                             loss="mse_attention", top_k=schedule[0],
                             keep_schedule=schedule,
                             sim_threshold=args.sim_threshold,
                             predictor_hidden=args.predictor_hidden),
            target_skip=1.0 - (sum(live) / len(live)) / (n + 1),
            structured=True, check_predictor=False,
        )
    if args.preset in ("ultra", "all"):
        from vit_pruning_tpu_torch.configs import schedule_live, ultra_schedule

        # the ultra preset = composed recipe, ~halved live token counts
        # (bench.py's ultra row); gates unmerged by default — add
        # --merge_dropped to gate the merged variant (measured negative at
        # gate scale) or --merge_ablation to record it un-gated
        schedule = ultra_schedule(n, config.num_layers)
        live = schedule_live(schedule, n)
        presets["ultra"] = dict(
            pcfg=PruneConfig(mode="topk_prog", predictor="cls_mlp",
                             loss="mse_attention", top_k=schedule[0],
                             keep_schedule=schedule,
                             sim_threshold=args.sim_threshold,
                             predictor_hidden=args.predictor_hidden),
            target_skip=1.0 - (sum(live) / len(live)) / (n + 1),
            structured=True, check_predictor=False,
        )

    if args.merge_dropped:
        # serve topk_prog presets with merge compaction (framework
        # extension; RESULTS.md §merge_dropped). Flipped at preset
        # construction so the in-training best-epoch eval and the final
        # measurement both use the true serving semantics; the training
        # forward itself is unchanged (the re-decide train path never
        # physically drops tokens). Non-topk_prog presets (the 32x32
        # gate's 'topk', the mask preset's swapped serving config) have
        # nothing to merge and are left alone.
        for spec in presets.values():
            if spec["pcfg"].mode == "topk_prog":
                spec["pcfg"] = spec["pcfg"].replace(merge_dropped=True)

    results = {"schema_version": SCHEMA_VERSION,
               "dense_top1": round(dense_acc, 4),
               "dense_top1_int8": round(dense_acc_i8, 4),
               "dataset": ("cifar100" if args.data_path
                           else f"synthetic_{getattr(args, 'task', 'localized')}"),
               "gate_model": args.gate_model,
               "image_size": config.image_size,
               "gate_max_drop": args.max_drop, "presets": {}}
    if not args.data_path:
        # pin the synthetic-task instance the deltas were measured on
        results["task_params"] = {
            "num_labels": config.num_labels,
            "train_size": args.train_size, "test_size": args.test_size,
            "label_noise": args.label_noise,
            "signal_patches": (getattr(args, "signal_patches", None)
                               or (8 if getattr(args, "task", "localized")
                                   == "distributed"
                                   else max(8, config.num_patches // 8))),
        }
    all_pass = True
    headline_params = None
    for name, spec in presets.items():
        # the mask preset serves the HEADLINE's weights (same predictor,
        # different serving semantics), so both share --headline_ckpt
        ckpt = args.headline_ckpt if name in ("headline", "mask") else None
        trained, measured = None, False
        if name == "mask" and headline_params is not None:
            log("mask preset: serving the in-run trained headline weights")
            trained = headline_params
        elif ckpt and os.path.exists(ckpt):
            from vit_pruning_tpu_torch.checkpoint import restore_checkpoint

            log(f"restoring {name} preset from {ckpt} (re-measure only)")
            like = _init_params(config, spec["pcfg"], device)
            trained = restore_checkpoint(ckpt, like)
        if trained is None:
            log(f"training {name} preset…")
            (acc, acc_i8, mlp_acc, skip, acc_structural, trained,
             pred_extra) = train_and_eval(
                config, spec["pcfg"], train_b, test_b, args, log,
                base_params=(headline_params or dense_params) if spec["structured"]
                else dense_params,
                structured=spec["structured"],
                teacher=(dense_params, config),
            )
            measured = True
            if ckpt and name in ("headline", "mask"):
                # the mask preset TRAINS with the headline recipe (same
                # weights, different serving config), so a fresh train under
                # either name fills --headline_ckpt — otherwise a
                # --preset mask run on a fresh machine would discard hours
                # of TPU training
                from vit_pruning_tpu_torch.checkpoint import save_checkpoint

                save_checkpoint(ckpt, trained)
                log(f"saved {name} preset to {ckpt}")
        if spec.get("serve_mask_budget") is not None:
            # swap to the serving configuration the bench.py mask row
            # measures: per-layer thresholds calibrated to the target
            # keep-rate + the per-image density cap (VERDICT r2 #3)
            probe = next(iter(train_b))
            mt = calibrate_serving_mask_threshold(
                trained, probe, config, spec["pcfg"],
                keep_rate=1.0 - args.skip)
            log("calibrated serving mlp_threshold = "
                + ", ".join(f"{v:.3f}" for v in mt))
            spec["pcfg"] = spec["pcfg"].replace(
                mode="mask", mlp_threshold=mt,
                mask_budget=spec["serve_mask_budget"], keep_schedule=None)
            measured = False
        if not measured:
            (acc, acc_i8, mlp_acc, skip, acc_structural,
             trained, pred_extra) = measure_preset(
                trained, config, spec["pcfg"], train_b, test_b, args, log,
                structured=False)
        if name == "headline":
            headline_params = trained
        drop = dense_acc - acc
        budget = args.composed_max_drop if spec["structured"] else args.max_drop
        if spec["structured"]:
            # Composed: gate the TOKEN-SKIP cost against the capacity control
            # (same recovered weights, token skip off). The structural
            # halving's capacity cost is reported but not gated — on a tiny
            # from-scratch gate model it wildly overstates what a pretrained
            # DeiT-S pays (the reference's own mild pruning cost 2.3% top-1
            # on ImageNet, BASELINE.md); total delta vs dense stays in the
            # JSON for the honest headline caveat.
            gates = {"token_delta": bool((acc_structural - acc) <= budget)}
            gates["token_delta_int8"] = bool((acc_structural - acc_i8) <= budget)
        else:
            gates = {"delta": bool(drop <= budget)}
            # the int8 serving variant must fit the same accuracy budget —
            # the bench.py --quant int8 throughput rows ride on this gate
            gates["delta_int8"] = bool((dense_acc - acc_i8) <= budget)
        if spec["check_predictor"]:
            gates["predictor"] = bool(mlp_acc >= args.min_predictor_acc)
        if spec["structured"] and spec["pcfg"].loss == "mse_attention":
            # deep-schedule predictor fidelity is GATED, not informational
            # (VERDICT r3 #2): the weakest drop layer's attention-mass
            # capture must clear the bar — a strong layer-0 capture must not
            # mask a deep layer whose kept set is junk
            gates["predictor_capture"] = bool(
                pred_extra.get("predictor_capture_min", 0.0)
                >= args.min_layer_capture)
        gates["skip"] = bool(abs(skip - spec["target_skip"]) <= args.skip_tol)
        ok = all(gates.values())
        all_pass &= ok
        results["presets"][name] = {
            # the exact serving PruneConfig this preset was gated on —
            # compare field-for-field with the config bench.py measures
            "serving_config": json.loads(spec["pcfg"].to_json()),
            "pruned_top1": round(acc, 4),
            "pruned_top1_int8": round(acc_i8, 4),
            "delta": round(drop, 4),
            "delta_int8": round(dense_acc - acc_i8, 4),
            # the dense baseline THIS preset's deltas were computed against —
            # a later --merge_into run may retrain dense and overwrite the
            # section-level dense_top1, so each preset pins its own
            "dense_top1": round(dense_acc, 4),
            "budget": budget,
            "predictor_accuracy": round(mlp_acc, 4) if mlp_acc is not None else None,
            "predictor_metric": ("attention_mass_capture"
                                 if spec["pcfg"].loss == "mse_attention"
                                 else "mask_vs_oracle"),
            **pred_extra,
            "measured_skip": round(skip, 4),
            "target_skip": round(spec["target_skip"], 4),
            "gates": gates,
            "pass": ok,
        }
        if acc_structural is not None:
            results["presets"][name]["structural_top1"] = round(acc_structural, 4)
            results["presets"][name]["token_delta"] = round(acc_structural - acc, 4)
            results["presets"][name]["capacity_cost"] = round(
                dense_acc - acc_structural, 4)
        log(f"{name}: {results['presets'][name]}")

    if args.margin_sweep:
        if headline_params is None:
            log("FATAL: --margin_sweep needs the headline preset in the run "
                "(use --preset headline/both/all, or --headline_ckpt)")
            print(json.dumps({"pass": False,
                              "error": "margin_sweep_without_headline"}))
            return 2
        results["gate_margin"] = margin_sweep(
            headline_params, dense_acc, config, test_b, args, log)
        gm = results["gate_margin"]
        log(f"gate_margin: can_fail={gm['gate_can_fail']} "
            f"(delta <= {args.max_drop} through skip "
            f"{gm['deepest_passing_skip']}, first failure at "
            f"{gm['first_failing_skip']})")

    results["pass"] = bool(all_pass)
    if args.merge_into:
        existing = {}
        if os.path.exists(args.merge_into):
            with open(args.merge_into) as fh:
                existing = json.load(fh)
        merge_results(existing, results, args.section, log)
        # the section this run just produced/updated must be fully
        # current-schema — merging a partial rerun into a stale section
        # (missing capture fields, old version) fails loudly here instead
        # of committing silent drift (VERDICT r4 #6)
        written = existing[args.section] if args.section else existing
        problems = validate_section(written, args.section or "<top>")
        if problems:
            for p in problems:
                log(f"SCHEMA: {p}")
            # don't discard an hours-long run: park the merged dict next to
            # the target for inspection, but never publish a stale section
            rejected = args.merge_into + ".rejected.json"
            with open(rejected, "w") as fh:
                json.dump(existing, fh, indent=1)
                fh.write("\n")
            raise SystemExit(
                f"--merge_into refused: section {args.section or '<top>'} "
                f"fails current-schema validation ({len(problems)} problems "
                f"above; merged dict parked at {rejected}); re-run with "
                f"--preset all (or enough presets to regenerate every stale "
                f"row)")
        with open(args.merge_into, "w") as fh:
            json.dump(existing, fh, indent=1)
            fh.write("\n")
    print(json.dumps(results))
    return 0 if all_pass else 1


def _merge_preset_run(old: dict, results: dict, log) -> dict:
    """Preset-preserving merge of one run's `results` into a prior record
    `old` with the same shape: a --preset headline rerun must not drop the
    existing composed entry (and vice versa). Section pass = all merged
    presets pass."""
    merged = dict(old)
    merged.update({k: v for k, v in results.items() if k != "presets"})
    merged["presets"] = {**old["presets"], **results["presets"]}
    # baselines may differ across merged runs (each preset pins its own
    # dense_top1); flag it rather than silently certifying deltas against
    # mixed baselines
    bases = {p.get("dense_top1") for p in merged["presets"].values()
             if p.get("dense_top1") is not None}
    if len(bases) > 1:
        merged["mixed_dense_baselines"] = sorted(bases)
        log(f"WARNING: merged presets were measured against different "
            f"dense baselines {sorted(bases)}; re-run all presets with "
            f"--dense_ckpt for a single-baseline section")
    merged["pass"] = bool(all(
        p.get("pass") for p in merged["presets"].values()))
    return merged


def merge_results(existing: dict, results: dict, section, log=log) -> dict:
    """Merge one quality run into the results file dict, in place.

    With `section`, the run lands under that key; without, at the top
    level. Either way previously-recorded presets the run didn't re-measure
    are preserved (preset-level union, not dict replacement)."""
    if section:
        old = existing.get(section, {})
        if isinstance(old, dict) and old.get("presets"):
            existing[section] = _merge_preset_run(old, results, log)
        else:
            existing[section] = results
    else:
        if isinstance(existing.get("presets"), dict):
            merged = _merge_preset_run(
                {k: v for k, v in existing.items()
                 if not (isinstance(v, dict) and v.get("presets"))},
                results, log)
            existing.update(merged)
        else:
            existing.update(results)
    return existing


if __name__ == "__main__":
    raise SystemExit(main())
