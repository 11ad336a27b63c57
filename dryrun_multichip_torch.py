"""The port's multi-rank dry run: what __graft_entry__.py's dryrun_multichip
checks for the JAX package, on torch.distributed ranks.

    python3 dryrun_multichip_torch.py                 # 8 ranks on the card(s)
    python3 dryrun_multichip_torch.py --device cpu    # 8 gloo ranks on the CPU

On a data 2 x model 4 mesh: the bce_oracle train step (parallel/steps.py) against the
single-process step on the same weights and batch (the loss, the params
after the step and Adam's first moments), and its ZeRO-1 twin against both;
dp x tp uint8 serving against serving.py::serving_forward. Then
the 2-stage pipelines (parallel/pipeline.py): dense over ('stage',),
pruned topk_prog + merge over ('stage', 'data') = 2 x 4, and dense
over ('stage', 'model') = 2 x 2, each against its single-process forward.
Loss rtol 1e-5, params 1e-5, first moments 1e-3 of each leaf's largest
(MU_RTOL), forwards rtol = atol = 2e-5 (on the card the kernels run on both
sides). The train-step helpers (parallel_train, single_train, train_checks)
are shared with chip_smoke.py's parallel phase and the parallel tests. The last line has the form of
MULTICHIP_r05.json's tail; the exit code is 0 only if every check passed.
Imports torch and the port, never jax.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

# the JAX dry run's 8 devices: data 2 x model 4, 2 pipeline stages
DATA, MODEL, STAGES = 2, 4, 2
RANKS = DATA * MODEL
# the JAX dry run's model: head and MLP widths divisible by the model axis
CONFIG = dict(image_size=32, patch_size=8, hidden_size=64, num_layers=2, num_heads=4,
              mlp_dim=128, num_labels=10)


def _close(a, b) -> tuple:
    d = float((a.float() - b.float()).abs().max())
    return bool(torch.allclose(a.float(), b.float(), rtol=2e-5, atol=2e-5)), f"max |diff| {d:.2e}"


# the train step that every comparison runs: 'both' losses, Adam over
# everything the 'vit_mlp_train' policy trains, lr 1e-3
POLICY, LR = "vit_mlp_train", 1e-3
# Adam's first moment after one step is 0.1 g: a leaf's moments are held to
# MU_RTOL of their largest value, which a gradient summed over the ranks
# instead of averaged, or divided by another count of ranks, misses by 0.5
# or more (Adam's update, lr g / |g| at the first step, cannot show that).
# A leaf whose moments lie below MU_FLOOR of the tree's largest is rounding
# (the key bias: softmax ignores a shift common to a row's keys, so its
# gradient is 0 but for rounding) and is held to MU_RTOL of that floor.
MU_RTOL, MU_FLOOR = 1e-3, 1e-5


def _by_path(tree) -> dict:
    from vit_pruning_tpu_torch.models.convert import flatten_tree

    return {"/".join(p): t for p, t in flatten_tree(tree)}


def _run(fn, timer):
    return (fn(), None) if timer is None else timer(fn)


def _whole_moments(state: dict, whole: dict, mesh, zero1: bool) -> dict:
    """Adam's first moments as whole leaves by path: each rank's block
    gathered over the mesh axes that its spec names."""
    from vit_pruning_tpu_torch.parallel.collectives import all_gather
    from vit_pruning_tpu_torch.parallel.mesh import axis_group
    from vit_pruning_tpu_torch.parallel.steps import opt_state_shardings

    specs = _by_path(opt_state_shardings(whole, mesh, zero1=zero1))
    out = {}
    for path, st in state.items():
        key, mu = "/".join(path), st["mu"]
        for dim, axis in enumerate(specs[key]):
            if axis is not None:
                mu = all_gather(mu, dim, axis_group(mesh, axis))
        out[key] = mu.clone()
    return out


def parallel_train(config, pcfg, params: dict, batch: dict, data: int, model: int,
                   zero1: bool = False, clip_norm=None, seed=None, timer=None) -> dict:
    """One step of parallel/steps.py's train step on a data x model mesh,
    from the whole `params` and `batch` (on the device the ranks run on).
    seed: mode random's generator. timer(fn) -> (fn(), ms) wraps the step
    alone. Returns the global metrics; the params after the step and
    Adam's first moments, whole, by path; this rank's param and moment
    shapes and the params' specs; and the step's ms."""
    from vit_pruning_tpu_torch.parallel import (
        init_sharded_opt_state,
        make_mesh,
        make_parallel_train_step,
        shard_batch,
        shard_params,
    )
    from vit_pruning_tpu_torch.parallel.steps import gather_params
    from vit_pruning_tpu_torch.train.freeze import masked_adam

    mesh = make_mesh(data=data, model=model, device=batch["labels"].device.type)
    local, specs = shard_params(params, mesh)
    opt = masked_adam(local, POLICY, LR, clip_norm=clip_norm)
    state = init_sharded_opt_state(opt, local, mesh, specs, zero1=zero1)
    step = make_parallel_train_step(config, pcfg, "both", opt, mesh, specs, zero1=zero1)
    rows = shard_batch(batch, mesh)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    metrics, ms = _run(lambda: step(local, rows, gen), timer)
    with torch.no_grad():
        whole = gather_params(local, specs, mesh)
        return {"metrics": metrics, "ms": ms,
                "params": {k: t.clone() for k, t in _by_path(whole).items()},
                "mu": _whole_moments(state, whole, mesh, zero1),
                "local": {k: tuple(t.shape) for k, t in _by_path(local).items()},
                "moments": {"/".join(p): (tuple(st["mu"].shape), tuple(st["nu"].shape))
                            for p, st in state.items()},
                "specs": _by_path(specs)}


def single_train(config, pcfg, params: dict, batch: dict, clip_norm=None, seed=None,
                 timer=None) -> dict:
    """The same step in one process (train/harness.py::make_train_step),
    updating `params` in place. Returns the metrics; by path the params
    after the step, Adam's first moments and the gradients (inf where a
    leaf had none); and the step's ms."""
    from vit_pruning_tpu_torch.train.freeze import masked_adam
    from vit_pruning_tpu_torch.train.harness import make_train_step

    opt = masked_adam(params, POLICY, LR, clip_norm=clip_norm)
    step = make_train_step(config, pcfg, "both", opt)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    metrics, ms = _run(lambda: step(params, batch, gen), timer)
    flat = _by_path(params)
    return {"metrics": metrics, "ms": ms,
            "params": {k: t.detach().clone() for k, t in flat.items()},
            "mu": {k: opt.state[t]["mu"].clone() for k, t in flat.items() if opt.state[t]},
            "grad": {k: torch.full_like(t, float("inf")) if t.grad is None else t.grad.clone()
                     for k, t in flat.items()}}


def _top(t) -> float:
    return float(t.max()) if t.numel() else 0.0


def train_checks(name: str, got: dict, want: dict, grad_floor=None) -> dict:
    """{check: (ok, detail)} of a parallel_train result against
    single_train's: the loss within 1e-5 relative, the params within 1e-5
    (with grad_floor, only those whose single-process |grad| is
    at least grad_floor; the detail counts the others), each leaf's first
    moments within MU_RTOL of its largest (see MU_FLOOR)."""
    loss, want_loss = float(got["metrics"]["loss"]), float(want["metrics"]["loss"])
    rel = abs(loss - want_loss) / abs(want_loss)
    out = {f"{name} loss": (bool(np.isfinite(loss)) and rel <= 1e-5,
                            f"{loss:.7f} vs {want_loss:.7f}, rel {rel:.2e}")}
    diff = {k: (t - want["params"][k]).abs() for k, t in got["params"].items()}
    overall = max(_top(d) for d in diff.values())
    if grad_floor is None:
        out[f"{name} params"] = (got["params"].keys() == want["params"].keys()
                                 and overall < 1e-5, f"max |diff| {overall:.2e}")
    else:
        small = {k: want["grad"][k].abs() < grad_floor for k in diff}
        held = max(_top(d[~small[k]]) for k, d in diff.items())
        left = sum(int(m.sum()) for m in small.values())
        total = sum(d.numel() for d in diff.values())
        out[f"{name} params"] = (held < 1e-5, (
            f"max |diff| {held:.2e} over the params whose single-process |grad| >= "
            f"{grad_floor:g}; {left} of {total} left out; max |diff| overall {overall:.2e}"))
    tops = {k: _top(m.abs()) for k, m in want["mu"].items()}
    floor = MU_FLOOR * max(tops.values())
    ratio = {k: _top((got["mu"][k] - m).abs()) / max(tops[k], floor)
             for k, m in want["mu"].items()}
    leaf = max((k for k in ratio if tops[k] >= floor), key=ratio.get)
    low = [ratio[k] for k in ratio if tops[k] < floor]
    out[f"{name} first moments"] = (
        got["mu"].keys() == want["mu"].keys() and max(ratio.values()) <= MU_RTOL,
        f"max |diff| {ratio[leaf]:.2e} of a leaf's largest |mu| ({leaf}, of {len(ratio)}); "
        f"{len(low)} leaves below {MU_FLOOR:g} of the tree's largest at most "
        f"{max(low, default=0.0):.2e} of that; bound {MU_RTOL:g}")
    return out


def dryrun_rank(device: str) -> dict:
    """Every rank's share of the dry run; returns its checks as {name: (ok,
    detail)} and the loss."""
    import torch.distributed as dist

    from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
    from vit_pruning_tpu_torch.data.datasets import Batches, synthetic_dataset
    from vit_pruning_tpu_torch.models.pruned_vit import (
        init_pruned_vit_params,
        progressive_topk_forward,
    )
    from vit_pruning_tpu_torch.models.vit import init_vit_params, vit_forward
    from vit_pruning_tpu_torch.parallel import (
        make_mesh,
        make_parallel_serving_step,
        shard_batch,
        shard_params,
    )
    from vit_pruning_tpu_torch.parallel.mesh import in_mesh
    from vit_pruning_tpu_torch.parallel.pipeline import (
        make_stage_mesh,
        pipeline_forward,
        pruned_pipeline_forward,
    )
    from vit_pruning_tpu_torch.serving import serving_forward

    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else "cpu"
    mesh = make_mesh(data=DATA, model=MODEL, device=device)
    config = ViTConfig(**CONFIG)
    pcfg = PruneConfig(mode="mask", predictor="cls_mlp", loss="bce_oracle")

    def fresh(pc, seed):
        return init_pruned_vit_params(config, pc, torch.Generator().manual_seed(seed), dev)

    images, labels = synthetic_dataset(n=2 * RANKS, image_size=32, num_labels=10)
    batch = next(iter(Batches(images, labels, batch_size=2 * RANKS, image_size=32,
                              device=dev)))

    # the data x model train step and its ZeRO-1 twin against the single-process step
    want = single_train(config, pcfg, fresh(pcfg, 0), batch)
    checks: dict = {}
    got = {}
    for name, zero1 in (("train", False), ("zero1", True)):
        got[name] = parallel_train(config, pcfg, fresh(pcfg, 0), batch, DATA, MODEL,
                                   zero1=zero1)
        checks.update(train_checks(name, got[name], want))
    d = max(float((t - got["train"]["params"][k]).abs().max())
            for k, t in got["zero1"]["params"].items())
    checks["zero1 vs train params"] = (d < 1e-5, f"max |diff| {d:.2e}")
    loss = float(got["train"]["metrics"]["loss"])

    # dp x tp uint8 serving against the single-process serving forward
    srv_cfg = PruneConfig(mode="topk_prog", predictor="cls_mlp",
                          top_k=max(config.num_patches // 2, 1))
    srv_params = fresh(srv_cfg, 6)
    u8 = torch.randint(0, 256, (2 * RANKS, 3, 32, 32), generator=torch.Generator().manual_seed(7),
                       dtype=torch.uint8).to(dev)
    local, specs = shard_params(srv_params, mesh)
    got = make_parallel_serving_step(config, srv_cfg, mesh, specs)(
        local, shard_batch({"u8": u8}, mesh)["u8"])
    want = shard_batch({"w": serving_forward(srv_params, u8, config, srv_cfg)["logits"]},
                       mesh)["w"]
    checks["serving"] = _close(got, want)

    # the 2-stage pipelines; every rank builds every mesh, its members run it
    pp_params = init_vit_params(config, torch.Generator().manual_seed(2), dev)
    xs = torch.randn((2 * STAGES, 3, 32, 32), generator=torch.Generator().manual_seed(3)).to(dev)
    pp_mesh = make_stage_mesh(STAGES, device=device)
    want = vit_forward(pp_params, xs, config)["logits"]
    if in_mesh(pp_mesh):
        checks["pipeline"] = _close(
            pipeline_forward(pp_params, xs, config, pp_mesh, num_microbatches=2), want)

    n_patches = config.num_patches
    prog_cfg = PruneConfig(
        mode="topk_prog", predictor="cls_mlp",
        keep_schedule=tuple([max(n_patches * 2 // 3, 2), max(n_patches // 3, 1)]
                            + [0] * (config.num_layers - 2)),
        merge_dropped=True)
    prog_params = fresh(prog_cfg, 4)
    dp = RANKS // STAGES
    xs2 = torch.randn((2 * STAGES * dp, 3, 32, 32),
                      generator=torch.Generator().manual_seed(5)).to(dev)
    ppdp_mesh = make_stage_mesh(STAGES, data=dp, device=device)
    if in_mesh(ppdp_mesh):
        checks["pruned_pipeline"] = _close(
            pruned_pipeline_forward(prog_params, xs2, config, prog_cfg, ppdp_mesh,
                                    num_microbatches=2),
            progressive_topk_forward(prog_params, xs2, config, prog_cfg)["logits"])

    pptp_mesh = make_stage_mesh(STAGES, model=2, device=device)
    if in_mesh(pptp_mesh):
        checks["pp_tp_pipeline"] = _close(
            pipeline_forward(pp_params, xs, config, pptp_mesh, num_microbatches=2), want)
    dist.barrier()
    return {"checks": checks, "loss": loss}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = ap.parse_args(argv)
    from vit_pruning_tpu_torch.models.convert import check_device
    from vit_pruning_tpu_torch.parallel import run_ranks

    check_device(args.device)  # raises without a card unless --device cpu
    if args.device == "cuda":
        from vit_pruning_tpu_torch.ops.cuda.build import load_library

        load_library()  # build once here, not in every rank
    results = run_ranks(dryrun_rank, RANKS, args.device, device=args.device, timeout_s=600)
    failed = sorted({f"{name} (rank {r}): {detail}" for r, res in enumerate(results)
                     for name, (ok, detail) in res["checks"].items() if not ok})
    if failed:
        print(f"dryrun_multichip FAILED: {failed}")
        return 1
    print(f"dryrun_multichip ok: mesh={{'data': {DATA}, 'model': {MODEL}}} "
          f"loss={results[0]['loss']:.4f} (+zero1 opt-state sharding) (+dp-sharded uint8 serving)"
          f" (+{STAGES}-stage pipeline verified, dense and pruned topk_prog+merge over "
          f"('stage','data')={STAGES}x{RANKS // STAGES}, dense over pp x tp "
          f"('stage','model')={STAGES}x2)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
