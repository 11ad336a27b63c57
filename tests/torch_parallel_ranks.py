"""Rank functions of tests/test_torch_parallel.py: what each rank of a
run_ranks spawn computes with the port's parallel package. The ranks are
spawned processes that import this module by name, so it imports only
torch, the port and the dry run's train-step helpers
(dryrun_multichip_torch.py), never jax. Inputs arrive as numpy (the
weights of the JAX package's init, its batches); results go back as
numpy."""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from dryrun_multichip_torch import parallel_train, single_train
from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
from vit_pruning_tpu_torch.models.convert import flatten_tree, params_from_jax
from vit_pruning_tpu_torch.models.pruned_vit import progressive_topk_forward
from vit_pruning_tpu_torch.models.vit import vit_forward
from vit_pruning_tpu_torch.parallel import (
    make_mesh,
    make_parallel_eval_step,
    make_parallel_serving_step,
    shard_batch,
    shard_params,
    zero1_pspecs,
)
from vit_pruning_tpu_torch.parallel.pipeline import (
    make_stage_mesh,
    pipeline_forward,
    pruned_pipeline_forward,
)
from vit_pruning_tpu_torch.parallel.sharding import resolve_pspecs
from vit_pruning_tpu_torch.parallel.steps import opt_state_shardings
from vit_pruning_tpu_torch.train.harness import make_eval_step

def _torch_batch(batch: dict) -> dict:
    return {"pixel_values": torch.from_numpy(np.asarray(batch["pixel_values"])),
            "labels": torch.from_numpy(np.asarray(batch["labels"])).long()}


def train(cfg: dict, pcfg: dict, params_np: dict, batch_np: dict, data: int, model: int,
          zero1: bool = False, clip_norm=None, seed=None):
    """One parallel train step ('both', masked_adam 'vit_mlp_train', lr
    1e-3; dryrun_multichip_torch.py::parallel_train). Returns the global
    metrics, the whole params and first moments after the step, and the
    shapes of this rank's params and Adam moments."""
    res = parallel_train(ViTConfig(**cfg), PruneConfig(**pcfg), params_from_jax(params_np, "cpu"),
                         _torch_batch(batch_np), data, model, zero1=zero1, clip_norm=clip_norm,
                         seed=seed)
    return {k: res[k] for k in ("metrics", "params", "mu", "moments", "local")}


def train_single(cfg: dict, pcfg: dict, params_np: dict, batch_np: dict, clip_norm=None,
                 seed=None):
    """The port's single-process step on the same inputs."""
    res = single_train(ViTConfig(**cfg), PruneConfig(**pcfg), params_from_jax(params_np, "cpu"),
                       _torch_batch(batch_np), clip_norm=clip_norm, seed=seed)
    return {k: res[k] for k in ("metrics", "params", "mu")}


def evaluate(cfg: dict, pcfg: dict, params_np: dict, batch_np: dict, data: int, model: int):
    """The parallel eval step with the oracle instrumentation, and the
    port's single-process eval step on the whole batch."""
    config, prune = ViTConfig(**cfg), PruneConfig(**pcfg)
    mesh = make_mesh(data=data, model=model, device="cpu")
    full = params_from_jax(params_np, "cpu")
    local, specs = shard_params(full, mesh)
    step = make_parallel_eval_step(config, prune, mesh, specs, full_testing=True)
    got = step(local, shard_batch(_torch_batch(batch_np), mesh))
    want = make_eval_step(config, prune, True)(full, _torch_batch(batch_np))
    return {"parallel": got, "single": want}


def serve(cfg: dict, pcfg: dict, params_np: dict, u8: np.ndarray, data: int, model: int):
    """The parallel uint8 serving step; each rank's logits gathered in
    data order."""
    config, prune = ViTConfig(**cfg), PruneConfig(**pcfg)
    mesh = make_mesh(data=data, model=model, device="cpu")
    local, specs = shard_params(params_from_jax(params_np, "cpu"), mesh)
    step = make_parallel_serving_step(config, prune, mesh, specs)
    logits = step(local, shard_batch({"u8": torch.from_numpy(u8)}, mesh)["u8"])
    parts = [torch.empty_like(logits) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, logits)
    return torch.cat([parts[r] for r in mesh.mesh[:, 0].tolist()])


def pipeline(cfg: dict, params_np: dict, x: np.ndarray, stages: int, microbatches: int,
             data: int = 1, model: int = 1):
    """pipeline_forward (None on ranks outside the stage mesh) and the
    single-process vit_forward."""
    config = ViTConfig(**cfg)
    mesh = make_stage_mesh(stages, data=data, model=model, device="cpu")
    params, pix = params_from_jax(params_np, "cpu"), torch.from_numpy(x)
    if mesh.get_coordinate() is None:
        return None
    got = pipeline_forward(params, pix, config, mesh, num_microbatches=microbatches)
    return {"got": got, "want": vit_forward(params, pix, config)["logits"]}


def pruned_pipeline(cfg: dict, pcfg: dict, params_np: dict, x: np.ndarray, stages: int,
                    microbatches: int, data: int = 1):
    """pruned_pipeline_forward and the single-process progressive forward."""
    config, prune = ViTConfig(**cfg), PruneConfig(**pcfg)
    mesh = make_stage_mesh(stages, data=data, device="cpu")
    params, pix = params_from_jax(params_np, "cpu"), torch.from_numpy(x)
    if mesh.get_coordinate() is None:
        return None
    got = pruned_pipeline_forward(params, pix, config, prune, mesh,
                                  num_microbatches=microbatches)
    return {"got": got,
            "want": progressive_topk_forward(params, pix, config, prune)["logits"]}


def meshes():
    """make_mesh's shapes on this world, and its refusal of a larger one."""
    out = {"2x2": dict(zip(("data", "model"), make_mesh(data=2, model=2, device="cpu").shape)),
           "default": dict(zip(("data", "model"), make_mesh(device="cpu").shape))}
    try:
        make_mesh(data=4, model=2, device="cpu")
        out["refused"] = False
    except ValueError:
        out["refused"] = True
    try:  # the card is the default device: this host has none
        make_mesh(data=2, model=2)
        out["no_card"] = None
    except RuntimeError as e:
        out["no_card"] = str(e)
    return out


def resolve(params_np: dict, data: int, model: int):
    """resolve_pspecs, zero1_pspecs and opt_state_shardings (both ways) of
    a whole param tree on a data x model mesh, each by path."""
    mesh = make_mesh(data=data, model=model, device="cpu")
    params = params_from_jax(params_np, "cpu")
    trees = {"resolve": resolve_pspecs(params, mesh), "zero1": zero1_pspecs(params, mesh),
             "opt": opt_state_shardings(params, mesh),
             "opt_zero1": opt_state_shardings(params, mesh, zero1=True)}
    return {k: {"/".join(p): s for p, s in flatten_tree(t)} for k, t in trees.items()}


def run_cases(cases: list):
    """[(name, function name, args, kwargs)] -> {name: result}, in order."""
    return {name: globals()[fn](*args, **kw) for name, fn, args, kw in cases}


def fail_on_rank(bad: int):
    """Raises on rank `bad`; the other ranks wait at a barrier it never
    reaches."""
    if dist.get_rank() == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    dist.barrier()
    return dist.get_rank()


def hang_on_rank(bad: int):
    """Rank `bad` never returns; the others return at once."""
    if dist.get_rank() == bad:
        while True:
            time.sleep(1.0)
    return dist.get_rank()
