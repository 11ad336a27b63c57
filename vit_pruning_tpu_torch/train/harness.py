"""Phased train / eval harness.

Mirrors vit_pruning_tpu/train/harness.py: `train()` with loss mixing
('classification' / 'cosine' / 'both' / 'alternate'), freeze-policy
dispatch, per-epoch eval with per-layer skip and confusion tables, the best
checkpoint and an exact resume from `state_dir`; `evaluate()` with the
oracle instrumentation; `phased_train()`, the reference's two phases
(predictors on the cosine loss, then the backbone on classification).

The JAX step is one jitted function of (params, opt_state, batch, rng); here
a step is eager PyTorch that updates the params in place through their
optimizer (train/freeze.py) and returns its metrics: step(params, batch,
generator). On the card the layers run kernels B1 / B5 under their autograd
Functions (ops/cuda/layer.py::RecomputedBackward).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch

from vit_pruning_tpu_torch.checkpoint import BestCheckpoint, restore_checkpoint, save_checkpoint
from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
from vit_pruning_tpu_torch.models.predictors import apply_predictor
from vit_pruning_tpu_torch.models.pruned_vit import _is_active, pruned_vit_forward
from vit_pruning_tpu_torch.models.vit import layer_slice
from vit_pruning_tpu_torch.train.freeze import masked_adam, per_predictor_adam, policy_for_loss_type
from vit_pruning_tpu_torch.train.losses import (
    cross_entropy,
    distillation_kl,
    focal_loss,
    mse_attention_loss,
    mse_cosine_loss,
    weighted_bce_oracle,
)
from vit_pruning_tpu_torch.train.metrics import EvalAccumulator, MLPTracker

COSINE_LOSS_RATIO = 1.0
# metrics of total_loss_fn that are counts (summed over accumulation
# microbatches); the others are batch means (averaged)
SUM_METRICS = ("confusion",)
# predictors whose params reach the loss only through each layer's scores:
# the detached cosine step applies to them
DETACHABLE_PREDICTORS = ("cls_mlp", "token_mlp", "common_mlp", "compressor",
                         "shared_compressor", "cnn", "key_mlp")


def _cast(tree, dtype):
    """Every floating leaf cast to dtype, inside the autograd graph."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if tree is None or not tree.is_floating_point():
        return tree
    return tree.to(dtype)


def total_loss_fn(params: dict, batch: dict, config: ViTConfig, pcfg: PruneConfig,
                  loss_type: str, generator: Optional[torch.Generator], remat: bool = False,
                  distill=None):
    """Returns (total, metrics). The classification phase runs without the
    oracle instrumentation (oracle=False); its metrics carry no confusion.
    distill: (teacher_params, teacher_config, weight, temperature) mixes
    (1 - w) CE + w KD(teacher logits) into the classification term; the
    teacher runs dense under torch.no_grad()."""
    with_oracle = loss_type != "classification"
    out = pruned_vit_forward(params, batch["pixel_values"], config, pcfg, train=True,
                             oracle=with_oracle, generator=generator, remat=remat)
    cls_loss = cross_entropy(out["logits"], batch["labels"])
    if distill is not None and loss_type in ("classification", "both"):
        t_params, t_config, w, temp = distill
        with torch.no_grad():
            t_logits = pruned_vit_forward(t_params, batch["pixel_values"], t_config,
                                          PruneConfig(mode="none", predictor="none"))["logits"]
        cls_loss = (1.0 - w) * cls_loss + w * distillation_kl(out["logits"], t_logits, temp)
    if loss_type == "classification":
        total, pred_loss = cls_loss, torch.zeros((), device=cls_loss.device)
    else:
        pred_loss = out["aux"]["pred_loss"].sum()
        if loss_type == "cosine":
            total = pred_loss
        elif loss_type == "both":
            total = cls_loss + COSINE_LOSS_RATIO * pred_loss
        else:
            raise ValueError(f"loss_type {loss_type!r}")
    metrics = {
        "loss": total.detach(),
        "cls_loss": cls_loss.detach(),
        "pred_loss": pred_loss.detach(),
        "accuracy": (out["logits"].argmax(-1) == batch["labels"]).float().mean(),
    }
    if with_oracle:
        metrics["confusion"] = out["aux"]["confusion"]
    return total, metrics


def _layer_target(pcfg: PruneConfig, aux: dict, i: int):
    if pcfg.loss == "bce_oracle":
        return aux["oracle_keep"][i], weighted_bce_oracle
    if pcfg.loss == "focal":
        return aux["oracle_keep"][i], lambda s, t: focal_loss(
            s, t, alpha=pcfg.focal_alpha, gamma=pcfg.focal_gamma)
    if pcfg.loss == "mse_attention":
        return aux["attn_target"][i], mse_attention_loss
    return aux["cos_target"][i], mse_cosine_loss


def make_train_step(config: ViTConfig, pcfg: PruneConfig, loss_type: str,
                    optimizer: torch.optim.Optimizer, compute_dtype=None, remat: bool = False,
                    distill=None, accum_steps: int = 1,
                    detach_cosine: Optional[bool] = None) -> Callable:
    """One optimization step: step(params, batch, generator=None) ->
    metrics, the params updated in place by `optimizer`.

    compute_dtype (e.g. torch.bfloat16) runs forward and backward in it
    while params, gradients and optimizer state stay float32: the cast is
    in the graph, so the gradients come back in float32.
    accum_steps > 1 splits the batch into equal microbatches and adds their
    gradients (each loss / accum_steps): one microbatch's activations at a
    time, the full batch's update; count metrics are summed, the others
    averaged.
    detach_cosine (None = automatic: on for a 'cosine' phase whose predictor
    reaches the loss only through the scores, without updatenet, neighbour
    averaging or accumulation): run the instrumented forward once with no
    graph, keep each layer's input and target, and differentiate only the
    per-layer score computations. The gradients are the generic step's.
    """
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def loss_fn(p, b, gen):
        if compute_dtype is not None:
            p = _cast(p, compute_dtype)
            b = dict(b, pixel_values=b["pixel_values"].to(compute_dtype))
        return total_loss_fn(p, b, config, pcfg, loss_type, gen, remat=remat, distill=distill)

    detached = (loss_type == "cosine" and accum_steps == 1
                and pcfg.predictor in DETACHABLE_PREDICTORS
                and pcfg.skip_correction != "updatenet" and pcfg.avg_threshold == 0.0
                ) if detach_cosine is None else detach_cosine

    def detached_step(params, batch, generator=None):
        p_fwd = params if compute_dtype is None else _cast(params, compute_dtype)
        pv = batch["pixel_values"]
        pv = pv if compute_dtype is None else pv.to(compute_dtype)
        with torch.no_grad():
            out = pruned_vit_forward(p_fwd, pv, config, pcfg, train=True, generator=generator,
                                     return_layer_inputs=True)
        xs, aux = out["layer_inputs"], out["aux"]
        optimizer.zero_grad(set_to_none=True)
        pp = params["predictor"] if compute_dtype is None else _cast(params["predictor"],
                                                                      compute_dtype)
        total = torch.zeros((), device=pv.device)
        for i in range(config.num_layers):
            if not _is_active(pcfg, i):
                continue
            lp = layer_slice(p_fwd["backbone"]["layers"], i)
            scores, _ = apply_predictor(pp, i, xs[i], config, pcfg, layer_params=lp)
            target, fn = _layer_target(pcfg, aux, i)
            total = total + fn(scores, target)
        total.backward()
        optimizer.step()
        return {"loss": total.detach(), "cls_loss": cross_entropy(out["logits"], batch["labels"]),
                "pred_loss": total.detach(),
                "accuracy": (out["logits"].argmax(-1) == batch["labels"]).float().mean(),
                "confusion": aux["confusion"]}

    def step(params, batch, generator=None):
        optimizer.zero_grad(set_to_none=True)
        if accum_steps == 1:
            loss, metrics = loss_fn(params, batch, generator)
            if loss.requires_grad:  # else no trainable leaf reaches it: nothing moves
                loss.backward()
        else:
            bsz = batch["labels"].shape[0]
            if bsz % accum_steps:
                raise ValueError(f"batch size {bsz} not divisible by accum_steps {accum_steps}")
            mb, sums = bsz // accum_steps, {}
            for j in range(accum_steps):
                micro = {k: v[j * mb:(j + 1) * mb] for k, v in batch.items()}
                loss, m = loss_fn(params, micro, generator)
                if loss.requires_grad:
                    (loss / accum_steps).backward()
                for k, v in m.items():
                    sums[k] = v if k not in sums else sums[k] + v
            metrics = {k: v if k in SUM_METRICS else v / accum_steps for k, v in sums.items()}
        optimizer.step()
        return metrics

    return detached_step if detached else step


def make_eval_step(config: ViTConfig, pcfg: PruneConfig, full_testing: bool) -> Callable:
    """(params, batch) -> {'correct', 'keep_masks'[, 'confusion']} with no
    graph; full_testing adds the oracle pass and its confusion counts.
    Mode 'random' draws from a generator seeded 0 for every batch, as the
    JAX package passes PRNGKey(0)."""

    @torch.no_grad()
    def step(params, batch):
        pv = batch["pixel_values"]
        gen = torch.Generator(device=pv.device).manual_seed(0)
        out = pruned_vit_forward(params, pv, config, pcfg, compute_oracle=full_testing,
                                 generator=gen)
        res = {"correct": (out["logits"].argmax(-1) == batch["labels"]).sum(),
               "keep_masks": out["keep_masks"]}
        if full_testing:
            res["confusion"] = out["aux"]["confusion"]
        return res

    return step


def _to_device(batch: dict, device) -> dict:
    return {k: v.to(device, non_blocking=True) if isinstance(v, torch.Tensor) else v
            for k, v in batch.items()}


def _device_of(params: dict):
    return params["backbone"]["head"]["w"].device


def evaluate(params: dict, batches, config: ViTConfig, pcfg: PruneConfig,
             full_testing: bool = False, log: Optional[Callable[[str], None]] = None,
             eval_step: Optional[Callable] = None):
    """Returns (accuracy, mlp_accuracy, EvalAccumulator)."""
    if eval_step is None:
        eval_step = make_eval_step(config, pcfg, full_testing)
    device = _device_of(params)
    acc = EvalAccumulator(config.num_layers)
    for batch in batches:
        res = eval_step(params, _to_device(batch, device))
        acc.update(
            correct=int(res["correct"]),
            batch=batch["labels"].shape[0],
            confusion=res["confusion"].cpu().numpy() if full_testing else None,
            keep_masks=res["keep_masks"].cpu().numpy(),
        )
    if log is not None and full_testing:
        log(acc.report())
    elif log is not None:
        log(f"Overall accuracy: {acc.accuracy:.2%}\n")
    return acc.accuracy, acc.mlp_accuracy, acc


@torch.no_grad()
def _dump_masks(params, test_batches, config: ViTConfig, pcfg: PruneConfig, viz_dir: str,
                epoch: int):
    """The epoch's mask montages (V9) of the first test batch's first two
    images, as the JAX package's train() draws them."""
    from vit_pruning_tpu_torch.viz.blackout import training_mask_dump

    device = _device_of(params)
    vb = _to_device(next(iter(test_batches)), device)
    gen = torch.Generator(device=device).manual_seed(0)  # mode 'random', as make_eval_step
    out = pruned_vit_forward(params, vb["pixel_values"], config, pcfg, generator=gen)
    training_mask_dump([img.float().cpu().numpy() for img in vb["pixel_values"][:2]],
                       out["keep_masks"].cpu().numpy(), config.patch_size, viz_dir, step=epoch)


def train(
    params: dict,
    train_batches,
    test_batches,
    config: ViTConfig,
    pcfg: PruneConfig,
    *,
    num_epochs: int = 10,
    loss_type: str = "both",
    lr=1e-4,
    log: Optional[Callable[[str], None]] = None,
    best: Optional[BestCheckpoint] = None,
    seed: int = 0,
    full_testing: bool = True,
    state_dir: Optional[str] = None,
    viz_dir: Optional[str] = None,
    compute_dtype=None,
    remat: bool = False,
    distill=None,
    per_layer_lr_scales=None,
    clip_norm: Optional[float] = None,
    accum_steps: int = 1,
) -> dict:
    """One training phase. Returns params (updated in place).

    loss_type 'alternate' switches predictor / backbone phases on epoch % 3.
    per_layer_lr_scales: predictor-only phases take per_predictor_adam, one
    rate per layer's predictor. state_dir: {'params', 'opt_state', 'epoch'}
    saved after every epoch, and a run resumes from it exactly (batches
    with a set_epoch method are reshuffled per epoch; each epoch's random
    draws come from a generator seeded by (seed, epoch)). viz_dir: after
    every epoch, the keep-mask montages of the first test batch's first two
    images (viz/blackout.py::training_mask_dump, step{epoch}_img{i}.png)."""
    log = log or (lambda s: None)
    device = _device_of(params)

    def build(loss_t):
        pol = policy_for_loss_type(loss_t)
        if per_layer_lr_scales is not None and pol == "mlp_train":
            opt = per_predictor_adam(params, lr, per_layer_lr_scales, policy=pol)
        else:
            opt = masked_adam(params, pol, lr, clip_norm=clip_norm)
        return opt, make_train_step(config, pcfg, loss_t, opt, compute_dtype=compute_dtype,
                                    remat=remat, distill=distill, accum_steps=accum_steps)

    start_epoch = 0
    state_path = (os.path.join(os.path.abspath(state_dir), f"state_{loss_type}")
                  if state_dir else None)
    optimizer = step = None
    if loss_type != "alternate":
        optimizer, step = build(loss_type)
    if state_path and os.path.exists(state_path):
        state = restore_checkpoint(state_path, {"params": params})
        if optimizer is not None:  # alternate rebuilds its optimizer every epoch
            optimizer.load_state_dict(state["opt_state"])
        start_epoch = int(state["epoch"]) + 1
        log(f"resumed from {state_path} at epoch {start_epoch}")
    eval_step = make_eval_step(config, pcfg, full_testing)

    for epoch in range(start_epoch, num_epochs):
        if loss_type == "alternate":
            optimizer, step = build("cosine" if epoch % 3 == 0 else "classification")
        if hasattr(train_batches, "set_epoch"):
            train_batches.set_epoch(epoch)
        gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + epoch)
        running, nb = 0.0, 0
        tracker = MLPTracker(config.num_layers)
        t_epoch = time.perf_counter()
        for batch in train_batches:
            metrics = step(params, _to_device(batch, device), gen)
            running += float(metrics["loss"])
            if "confusion" in metrics:
                tracker.update(metrics["confusion"].cpu().numpy())
            nb += 1
        t_epoch = time.perf_counter() - t_epoch
        log(f"epoch {epoch}: {nb} steps in {t_epoch:.1f}s "
            f"({1e3 * t_epoch / max(nb, 1):.1f} ms/step incl. host)")
        if tracker.samples.sum() > 0:
            log(tracker.report() + "\n")
        val_acc, _, _ = evaluate(params, test_batches, config, pcfg, full_testing=full_testing,
                                 log=log, eval_step=eval_step)
        if best is not None:
            best.update(val_acc, params)
        if state_path:
            state = {"params": params, "epoch": epoch}
            if loss_type != "alternate":
                state["opt_state"] = optimizer.state_dict()
            save_checkpoint(state_path, state)
        if viz_dir:
            _dump_masks(params, test_batches, config, pcfg, viz_dir, epoch)
        log(f"Test accuracy after {epoch + 1} epochs: {val_acc:.2%}\n")
    if best is not None:
        log(f"Best accuracy: {best.best_accuracy * 100}%\n")
    return params


def phased_train(
    params: dict,
    train_batches,
    test_batches,
    config: ViTConfig,
    pcfg: PruneConfig,
    *,
    train_type: str = "both",
    loss_types=("cosine", "classification"),
    num_epochs=(10, 10),
    lrs=(1e-3, 1e-5),
    log: Optional[Callable[[str], None]] = None,
    best: Optional[BestCheckpoint] = None,
    full_testing: bool = True,
    compute_dtype=None,
    per_layer_lr_scales=None,
    accum_steps: int = 1,
) -> dict:
    """The reference's two phases: train_type 'mlp' runs the first
    (predictors, cosine loss, lr 1e-3), 'vit' the second (backbone,
    classification, lr 1e-5), 'both' both, 'none' neither (eval only)."""
    log = log or (lambda s: None)
    acc0 = evaluate(params, test_batches, config, pcfg, full_testing=full_testing, log=log)
    log(f"Test accuracy at starting: {acc0[:2]}")
    if train_type in ("mlp", "both"):
        params = train(params, train_batches, test_batches, config, pcfg,
                       num_epochs=num_epochs[0], loss_type=loss_types[0], lr=lrs[0], log=log,
                       best=best, full_testing=full_testing, compute_dtype=compute_dtype,
                       per_layer_lr_scales=per_layer_lr_scales, accum_steps=accum_steps)
    if train_type in ("vit", "both"):
        params = train(params, train_batches, test_batches, config, pcfg,
                       num_epochs=num_epochs[1], loss_type=loss_types[1], lr=lrs[1], log=log,
                       best=None, full_testing=full_testing, compute_dtype=compute_dtype,
                       accum_steps=accum_steps)
    return params
