"""Train, eval and serving steps over a ('data', 'model') mesh.

Mirrors vit_pruning_tpu/parallel/steps.py. There each step is one jitted
global program over sharded arrays; here each rank runs the port's own
single-process step on its shard of the batch, and the collectives that XLA
inserts are explicit:

  * params: each rank keeps its slice of every leaf (sharding.py::
    shard_params). A step gathers the model-sharded leaves over 'model'
    (collectives.py::gather_with_grad) and runs the unchanged single-process
    forward on whole weights: the JAX package wraps no Pallas call in a
    partitioning rule, so under pjit XLA hands its kernels whole operands
    too. On the card the layers run kernels B1 / B2 as in one process.
    The whole tree is gathered at the start of the step, one collective a
    leaf: the train step's graph keeps every gathered weight for the
    backward in any case, and a gather a layer would be L times as many
    collectives. So a step's peak holds the whole weights on every rank,
    in the eval and serving steps too: model sharding divides the weights
    a rank keeps between steps, not its peak.
  * batch: rows over 'data'; the ranks of one 'model' line hold the same
    rows and compute the same thing. The step's objective is the mean of
    all ranks' losses, which is the single-process loss: the ranks' losses
    are means over equal shards, and weighted_bce_oracle takes its label
    mean over the data group (train/losses.py::batch_group).
  * gradients: a gathered leaf's backward sums its gradient over 'model'
    and keeps the rank's slice; replicated leaves are summed over 'model'
    too; then every gradient is summed over 'data' and divided by the
    number of ranks.
  * ZeRO-1 (zero1=True): each data rank keeps Adam's moments for its block
    of every leaf, on the first unsharded dim of size >= data that data
    divides (`_zero1_spec`, the JAX package's rule), updates that block and
    all-gathers the params over 'data'. clip_norm takes the global norm.
  * mode 'random': every rank draws the whole batch's noise from the
    caller's generator and keeps its rows (ops/masking.py::draw_rows), so
    the masks are the single-process step's.

The steps follow the port's conventions: step(params, batch, generator=None)
-> metrics with the params (this rank's slices) updated in place; metrics
are the global ones (loss, cls_loss, pred_loss and accuracy the global
means, confusion summed over 'data'), the same on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.distributed.device_mesh import DeviceMesh

from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
from vit_pruning_tpu_torch.models.convert import flatten_tree
from vit_pruning_tpu_torch.ops.masking import draw_rows
from vit_pruning_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_,
    gather_with_grad,
)
from vit_pruning_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size
from vit_pruning_tpu_torch.parallel.sharding import map_specs, resolve_pspecs, sharded_dim
from vit_pruning_tpu_torch.serving import serving_forward
from vit_pruning_tpu_torch.train.freeze import Adam
from vit_pruning_tpu_torch.train.harness import make_eval_step, make_train_step
from vit_pruning_tpu_torch.train.losses import batch_group

MEAN_METRICS = ("loss", "cls_loss", "pred_loss", "accuracy")


def gather_params(params: dict, specs: dict, mesh: DeviceMesh) -> dict:
    """The whole tree from this rank's slices: each leaf that `specs`
    splits over 'model' gathered (differentiably), the others the same
    tensors."""
    group = axis_group(mesh, "model")

    def leaf(t, spec):
        dim = sharded_dim(spec, "model")
        return t if dim is None else gather_with_grad(t, dim, group)

    return map_specs(params, specs, leaf)


def _zero1_spec(shape, spec: tuple, mesh: DeviceMesh) -> tuple:
    """ZeRO-1 moment spec: additionally shard over 'data' on the first
    unsharded axis that divides the data-axis size. Placements over
    'model' stay (ZeRO composes with tp); leaves with no divisible axis
    keep the param's spec. An unsharded dim has the same size in a slice
    and in the whole leaf, so `shape` may be either's."""
    nd = axis_size(mesh, "data")
    if nd == 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for dim, axis in enumerate(entries):
        if axis is None and shape[dim] >= nd and shape[dim] % nd == 0:
            entries[dim] = "data"
            return tuple(entries)
    return spec


def zero1_pspecs(params_like: dict, mesh: DeviceMesh) -> dict:
    """Optimizer-moment specs for ZeRO-1: each param's resolved spec with
    'data' added on a divisible axis (see _zero1_spec)."""
    return map_specs(params_like, resolve_pspecs(params_like, mesh),
                     lambda a, s: _zero1_spec(a.shape, s, mesh))


def opt_state_shardings(params_like: dict, mesh: DeviceMesh, zero1: bool = False) -> dict:
    """The specs of Adam's moments: each param's own (a moment has the
    shape of the param's slice, co-sharded with it), or ZeRO-1's."""
    return zero1_pspecs(params_like, mesh) if zero1 else resolve_pspecs(params_like, mesh)


def _sum_over(tensors: list, group):
    """Sum every tensor over `group` in place, one collective per dtype."""
    if group is None or not tensors:
        return
    for dtype in {t.dtype for t in tensors}:
        same = [t for t in tensors if t.dtype == dtype]
        flat = all_reduce_(torch.cat([t.reshape(-1) for t in same]), group)
        for t, part in zip(same, flat.split([t.numel() for t in same])):
            t.copy_(part.view_as(t))


class _ParallelUpdate:
    """What make_train_step sees as its optimizer: zero_grad as the port's
    Adam, and a step that first reduces the gradients over the mesh, then
    updates through the Adam's own arithmetic (Adam.updates), whole leaves
    or, under ZeRO-1, this data rank's block of each."""

    def __init__(self, optimizer: Adam, mesh: DeviceMesh, zero1: bool):
        self.opt, self.mesh, self.zero1 = optimizer, mesh, zero1
        self.spec_of = {}

    def bind(self, params: dict, specs: dict):
        """The spec of each param the optimizer holds, from the trees."""
        by_path = dict(flatten_tree(specs))
        self.spec_of = {id(t): by_path[path] for path, t in flatten_tree(params)}

    def zero_grad(self, set_to_none: bool = True):
        self.opt.zero_grad(set_to_none=set_to_none)

    def block(self, p: torch.Tensor):
        """(dim, start, width) of this data rank's ZeRO-1 block of p, or
        None where p keeps whole moments."""
        if not self.zero1:
            return None
        spec = self.spec_of[id(p)]
        z = sharded_dim(_zero1_spec(p.shape, spec, self.mesh), "data")
        if z is None:
            return None
        width = p.shape[z] // axis_size(self.mesh, "data")
        return z, axis_index(self.mesh, "data") * width, width

    @torch.no_grad()
    def step(self):
        mesh = self.mesh
        params = [p for g in self.opt.param_groups for p in g["params"]]
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        sharded = [sharded_dim(self.spec_of[id(p)], "model") is not None for p in params]
        model_g, data_g = axis_group(mesh, "model"), axis_group(mesh, "data")
        # a gathered leaf's gradient was summed over 'model' by the gather's backward
        _sum_over([g for g, s in zip(grads, sharded) if not s], model_g)
        _sum_over(grads, data_g)
        world = axis_size(mesh, "data") * axis_size(mesh, "model")
        if world > 1:
            grads = [g / world for g in grads]
        norm = None
        if self.opt.clip_norm is not None:  # the global norm: slices summed over 'model'
            sq = [(g.float() ** 2).sum() for g in grads]
            zero = torch.zeros((), device=params[0].device)
            whole = sum((q for q, s in zip(sq, sharded) if not s), zero)
            sliced = sum((q for q, s in zip(sq, sharded) if s), zero)
            norm = torch.sqrt(whole + all_reduce_(sliced, model_g))
        blocks = [self.block(p) for p in params]
        parts = [g if b is None else g.narrow(*b) for g, b in zip(grads, blocks)]
        for p, u, b in zip(params, self.opt.updates(grads=parts, norm=norm), blocks):
            if b is None:
                p.add_(u.to(p.dtype))
            else:
                piece = p.narrow(*b)
                piece.add_(u.to(p.dtype))
                p.copy_(all_gather(piece, b[0], data_g))


def init_sharded_opt_state(optimizer: Adam, params: dict, mesh: DeviceMesh, specs: dict,
                           zero1: bool = False) -> dict:
    """Adam's state for this rank's slices, allocated now: moments of each
    slice's shape, or under zero1 of this data rank's block of it. Returns
    {path: state} over the leaves the optimizer holds (a parallel step
    would allocate the same state at its first update)."""
    update = _ParallelUpdate(optimizer, mesh, zero1)
    update.bind(params, specs)
    held = {id(p) for g in optimizer.param_groups for p in g["params"]}
    out = {}
    for path, p in flatten_tree(params):
        if id(p) not in held:
            continue
        b = update.block(p)
        shape = p.shape if b is None else p.narrow(*b).shape
        st = optimizer.state[p]
        st.clear()
        st.update(count=0, mu=torch.zeros(shape, dtype=p.dtype, device=p.device),
                  nu=torch.zeros(shape, dtype=p.dtype, device=p.device))
        out[path] = st
    return out


def _reduce_metrics(metrics: dict, group, n: int) -> dict:
    """The global metrics from every data rank's: means of the means of
    equal shards, sums of the counts."""
    if group is None:
        return metrics
    out = dict(metrics)
    keys = [k for k in MEAN_METRICS if k in metrics]
    vals = all_reduce_(torch.stack([metrics[k].detach().float().reshape(()) for k in keys]),
                       group) / n
    out.update(zip(keys, vals))
    if "confusion" in metrics:
        out["confusion"] = all_reduce_(metrics["confusion"].clone(), group)
    return out


def make_parallel_train_step(
    config: ViTConfig,
    pcfg: PruneConfig,
    loss_type: str,
    optimizer: Adam,
    mesh: DeviceMesh,
    specs: dict,
    zero1: bool = False,
) -> Callable:
    """step(params, batch, generator=None) -> metrics, over the mesh.
    params: this rank's slices (shard_params); specs: their spec tree (the
    second result of shard_params); batch: this rank's rows (shard_batch);
    optimizer: the port's Adam over the slices (masked_adam(params, ...)).
    zero1=True shards Adam's moments over 'data' as well (see the module
    docstring)."""
    if not isinstance(optimizer, Adam):
        raise TypeError(f"the parallel step updates through the port's Adam, got "
                        f"{type(optimizer).__name__}")
    if zero1 and any(g["scale"] is not None for g in optimizer.param_groups):
        raise ValueError("zero1: per-layer update scales (per_predictor_adam) are not "
                         "sharded; use zero1=False")
    update = _ParallelUpdate(optimizer, mesh, zero1)
    inner = make_train_step(config, pcfg, loss_type, update)
    data_g, nd, di = axis_group(mesh, "data"), axis_size(mesh, "data"), axis_index(mesh, "data")

    def step(params, batch, generator=None):
        update.bind(params, specs)
        rows = batch["labels"].shape[0]
        with batch_group(data_g), draw_rows(rows * nd, rows * di):
            metrics = inner(gather_params(params, specs, mesh), batch, generator)
        return _reduce_metrics(metrics, data_g, nd)

    return step


def make_parallel_eval_step(
    config: ViTConfig,
    pcfg: PruneConfig,
    mesh: DeviceMesh,
    specs: dict,
    full_testing: bool = False,
) -> Callable:
    """step(params, batch) -> {'correct', 'keep_masks'[, 'confusion']} for
    the whole batch: correct and confusion summed over 'data', keep_masks
    [L, B, S] gathered from every data rank's rows."""
    inner = make_eval_step(config, pcfg, full_testing)
    data_g, nd, di = axis_group(mesh, "data"), axis_size(mesh, "data"), axis_index(mesh, "data")

    @torch.no_grad()
    def step(params, batch):
        rows = batch["labels"].shape[0]
        with draw_rows(rows * nd, rows * di):
            res = inner(gather_params(params, specs, mesh), batch)
        res["correct"] = all_reduce_(res["correct"].clone(), data_g)
        if "confusion" in res:
            res["confusion"] = all_reduce_(res["confusion"].clone(), data_g)
        res["keep_masks"] = all_gather(res["keep_masks"], 1, data_g)
        return res

    return step


def make_parallel_serving_step(
    config: ViTConfig,
    pcfg: PruneConfig,
    mesh: DeviceMesh,
    specs: dict,
) -> Callable:
    """Scale-out deployment forward: step(params, pixels_u8) -> logits of
    this rank's rows (uint8 [B / data, C, H, W], shard_batch), with the
    same param slices as eval; on the card the layers run B1 and the last
    one B2, as serving.py::serving_forward does in one process."""

    @torch.no_grad()
    def step(params, pixels_u8):
        return serving_forward(gather_params(params, specs, mesh), pixels_u8, config, pcfg,
                               logits_only=True)["logits"]

    return step
