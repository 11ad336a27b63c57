"""Freeze policies and the optimizers that honour them.

Mirrors vit_pruning_tpu/train/freeze.py. A policy is a boolean tree over the
params (True = trainable), as the reference toggles requires_grad over
module subsets and builds a new Adam over the trainable ones each phase.
optax's masked Adam becomes `Adam`, a torch.optim optimizer of the port's
own with optax.adam's update rule: it holds only the trainable leaves, so a
frozen leaf gets no update and no Adam state; `masked_adam` also sets
requires_grad on every leaf by the policy, so autograd computes no gradient
for a frozen one. clip_norm clips by the global norm of the trainable
leaves' gradients, as optax's multi_transform does; lr is a float or a
callable from the step count (0 at the first update) to the rate.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Union

import torch

from vit_pruning_tpu_torch.models.convert import flatten_tree

POLICIES = (
    "vit_mlp_train",         # everything trainable
    "vit_train",             # backbone only, predictors frozen
    "mlp_train",             # predictors only
    "classifier_train",      # classifier head only
    "classifier_mlp_train",  # head + predictors
)


def _fill(tree, value: bool):
    if isinstance(tree, dict):
        return {k: _fill(v, value) for k, v in tree.items()}
    return None if tree is None else value


def freeze_mask(params: dict, policy: str) -> dict:
    """Boolean tree: True = trainable under `policy`. Trees beside the
    backbone and the predictor (updatenet) follow the predictor."""
    if policy not in POLICIES:
        raise ValueError(f"policy {policy!r} not in {POLICIES}")
    backbone, pred = params["backbone"], params.get("predictor")
    head_only = policy in ("classifier_train", "classifier_mlp_train")
    bb = _fill(backbone, policy in ("vit_mlp_train", "vit_train"))
    if head_only:
        bb["head"] = _fill(backbone["head"], True)
    pred_trainable = policy in ("vit_mlp_train", "mlp_train", "classifier_mlp_train")
    mask = {"backbone": bb, "predictor": _fill(pred, pred_trainable)}
    for extra in params:
        if extra not in mask:
            mask[extra] = _fill(params[extra], pred_trainable)
    return mask


def policy_for_loss_type(loss_type: str) -> str:
    """The phase's policy: cosine trains the predictors, classification the
    backbone, both everything."""
    return {"cosine": "mlp_train", "classification": "vit_train",
            "both": "vit_mlp_train"}.get(loss_type, "vit_mlp_train")


class Adam(torch.optim.Optimizer):
    """optax.adam over `params` (b1 0.9, b2 0.999, eps 1e-8): with g the
    gradient (zeros where .grad is None), mu and nu its moments and t the
    update count, the update is -lr(t - 1) * mu_hat / (sqrt(nu_hat) + eps).
    clip_norm: the gradients first scaled by clip_norm / their global norm
    where that norm exceeds it (optax.clip_by_global_norm). A param group's
    'scale' (a tensor broadcast against its params, or None) multiplies its
    updates after Adam (per_predictor_adam's per-layer rates)."""

    def __init__(self, params, lr: Union[float, Callable[[int], float]],
                 clip_norm: Optional[float] = None, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        super().__init__(params, {"scale": None})
        self.lr, self.clip_norm, self.b1, self.b2, self.eps = lr, clip_norm, b1, b2, eps

    @torch.no_grad()
    def updates(self, grads: Optional[list] = None, norm: Optional[torch.Tensor] = None) -> list:
        """The updates for the current gradients, one per param in group
        order; advances the moments and the count. step() adds them.

        grads: the gradients to use instead of the params' .grad, one per
        param in group order, each the param's shape or a block of it; a
        param's moments take the shape of its first gradient, so ZeRO-1
        (parallel/steps.py) keeps only its block's. norm: the global
        gradient norm for clip_norm when the gradients are a part of it."""
        params = [p for g in self.param_groups for p in g["params"]]
        if grads is None:
            grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        if self.clip_norm is not None:
            if norm is None:
                norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
            if norm >= self.clip_norm:
                grads = [g / norm.to(g.dtype) * self.clip_norm for g in grads]
        out, i = [], 0
        for group in self.param_groups:
            for p in group["params"]:
                g, st = grads[i], self.state[p]
                i += 1
                if not st:
                    st["count"] = 0
                    st["mu"], st["nu"] = torch.zeros_like(g), torch.zeros_like(g)
                lr = self.lr(st["count"]) if callable(self.lr) else self.lr
                st["count"] += 1
                t = st["count"]
                st["mu"].mul_(self.b1).add_(g * (1.0 - self.b1))
                st["nu"].mul_(self.b2).add_(g.square() * (1.0 - self.b2))
                mu_hat = st["mu"] / (1.0 - self.b1 ** t)
                nu_hat = st["nu"] / (1.0 - self.b2 ** t)
                u = mu_hat / (torch.sqrt(nu_hat) + self.eps) * -lr
                if group["scale"] is not None:
                    u = u * group["scale"]
                out.append(u)
        return out

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for g in self.param_groups for p in g["params"]]
        for p, u in zip(params, self.updates()):
            p.add_(u.to(p.dtype))


def trainable_leaves(params: dict, policy: str) -> list:
    """[(path, leaf)] of the leaves `policy` trains; sets requires_grad on
    every leaf of `params` by the policy (the reference's toggling)."""
    mask = dict(flatten_tree(freeze_mask(params, policy)))
    out = []
    for path, leaf in flatten_tree(params):
        leaf.requires_grad_(bool(mask[path]))
        if mask[path]:
            out.append((path, leaf))
    return out


def masked_adam(params: dict, policy: str, lr, clip_norm: Optional[float] = None) -> Adam:
    """Adam over the leaves `policy` trains (requires_grad set by it on
    every leaf); frozen leaves get no update and no state."""
    return Adam([leaf for _, leaf in trainable_leaves(params, policy)], lr, clip_norm)


def per_predictor_adam(params: dict, lr, lr_scales: Optional[Sequence[float]] = None,
                       policy: str = "mlp_train") -> Adam:
    """Each layer's predictor with its own learning rate: lr_scales [L]
    multiplies the update of every predictor leaf stacked on the leading
    [L] axis, slice by slice; leaves under a 'shared_' key hold one set of
    weights for every layer and are not scaled (their leading dim may
    equal L by chance). Adam is elementwise and each predictor's loss
    reaches only its own weights, so with lr_scales None this is
    masked_adam."""
    leaves = trainable_leaves(params, policy)
    if lr_scales is None:
        return Adam([leaf for _, leaf in leaves], lr)
    scales = torch.as_tensor(lr_scales, dtype=torch.float32)
    groups = []
    for path, leaf in leaves:
        scale = None
        if (path[0] == "predictor" and not path[1].startswith("shared_") and leaf.dim() >= 1
                and leaf.shape[0] == scales.shape[0]):
            scale = scales.reshape((-1,) + (1,) * (leaf.dim() - 1)).to(leaf.device, leaf.dtype)
        groups.append({"params": [leaf], "scale": scale})
    return Adam(groups, lr)
