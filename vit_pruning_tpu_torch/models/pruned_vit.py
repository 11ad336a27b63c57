"""Pruned ViT: the re-decide modes and progressive top-k compaction.

Mirrors vit_pruning_tpu/models/pruned_vit.py, serving and training:

  pruned_vit_forward  every layer scores all positions again, keeps some and
                      carries the skipped ones through (modes mask, topk,
                      oracle, random; none routes through vit_forward,
                      topk_prog through progressive_topk_forward)
  progressive_topk_forward
                      dropped tokens never rejoin; the sequence shrinks per
                      keep_schedule (optionally merging the dropped tokens)

The JAX package compacts tokens with one-hot matmuls (a TPU workaround for
slow dynamic gathers); here rows are gathered and scattered by index, with
the same kept set and the same kept-first stable row order.

Kernels: a budget-bounded layer (topk, mask with mask_budget, random) runs
as kernel B3 (ops/cuda/layer.py::fused_vit_layer_bucketed); every other
layer goes through vit_layer (kernel B1); with logits_only=True the
progressive path's last layer, final LN and classifier run as kernel B2.
Under encoder fusion the progressive path's layers between two drops run as
one call of kernel B5 each (ops/cuda/model.py), and mode 'none' inherits
vit_forward's route.
Under int8 serving (`quant`) every layer goes through vit_layer's int8
route (kernel B4), B3 included: a budget-bounded layer gathers to its cap
and runs B4 there. The stacked weights are quantized once per forward; the
float weights stay beside them for the predictors and the float B2 tail.

Training (train=True) and the oracle instrumentation (compute_oracle /
oracle: the dense teacher pass per layer, or the parallel teacher stream,
the predictor losses and the aux outputs) take the JAX package's static
training paths: the full-length masked layer (B1 with the key mask) in
modes mask / random / query_only, and in mode topk the top-k gather, the
layer at k + 1 (B1) and the scatter back; topk_prog trains as topk. B1 and
B5 are differentiable (their Functions recompute the plain layers in the
backward); the teacher signals are computed under torch.no_grad() where
the JAX package stop-grads them, outside the (remat'd) layer where it
hoists them. Training runs unquantized.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
from vit_pruning_tpu_torch.models.predictors import (
    apply_predictor,
    apply_updatenet,
    init_predictor_params,
    init_updatenet_params,
)
from vit_pruning_tpu_torch.models.vit import (
    check_attn_geometry,
    embed,
    encoder_route,
    init_vit_params,
    layer_norm,
    layer_range,
    layer_slice,
    layers_for,
    vit_forward,
    vit_layer,
)
from vit_pruning_tpu_torch.ops.cuda.layer import (
    bucket_compact,
    bucket_expand,
    fused_vit_layer_bucketed,
)
from vit_pruning_tpu_torch.ops.dispatch import kernels_enabled, resolve_quant
from vit_pruning_tpu_torch.ops.masking import (
    add_cls_keep,
    compact_dest,
    confusion_counts,
    gather_compact,
    neighbor_average,
    neighbor_index_table,
    random_keep_mask,
    rank_keep_mask,
    scatter_back,
    similarity_oracle,
    threshold_keep_mask,
    topk_keep_mask,
)
from vit_pruning_tpu_torch.train.losses import (
    focal_loss,
    mse_attention_loss,
    mse_cosine_loss,
    weighted_bce_oracle,
)


def init_pruned_vit_params(
    config: ViTConfig,
    pcfg: PruneConfig,
    generator: torch.Generator,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """{'backbone', 'predictor' (None for predictor='none')} and, with
    skip_correction='updatenet', 'updatenet'."""
    params = {
        "backbone": init_vit_params(config, generator, device, dtype),
        "predictor": init_predictor_params(config, pcfg, generator, device, dtype),
    }
    if pcfg.skip_correction == "updatenet":
        params["updatenet"] = init_updatenet_params(config, generator, device, dtype)
    return params


def _is_active(pcfg: PruneConfig, i: int) -> bool:
    if pcfg.mode == "none":
        return False
    return pcfg.active_layers is None or i in pcfg.active_layers


# --- re-decide modes -----------------------------------------------------------------

def _bucket_caps(s: int) -> tuple:
    """Capacity ladder of the uncapped mask mode: 24-step rungs from ~3/8 of
    the sequence up to its full length (S 197: 80, 104, 128, 152, 176, 197)."""
    lo = max(16, ((int(s * 0.375) + 15) // 16) * 16)
    return tuple(sorted(set(range(lo, s, 24)) | {s}))


def bucketed_masked_layer(
    x: torch.Tensor,
    layer_params: dict,
    mask: torch.Tensor,
    config: ViTConfig,
    cap_hint: Optional[int] = None,
    passthrough: Optional[torch.Tensor] = None,
    quant: str = "none",
) -> torch.Tensor:
    """Mask-mode layer that computes only at a capacity holding the kept
    tokens: each kept token attends over exactly the kept keys, skipped
    tokens carry `passthrough` (None = x itself). The result is finished.

    cap_hint: a static bound on every image's kept count (mask_budget + 1,
    top_k + 1, the random budget + 1). With it, the layer runs at exactly
    that capacity, as kernel B3 when kernels are on (float only), else as
    the plain gather -> vit_layer -> scatter; neither route reads the device
    from the host. Under quant='int8' the gather route runs vit_layer's int8
    layer (B4) at the cap: the JAX package adds cap_hint to its ladder
    instead and may pick a smaller rung, but keys past an image's count
    weigh exp(-1e30 - max) = 0, so its kept rows are the same.

    Without it, the rung is the smallest of _bucket_caps holding the batch's
    largest kept count. JAX picks it with lax.switch on the device; the port
    reads that count on the host, ONE sync per layer (`int(counts.max())`),
    and only on this uncapped route. The full-length rung runs the masked
    layer in place (B1 with the token mask); a shorter rung gathers the
    kept-first rows, runs vit_layer with keys `row < count` (B1 at the
    rung's length) and scatters them back.
    """
    b, s, _ = x.shape
    dest = compact_dest(mask)
    if cap_hint is not None and cap_hint < s:
        if kernels_enabled() and quant != "int8":
            y = fused_vit_layer_bucketed(x, layer_params, dest, mask, cap_hint,
                                         config.num_heads, config.layernorm_eps)
            return y if passthrough is None else torch.where(mask[..., None], y, passthrough)
        cap = cap_hint
    else:
        maxc = int(mask.sum(-1).max())  # the host read of the uncapped ladder
        cap = next(c for c in _bucket_caps(s) if c >= maxc)
        if cap == s:
            y = vit_layer(x, layer_params, config, token_mask=mask, quant=quant)
            return torch.where(mask[..., None], y, x if passthrough is None else passthrough)
    xc, key_ok = bucket_compact(x, dest, mask, cap)
    yc = vit_layer(xc, layer_params, config, token_mask=key_ok, quant=quant)
    return bucket_expand(x if passthrough is None else passthrough, yc, dest, mask, cap)


def _sim_threshold(pcfg: PruneConfig, layer_idx: int) -> float:
    """Per-layer oracle threshold (one float or a per-layer tuple)."""
    st = pcfg.sim_threshold
    return st[layer_idx] if isinstance(st, tuple) else st


def _mlp_threshold(pcfg: PruneConfig, layer_idx: int) -> float:
    """Per-layer predictor threshold (one float or a per-layer tuple)."""
    mt = pcfg.mlp_threshold
    return mt[layer_idx] if isinstance(mt, tuple) else mt


def _hoistable_oracle(pcfg: PruneConfig) -> bool:
    """Can the layer's teacher signals be computed outside its autograd /
    remat scope (_hoisted_oracle_targets)? Every consumer detaches them
    and the dense pass is not the layer's output. Not for mode 'oracle'
    and measure_only (the dense pass is the output) nor key_cosine (its
    predictor runs the dense pass anyway)."""
    return (pcfg.mode in ("mask", "topk", "topk_prog", "random")
            and not pcfg.measure_only and pcfg.predictor != "key_cosine")


def _cos_target(dense_p: torch.Tensor, oracle_in: torch.Tensor) -> torch.Tensor:
    """(cos(dense_p, oracle_in) + 1) / 2 per token: mse_cosine's target."""
    dot = (dense_p * oracle_in).sum(-1)
    nrm = torch.linalg.vector_norm(dense_p, dim=-1) * torch.linalg.vector_norm(oracle_in, dim=-1)
    return (dot / nrm.clamp_min(1e-12) + 1.0) / 2.0


@torch.no_grad()
def _hoisted_oracle_targets(layer_params: dict, layer_idx: int, x: torch.Tensor,
                            config: ViTConfig, pcfg: PruneConfig,
                            teacher: Optional[tuple]) -> dict:
    """The predictor loss's teacher signals, outside the layer's autograd
    and remat scope: one dense pass with no graph, and small [B, N]
    results kept for the backward instead of [B, S, D] activations.
    Returns {'similarity', 'oracle_keep'} and 'attn_target' (mse_attention)
    or 'cos_target' (mse_cosine)."""
    t: dict = {}
    dense_out = None
    if pcfg.loss == "mse_attention":
        # the target needs the probabilities: the per-op plain layer, as the
        # JAX package's (use_pallas False)
        dense_out, probs = vit_layer(x, layer_params, config, return_probs=True,
                                     use_kernels=False)
        t["attn_target"] = probs[:, :, 0, 1:].mean(dim=1)
    elif teacher is None:
        dense_out = vit_layer(x, layer_params, config, quant="none")
    if teacher is not None:  # the parallel teacher stream
        oracle_in, dense_p = teacher[0][:, 1:], teacher[1][:, 1:]
    else:
        oracle_in, dense_p = x[:, 1:], dense_out[:, 1:]
    sim = similarity_oracle(oracle_in, dense_p, pcfg.oracle_alpha)
    t["similarity"] = sim
    t["oracle_keep"] = sim < _sim_threshold(pcfg, layer_idx)
    if pcfg.loss == "mse_cosine":
        t["cos_target"] = _cos_target(dense_p, oracle_in)
    return t


def _passthrough(x: torch.Tensor, extras: dict, mask: torch.Tensor) -> torch.Tensor:
    """Value carried by skipped tokens: x itself, or x + the learned /
    CLS-direction approximation of the layer's residual."""
    if "approx_residual" in extras:
        return torch.cat([x[:, 0:1], x[:, 1:] + extras["approx_residual"]], dim=1)
    return x


def pruned_layer_forward(
    layer_params: dict,
    pred_params: Optional[dict],
    layer_idx: int,
    x: torch.Tensor,
    config: ViTConfig,
    pcfg: PruneConfig,
    *,
    prev_keep: Optional[torch.Tensor],
    nbr_idx: torch.Tensor,
    random_keep: Optional[torch.Tensor] = None,
    updatenet_params: Optional[dict] = None,
    quant: str = "none",
    need_oracle: bool = False,
    teacher: Optional[tuple] = None,
    train: bool = False,
    oracle_targets: Optional[dict] = None,
):
    """One pruned encoder layer. Returns (x_out, info): info holds
    'keep_mask' [B, S] bool and 'scores' [B, N], and with need_oracle also
    'pred_loss' (scalar), 'similarity' [B, N], 'oracle_keep' [B, N] bool,
    'confusion' [2, 2] (+ 'cos_target' / 'attn_target' for those losses).

    random_keep [B, N] bool is mode random's patch mask, drawn by the
    caller (outside any checkpointed scope, so that a recompute sees it).
    train (or need_oracle) takes the static training paths instead of the
    serving-only bucketed layer. teacher (x_in, x_out) of the parallel
    teacher stream; oracle_targets from _hoisted_oracle_targets, when given,
    spare the layer its own dense pass. Under quant='int8' every layer pass
    runs int8 except key_cosine's own dense pass, which stays float (and is
    reused as the oracle / measure_only pass, as in the JAX package)."""
    b, s, _ = x.shape
    n = s - 1

    # neighbour refresh of previously skipped tokens
    if pcfg.avg_threshold > 0.0 and prev_keep is not None:
        patches = neighbor_average(x[:, 1:], nbr_idx, pcfg.avg_threshold,
                                   source_mask=~prev_keep[:, 1:])
        x = torch.cat([x[:, 0:1], patches], dim=1)

    # score and select
    extras: dict = {}
    if pcfg.predictor != "none" and pred_params is not None:
        scores, extras = apply_predictor(pred_params, layer_idx, x, config, pcfg,
                                         layer_params=layer_params)
    else:
        scores = torch.ones((b, n), dtype=x.dtype, device=x.device)
    if pcfg.skip_correction == "updatenet" and updatenet_params is not None:
        extras["approx_residual"] = apply_updatenet(updatenet_params, layer_idx, x)
    elif pcfg.skip_correction == "cls_direction":
        cls = x[:, 0:1]
        norm = torch.linalg.vector_norm(cls, dim=-1, keepdim=True).clamp_min(1e-12)
        extras["approx_residual"] = (cls / norm).expand_as(x[:, 1:])

    # key_cosine computed the dense pass already: reuse it
    dense_out = extras.get("dense_out")
    probs = None
    need_probs = need_oracle and pcfg.loss == "mse_attention" and oracle_targets is None
    if (pcfg.mode == "oracle" or pcfg.measure_only or need_probs
            or (need_oracle and teacher is None and oracle_targets is None)):
        if need_probs:
            dense_out, probs = vit_layer(x, layer_params, config, return_probs=True,
                                         use_kernels=False)
        elif dense_out is None:
            dense_out = vit_layer(x, layer_params, config, quant=quant)
    static = need_oracle or train  # the training paths: one differentiable shape

    def passthrough_arg(mask):
        return _passthrough(x, extras, mask) if "approx_residual" in extras else None

    if pcfg.mode == "mask":
        keep = threshold_keep_mask(scores, _mlp_threshold(pcfg, layer_idx))
        if pcfg.mask_budget is not None and pcfg.mask_budget < n:
            # at most mask_budget of the above-threshold tokens, by score rank
            capped = rank_keep_mask(torch.where(keep, scores, float("-inf")), pcfg.mask_budget)
            keep = keep & capped
        mask = add_cls_keep(keep)
        if pcfg.measure_only:
            out = dense_out  # masks and stats only, dense execution
        elif pcfg.query_only:
            # skipped tokens stay in K/V; only their own outputs are discarded
            y = vit_layer(x, layer_params, config, quant=quant)
            out = torch.where(mask[..., None], y, _passthrough(x, extras, mask))
        elif static:
            y = vit_layer(x, layer_params, config, token_mask=mask, quant=quant)
            out = torch.where(mask[..., None], y, _passthrough(x, extras, mask))
        else:
            hint = pcfg.mask_budget + 1 if pcfg.mask_budget is not None else None
            out = bucketed_masked_layer(x, layer_params, mask, config, cap_hint=hint,
                                        passthrough=passthrough_arg(mask), quant=quant)
    elif pcfg.mode == "topk" and static:
        # CLS + the sorted top-k patches, gathered, the layer at k + 1, scattered back
        keep, kidx = topk_keep_mask(scores, pcfg.top_k)
        mask = add_cls_keep(keep)
        cidx = torch.cat([torch.zeros((b, 1), dtype=torch.long, device=x.device),
                          torch.sort(kidx, dim=-1).values + 1], dim=1)
        yc = vit_layer(gather_compact(x, cidx), layer_params, config, quant=quant)
        out = scatter_back(_passthrough(x, extras, mask), cidx, yc)
    elif pcfg.mode == "topk":
        # the same set as topk_keep_mask (ties to the lower index), mask only
        mask = add_cls_keep(rank_keep_mask(scores, pcfg.top_k))
        out = bucketed_masked_layer(x, layer_params, mask, config, cap_hint=pcfg.top_k + 1,
                                    passthrough=passthrough_arg(mask), quant=quant)
    elif pcfg.mode == "oracle":
        sim_o = similarity_oracle(x[:, 1:], dense_out[:, 1:], pcfg.oracle_alpha)
        mask = add_cls_keep(sim_o < _sim_threshold(pcfg, layer_idx))  # changes a lot: process
        out = torch.where(mask[..., None], dense_out, x)
    elif pcfg.mode == "random":
        if random_keep is None:
            raise ValueError("mode='random' requires random_keep, the caller's draw")
        mask = add_cls_keep(random_keep)
        if static:
            y = vit_layer(x, layer_params, config, token_mask=mask, quant=quant)
            out = torch.where(mask[..., None], y, x)
        else:
            out = bucketed_masked_layer(x, layer_params, mask, config,
                                        cap_hint=_random_budget(pcfg, layer_idx) + 1,
                                        quant=quant)
    else:
        raise ValueError(f"unknown prune mode {pcfg.mode!r}")

    if pcfg.layer_skip_threshold > 0.0:
        # images whose mean keep-score is below the threshold bypass the layer
        skip_layer = scores.mean(dim=1) < pcfg.layer_skip_threshold
        out = torch.where(skip_layer[:, None, None], x, out)
        mask = torch.where(skip_layer[:, None], torch.zeros_like(mask), mask)
        mask[:, 0] = True  # CLS counted as live for reporting

    info = {"keep_mask": mask, "scores": scores}
    if need_oracle:
        if oracle_targets is not None:  # hoisted, already without a graph
            sim, oracle_keep = oracle_targets["similarity"], oracle_targets["oracle_keep"]
            cos, target = oracle_targets.get("cos_target"), oracle_targets.get("attn_target")
        else:
            if teacher is not None:  # the oracle from the unpruned trajectory
                oracle_in, dense_p = teacher[0][:, 1:].detach(), teacher[1][:, 1:].detach()
            else:
                oracle_in, dense_p = x[:, 1:].detach(), dense_out[:, 1:].detach()
            sim = similarity_oracle(oracle_in, dense_p, pcfg.oracle_alpha)
            oracle_keep = sim < _sim_threshold(pcfg, layer_idx)
            if pcfg.loss == "mse_cosine":
                cos = _cos_target(dense_p, oracle_in)
            elif pcfg.loss == "mse_attention":
                target = probs[:, :, 0, 1:].mean(dim=1).detach()
        if pcfg.loss == "bce_oracle":
            pred_loss = weighted_bce_oracle(scores, oracle_keep)
        elif pcfg.loss == "mse_cosine":
            pred_loss = mse_cosine_loss(scores, cos)
            info["cos_target"] = cos  # the detached cosine step's target
        elif pcfg.loss == "mse_attention":
            pred_loss = mse_attention_loss(scores, target)
            info["attn_target"] = target
        elif pcfg.loss == "focal":
            pred_loss = focal_loss(scores, oracle_keep, alpha=pcfg.focal_alpha,
                                   gamma=pcfg.focal_gamma)
        else:
            raise ValueError(f"unknown loss {pcfg.loss!r}")
        info.update(pred_loss=pred_loss, similarity=sim, oracle_keep=oracle_keep,
                    confusion=confusion_counts(oracle_keep, mask[:, 1:]))
    return out, info


def _random_budget(pcfg: PruneConfig, layer_idx: int) -> int:
    return pcfg.random_keep[layer_idx] if pcfg.random_keep is not None else pcfg.top_k


def _aux_keys(pcfg: PruneConfig) -> list:
    keys = ["pred_loss", "similarity", "oracle_keep", "confusion"]
    if pcfg.loss == "mse_attention":
        keys.append("attn_target")
    elif pcfg.loss == "mse_cosine":
        keys.append("cos_target")
    return keys


def _inactive_aux(pcfg: PruneConfig, b: int, n: int, dtype, device) -> dict:
    """The aux entries of a layer that prunes nothing: no loss, similarity
    0, every token kept, no confusion counts."""
    aux = {"pred_loss": torch.zeros((), device=device),
           "similarity": torch.zeros((b, n), dtype=dtype, device=device),
           "oracle_keep": torch.ones((b, n), dtype=torch.bool, device=device),
           "confusion": torch.zeros((2, 2), dtype=torch.int32, device=device)}
    if pcfg.loss == "mse_attention":
        aux["attn_target"] = torch.zeros((b, n), dtype=dtype, device=device)
    elif pcfg.loss == "mse_cosine":
        aux["cos_target"] = torch.ones((b, n), dtype=dtype, device=device)
    return aux


def pruned_vit_forward(
    params: dict,
    pixel_values: torch.Tensor,
    config: ViTConfig,
    pcfg: PruneConfig,
    *,
    train: bool = False,
    compute_oracle: bool = False,
    oracle: Optional[bool] = None,
    return_layer_inputs: bool = False,
    generator: Optional[torch.Generator] = None,
    quant: Optional[str] = None,
    remat: bool = False,
) -> dict:
    """Full pruned forward.

    Returns dict(logits [B, labels], cls [B, D], last_hidden [B, S, D],
    keep_masks [L, B, S] bool, scores [L, B, N]; + layer_inputs [L, B, S, D],
    each layer's input as its predictor saw it, when return_layer_inputs;
    + aux when the oracle instrumentation runs: pred_loss [L], similarity
    [L, B, N], oracle_keep [L, B, N], confusion [L, 2, 2], and attn_target /
    cos_target [L, B, N] for those losses).

    The instrumentation (one dense pass per layer as the label source, or
    the parallel teacher stream) runs when `train or compute_oracle`, unless
    `oracle` says otherwise: the classification phase passes oracle=False
    and trains on the static paths without it. `generator` draws mode
    'random''s noise, layer after layer. quant: 'none', 'int8' or None
    (read the dispatch switch once, here); training and the instrumentation
    run unquantized. remat: recompute each layer in the backward
    (torch.utils.checkpoint), inactive ones and mode 'none' too.
    """
    need_oracle = (train or compute_oracle) if oracle is None else oracle
    # training and the oracle instrumentation run unquantized, as in the JAX
    # package (round and clip have no useful gradient)
    quant = "none" if (train or need_oracle) else resolve_quant(quant)
    L = config.num_layers
    if pcfg.mode == "none" and not return_layer_inputs:
        # dense: vit_forward, with the masks and scores of an all-inactive run
        dense = vit_forward(params["backbone"], pixel_values, config, quant=quant, remat=remat)
        x = dense["last_hidden"]
        b, s = x.shape[:2]
        out = {
            "logits": dense["logits"],
            "cls": dense["cls"],
            "last_hidden": x,
            "keep_masks": torch.ones((L, b, s), dtype=torch.bool, device=x.device),
            "scores": torch.ones((L, b, s - 1), dtype=x.dtype, device=x.device),
        }
        if need_oracle:
            aux = _inactive_aux(pcfg, b, s - 1, x.dtype, x.device)
            out["aux"] = {k: v.expand(L, *v.shape).clone() for k, v in aux.items()}
        return out
    if pcfg.mode == "topk_prog":
        if not (train or need_oracle):
            return progressive_topk_forward(params, pixel_values, config, pcfg, quant=quant)
        # training and the oracle take the per-layer re-decide semantics the
        # predictor is trained with; deployment then runs progressive
        pcfg = pcfg.replace(mode="topk")
    backbone = params["backbone"]
    pred = params.get("predictor")
    layers = layers_for(backbone["layers"], quant)

    x = embed(pixel_values, backbone["embed"], config)
    nbr_idx = torch.from_numpy(neighbor_index_table(config.grid_size)).long().to(x.device)
    use_teacher = need_oracle and pcfg.oracle_stream == "parallel"
    x_teacher = x if use_teacher else None
    masks, scores_l, aux_l, layer_inputs = [], [], [], []
    prev_keep = None
    # skip-next flag [B] bool, set by the previous layer's thresholded mask:
    # flagged images bypass this layer
    skip_vec = None
    for i in range(L):
        if return_layer_inputs:
            layer_inputs.append(x)
        lp = layer_slice(layers, i)
        teacher = None
        if use_teacher:  # the unpruned trajectory beside the pruned one
            t_out = vit_layer(x_teacher, lp, config, quant=quant)
            teacher = (x_teacher, t_out)
            x_teacher = t_out
        x_in = x
        if not _is_active(pcfg, i):
            if remat:
                x = checkpoint(vit_layer, x, lp, config, quant=quant, use_reentrant=False)
            else:
                x = vit_layer(x, lp, config, quant=quant)
            if skip_vec is not None:
                # "the next layer" is the physically next one, active or not
                x = torch.where(skip_vec[:, None, None], x_in, x)
                skip_vec = None
            b, s = x.shape[:2]
            info = {"keep_mask": torch.ones((b, s), dtype=torch.bool, device=x.device),
                    "scores": torch.ones((b, s - 1), dtype=x.dtype, device=x.device)}
            if need_oracle:
                info.update(_inactive_aux(pcfg, b, s - 1, x.dtype, x.device))
        else:
            otargets = None
            if need_oracle and _hoistable_oracle(pcfg):
                otargets = _hoisted_oracle_targets(lp, i, x, config, pcfg, teacher)
            rkeep = None
            if pcfg.mode == "random":
                # drawn here, outside the checkpointed layer: a recompute
                # restores the default generators only, not this one
                if generator is None:
                    raise ValueError("mode='random' requires a generator")
                rkeep = random_keep_mask(generator, x.shape[0], x.shape[1] - 1,
                                         _random_budget(pcfg, i), x.device)
            layer_fn = functools.partial(
                pruned_layer_forward, config=config, pcfg=pcfg, nbr_idx=nbr_idx, quant=quant,
                need_oracle=need_oracle, train=train)
            args = (lp, pred, i, x)
            kw = dict(prev_keep=prev_keep, random_keep=rkeep,
                      updatenet_params=params.get("updatenet"), teacher=teacher,
                      oracle_targets=otargets)
            if remat:
                x, info = checkpoint(layer_fn, *args, use_reentrant=False, **kw)
            else:
                x, info = layer_fn(*args, **kw)
            if pcfg.skip_next_threshold > 0.0:
                # this layer's thresholded mask decides whether each image
                # skips the next layer; an image skipped here reports an
                # all-ones mask and no scores, and never triggers a skip
                raw_mask = info["keep_mask"]
                trigger = raw_mask[:, 1:].float().mean(dim=1) > pcfg.skip_next_threshold
                if skip_vec is not None:
                    x = torch.where(skip_vec[:, None, None], x_in, x)
                    info = dict(
                        info,
                        keep_mask=torch.where(skip_vec[:, None], torch.ones_like(raw_mask),
                                              raw_mask),
                        scores=torch.where(skip_vec[:, None], torch.ones_like(info["scores"]),
                                           info["scores"]),
                    )
                    trigger = trigger & ~skip_vec
                skip_vec = trigger
        prev_keep = info["keep_mask"]
        masks.append(info["keep_mask"])
        scores_l.append(info["scores"])
        if need_oracle:
            aux_l.append({k: info[k] for k in _aux_keys(pcfg)})

    x = layer_norm(x, backbone["ln_f"], config.layernorm_eps)
    cls = x[:, 0]
    out = {
        "logits": cls @ backbone["head"]["w"] + backbone["head"]["b"],
        "cls": cls,
        "last_hidden": x,
        "keep_masks": torch.stack(masks),
        "scores": torch.stack(scores_l),
    }
    if need_oracle:
        out["aux"] = {k: torch.stack([a[k] for a in aux_l]) for k in aux_l[0]}
    if return_layer_inputs:
        out["layer_inputs"] = torch.stack(layer_inputs)
    return out


def skip_ratio(keep_masks: torch.Tensor) -> torch.Tensor:
    """Fraction of tokens skipped per layer: [L, B, S] -> [L]."""
    return 1.0 - keep_masks.float().mean(dim=(1, 2))


# --- progressive compaction ------------------------------------------------------------

def _keep_projection(scores: torch.Tensor, k: int):
    """CLS + the top-k patches by score (rank_keep_mask tie-break).

    Returns (mask [B, S] bool, cidx [B, k+1] long): cidx[b, r] is the source
    position of compacted row r, in token order — the rows of the JAX
    package's one-hot P, as indices. The drop and the merge both take their
    kept set from here.
    """
    mask = add_cls_keep(rank_keep_mask(scores, k))
    b, s = mask.shape
    rank = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    # dropped tokens write to a spare column k+1, cut off below (no host sync)
    dest = torch.where(mask, rank, k + 1)
    src = torch.arange(s, device=mask.device).expand(b, s)
    cidx = torch.zeros((b, k + 2), dtype=torch.int64, device=mask.device)
    cidx.scatter_(1, dest, src)
    return mask, cidx[:, : k + 1]


def progressive_drop(
    x: torch.Tensor,
    pred_params: Optional[dict],
    layer_idx: int,
    k: int,
    config: ViTConfig,
    pcfg: PruneConfig,
    layer_params: Optional[dict] = None,
):
    """Score the live sequence, keep CLS + the top-k patches in token order.
    Returns (x_compacted [B, k+1, D], scores [B, cur-1], cidx [B, k+1])."""
    scores, _ = apply_predictor(
        pred_params, layer_idx, x, config, pcfg, layer_params=layer_params
    )
    _, cidx = _keep_projection(scores, k)
    xc = torch.gather(x, 1, cidx[..., None].expand(-1, -1, x.shape[-1]))
    return xc, scores, cidx


def merge_dropped_tokens(
    x_full: torch.Tensor,
    xc: torch.Tensor,
    scores: torch.Tensor,
    k: int,
    sizes: torch.Tensor,
):
    """Each dropped patch token merges into its most cosine-similar kept
    patch as a size-weighted average; CLS never merges either way.

    x_full [B, S, D] before the drop, xc [B, k+1, D] the compacted sequence
    (from progressive_drop on the same scores), sizes [B, S] the tokens'
    accumulated sizes. Returns (xc_merged [B, k+1, D], sizes [B, k+1]). The
    JAX package scatter-adds with one-hot matmuls; here by index (on the
    card an atomic scatter-add, so the sum order is not fixed).
    """
    mask, cidx = _keep_projection(scores, k)
    sz_c = torch.gather(sizes, 1, cidx)
    kept_p = xc[:, 1:]
    xn = x_full * torch.rsqrt((x_full * x_full).sum(-1, keepdim=True) + 1e-6)
    kn = kept_p * torch.rsqrt((kept_p * kept_p).sum(-1, keepdim=True) + 1e-6)
    target = (xn @ kn.transpose(1, 2)).argmax(-1)  # [B, S]: first max, as jnp.argmax
    w = sizes * (~mask).to(sizes.dtype)  # dropped tokens' sizes; 0 for kept and CLS
    b, _, d = x_full.shape
    add_num = torch.zeros((b, k, d), dtype=x_full.dtype, device=x_full.device).scatter_add_(
        1, target[..., None].expand(-1, -1, d), x_full * w[..., None])
    add_sz = torch.zeros((b, k), dtype=sizes.dtype, device=sizes.device).scatter_add_(
        1, target, w)
    new_sz = sz_c[:, 1:] + add_sz
    merged = (kept_p * sz_c[:, 1:, None] + add_num) / new_sz[..., None]
    return torch.cat([xc[:, :1], merged], dim=1), torch.cat([sz_c[:, :1], new_sz], dim=1)


def progressive_topk_forward(
    params: dict,
    pixel_values: Optional[torch.Tensor],
    config: ViTConfig,
    pcfg: PruneConfig,
    *,
    x0: Optional[torch.Tensor] = None,
    logits_only: bool = False,
    quant: Optional[str] = None,
) -> dict:
    """Returns dict(logits, keep_masks [L, B, S] bool over original
    positions, scores [L, B, N] over original patch positions with -inf at
    dropped ones; + cls, last_hidden when logits_only=False).

    quant: 'none', 'int8' or None (read the dispatch switch once, here).
    Under int8 every layer runs int8, except that with logits_only and
    kernels on the last layer, final LN and classifier run as the float B2
    kernel, as the JAX package's Pallas route does (a layer whose query,
    attention and MLP touch one row gains nothing from int8); in 'eager'
    the last layer runs int8, as its jnp route does.

    The layers between two drops run at one sequence length: as one call of
    kernel B5 each where models/vit.py::encoder_route says so (in float,
    under int8 too, as the JAX package's segments), else layer by layer."""
    backbone = params["backbone"]
    pred = params.get("predictor")
    check_attn_geometry(backbone["layers"]["attn"]["q"]["w"].shape[-1], config)
    quant = resolve_quant(quant)
    fuse = encoder_route(backbone["layers"], config)
    layers = layers_for(backbone["layers"], "none" if fuse else quant)

    def run_segment(x, l0, l1):
        """Layers [l0, l1) at a fixed sequence length."""
        if fuse and l1 > l0:
            from vit_pruning_tpu_torch.ops.cuda.model import fused_vit_encoder

            return fused_vit_encoder(x, layer_range(layers, l0, l1), config.num_heads,
                                     config.layernorm_eps)
        for j in range(l0, l1):
            x = vit_layer(x, layer_slice(layers, j), config, quant=quant)
        return x

    x = x0 if x0 is not None else embed(pixel_values, backbone["embed"], config)
    b, s, _ = x.shape
    L = config.num_layers
    schedule = pcfg.keep_schedule or tuple([pcfg.top_k] + [0] * (L - 1))
    schedule = tuple(min(k, s - 1) if k else 0 for k in schedule)

    orig = torch.arange(s, device=x.device).expand(b, s)  # source position of each live token
    masks, scores_l = [], []
    cur = s
    sizes = torch.ones((b, s), dtype=x.dtype, device=x.device) if pcfg.merge_dropped else None
    use_cls_kernel = logits_only and kernels_enabled()
    seg_start = 0
    for i in range(L):
        k_i = schedule[i]
        if k_i and k_i < cur - 1 and _is_active(pcfg, i):
            x = run_segment(x, seg_start, i)
            seg_start = i
            x_full = x
            x, scores, cidx = progressive_drop(x, pred, i, k_i, config, pcfg,
                                               layer_params=layer_slice(layers, i))
            if pcfg.merge_dropped:
                x, sizes = merge_dropped_tokens(x_full, x, scores, k_i, sizes)
            full = torch.full((b, s - 1), float("-inf"), dtype=scores.dtype, device=x.device)
            scores_l.append(full.scatter(1, orig[:, 1:] - 1, scores))
            orig = torch.gather(orig, 1, cidx)
            cur = k_i + 1
        else:
            scores_l.append(torch.full((b, s - 1), float("-inf"), dtype=x.dtype, device=x.device))
        masks.append(torch.zeros((b, s), dtype=torch.bool, device=x.device).scatter(1, orig, True))

    if use_cls_kernel:
        from vit_pruning_tpu_torch.ops.cuda.layer import fused_vit_layer_cls_logits

        x = run_segment(x, seg_start, L - 1)
        logits = fused_vit_layer_cls_logits(
            x, layer_slice(layers, L - 1), backbone["ln_f"], backbone["head"],
            config.num_heads, config.layernorm_eps,
        )
        return {"logits": logits, "keep_masks": torch.stack(masks), "scores": torch.stack(scores_l)}

    x = run_segment(x, seg_start, L)
    x = layer_norm(x, backbone["ln_f"], config.layernorm_eps)
    cls = x[:, 0]
    out = {
        "logits": cls @ backbone["head"]["w"] + backbone["head"]["b"],
        "keep_masks": torch.stack(masks),
        "scores": torch.stack(scores_l),
    }
    if not logits_only:
        out["cls"] = cls
        out["last_hidden"] = x  # compacted: live tokens only
    return out
