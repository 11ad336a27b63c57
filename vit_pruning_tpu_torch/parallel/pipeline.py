"""Pipeline parallelism over encoder layers (GPipe schedule, ranks of a
'stage' mesh axis, point-to-point hops).

Mirrors vit_pruning_tpu/parallel/pipeline.py, forward only as there. The
[L, ...] stacked layer weights split on their leading (layer) axis: stage s
runs layers [s * L / stages, (s + 1) * L / stages). Microbatches stream
through the classic GPipe schedule: at step t, stage s processes
microbatch (t - s); activations hop stage -> stage + 1. Total steps =
microbatches + stages - 1; bubble fraction = (stages - 1) / (microbatches +
stages - 1).

The JAX package is one SPMD program (shard_map + ppermute in a fori_loop),
so every hop there has one static shape: the pruned pipeline pads each hop
to the full sequence. Here each stage is a process of its own and every
hop's length is known from the static schedule, so a stage sends its true
compacted length (with merge_dropped's token sizes as one extra feature
column). Only the last stage's CLS rows matter to the classifier; they
reach every rank by broadcast (the JAX package's masked psum), and the
final LN and the head run on every rank, as there. Every rank takes the
whole param tree and the whole batch (replicated inputs, as there) and
uses its stage's layers and its rows.

Composition: a ('stage', 'data') mesh splits every microbatch's rows over
'data', each data column a pipeline of its own; a ('stage', 'model') mesh
runs each stage's layers Megatron-sharded over 'model' (tp_vit_layer, two
all-reduces a layer). Under gloo a hop between ranks on the card goes
through a host copy (collectives.py).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
from vit_pruning_tpu_torch.models.pruned_vit import (
    _is_active,
    merge_dropped_tokens,
    progressive_drop,
)
from vit_pruning_tpu_torch.models.vit import (
    embed,
    layer_norm,
    layer_range,
    layer_slice,
    layers_for,
    vit_layer,
)
from vit_pruning_tpu_torch.ops.dispatch import resolve_quant
from vit_pruning_tpu_torch.parallel.collectives import (
    all_gather,
    all_reduce_with_grad,
    broadcast,
    recv,
    send,
)
from vit_pruning_tpu_torch.parallel.mesh import (
    axis_group,
    axis_index,
    axis_size,
    build_mesh,
    rank_at,
)
from vit_pruning_tpu_torch.parallel.sharding import _layer_pspecs, local_slice, map_specs


def make_stage_mesh(stages: int, data: int = 1, model: int = 1, device="cuda") -> DeviceMesh:
    """('stage',) mesh, or composed with one other axis: ('stage', 'data')
    for pp x dp, ('stage', 'model') for pp x tp. data and model are
    mutually exclusive here, as in the JAX package. Over the first
    stages * data * model ranks; every rank calls it."""
    if data > 1 and model > 1:
        raise ValueError("compose 'data' or 'model' with 'stage', not both")
    if data == 1 and model == 1:
        return build_mesh((stages,), ("stage",), device)
    return build_mesh((stages, max(data, model)), ("stage", "data" if data > 1 else "model"),
                      device)


def tp_vit_layer(x: torch.Tensor, lp: dict, config: ViTConfig, group) -> torch.Tensor:
    """One pre-LN transformer block, Megatron-tensor-parallel over `group`:
    q/k/v projections column-sharded (each rank holds num_heads / model
    heads), attention per local head, output projection row-sharded with
    an all-reduce, then fc1 column-sharded / fc2 row-sharded with the
    second all-reduce. The row-sharded projections' biases are whole and
    added once, after the all-reduce. Plain torch, erf GELU, as the JAX
    package's jnp form; equal to models/vit.py::vit_layer up to the float
    reassociation of the two sums."""
    b, s, _ = x.shape
    hd = config.head_dim
    eps = config.layernorm_eps
    attn, mlp = lp["attn"], lp["mlp"]
    h = layer_norm(x, lp["ln1"], eps)
    q = h @ attn["q"]["w"] + attn["q"]["b"]
    k = h @ attn["k"]["w"] + attn["k"]["b"]
    v = h @ attn["v"]["w"] + attn["v"]["b"]
    hloc = q.shape[-1] // hd  # local heads on this rank

    def split(t):
        return t.reshape(b, s, hloc, hd).transpose(1, 2)

    logits = split(q) @ split(k).transpose(-1, -2) / math.sqrt(hd)
    ctx = torch.softmax(logits, dim=-1) @ split(v)
    ctx = ctx.transpose(1, 2).reshape(b, s, hloc * hd)
    x = x + all_reduce_with_grad(ctx @ attn["o"]["w"], group) + attn["o"]["b"]
    h2 = layer_norm(x, lp["ln2"], eps)
    m = F.gelu(h2 @ mlp["fc1"]["w"] + mlp["fc1"]["b"])
    return x + all_reduce_with_grad(m @ mlp["fc2"]["w"], group) + mlp["fc2"]["b"]


def _split_checks(mesh: DeviceMesh, config: ViTConfig, batch: int, num_microbatches: int):
    """(stages, layers a stage, rows of a microbatch on this rank)."""
    stages, L = axis_size(mesh, "stage"), config.num_layers
    if L % stages:
        raise ValueError(f"{L} layers do not split into {stages} equal stages")
    if batch % num_microbatches:
        raise ValueError(f"batch {batch} not divisible by {num_microbatches} microbatches")
    mb, nd = batch // num_microbatches, axis_size(mesh, "data")
    if mb % nd:
        raise ValueError(f"microbatch of {mb} rows does not split over data={nd}")
    return stages, L // stages, mb // nd


def _gpipe(mesh: DeviceMesh, num_microbatches: int, inject: Callable, compute: Callable,
           in_shape: tuple, dtype, device, cls_width: int) -> torch.Tensor:
    """Run this rank's stage over the GPipe schedule. Stage 0 takes
    microbatch m from inject(m), the others receive it from the previous
    stage (in_shape); each sends compute(x) on, and the last keeps its CLS
    rows. Returns every microbatch's CLS rows [M, rows, cls_width] on every
    rank of this rank's stage line."""
    stages, s = axis_size(mesh, "stage"), axis_index(mesh, "stage")
    second = next((a for a in mesh.mesh_dim_names if a != "stage"), None)
    coord = () if second is None else (axis_index(mesh, second),)

    def peer(stage):  # the rank of `stage` in this rank's stage line
        return rank_at(mesh, stage, *coord)

    M, last = num_microbatches, stages - 1
    pending, outs = [], []
    for t in range(M + stages - 1):
        m = t - s  # the microbatch this stage runs at step t
        if not 0 <= m < M:
            continue
        x = inject(m) if s == 0 else recv(in_shape, dtype, device, src=peer(s - 1))
        y = compute(x)
        if s < last:
            pending.append(send(y, peer(s + 1)))
        else:
            outs.append(y[:, 0, :cls_width])
    for work, _ in pending:
        work.wait()
    out = (torch.stack(outs) if s == last
           else torch.empty((M, in_shape[0], cls_width), dtype=dtype, device=device))
    return broadcast(out, peer(last), axis_group(mesh, "stage"))


def _classify(cls_rows: torch.Tensor, mesh: DeviceMesh, backbone: dict, config: ViTConfig):
    """Every data rank's CLS rows [M, rows, D] -> logits [B, labels] of the
    whole batch in its order, the final LN and the head as vit_forward's."""
    h = all_gather(cls_rows, 1, axis_group(mesh, "data"))
    h = layer_norm(h.reshape(-1, h.shape[-1]), backbone["ln_f"], config.layernorm_eps)
    return h @ backbone["head"]["w"] + backbone["head"]["b"]


def _rows(pixel_values: torch.Tensor, mesh: DeviceMesh, m: int, rows: int):
    """This rank's rows of microbatch m: its data block of it."""
    start = (m * axis_size(mesh, "data") + axis_index(mesh, "data")) * rows
    return pixel_values[start:start + rows]


@torch.no_grad()
def pipeline_forward(
    params: dict,
    pixel_values: torch.Tensor,
    config: ViTConfig,
    mesh: DeviceMesh,
    num_microbatches: int = 4,
    quant: Optional[str] = None,
) -> torch.Tensor:
    """Dense ViT forward with the encoder layers pipelined over the mesh's
    'stage' axis. Returns logits [B, num_labels] on every rank.
    num_microbatches must divide B. The embed runs on stage 0; the layers
    run as models/vit.py::vit_layer (kernel B1 on the card), or
    tp_vit_layer on a ('stage', 'model') mesh. quant None reads the serving
    switch, here."""
    b = pixel_values.shape[0]
    stages, per_stage, rows = _split_checks(mesh, config, b, num_microbatches)
    quant = resolve_quant(quant)
    s = axis_index(mesh, "stage")
    layers = layer_range(params["layers"], s * per_stage, (s + 1) * per_stage)
    if "model" in mesh.mesh_dim_names:
        n_model = axis_size(mesh, "model")
        if config.num_heads % n_model or config.mlp_dim % n_model:
            raise ValueError(
                f"tp over 'model'={n_model} needs num_heads ({config.num_heads}) and mlp_dim "
                f"({config.mlp_dim}) divisible by it")
        layers = map_specs(layers, _layer_pspecs(), lambda t, spec: local_slice(t, spec, mesh))
        group = axis_group(mesh, "model")

        def layer(x, lp):
            return tp_vit_layer(x, lp, config, group)
    else:
        layers = layers_for(layers, quant)

        def layer(x, lp):
            return vit_layer(x, lp, config, quant=quant)

    def compute(x):
        for j in range(per_stage):
            x = layer(x, layer_slice(layers, j))
        return x

    dtype = params["embed"]["patch"]["w"].dtype
    d = config.hidden_size
    cls_rows = _gpipe(
        mesh, num_microbatches,
        lambda m: embed(_rows(pixel_values, mesh, m, rows), params["embed"], config).to(dtype),
        compute, (rows, config.seq_len, d), dtype, pixel_values.device, d)
    return _classify(cls_rows, mesh, params, config)


@torch.no_grad()
def pruned_pipeline_forward(
    params: dict,
    pixel_values: torch.Tensor,
    config: ViTConfig,
    pcfg: PruneConfig,
    mesh: DeviceMesh,
    num_microbatches: int = 4,
    quant: Optional[str] = None,
) -> torch.Tensor:
    """topk_prog serving forward with the encoder layers pipelined over
    'stage': the pruned counterpart of `pipeline_forward`, equal to
    models/pruned_vit.py::progressive_topk_forward. Each stage runs its
    drops and its layers at its own static lengths (drops may fall
    anywhere, mid-stage too), through progressive_drop and, with
    pcfg.merge_dropped, merge_dropped_tokens, as the single-process path.
    Per-layer (stacked) predictor leaves split over the stages with the
    layers; subtrees named 'shared_*' hold one set of weights for every
    layer and stay whole. Composes with data parallelism over a ('stage',
    'data') mesh. Returns logits [B, num_labels] on every rank."""
    if pcfg.mode != "topk_prog":
        raise ValueError(f"pruned pipeline serves mode='topk_prog', got {pcfg.mode!r}")
    b = pixel_values.shape[0]
    stages, per_stage, rows = _split_checks(mesh, config, b, num_microbatches)
    quant = resolve_quant(quant)
    backbone, pred = params["backbone"], params.get("predictor")
    s_len, d, L = config.seq_len, config.hidden_size, config.num_layers
    merge = bool(pcfg.merge_dropped)

    # the static drop pattern: the decision loop of progressive_topk_forward
    schedule = pcfg.keep_schedule or tuple([pcfg.top_k] + [0] * (L - 1))
    schedule = tuple(min(k, s_len - 1) if k else 0 for k in schedule)
    drop_at, in_len = [], []  # in_len[g] = live length entering layer g
    cur = s_len
    for g in range(L):
        in_len.append(cur)
        dg = bool(schedule[g]) and schedule[g] < cur - 1 and _is_active(pcfg, g)
        drop_at.append(dg)
        if dg:
            cur = schedule[g] + 1

    s = axis_index(mesh, "stage")
    l0, l1 = s * per_stage, (s + 1) * per_stage
    layers = layers_for(layer_range(backbone["layers"], l0, l1), quant)
    local_pred = None if pred is None else {
        k: sub if k.startswith("shared_") else layer_range(sub, l0, l1)
        for k, sub in pred.items()}
    dtype = backbone["embed"]["patch"]["w"].dtype

    def inject(m):
        x = embed(_rows(pixel_values, mesh, m, rows), backbone["embed"], config).to(dtype)
        if merge:  # token sizes, 1 at the start, ride the hops as one more column
            x = torch.cat([x, torch.ones(x.shape[:2] + (1,), dtype=dtype, device=x.device)], -1)
        return x

    def compute(xp):
        x = xp[..., :d].contiguous()  # the layer kernels take contiguous rows
        sizes = xp[..., d] if merge else None
        for j in range(per_stage):
            g, lp = l0 + j, layer_slice(layers, j)
            if drop_at[g]:
                x_full = x
                x, scores, _ = progressive_drop(x, local_pred, j, schedule[g], config, pcfg,
                                                layer_params=lp)
                if merge:
                    x, sizes = merge_dropped_tokens(x_full, x, scores, schedule[g], sizes)
            x = vit_layer(x, lp, config, quant=quant)
        return torch.cat([x, sizes[..., None]], -1) if merge else x

    in_shape = (rows, in_len[l0], d + 1 if merge else d)
    cls_rows = _gpipe(mesh, num_microbatches, inject, compute, in_shape, dtype,
                      pixel_values.device, d)
    return _classify(cls_rows, mesh, backbone, config)
