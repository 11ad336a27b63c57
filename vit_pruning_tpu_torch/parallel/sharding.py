"""Sharding rules: which param axes map to which mesh axes.

Mirrors vit_pruning_tpu/parallel/sharding.py. A spec is a tuple with one
entry per leading dim of the leaf, a mesh axis name or None (the
PartitionSpec P(None, None, 'model') is (None, None, 'model'); P() is ()):

  * QKV projections column-parallel (output dim over 'model')
  * attention output projection row-parallel (input dim over 'model')
  * MLP fc1 column-parallel, fc2 row-parallel
  * embeddings / layernorms / predictor heads replicated (tiny)
  * classifier column-parallel over labels
Batch is sharded over 'data'. Layer params are stacked with a leading [L]
axis, so every layer rule gets a leading None.

In the JAX package device_put places each shard on its device and XLA
inserts the collectives. Here `shard_params` keeps the calling rank's slice
of each leaf; the parallel steps (parallel/steps.py) gather the slices
where a computation needs the whole leaf.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from vit_pruning_tpu_torch.parallel.mesh import axis_index, axis_size

REPLICATED = ()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return None if tree is None else fn(tree)


def map_specs(tree, specs, fn):
    """fn(leaf, spec) over a param tree and its spec tree."""
    if isinstance(tree, dict):
        return {k: map_specs(v, specs[k], fn) for k, v in tree.items()}
    return None if tree is None else fn(tree, specs)


def _layer_pspecs() -> dict:
    col = {"w": (None, None, "model"), "b": (None, "model")}   # leading L axis
    row = {"w": (None, "model", None), "b": (None,)}
    ln = {"g": (None,), "b": (None,)}
    return {
        "ln1": ln,
        "attn": {"q": col, "k": col, "v": col, "o": row},
        "ln2": dict(ln),
        "mlp": {"fc1": dict(col), "fc2": dict(row)},
    }


def param_pspecs(params: dict) -> dict:
    """Spec tree matching a pruned-ViT param tree ({'backbone':...,
    'predictor':...}) or a bare backbone tree."""

    def replicate(tree):
        return _map(tree, lambda _: REPLICATED)

    def backbone_specs(bb):
        return {
            "embed": replicate(bb["embed"]),
            "layers": _layer_pspecs(),
            "ln_f": replicate(bb["ln_f"]),
            "head": {"w": (None, "model"), "b": ("model",)},
        }

    if "backbone" in params:
        specs = {"backbone": backbone_specs(params["backbone"])}
        for k in params:
            if k != "backbone":
                specs[k] = replicate(params[k])  # predictor / updatenet: tiny
        return specs
    return backbone_specs(params)


def batch_pspecs() -> dict:
    return {"pixel_values": ("data",), "labels": ("data",)}


def _divisible(shape, spec: tuple, mesh: DeviceMesh) -> bool:
    return all(axis is None or shape[dim] % axis_size(mesh, axis) == 0
               for dim, axis in enumerate(spec))


def resolve_pspecs(params: dict, mesh: DeviceMesh) -> dict:
    """param_pspecs with replication fallback for any leaf whose dims don't
    divide the mesh axes (e.g. a 10-class head on a 4-way model axis).
    params may be any tree of the full leaves' shapes."""
    return map_specs(params, param_pspecs(params),
                     lambda a, s: s if _divisible(a.shape, s, mesh) else REPLICATED)


def sharded_dim(spec: tuple, axis: str) -> Optional[int]:
    """The dim of a leaf that `spec` splits over `axis`, or None."""
    return spec.index(axis) if axis in spec else None


def local_slice(t: torch.Tensor, spec: tuple, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of a full leaf under `spec` (a view)."""
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = axis_size(mesh, axis)
            width = t.shape[dim] // n
            t = t.narrow(dim, axis_index(mesh, axis) * width, width)
    return t


def shard_params(params: dict, mesh: DeviceMesh):
    """(the calling rank's slice of every leaf, the resolved spec tree).
    The slices are copies, so the full tree can be freed; leaves keep
    their requires_grad."""
    specs = resolve_pspecs(params, mesh)
    local = map_specs(params, specs, lambda t, s: local_slice(t.detach(), s, mesh).clone()
                      .requires_grad_(t.requires_grad))
    return local, specs


def shard_batch(batch: dict, mesh: DeviceMesh) -> dict:
    """The calling rank's rows of every entry (its block of the leading
    dim over 'data'); a batch the data axis does not divide is refused."""
    n, i = axis_size(mesh, "data"), axis_index(mesh, "data")
    out: dict[str, Any] = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch entry {k!r} of {v.shape[0]} rows does not split over "
                             f"data={n}")
        rows = v.shape[0] // n
        out[k] = v[i * rows:(i + 1) * rows]
    return out
