"""Process groups and device meshes.

Mirrors vit_pruning_tpu/parallel/mesh.py. The JAX package builds a
jax.sharding.Mesh over the devices of one SPMD program and lets XLA insert
the collectives; here every mesh position is a process (a rank) and a mesh
is a torch DeviceMesh over the ranks of the default process group, whose
per-axis process groups carry the collectives of parallel/collectives.py.

Axes:
  data  — batch data parallelism
  model — the tensor-parallel axis of the param shardings
          (parallel/sharding.py)

`init_distributed` starts the default process group of one rank: NCCL when
every rank has a card of its own, gloo otherwise (the CPU, or more ranks
than cards, as two ranks sharing one card). parallel/launch.py::run_ranks
calls it in each rank it spawns.
"""

from __future__ import annotations

import datetime
import math
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from vit_pruning_tpu_torch.models.convert import check_device


class Distributed(NamedTuple):
    """What init_distributed chose: the backend and this rank's device."""
    backend: str
    device: torch.device


def init_distributed(backend: Optional[str] = None, device="cuda", *, rank: int,
                     world_size: int, init_method: str,
                     timeout_s: float = 300.0) -> Distributed:
    """Start this rank's default process group at `init_method` (e.g.
    tcp://127.0.0.1:<port>). device 'cuda' (the default) puts the rank on
    card rank % device_count and raises without a card; 'cpu' keeps it on
    the host. backend None picks 'nccl' when every rank has a card of its
    own and 'gloo' otherwise; collectives time out after timeout_s, so a
    rank that never arrives fails the others."""
    dev = check_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        own_card = dev.type == "cuda" and world_size <= torch.cuda.device_count()
        backend = "nccl" if own_card else "gloo"
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return Distributed(backend, dev)


def build_mesh(shape: tuple, names: tuple, device) -> DeviceMesh:
    """A DeviceMesh of `shape` over ranks 0 .. prod(shape) - 1, its dims
    named `names`. Every rank calls it (building the axis groups is
    collective); ranks past it take no part in it."""
    n = math.prod(shape)
    world = dist.get_world_size()
    if n > world:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} needs {n} devices, have {world}")
    return DeviceMesh(check_device(device).type, torch.arange(n).reshape(shape),
                      mesh_dim_names=names)


def make_mesh(data: Optional[int] = None, model: int = 1, device="cuda") -> DeviceMesh:
    """('data', 'model') mesh over the first data * model ranks. data
    defaults to world_size // model."""
    if data is None:
        data = dist.get_world_size() // model
    return build_mesh((data, model), ("data", "model"), device)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The mesh's extent along `axis`; 1 for an axis it does not have."""
    names = mesh.mesh_dim_names
    return mesh.size(names.index(axis)) if axis in names else 1


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along `axis` (0 for an axis the mesh lacks):
    the counterpart of lax.axis_index."""
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's line along `axis`, or None where
    that line holds one rank (nothing to communicate)."""
    return mesh.get_group(axis) if axis_size(mesh, axis) > 1 else None


def in_mesh(mesh: DeviceMesh) -> bool:
    """Does this rank hold a position of the mesh?"""
    return mesh.get_coordinate() is not None


def rank_at(mesh: DeviceMesh, *coords: int) -> int:
    """The global rank at mesh coordinates `coords`."""
    return int(mesh.mesh[tuple(coords)])
