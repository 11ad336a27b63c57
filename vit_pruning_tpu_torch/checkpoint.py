"""Checkpoint save / restore and best-checkpoint tracking.

Mirrors vit_pruning_tpu/checkpoint.py with torch.save / torch.load in place
of orbax. A checkpoint is a tree of dicts, lists, tensors and numbers:
params, or {'params', 'opt_state' (an optimizer's state_dict), 'epoch'},
which makes a resume exact (the reference saved params only).
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch


def save_checkpoint(path: str, tree: Any):
    """Write `tree` to `path` (its directory made if missing) through a
    temporary file, so that an interrupted save leaves the old one."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)


def restore_checkpoint(path: str, like: Any = None) -> Any:
    """Load a tree written by save_checkpoint. Where `like` holds a tensor,
    the loaded value is copied into it in place (cast to its dtype, on its
    device), so that an optimizer's references to the params stay valid;
    every other leaf of the result is the loaded one."""
    loaded = torch.load(os.path.abspath(path), map_location="cpu", weights_only=True)
    return _into(like, loaded)


@torch.no_grad()
def _into(like: Any, loaded: Any) -> Any:
    if isinstance(like, torch.Tensor):
        like.copy_(loaded)
        return like
    if isinstance(like, dict):
        return {k: _into(like.get(k), v) for k, v in loaded.items()}
    return loaded


class BestCheckpoint:
    """The best-accuracy params, on disk (save_dir and run_name given) or in
    memory as a copy (`.best_params`: the train step updates the params in
    place, so a bare reference would follow them)."""

    def __init__(self, save_dir: Optional[str] = None, run_name: str = ""):
        self.path = os.path.join(save_dir, run_name) if save_dir and run_name else None
        self.best_accuracy = 0.0
        self.best_params: Any = None

    def update(self, accuracy: float, params: Any) -> bool:
        if accuracy <= self.best_accuracy:
            return False
        self.best_accuracy = accuracy
        if self.path:
            save_checkpoint(self.path, params)
        else:
            self.best_params = _clone(params)
        return True


def _clone(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree
