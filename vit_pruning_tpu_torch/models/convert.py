"""Weight bridge between the JAX param tree and the port's tensor tree.

Both packages use the same layout (models/vit.py docstring of the JAX
package): nested dicts, per-layer leaves stacked on a leading [L] axis,
linear weights stored [in, out]. The bridge only changes the leaf type, so
the tests can feed one set of weights to both packages.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _map(tree: Any, fn, key: str = ""):
    """fn(leaf, key of the leaf) over a nested dict; None leaves stay None."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree, key)


def _leaf_dtype(key: str, current: torch.dtype, dtype: torch.dtype) -> torch.dtype:
    """The dtype a leaf is cast to: int8 serving weights ('wq', any integer
    leaf) and their f32 scales ('wscale') keep theirs, every other leaf
    takes `dtype`."""
    if not current.is_floating_point or key == "wscale":
        return current
    return dtype


def check_device(device) -> torch.device:
    """The device an init function or the bridge puts params on. The card
    is the default everywhere; without one, asking for it raises here
    instead of quietly using the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: no CUDA device is available; pass device='cpu' "
            f"to build the params on the CPU"
        )
    return dev


def params_from_jax(tree: Any, device="cuda", dtype: torch.dtype = torch.float32) -> Any:
    """JAX param tree with numpy (or numpy-convertible) leaves -> tensor tree
    on `device` in `dtype`. None leaves (e.g. no predictor) stay None. A
    quantized tree (quantize_layer_params) crosses unchanged: int8 'wq'
    stays int8 and 'wscale' float32."""
    device = check_device(device)

    def leaf(a, key):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":  # ml_dtypes bf16 has no torch twin in numpy
            a = a.astype(np.float32)
        t = torch.from_numpy(np.array(a))  # copy: writable
        return t.to(device=device, dtype=_leaf_dtype(key, t.dtype, dtype))

    return _map(tree, leaf)


def params_to_numpy(tree: Any) -> Any:
    """Tensor tree -> numpy tree (bf16 leaves come back as float32, which
    holds every bf16 value exactly; int8 and float32 leaves unchanged)."""

    def leaf(t: torch.Tensor, key):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return _map(tree, leaf)


def tree_to(tree: Any, device=None, dtype: torch.dtype = None) -> Any:
    """Move and/or cast every leaf of a tensor tree (int8 weights and their
    scales keep their dtype)."""
    return _map(tree, lambda t, key: t.to(
        device=device, dtype=None if dtype is None else _leaf_dtype(key, t.dtype, dtype)))
