"""Zero-padding of the widths the CUDA kernels do not take (ROADMAP C.1).

The layer kernels B1-B5 take a hidden width D and an MLP width M that are
multiples of 8 (`LAYER_MULTIPLE`; B4, whose int8 products step K by 16, of
16: `INT8_MULTIPLE`), and B8a / B8b an embedding width D that is a multiple
of 8. The Pallas kernels take the whole width as one block, so the JAX
package serves any width: `prune_mlp_channels` may keep any number of
channels, and `attn_head_dim` frees D from the heads. The wrappers pad
instead, and the padding changes no result:

  * M: fc1's columns and bias and fc2's rows get zeros. GELU(0) = 0, so a
    padded channel adds exactly nothing.
  * D: x's columns, both layer norms' g and b, and every weight along D get
    zeros. The kernels take the true width as the layer norms' (their DN
    argument), so the statistics run over the true columns and LN's padded
    columns come out 0 (g = b = 0); the O and fc2 products write 0 into
    them, so x's padded columns stay 0 through the residuals. The wrapper
    slices the output back to D.
  * int8 (B4): the padded weight codes are 0 and their column scales 1;
    a padded row's amax is the true row's, since the padding is zeros.
DINOv2's block (ops/swiglu.py) is not padded: its widths are multiples of 8.

`with_kernel_weights` (called by models/vit.py::layers_for) builds a
forward's padded tree once, under the key PADDED beside the tree's own
leaves; `kernel_layer` hands a wrapper that tree, or pads one it was given
without it per launch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from vit_pruning_tpu_torch.models.convert import flatten_tree
from vit_pruning_tpu_torch.ops.swiglu import mlp_width, refuse_dinov2

LAYER_MULTIPLE = 8
INT8_MULTIPLE = 16
# the key of a layer tree under which a forward keeps the padded copy the
# layer kernels read
PADDED = "kernel_padded"


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pad_dim(t: torch.Tensor, dim: int, size: int, value: float = 0.0) -> torch.Tensor:
    """t padded with `value` at the end of `dim` to `size`; t itself when it
    has that size already."""
    n = t.shape[dim]
    if n == size:
        return t
    dim %= t.dim()
    return F.pad(t, [0, 0] * (t.dim() - 1 - dim) + [0, size - n], value=value)


def layer_widths(params: dict) -> tuple:
    """(D, M) of one layer's or the stacked layers' tree, float or int8."""
    return params["ln1"]["g"].shape[-1], mlp_width(params)


def _linear(lin: dict, k: int, n: int) -> dict:
    out = {}
    for key, t in lin.items():
        if key in ("w", "wq"):
            out[key] = pad_dim(pad_dim(t, -2, k), -1, n)
        else:  # the bias, or the int8 column scales (1 where padded)
            out[key] = pad_dim(t, -1, n, 1.0 if key == "wscale" else 0.0)
    return out


def pad_layer(params: dict, d_to: int, m_to: int) -> dict:
    """One layer's (or the stacked layers') tree zero-padded to hidden width
    d_to and MLP width m_to, as the module head says. The attention width
    keeps its size: every head dim the kernels take is a multiple of 16."""
    a, mlp = params["attn"], params["mlp"]
    kw = (a["q"]["w"] if "w" in a["q"] else a["q"]["wq"]).shape[-1]

    def ln(p):
        return {k: pad_dim(v, -1, d_to) for k, v in p.items()}

    refuse_dinov2("pad_layer", params)
    return {
        "ln1": ln(params["ln1"]),
        "attn": {**{n: _linear(a[n], d_to, kw) for n in "qkv"}, "o": _linear(a["o"], kw, d_to)},
        "ln2": ln(params["ln2"]),
        "mlp": {"fc1": _linear(mlp["fc1"], d_to, m_to), "fc2": _linear(mlp["fc2"], m_to, d_to)},
    }


def needs_padding(params: dict, multiple: int) -> bool:
    return any(n % multiple for n in layer_widths(params))


def kernel_layer(params: dict, multiple: int) -> dict:
    """The layer tree a kernel reads: the forward's PADDED copy when it fits
    `multiple`, else `params` padded here, or `params` itself when its
    widths are multiples already."""
    padded = params.get(PADDED)
    if padded is not None and not needs_padding(padded, multiple):
        return padded
    if not needs_padding(params, multiple):
        return params
    d, m = layer_widths(params)
    return pad_layer(params, round_up(d, multiple), round_up(m, multiple))


def with_kernel_weights(layers: dict, multiple: int) -> dict:
    """A shallow copy of a layer tree with its padded copy under PADDED, or
    the tree itself when it needs none, has one, or autograd records through
    it (the recomputed backward differentiates the tree's own leaves, so the
    kernel's forward pads inside it instead)."""
    if PADDED in layers or not needs_padding(layers, multiple):
        return layers
    if torch.is_grad_enabled() and any(t.requires_grad for _, t in flatten_tree(layers)):
        return layers
    return {**layers, PADDED: kernel_layer(layers, multiple)}
