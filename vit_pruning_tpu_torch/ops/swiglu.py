"""DINOv2's block parts in the layer tree: the SwiGLU MLP and LayerScale.

A layer tree (one layer's, or the layers' stacked on a leading [L] axis)
says by its own leaves which block it is, so that every route reads the
same tree and none has to be told:

  * SwiGLU: fc1 is twice as wide as fc2 is deep. In checkpoint order
    (models/convert.py, the init) fc1 is {'w' [D, 2M], 'b' [2M]}, its
    columns [u1 | u2] as the published W_in splits them (chunk(2, -1)), and
    the MLP is W_out(silu(u1) * u2). Interleaved (`with_gated_fc1`, once at
    load) fc1 is {'wg', 'bg'}: column 2i is u1's i, column 2i + 1 its u2
    partner, which is what kernel B1's gated epilogue reads, so that each
    output tile of the fc1 product holds whole pairs and writes
    silu(u1) * u2 [rows, M] without the [rows, 2M] product.
  * LayerScale: 'ls1' and 'ls2' [D] beside 'ln1' and 'ln2', the gains of
    the attention and MLP branches before their residuals.

The plain versions take either order of fc1. Kernel B1 takes the
interleaved fc1 alone: the interleave is set-up, made once at load, and
the kernel route raises for a SwiGLU tree in checkpoint order
(`require_interleaved`) rather than copy its fc1 inside a call. The
routes that compute neither (kernels B2-B5, int8, B7, the f32 products, merge) refuse such a
tree with `refuse_dinov2` instead of computing another block.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def weight(linear: dict) -> torch.Tensor:
    """A linear's weight matrix: the float 'w', SwiGLU's interleaved 'wg', or
    the int8 'wq' of a quantized tree."""
    for key in ("w", "wg", "wq"):
        if key in linear:
            return linear[key]
    raise KeyError(f"a linear with none of 'w', 'wg', 'wq': {sorted(linear)}")


def mlp_width(params: dict) -> int:
    """M: fc2's input width (fc1's output, or half of it under SwiGLU)."""
    return weight(params["mlp"]["fc2"]).shape[-2]


def is_gated(params: dict) -> bool:
    """fc1 interleaved for the gated epilogue ({'wg', 'bg'})."""
    return "wg" in params["mlp"]["fc1"]


def is_swiglu(params: dict) -> bool:
    """A SwiGLU MLP: fc1 2M wide, in either order."""
    return weight(params["mlp"]["fc1"]).shape[-1] == 2 * mlp_width(params)


def has_layerscale(params: dict) -> bool:
    return "ls1" in params


def interleave_fc1(fc1: dict) -> dict:
    """{'w' [..., D, 2M], 'b' [..., 2M]} in checkpoint order -> {'wg', 'bg'}:
    column 2i = u1's column i, 2i + 1 = u2's column i."""
    def pairs(t):
        u1, u2 = t.chunk(2, dim=-1)
        return torch.stack([u1, u2], dim=-1).flatten(-2).contiguous()
    return {"wg": pairs(fc1["w"]), "bg": pairs(fc1["b"])}


def with_gated_fc1(layers: dict) -> dict:
    """A shallow copy of a SwiGLU layer tree with fc1 interleaved (the set-up
    a deployment runs once at load, as ops/quant.py::attach_int8_weights
    for int8); any other tree as it is."""
    if not is_swiglu(layers) or is_gated(layers):
        return layers
    mlp = layers["mlp"]
    return {**layers, "mlp": {**mlp, "fc1": interleave_fc1(mlp["fc1"])}}


def require_interleaved(who: str, params: dict):
    """Raise for a SwiGLU tree whose fc1 is still in checkpoint order, on a
    route that launches kernel B1: its gated epilogue reads the interleaved
    fc1 that `with_gated_fc1` makes once at load."""
    if is_swiglu(params) and not is_gated(params):
        raise ValueError(
            f"{who}: a SwiGLU layer tree with fc1 in checkpoint order; kernel B1 reads fc1 "
            f"interleaved, made once at load by ops/swiglu.py::with_gated_fc1")


def gate(u: torch.Tensor, interleaved: bool) -> torch.Tensor:
    """silu(u1) * u2 of fc1's output u [..., 2M], in u's dtype."""
    if interleaved:
        u1, u2 = u[..., 0::2], u[..., 1::2]
    else:
        u1, u2 = u.chunk(2, dim=-1)
    return F.silu(u1) * u2


def fc1_linear(params: dict):
    """fc1's (weight, bias) in the tree's order, and whether interleaved."""
    fc1 = params["mlp"]["fc1"]
    if "wg" in fc1:
        return fc1["wg"], fc1["bg"], True
    return fc1["w"], fc1["b"], False


def swiglu_mlp(x: torch.Tensor, mlp: dict) -> torch.Tensor:
    """The plain SwiGLU MLP in x's dtype: W_out(silu(u1) * u2)."""
    w, b, inter = fc1_linear({"mlp": mlp})
    return gate(x @ w + b, inter) @ mlp["fc2"]["w"] + mlp["fc2"]["b"]


def refuse_dinov2(who: str, params: dict):
    """Raise for a SwiGLU or LayerScale tree on a route that computes the
    plain ViT block alone."""
    if is_swiglu(params) or has_layerscale(params):
        raise ValueError(
            f"{who}: takes the plain ViT block alone (GELU MLP, no LayerScale); a SwiGLU or "
            f"LayerScale layer runs on kernel B1 in bf16 or on the plain layer")
