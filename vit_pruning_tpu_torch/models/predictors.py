"""Skip-predictor heads: every kind of vit_pruning_tpu/models/predictors.py,
in the same param layout, so the weight bridge carries JAX-made params over
unchanged.

  cls_mlp           MLP([CLS ⊕ token]) -> sigmoid, [2D, h, 1]
  token_mlp         MLP(token), [D, h, 1]
  common_mlp        one token MLP shared by every layer ('shared_mlp')
  compressor        per-token D->128->64->16, flatten N*16, MLP [N*16, 512, N]
  shared_compressor the same with one compressor for all layers
  cnn               per-token D->256->64->16, then two 3x3 convs over the grid
  bottleneck        MLP [D, 32, D, 32, 1]; the middle activation is the
                    skipped tokens' approximate residual
  cls_cosine        1 - (cos(token, CLS) + 1) / 2, no params
  key_mlp           MLP on head-averaged attention keys, [hd, D, D/2, 1]
  key_cosine        (cos(keys(x), keys(layer(x))) + 1) / 2, no params

Naming contract: top-level keys prefixed 'shared_' hold one set of weights
used at every layer; every other subtree is stacked [L, ...] on its leading
axis. Linear weights are [in, out]; conv weights HWIO, as in the JAX
package. All heads emit post-sigmoid scores in (0, 1), [B, N] (patch tokens
only; CLS is never scored).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig, prefix_len
from vit_pruning_tpu_torch.models.convert import check_device, tree_to
from vit_pruning_tpu_torch.models.vit import (
    layer_norm,
    layer_slice,
    linear_init,
    stack_trees,
    trunc_normal,
    vit_layer,
)


def _init_mlp(generator: torch.Generator, sizes) -> dict:
    return {f"l{i}": linear_init(generator, sizes[i], sizes[i + 1]) for i in range(len(sizes) - 1)}


def _apply_mlp(params: dict, x: torch.Tensor, final_sigmoid: bool = True) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        p = params[f"l{i}"]
        x = x @ p["w"] + p["b"]
        if i < n - 1:
            x = torch.relu(x)
        elif final_sigmoid:
            x = torch.sigmoid(x)
    return x


# --- init ------------------------------------------------------------------------

def init_predictor_params(
    config: ViTConfig,
    pcfg: PruneConfig,
    generator: torch.Generator,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> Optional[dict]:
    """Predictor params for all layers (None for predictor='none'). Same
    shapes and distributions as the JAX package's init, not the same
    numbers."""
    device = check_device(device)
    kind = pcfg.predictor
    if kind == "none":
        return None
    d, n, h, L = config.hidden_size, config.num_patches, pcfg.predictor_hidden, config.num_layers

    def stack(fn):
        return stack_trees([fn() for _ in range(L)])

    def cnn_init():
        return {
            "compress": _init_mlp(generator, [d, 256, 64, 16]),
            "conv1": {"w": trunc_normal((3, 3, 16, 8), generator, 0.1), "b": torch.zeros(8)},
            "conv2": {"w": trunc_normal((3, 3, 8, 1), generator, 0.1), "b": torch.zeros(1)},
        }

    inits = {
        "cls_mlp": lambda: {"mlp": stack(lambda: _init_mlp(generator, [2 * d, h, 1]))},
        "token_mlp": lambda: {"mlp": stack(lambda: _init_mlp(generator, [d, h, 1]))},
        "common_mlp": lambda: {"shared_mlp": _init_mlp(generator, [d, h, 1])},
        "compressor": lambda: {
            "compress": stack(lambda: _init_mlp(generator, [d, 128, 64, 16])),
            "flat": stack(lambda: _init_mlp(generator, [n * 16, 512, n])),
        },
        "shared_compressor": lambda: {
            "shared_compress": _init_mlp(generator, [d, 128, 64, 16]),
            "flat": stack(lambda: _init_mlp(generator, [n * 16, 512, n])),
        },
        "cnn": lambda: {"cnn": stack(cnn_init)},
        "bottleneck": lambda: {"mlp": stack(lambda: _init_mlp(generator, [d, 32, d, 32, 1]))},
        "cls_cosine": dict,  # parameter-free
        "key_cosine": dict,  # parameter-free
        "key_mlp": lambda: {
            "key_mlp": stack(lambda: _init_mlp(generator, [config.head_dim, d, d // 2, 1]))
        },
    }
    if kind not in inits:
        raise ValueError(f"unknown predictor kind {kind!r}")
    return tree_to(inits[kind](), device, dtype)


def init_updatenet_params(
    config: ViTConfig,
    generator: torch.Generator,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """UpdateNet [2D -> D/2 -> D], one per layer, stacked."""
    device = check_device(device)
    d = config.hidden_size
    per = [_init_mlp(generator, [2 * d, d // 2, d]) for _ in range(config.num_layers)]
    return tree_to(stack_trees(per), device, dtype)


def apply_updatenet(un_params: dict, layer_idx: int, hidden_states: torch.Tensor) -> torch.Tensor:
    """Learned residual update for skipped tokens from [token ⊕ CLS]:
    [B, S, D] -> [B, N, D]."""
    patches = hidden_states[:, 1:]
    inp = torch.cat([patches, hidden_states[:, 0:1].expand_as(patches)], dim=-1)
    return _apply_mlp(layer_slice(un_params, layer_idx), inp, final_sigmoid=False)


# --- apply ---------------------------------------------------------------------------

def _head_averaged_keys(h: torch.Tensor, layer_params: dict, config: ViTConfig) -> torch.Tensor:
    """Keys of LN1(h) under the layer's own Wk, averaged over heads: [B, S, hd]."""
    hn = layer_norm(h, layer_params["ln1"], config.layernorm_eps)
    k = hn @ layer_params["attn"]["k"]["w"] + layer_params["attn"]["k"]["b"]
    b, s, _ = k.shape
    return k.reshape(b, s, config.num_heads, config.head_dim).mean(dim=2)


def _cos01(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dot = (a * b).sum(-1)
    nrm = torch.linalg.vector_norm(a, dim=-1) * torch.linalg.vector_norm(b, dim=-1)
    return (dot / nrm.clamp_min(1e-12) + 1.0) / 2.0


def _conv3x3_same(x: torch.Tensor, p: dict) -> torch.Tensor:
    """3x3 SAME conv, NHWC activations and HWIO weights as the JAX package
    stores them, run as NCHW / OIHW with padding 1."""
    y = F.conv2d(x.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1) + p["b"]


def apply_predictor(
    pred_params: dict,
    layer_idx: int,
    hidden_states: torch.Tensor,
    config: ViTConfig,
    pcfg: PruneConfig,
    layer_params: Optional[dict] = None,
) -> Tuple[torch.Tensor, dict]:
    """Score the patch tokens of hidden_states [B, S, D] (CLS at 0, then the
    config's registers, which are never scored).

    Returns (scores [B, N] in (0, 1), extras): extras holds the bottleneck's
    'approx_residual', key_mlp's 'keys' and key_cosine's 'dense_out' (the
    layer's dense output, which the caller reuses).
    """
    kind = pcfg.predictor
    prefix = prefix_len(config)
    patches = hidden_states[:, prefix:]
    extras: dict = {}
    if kind == "cls_mlp":
        # concat([cls, t]) @ W0 == cls @ W0[:D] + t @ W0[D:]: the CLS term is one
        # row broadcast over all patches, so the [B, N, 2D] concat is never built
        p = layer_slice(pred_params["mlp"], layer_idx)
        d = hidden_states.shape[-1]
        w0 = p["l0"]["w"]
        hidden = torch.relu(hidden_states[:, 0:1] @ w0[:d] + patches @ w0[d:] + p["l0"]["b"])
        rest = {f"l{i - 1}": p[f"l{i}"] for i in range(1, len(p))}
        scores = _apply_mlp(rest, hidden)[..., 0]
    elif kind == "token_mlp":
        scores = _apply_mlp(layer_slice(pred_params["mlp"], layer_idx), patches)[..., 0]
    elif kind == "common_mlp":
        scores = _apply_mlp(pred_params["shared_mlp"], patches)[..., 0]
    elif kind in ("compressor", "shared_compressor"):
        comp = (pred_params["shared_compress"] if kind == "shared_compressor"
                else layer_slice(pred_params["compress"], layer_idx))
        lat = _apply_mlp(comp, patches, final_sigmoid=False)  # [B, N, 16]
        flat = lat.reshape(lat.shape[0], -1)
        scores = _apply_mlp(layer_slice(pred_params["flat"], layer_idx), flat)
    elif kind == "cnn":
        p = layer_slice(pred_params["cnn"], layer_idx)
        lat = _apply_mlp(p["compress"], patches, final_sigmoid=False)
        g = config.grid_size
        y = torch.relu(_conv3x3_same(lat.reshape(lat.shape[0], g, g, -1), p["conv1"]))
        y = _conv3x3_same(y, p["conv2"])
        scores = torch.sigmoid(y.reshape(y.shape[0], -1))
    elif kind == "bottleneck":
        p = layer_slice(pred_params["mlp"], layer_idx)
        h1 = torch.relu(patches @ p["l0"]["w"] + p["l0"]["b"])
        middle = torch.relu(h1 @ p["l1"]["w"] + p["l1"]["b"])
        h3 = torch.relu(middle @ p["l2"]["w"] + p["l2"]["b"])
        scores = torch.sigmoid(h3 @ p["l3"]["w"] + p["l3"]["b"])[..., 0]
        extras["approx_residual"] = middle  # stands in for layer(x) - x
    elif kind == "cls_cosine":
        scores = 1.0 - _cos01(patches, hidden_states[:, 0:1])
    elif kind == "key_mlp":
        if layer_params is None:
            raise ValueError("predictor 'key_mlp' needs layer_params")
        keys = _head_averaged_keys(hidden_states, layer_params, config)
        scores = _apply_mlp(layer_slice(pred_params["key_mlp"], layer_idx),
                            keys[:, prefix:])[..., 0]
        extras["keys"] = keys
    elif kind == "key_cosine":
        if layer_params is None:
            raise ValueError("predictor 'key_cosine' needs layer_params")
        # The JAX package runs this dense pass on its jnp layer; here it goes
        # through vit_layer, so on the card through kernel B1 and its staged2
        # numerics (equal within the layer tolerance). It stays float under
        # int8 serving, as in the JAX package.
        dense_out = vit_layer(hidden_states, layer_params, config, quant="none")
        k_cur = _head_averaged_keys(hidden_states, layer_params, config)
        k_next = _head_averaged_keys(dense_out, layer_params, config)
        scores = _cos01(k_next, k_cur)[:, prefix:]
        extras["dense_out"] = dense_out
    else:
        raise ValueError(f"predictor kind {kind!r} has no apply rule")
    return scores, extras


def predictor_param_filter(path_leaf: str) -> bool:
    """True for predictor params (a leaf's path, '/'-joined from the root):
    the test the freeze policies select predictors by (train/freeze.py)."""
    return path_leaf.startswith("predictor")
