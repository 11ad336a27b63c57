"""Weight bridges: the JAX param tree and HF torch checkpoints.

Both packages use the same layout (models/vit.py docstring of the JAX
package): nested dicts, per-layer leaves stacked on a leading [L] axis,
linear weights stored [in, out]. `params_from_jax` / `params_to_numpy` only
change the leaf type, so the tests can feed one set of weights to both
packages.

The HF bridge mirrors vit_pruning_tpu/models/convert.py: `strip_prefix`,
`torch_state_dict_to_params` (an HF ViT(ForImageClassification) state_dict
to the param tree, with the 'vit.' prefix surgery and a random classifier
where the checkpoint has none, as a strict=False load),
`params_to_torch_state_dict` (the inverse, loadable with strict=True),
`interpolate_pos_embed` (the position table resized to another image size
by the JAX package's bicubic resize, which makes sequences past 197 tokens
reachable: DeiT-S at 384 gives 577) and `load_hf_vit` (a live HF model or a
local directory; transformers is imported only there). `load_dinov2_state_dict`
maps HF's Dinov2WithRegisters names to the port's tree (DINOv2 with
registers: SwiGLU, LayerScale, registers, the pooled head).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _map(tree: Any, fn, key: str = ""):
    """fn(leaf, key of the leaf) over a nested dict; None leaves stay None."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    if tree is None:
        return None
    return fn(tree, key)


def flatten_tree(tree, prefix: tuple = ()) -> list:
    """[(path, leaf)] of a nested dict's leaves in the dict's order (None
    leaves left out): how a tree crosses into autograd (a Function sees
    only tensors passed to it one by one) and into an optimizer."""
    if isinstance(tree, dict):
        return [pl for k, v in tree.items() for pl in flatten_tree(v, prefix + (k,))]
    return [] if tree is None else [(prefix, tree)]


def unflatten_tree(paths, leaves) -> dict:
    """The nested dict of flatten_tree's paths, with `leaves` at them."""
    root: dict = {}
    for path, leaf in zip(paths, leaves):
        node = root
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return root


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
    """Tensor tree -> numpy tree of copies (bf16 leaves come back as float32,
    which holds every bf16 value exactly; int8 and float32 leaves
    unchanged). A copy: a train step updates the params in place."""

    def leaf(t: torch.Tensor, key):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().copy()

    return _map(tree, leaf)


def tree_to(tree: Any, device=None, dtype: torch.dtype = None) -> Any:
    """Move and/or cast every leaf of a tensor tree (int8 weights and their
    scales keep their dtype)."""
    return _map(tree, lambda t, key: t.to(
        device=device, dtype=None if dtype is None else _leaf_dtype(key, t.dtype, dtype)))


# --- the HF checkpoint bridge ------------------------------------------------------------

def strip_prefix(state_dict: Dict[str, Any], prefix: str = "vit.") -> Dict[str, Any]:
    """Key surgery: 'vit.encoder...' -> 'encoder...'."""
    return {k[len(prefix):] if k.startswith(prefix) else k: v for k, v in state_dict.items()}


def _f32(t) -> torch.Tensor:
    """A checkpoint leaf as a float32 CPU tensor of its own."""
    return torch.as_tensor(t.detach() if hasattr(t, "detach") else t).to(
        "cpu", torch.float32).clone()


def _lin(sd: dict, name: str) -> dict:
    """torch Linear [out, in] -> input-major {'w' [in, out], 'b' [out]}."""
    return {"w": _f32(sd[f"{name}.weight"]).t().contiguous(), "b": _f32(sd[f"{name}.bias"])}


def _ln(sd: dict, name: str) -> dict:
    return {"g": _f32(sd[f"{name}.weight"]), "b": _f32(sd[f"{name}.bias"])}


def torch_state_dict_to_params(
    state_dict: Dict[str, Any],
    config,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """An HF ViT(ForImageClassification) state_dict -> the backbone param tree
    on `device` in `dtype`. A checkpoint without a classifier (a bare
    ViTModel) gets a random head from `generator` (seed 0 by default), the
    strict=False load of the reference; its numbers differ from the JAX
    package's random head, its distribution does not."""
    from vit_pruning_tpu_torch.models.vit import linear_init, stack_trees

    sd = strip_prefix(dict(state_dict))
    d = config.hidden_size
    proj_w = _f32(sd["embeddings.patch_embeddings.projection.weight"])  # [D, C, P, P]
    embed = {
        "patch": {"w": proj_w.reshape(d, -1).t().contiguous(),  # (c, kh, kw) flattening
                  "b": _f32(sd["embeddings.patch_embeddings.projection.bias"])},
        "cls": _f32(sd["embeddings.cls_token"]),
        "pos": _f32(sd["embeddings.position_embeddings"]),
    }
    layers = []
    for i in range(config.num_layers):
        p = f"encoder.layer.{i}"
        layers.append({
            "ln1": _ln(sd, f"{p}.layernorm_before"),
            "attn": {n: _lin(sd, f"{p}.attention.attention.{hf}")
                     for n, hf in (("q", "query"), ("k", "key"), ("v", "value"))}
                    | {"o": _lin(sd, f"{p}.attention.output.dense")},
            "ln2": _ln(sd, f"{p}.layernorm_after"),
            "mlp": {"fc1": _lin(sd, f"{p}.intermediate.dense"),
                    "fc2": _lin(sd, f"{p}.output.dense")},
        })
    if "classifier.weight" in sd:
        head = _lin(sd, "classifier")
    else:
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        head = linear_init(gen, d, config.num_labels)
    params = {"embed": embed, "layers": stack_trees(layers), "ln_f": _ln(sd, "layernorm"),
              "head": head}
    return tree_to(params, check_device(device), dtype)


# the backbone's prefix in HF's Dinov2WithRegistersForImageClassification
DINOV2_PREFIX = "dinov2_with_registers."


def load_dinov2_state_dict(
    state_dict: Dict[str, Any],
    config,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """An HF Dinov2WithRegisters(ForImageClassification) state_dict -> the
    backbone param tree (models/vit.py's layout with DINOv2's parts) on
    `device` in `dtype`, in checkpoint order: mlp.weights_in becomes fc1
    [D, 2M] with its columns [u1 | u2] as published, layer_scale{1,2}
    become 'ls1' / 'ls2', register_tokens 'embed.registers'. The mask
    token, which inference never uses, is left out. A checkpoint without a
    classifier (a bare backbone) gets a random [2D, labels] head from
    `generator` (seed 0 by default), as torch_state_dict_to_params does.
    Serving interleaves fc1 once after this, at set-up
    (ops/swiglu.py::with_gated_fc1)."""
    from vit_pruning_tpu_torch.models.vit import linear_init, stack_trees

    sd = strip_prefix(dict(state_dict), DINOV2_PREFIX)
    d = config.hidden_size
    proj_w = _f32(sd["embeddings.patch_embeddings.projection.weight"])  # [D, C, P, P]
    embed = {
        "patch": {"w": proj_w.reshape(d, -1).t().contiguous(),  # (c, kh, kw) flattening
                  "b": _f32(sd["embeddings.patch_embeddings.projection.bias"])},
        "cls": _f32(sd["embeddings.cls_token"]),
        "registers": _f32(sd["embeddings.register_tokens"]),
        "pos": _f32(sd["embeddings.position_embeddings"]),
    }
    layers = []
    for i in range(config.num_layers):
        p = f"encoder.layer.{i}"
        layers.append({
            "ln1": _ln(sd, f"{p}.norm1"),
            "attn": {n: _lin(sd, f"{p}.attention.attention.{hf}")
                     for n, hf in (("q", "query"), ("k", "key"), ("v", "value"))}
                    | {"o": _lin(sd, f"{p}.attention.output.dense")},
            "ls1": _f32(sd[f"{p}.layer_scale1.lambda1"]),
            "ln2": _ln(sd, f"{p}.norm2"),
            "mlp": {"fc1": _lin(sd, f"{p}.mlp.weights_in"), "fc2": _lin(sd, f"{p}.mlp.weights_out")},
            "ls2": _f32(sd[f"{p}.layer_scale2.lambda1"]),
        })
    if "classifier.weight" in sd:
        head = _lin(sd, "classifier")
    else:
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        head = linear_init(gen, 2 * d, config.num_labels)
    params = {"embed": embed, "layers": stack_trees(layers), "ln_f": _ln(sd, "layernorm"),
              "head": head}
    return tree_to(params, check_device(device), dtype)


def params_to_torch_state_dict(params: dict, config, classifier: bool = True) -> Dict[str, Any]:
    """Inverse of `torch_state_dict_to_params`: the param tree (a pruned
    model's, whose 'backbone' is exported, or a bare backbone) -> an HF
    state_dict of float32 CPU tensors, loadable into
    ViTForImageClassification with strict=True."""
    tree = params["backbone"] if "backbone" in params else params

    def t(x, transpose=False):
        x = x.detach().to("cpu", torch.float32)
        return (x.t() if transpose else x).contiguous().clone()

    d, c, p = config.hidden_size, config.num_channels, config.patch_size
    sd = {
        "vit.embeddings.cls_token": t(tree["embed"]["cls"]),
        "vit.embeddings.position_embeddings": t(tree["embed"]["pos"]),
        # [C*P*P, D] input-major -> conv [D, C, P, P]
        "vit.embeddings.patch_embeddings.projection.weight":
            t(tree["embed"]["patch"]["w"], transpose=True).reshape(d, c, p, p),
        "vit.embeddings.patch_embeddings.projection.bias": t(tree["embed"]["patch"]["b"]),
        "vit.layernorm.weight": t(tree["ln_f"]["g"]),
        "vit.layernorm.bias": t(tree["ln_f"]["b"]),
    }
    lay = tree["layers"]
    # HF's names in the JAX package's key order
    names = (("layernorm_before", lay["ln1"]), ("attention.attention.query", lay["attn"]["q"]),
             ("attention.attention.key", lay["attn"]["k"]),
             ("attention.attention.value", lay["attn"]["v"]),
             ("attention.output.dense", lay["attn"]["o"]), ("layernorm_after", lay["ln2"]),
             ("intermediate.dense", lay["mlp"]["fc1"]), ("output.dense", lay["mlp"]["fc2"]))
    for i in range(config.num_layers):
        for hf, p in names:
            pre = f"vit.encoder.layer.{i}.{hf}"
            if "g" in p:  # LayerNorm
                sd[f"{pre}.weight"], sd[f"{pre}.bias"] = t(p["g"][i]), t(p["b"][i])
            else:
                sd[f"{pre}.weight"] = t(p["w"][i], transpose=True)
                sd[f"{pre}.bias"] = t(p["b"][i])
    if classifier:
        sd["classifier.weight"] = t(tree["head"]["w"], transpose=True)
        sd["classifier.bias"] = t(tree["head"]["b"])
    return sd


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 on |x|."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _bicubic_resize_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """[n_in, n_out] float64 weights of jax.image.resize(method='bicubic') on
    one axis: half-pixel centres, Keys' cubic with a = -0.5, and, when
    shrinking, the kernel widened by n_in / n_out (JAX's antialias);
    columns normalised to sum 1, samples outside the input zeroed.
    torch's F.interpolate(mode='bicubic') takes a = -0.75 and never
    antialiases in its bicubic mode, so it is not this resize."""
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float64) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float64)[:, None]).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(0, keepdim=True)
    eps32 = float(torch.finfo(torch.float32).eps)
    w = torch.where(total.abs() > 1000.0 * eps32, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def interpolate_pos_embed(params: dict, config, new_image_size: int) -> tuple:
    """Resize the position embeddings to another input resolution: the
    patch grid's table resized bicubically (as the JAX package's
    jax.image.resize), the CLS entry kept. Takes a backbone or a pruned
    model's tree; returns (new_params, new_config). The sequence grows with
    the grid: DeiT-S/16 at 384 runs S 577, which the layer kernels take."""
    tree = params["backbone"] if "backbone" in params else params
    pos = tree["embed"]["pos"]  # [1, S, D]
    d = pos.shape[-1]
    old_grid, new_grid = config.grid_size, new_image_size // config.patch_size
    w = _bicubic_resize_matrix(old_grid, new_grid).to(pos.device)
    grid = pos[0, 1:].reshape(old_grid, old_grid, d).to(torch.float64)
    resized = torch.einsum("ijd,ia,jb->abd", grid, w, w).reshape(1, new_grid * new_grid, d)
    new_pos = torch.cat([pos[:, :1], resized.to(pos.dtype)], dim=1)
    new_tree = dict(tree, embed=dict(tree["embed"], pos=new_pos))
    out = dict(params, backbone=new_tree) if "backbone" in params else new_tree
    return out, config.replace(image_size=new_image_size)


def load_hf_vit(model_or_dir, config=None, device="cuda", dtype: torch.dtype = torch.float32):
    """An HF ViT classification model -> (params, config). Takes a live
    model object or the path of a local directory saved with
    save_pretrained (loaded with local_files_only=True: nothing is
    fetched). transformers is imported only for a directory."""
    from vit_pruning_tpu_torch.configs import ViTConfig

    if isinstance(model_or_dir, (str, os.PathLike)):
        if not os.path.isdir(model_or_dir):
            raise ValueError(f"load_hf_vit: {str(model_or_dir)!r} is not a local directory "
                             f"(a model is loaded from disk only, never fetched)")
        from transformers import AutoModelForImageClassification

        model = AutoModelForImageClassification.from_pretrained(
            os.fspath(model_or_dir), local_files_only=True)
    else:
        model = model_or_dir
    hf_cfg = model.config
    if config is None:
        config = ViTConfig(
            image_size=hf_cfg.image_size, patch_size=hf_cfg.patch_size,
            num_channels=hf_cfg.num_channels, hidden_size=hf_cfg.hidden_size,
            num_layers=hf_cfg.num_hidden_layers, num_heads=hf_cfg.num_attention_heads,
            mlp_dim=hf_cfg.intermediate_size, num_labels=getattr(hf_cfg, "num_labels", 1000),
            layernorm_eps=hf_cfg.layer_norm_eps,
        )
    return torch_state_dict_to_params(model.state_dict(), config, device=device,
                                      dtype=dtype), config
