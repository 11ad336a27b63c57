"""ViT/DeiT forward in PyTorch, plain functions over a nested-dict param tree.

Mirrors vit_pruning_tpu/models/vit.py, in the same param layout:

  {'embed': {'patch': {'w' [C*P*P, D], 'b' [D]}, 'cls' [1, 1, D], 'pos' [1, S, D]},
   'layers': {'ln1': {'g','b'}, 'attn': {'q','k','v','o': {'w','b'}},
              'ln2': {'g','b'}, 'mlp': {'fc1': {'w','b'}, 'fc2': {'w','b'}}},
             # every layer leaf stacked on a leading [L] axis
   'ln_f': {'g','b'}, 'head': {'w' [D, labels], 'b'}}

DINOv2's block and tokens (the port's own ViTConfig fields, configs.py):
a SwiGLU MLP has fc1 [D, 2M] (checkpoint order, or interleaved for kernel
B1 once at load: ops/swiglu.py), LayerScale puts 'ls1' and 'ls2' [D] in
each layer, registers are 'embed': {'registers' [1, R, D]} (after CLS, no
position embedding: 'pos' has 1 + N rows), and the CLS ⊕ patch-mean head
has 'head': {'w' [2D, labels]}.

`vit_layer` routes through kernel B1 (ops/cuda/layer.py::fused_vit_layer;
under autograd through its Function, whose backward recomputes the plain
layer) unless the dispatch mode is 'eager', in which case it runs the plain layer
below (layer_norm -> mha -> mlp_block with erf GELU), the counterpart of the
JAX package's use_pallas=False path. Under int8 serving (`quant`, or the
dispatch switch when it is None) the layer runs kernel B4
(ops/cuda/layer_int8.py) or, in 'eager', ops/quant.py::int8_vit_layer_ref.
With head_mask or return_probs the layer takes the per-op route in float:
layer_norm -> mha (kernel B6 in mode 'kernel') -> layer_norm -> mlp_block
(kernel B7 when kernels are on). `vit_forward` runs all layers as one call
of kernel B5 (ops/cuda/model.py, differentiable the same way) when encoder
fusion is on and the weights fit (`encoder_route`). `remat` checkpoints each
layer of the layer loop (torch.utils.checkpoint), as the JAX package's
jax.checkpoint of its scan body.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vit_pruning_tpu_torch.configs import ViTConfig, port_field, prefix_len
from vit_pruning_tpu_torch.models.convert import check_device, tree_to
from vit_pruning_tpu_torch.ops.attention import mha
from vit_pruning_tpu_torch.ops.cuda.widths import (
    INT8_MULTIPLE,
    LAYER_MULTIPLE,
    PADDED,
    with_kernel_weights,
)
from vit_pruning_tpu_torch.ops.dispatch import (
    attention_kernel_enabled,
    encoder_fusion_enabled,
    kernels_enabled,
    resolve_quant,
)
from vit_pruning_tpu_torch.ops.patch_embed import patch_embed
from vit_pruning_tpu_torch.ops.quant import (
    attach_int8_weights,
    int8_vit_layer_ref,
    is_quantized,
    with_kmajor_int8_weights,
)
from vit_pruning_tpu_torch.ops.swiglu import (
    has_layerscale,
    is_swiglu,
    refuse_dinov2,
    require_interleaved,
    swiglu_mlp,
    weight,
)
from vit_pruning_tpu_torch.utils.profiling import span


def layer_norm(x: torch.Tensor, params: dict, eps: float) -> torch.Tensor:
    """LayerNorm in x's dtype with the biased variance, as the JAX package."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * params["g"] + params["b"]


def mlp_block(x: torch.Tensor, params: dict, use_kernel: bool = False) -> torch.Tensor:
    """Linear -> GELU (erf) -> Linear; use_kernel: kernel B7 on the [B*S, D]
    rows (f32 arithmetic, output in x's dtype). A SwiGLU MLP (ops/swiglu.py)
    runs its plain version: B7 computes the GELU MLP alone."""
    if is_swiglu({"mlp": params}):
        return swiglu_mlp(x, params)
    if use_kernel:
        from vit_pruning_tpu_torch.ops.cuda.mlp import fused_mlp

        b, s, d = x.shape
        y = fused_mlp(x.reshape(b * s, d), params["fc1"]["w"], params["fc1"]["b"],
                      params["fc2"]["w"], params["fc2"]["b"])
        return y.reshape(b, s, d)
    h = F.gelu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return h @ params["fc2"]["w"] + params["fc2"]["b"]


def check_block(params: dict, config: ViTConfig):
    """The layer tree's block (ops/swiglu.py: SwiGLU by fc1's width,
    LayerScale by its gains) must be the config's. The routes compute the
    tree's block; the config's mlp_kind and layerscale are what init and
    the FLOP count read, so a tree served under another model's config
    raises here rather than being counted as the wrong model."""
    if is_swiglu(params) != (port_field(config, "mlp_kind") == "swiglu"):
        raise ValueError(f"the layer's MLP is {'SwiGLU' if is_swiglu(params) else 'GELU'}, the "
                         f"config's mlp_kind {port_field(config, 'mlp_kind')!r}")
    if has_layerscale(params) != port_field(config, "layerscale"):
        raise ValueError(f"the layer {'has' if has_layerscale(params) else 'lacks'} LayerScale's "
                         f"gains, the config's layerscale is {port_field(config, 'layerscale')}")


def check_attn_geometry(q_width: int, config: ViTConfig):
    """Head-pruned params under the unpruned config (or the reverse) would
    split heads at the wrong width and run with wrong numerics."""
    if q_width != config.attn_width:
        raise ValueError(
            f"attention projection width {q_width} != config.num_heads "
            f"({config.num_heads}) x config.head_dim ({config.head_dim}); "
            f"use the ViTConfig returned by prune_heads for pruned params"
        )


def vit_layer(
    x: torch.Tensor,
    params: dict,
    config: ViTConfig,
    token_mask: Optional[torch.Tensor] = None,
    head_mask: Optional[torch.Tensor] = None,
    return_probs: bool = False,
    quant: Optional[str] = None,
    use_kernels: Optional[bool] = None,
):
    """One pre-LN block. token_mask [B, S] bool restricts attention keys to
    kept tokens; outputs at masked rows are computed but meaningless.

    quant: 'none', 'int8' or None (read the dispatch switch now). Under
    int8 the layer's weights are quantized here unless `params` already
    carries 'wq' / 'wscale' (ops/quant.py::attach_int8_weights), which is
    how the forwards below quantize once per call.

    head_mask [H] or [B, H] multiplies the attention probabilities;
    return_probs returns (x, probs [B, H, S, S]). Either one turns int8
    off and takes the per-op route (LN in x's dtype -> mha -> LN ->
    mlp_block), as the JAX package does.

    use_kernels: None = the dispatch mode (kernels unless 'eager'); False
    runs the plain layer on every device, as the JAX package's vit_layer
    does by default (its use_pallas=False), which is what its return_probs
    callers rely on (ops/structured.py::head_importance)."""
    q = params["attn"]["q"]
    check_attn_geometry((q["w"] if "w" in q else q["wq"]).shape[-1], config)
    check_block(params, config)
    use_kernels = kernels_enabled() if use_kernels is None else use_kernels
    per_op = head_mask is not None or return_probs
    if not per_op and resolve_quant(quant) == "int8":
        refuse_dinov2("int8 serving", params)
        qp = params if is_quantized(params) else attach_int8_weights(params)
        if use_kernels:
            from vit_pruning_tpu_torch.ops.cuda.layer_int8 import fused_vit_layer_int8

            return fused_vit_layer_int8(x, qp, config.num_heads, config.layernorm_eps,
                                        token_mask)
        return int8_vit_layer_ref(x, qp, config, token_mask)
    if "w" not in q:
        raise ValueError("params carry int8 weights only: run them with quant='int8'")
    if use_kernels and not per_op:
        from vit_pruning_tpu_torch.ops.cuda.layer import fused_vit_layer

        return fused_vit_layer(x, params, config.num_heads, config.layernorm_eps, token_mask)
    h = layer_norm(x, params["ln1"], config.layernorm_eps)
    attn = mha(h, params["attn"], config.num_heads, token_mask=token_mask, head_mask=head_mask,
               return_probs=return_probs, use_kernel=use_kernels and attention_kernel_enabled())
    if return_probs:
        attn, probs = attn
    scale = has_layerscale(params)
    x = x + (params["ls1"] * attn if scale else attn)
    h = layer_norm(x, params["ln2"], config.layernorm_eps)
    y = mlp_block(h, params["mlp"], use_kernel=use_kernels)
    x = x + (params["ls2"] * y if scale else y)
    return (x, probs) if return_probs else x


def embed(pixel_values: torch.Tensor, params: dict, config: ViTConfig) -> torch.Tensor:
    """Patch projection + CLS token + position embeddings (+ the registers
    after CLS, without one) -> [B, S, D]."""
    b, c, h, w = pixel_values.shape
    if (c, h, w) != (config.num_channels, config.image_size, config.image_size):
        raise ValueError(
            f"pixel_values {tuple(pixel_values.shape)} does not match config (expected "
            f"[B, {config.num_channels}, {config.image_size}, {config.image_size}])"
        )
    x = patch_embed(pixel_values, params["patch"], config.patch_size)
    cls = params["cls"].expand(b, 1, config.hidden_size).to(x.dtype)
    return with_registers(torch.cat([cls, x], dim=1) + params["pos"].to(x.dtype), params, config)


def registers_of(params: dict, config: ViTConfig) -> Optional[torch.Tensor]:
    """The embed's register tokens [1, R, D], None where it has none;
    raises where R is not the config's."""
    reg = params.get("registers")
    have = 0 if reg is None else reg.shape[1]
    want = port_field(config, "num_registers")
    if have != want:
        raise ValueError(f"the embed has {have} register tokens, the config {want}")
    return reg if have else None


def with_registers(x: torch.Tensor, params: dict, config: ViTConfig) -> torch.Tensor:
    """x [B, 1 + N, D] (CLS and the patches, positions added) with the
    config's registers put in after CLS: [B, 1 + R + N, D]."""
    reg = registers_of(params, config)
    if reg is None:
        return x
    return torch.cat([x[:, :1], reg.to(x.dtype).expand(x.shape[0], -1, -1), x[:, 1:]], dim=1)


def pooled(x: torch.Tensor, config: ViTConfig) -> torch.Tensor:
    """The head's input from the final LN's output x [B, S, D]: the CLS row,
    or (head_pool 'cls_mean') CLS ⊕ the mean of the patch rows, the
    registers left out."""
    if port_field(config, "head_pool") == "cls":
        return x[:, 0]
    return torch.cat([x[:, 0], x[:, prefix_len(config):].mean(dim=1)], dim=-1)


def layer_slice(layers: dict, i: int) -> dict:
    """Layer i of a stacked [L, ...] tree (views, no copy)."""
    if isinstance(layers, dict):
        return {k: layer_slice(v, i) for k, v in layers.items()}
    return layers[i]


def layers_for(layers: dict, quant: str) -> dict:
    """The stacked layer tree a forward runs: under int8, the float tree
    with every layer's int8 weights attached (one quantization per call)
    unless it carries them already. When kernels are on, also what the
    layer kernels read, built once per call rather than once per layer
    launch: for widths the kernels do not take, the zero-padded tree
    (ops/cuda/widths.py, under PADDED), and under int8 kernel B4's K-major
    layout (ops/quant.py::kmajor_int8_weights) of the tree it reads. A
    SwiGLU tree on the card comes with fc1 interleaved at load
    (ops/swiglu.py::with_gated_fc1); in checkpoint order it raises. A
    `prep` span (utils/profiling.py)."""
    with span("prep"):
        if quant == "int8" and not is_quantized(layers):
            refuse_dinov2("int8 serving", layers)
            layers = attach_int8_weights(layers)
        if not kernels_enabled():
            return layers
        if not weight(layers["mlp"]["fc1"]).is_cpu:  # the route launches B1
            require_interleaved("layers_for", layers)
        if quant != "int8":
            return with_kernel_weights(layers, LAYER_MULTIPLE)
        layers = with_kernel_weights(layers, INT8_MULTIPLE)
        if PADDED in layers:
            return {**layers, PADDED: with_kmajor_int8_weights(layers[PADDED])}
        return with_kmajor_int8_weights(layers)


def layer_range(layers: dict, start: int, stop: int) -> dict:
    """Layers [start, stop) of a stacked tree, still stacked (views, no copy)."""
    if isinstance(layers, dict):
        return {k: layer_range(v, start, stop) for k, v in layers.items()}
    return layers[start:stop]


def encoder_route(layers: dict, config: ViTConfig) -> bool:
    """Does a fixed-length stretch of these layers run as kernel B5? When
    kernels are on, encoder fusion is on and the float weights fit the JAX
    package's budget (ops/cuda/model.py::encoder_weights_fit), as its
    vit_forward and progressive_topk_forward decide. The route does not look
    at the serving quantization: under int8 it runs the float B5, as the
    JAX package's does."""
    from vit_pruning_tpu_torch.ops.cuda.model import encoder_weights_fit

    if is_swiglu(layers) or has_layerscale(layers):  # B5 takes neither
        return False
    return (kernels_enabled() and encoder_fusion_enabled() and encoder_weights_fit(
        config.num_layers, config.hidden_size, config.mlp_dim,
        layers["attn"]["q"]["b"].element_size()))


def vit_forward(
    params: dict,
    pixel_values: torch.Tensor,
    config: ViTConfig,
    head_mask: Optional[torch.Tensor] = None,
    output_hidden_states: bool = False,
    quant: Optional[str] = None,
    remat: bool = False,
) -> dict:
    """Dense forward. Returns dict(logits, cls, last_hidden[, hidden_states]).

    head_mask: [L, H] or [L, B, H] float (multiplies each layer's attention
    probabilities) or None. output_hidden_states: also return the L + 1
    layer inputs and output as a list. Either one runs the layers one by
    one, as vit_layer routes them; without them the encoder is one call of
    kernel B5 where `encoder_route` says so.
    quant: 'none', 'int8' or None (read the dispatch switch once, here).
    Under int8 the stacked layer weights are quantized once per call.
    remat: recompute each layer of the layer loop in the backward instead
    of keeping its activations (the training memory lever); as in the JAX
    package, the B5 route and the head_mask / hidden-states loop ignore it."""
    quant = resolve_quant(quant)
    x = embed(pixel_values, params["embed"], config)
    hidden_states = [x] if output_hidden_states else None
    if head_mask is None and not output_hidden_states and encoder_route(params["layers"], config):
        from vit_pruning_tpu_torch.ops.cuda.model import fused_vit_encoder

        x = fused_vit_encoder(x, layers_for(params["layers"], "none"), config.num_heads,
                              config.layernorm_eps)
    else:
        # a head-masked layer runs in float (vit_layer): no int8 weights needed
        layers = layers_for(params["layers"], quant if head_mask is None else "none")
        per_layer = head_mask is not None or output_hidden_states
        for i in range(config.num_layers):
            hm = head_mask[i] if head_mask is not None else None
            if remat and not per_layer:
                x = checkpoint(vit_layer, x, layer_slice(layers, i), config, quant=quant,
                               use_reentrant=False)
            else:
                x = vit_layer(x, layer_slice(layers, i), config, head_mask=hm, quant=quant)
            if output_hidden_states:
                hidden_states.append(x)
    x = layer_norm(x, params["ln_f"], config.layernorm_eps)
    cls = x[:, 0]
    logits = pooled(x, config) @ params["head"]["w"] + params["head"]["b"]
    out = {"logits": logits, "cls": cls, "last_hidden": x}
    if output_hidden_states:
        out["hidden_states"] = hidden_states
    return out


# --- Initialization -------------------------------------------------------------

def trunc_normal(shape, generator: torch.Generator, std: float = 0.02) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by std (the JAX package's init), drawn
    on the CPU so that a seed gives the same weights on every device."""
    t = torch.empty(shape)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * std


def linear_init(generator: torch.Generator, fan_in: int, fan_out: int) -> dict:
    return {"w": trunc_normal((fan_in, fan_out), generator), "b": torch.zeros(fan_out)}


def stack_trees(trees: list) -> dict:
    if isinstance(trees[0], dict):
        return {k: stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_vit_params(
    config: ViTConfig,
    generator: torch.Generator,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> dict:
    """Random init as the JAX package's: trunc-normal(0.02) weights, zero
    biases, unit LN gains. Same distribution, not the same numbers. Drawn
    on the CPU from `generator`, then moved to `device` (the card unless
    the caller asks for 'cpu'). DINOv2's parts (the config's port-only
    fields): fc1 2M wide in checkpoint order under SwiGLU, LayerScale's
    gains at LAYERSCALE_INIT, registers trunc-normal(0.02), the pooled
    head 2D wide."""
    device = check_device(device)
    d = config.hidden_size
    fc1_width = config.mlp_dim * (2 if port_field(config, "mlp_kind") == "swiglu" else 1)
    registers = port_field(config, "num_registers")

    def layer_init():
        layer = {
            "ln1": {"g": torch.ones(d), "b": torch.zeros(d)},
            "attn": {n: linear_init(generator, d, d) for n in ("q", "k", "v", "o")},
            "ln2": {"g": torch.ones(d), "b": torch.zeros(d)},
            "mlp": {
                "fc1": linear_init(generator, d, fc1_width),
                "fc2": linear_init(generator, config.mlp_dim, d),
            },
        }
        if port_field(config, "layerscale"):
            layer.update(ls1=torch.full((d,), LAYERSCALE_INIT),
                         ls2=torch.full((d,), LAYERSCALE_INIT))
        return layer

    params = {
        "layers": stack_trees([layer_init() for _ in range(config.num_layers)]),
        "embed": {
            "patch": linear_init(generator, config.patch_dim, d),
            "cls": trunc_normal((1, 1, d), generator),
            "pos": trunc_normal((1, config.num_patches + 1, d), generator),
        },
        "ln_f": {"g": torch.ones(d), "b": torch.zeros(d)},
        "head": linear_init(generator, d * (2 if port_field(config, "head_pool") == "cls_mean"
                                            else 1), config.num_labels),
    }
    if registers:
        params["embed"]["registers"] = trunc_normal((1, registers, d), generator)
    return tree_to(params, device, dtype)


# LayerScale's gains at init: HF Dinov2WithRegistersConfig's layerscale_value, 1.0 in
# the published checkpoints' configs (facebook/dinov2-with-registers-*)
LAYERSCALE_INIT = 1.0


def param_count(params: dict) -> int:
    """Number of values in a param tree (None leaves count 0)."""
    if isinstance(params, dict):
        return sum(param_count(v) for v in params.values())
    return 0 if params is None else params.numel()
