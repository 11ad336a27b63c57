"""Analytic per-image FLOPs accounting, dense vs pruned.

A copy of vit_pruning_tpu/utils/flops.py over the port's configs (held
equal to it by the tests for every config and schedule preset).

Replaces the reference's ptflops profiling (himanshu/main_model_utils.py:194-231,
hi_main.py:181-185): instead of tracing torch modules we count the matmul
FLOPs of this architecture directly (2*M*N*K per matmul, the MXU-relevant
number), parameterized by the per-layer number of live tokens so the
pruned-vs-dense comparison the reference prints per run is reproducible from
recorded masks.
"""

from __future__ import annotations

from typing import Optional, Sequence

from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig, port_field, prefix_len


def _layer_flops(config: ViTConfig, tokens: float, kv_tokens: Optional[float] = None) -> float:
    """One encoder layer with `tokens` query tokens attending over
    `kv_tokens` keys (defaults to tokens).

    Uses config.attn_width (== hidden unless heads were physically pruned by
    ops/structured.py::prune_heads) and config.mlp_dim, so structurally
    pruned geometries are accounted correctly — callers holding
    channel-pruned params must pass a config with the halved mlp_dim
    (prune_mlp_channels changes weights, not the config). A SwiGLU MLP
    (DINOv2's) has three products of D x M: fc1 is 2M wide."""
    d = config.hidden_size
    aw = config.attn_width
    m = config.mlp_dim
    kv = tokens if kv_tokens is None else kv_tokens
    qkv = 3 * 2 * tokens * d * aw         # fused QKV projection
    attn = 2 * tokens * kv * aw * 2       # QK^T and PV
    out = 2 * tokens * aw * d             # output projection
    products = 3 if port_field(config, "mlp_kind") == "swiglu" else 2
    mlp = 2 * tokens * d * m * products   # fc1 (2M wide under SwiGLU) + fc2
    return qkv + attn + out + mlp


def _predictor_flops(config: ViTConfig, pcfg: PruneConfig) -> float:
    n, d, h = config.num_patches, config.hidden_size, pcfg.predictor_hidden
    kind = pcfg.predictor
    if kind == "none":
        return 0.0
    if kind == "cls_mlp":
        return 2 * n * (2 * d * h + h)
    if kind in ("token_mlp", "common_mlp"):
        return 2 * n * (d * h + h)
    if kind in ("compressor", "shared_compressor"):
        comp = 2 * n * (d * 128 + 128 * 64 + 64 * 16)
        flat = 2 * (n * 16 * 512 + 512 * n)
        return comp + flat
    if kind == "cnn":
        comp = 2 * n * (d * 256 + 256 * 64 + 64 * 16)
        conv = 2 * n * (9 * 16 * 8 + 9 * 8 * 1)
        return comp + conv
    if kind == "bottleneck":
        return 2 * n * (d * 32 + 32 * d + d * 32 + 32)
    return 0.0


def _head_flops(config: ViTConfig) -> float:
    """The classifier on CLS, or on CLS ⊕ the patch mean (2 D wide)."""
    width = config.hidden_size * (2 if port_field(config, "head_pool") == "cls_mean" else 1)
    return 2 * width * config.num_labels


def vit_flops(config: ViTConfig) -> float:
    """Dense per-image forward FLOPs (matmuls only)."""
    s = config.seq_len
    patch = 2 * config.num_patches * config.patch_dim * config.hidden_size
    layers = config.num_layers * _layer_flops(config, s)
    return patch + layers + _head_flops(config)


def pruned_vit_flops(
    config: ViTConfig,
    pcfg: PruneConfig,
    tokens_per_layer: Optional[Sequence[float]] = None,
) -> float:
    """Per-image FLOPs given per-layer live-token counts (incl. CLS and
    any registers).

    tokens_per_layer: measured mean kept tokens per layer (from keep_masks);
    defaults to top_k + CLS (+ registers) for topk mode, dense otherwise.
    """
    s = config.seq_len
    if tokens_per_layer is None:
        if pcfg.mode == "topk_prog":
            from vit_pruning_tpu_torch.configs import schedule_live

            sched = pcfg.keep_schedule or tuple(
                [pcfg.top_k] + [0] * (config.num_layers - 1))
            extra = prefix_len(config) - 1  # the registers beside CLS
            tokens_per_layer = [t + extra for t in schedule_live(sched, config.num_patches)]
        elif pcfg.mode in ("topk", "random"):
            tokens_per_layer = [pcfg.top_k + prefix_len(config)] * config.num_layers
        else:
            tokens_per_layer = [s] * config.num_layers

    patch = 2 * config.num_patches * config.patch_dim * config.hidden_size
    total = patch + _head_flops(config)
    pf = _predictor_flops(config, pcfg)
    for t in tokens_per_layer:
        total += _layer_flops(config, t) + pf
    return total
