"""Serving entry point: raw uint8 images -> logits.

Mirrors vit_pruning_tpu/serving.py: uint8 pixels go to the device (4x fewer
bytes than float32), are normalised there in float32, cast to the weight
dtype, patch-projected (on the card all of it, with the CLS and register
rows, in one launch of kernel B8a reading the image), and then run through
the progressive top-k forward, in float or, with quant='int8', through int8
weight products (kernel B4).

`export_serving` stages the whole uint8 -> logits program out with
torch.export, the kernels included as their registered operators (vpt::*,
ops/cuda/library.py), as the JAX package stages its program out with
jax.export, Pallas kernels included as tpu_custom_call; `load_exported`
reloads it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
from vit_pruning_tpu_torch.data.preprocess import VIT_MEAN, VIT_STD
from vit_pruning_tpu_torch.models.pruned_vit import progressive_topk_forward
from vit_pruning_tpu_torch.models.vit import with_registers
from vit_pruning_tpu_torch.ops.cuda.embed import embed_image_u8
from vit_pruning_tpu_torch.ops.dispatch import kernels_enabled, launch_kernel_for
from vit_pruning_tpu_torch.ops.patch_embed import patch_embed
from vit_pruning_tpu_torch.utils.profiling import span


def _require_u8(pixels: torch.Tensor, who: str):
    if pixels.dtype != torch.uint8:
        raise ValueError(f"{who} expects uint8 pixels, got {pixels.dtype}")


def embed_from_u8(
    pixels_u8: torch.Tensor, embed_params: dict, config: ViTConfig, impl: str = "auto"
) -> torch.Tensor:
    """uint8 [B, C, H, W] -> embeddings [B, S, D]: normalise, patch
    projection, position add, CLS, and the config's registers after CLS (no
    position add). The serving embed.

    impl 'auto' with kernels on (ops/dispatch.py: a CUDA tensor in mode
    'auto', a CUDA or meta tensor in mode 'kernel') runs the whole of it as
    one launch of kernel B8a reading the image
    (ops/cuda/embed.py::embed_image_u8, the operator
    vpt::fused_image_embed_u8): the normalisation folded into the product's
    input, b and the position added in f32, one cast, the sequence written
    in place. Otherwise (mode 'eager', CPU tensors in mode 'auto', impl
    'matmul' or 'conv') the plain route, as the JAX package's XLA embed:
    (x / 255 - mean) / std in f32, cast to the weights' dtype, the patch
    projection (ops/patch_embed.py `impl`), + pos, the CLS row and the
    registers concatenated."""
    _require_u8(pixels_u8, "embed_from_u8")
    with span("embed"):
        if impl == "auto" and kernels_enabled() and launch_kernel_for(pixels_u8):
            return embed_image_u8(pixels_u8, embed_params, config)
        w_dtype = embed_params["patch"]["w"].dtype
        x = (pixels_u8.float() / 255.0 - VIT_MEAN) / VIT_STD
        y = patch_embed(x.to(w_dtype), embed_params["patch"], config.patch_size, impl=impl)
        pos = embed_params["pos"]
        y = y + pos[:, 1:]
        cls = (embed_params["cls"] + pos[:, :1]).to(y.dtype).expand(y.shape[0], 1, y.shape[-1])
        return with_registers(torch.cat([cls, y], dim=1), embed_params, config)


def serving_forward(
    params: dict,
    pixels_u8: torch.Tensor,
    config: ViTConfig,
    pcfg: PruneConfig,
    logits_only: bool = True,
    quant: Optional[str] = None,
) -> dict:
    """pixels_u8 [B, C, H, W] uint8 -> the progressive forward's output dict
    (logits, keep_masks, scores; + cls/last_hidden when logits_only=False).
    quant: 'none', 'int8' or None (read the dispatch switch). The call is
    one `serve` span (utils/profiling.py), its stages spans inside it."""
    _require_u8(pixels_u8, "serving_forward")
    with span("serve"):
        x0 = embed_from_u8(pixels_u8, params["backbone"]["embed"], config)
        return progressive_topk_forward(params, None, config, pcfg, x0=x0,
                                        logits_only=logits_only, quant=quant)


class _Serving(torch.nn.Module):
    """fwd(params, pixels_u8) -> serving_forward's logits: the module
    torch.export traces (the params pytree and the pixels are its inputs)."""

    def __init__(self, config: ViTConfig, pcfg: PruneConfig, quant: str):
        super().__init__()
        self.config, self.pcfg, self.quant = config, pcfg, quant

    def forward(self, params: dict, pixels_u8: torch.Tensor) -> torch.Tensor:
        return serving_forward(params, pixels_u8, self.config, self.pcfg, logits_only=True,
                               quant=self.quant)["logits"]


def export_serving(
    params: dict,
    config: ViTConfig,
    pcfg: PruneConfig,
    batch_size: int,
    path: Optional[str] = None,
    quant: str = "none",
):
    """Stage the serving forward out as a torch.export program.

    The uint8 [batch_size, C, H, W] -> logits program (embed, progressive
    compaction, the CLS-only last layer) is traced once, at a static batch
    and config.image_size, with the params pytree as an input beside the
    pixels, as the JAX package's export takes them: the program holds no
    weights, nor keeps the trace's example inputs. The kernel mode
    (ops/dispatch.py) read during the trace picks the route, as use_pallas
    does in the JAX package: with CUDA params in modes 'auto' / 'kernel'
    (or meta params in mode 'kernel': a trace without a card) the program
    calls the kernels as vpt:: operators (the embed once, as B8a on the
    image; B1 for L - 1 layers and B2 once in float; B4 for L - 1 and the
    float B2 under int8); with CPU params in mode 'auto' it holds their
    plain versions.

    Returns the ExportedProgram; with `path`, also writes it there
    (torch.export.save)."""
    side = config.image_size
    # on the params' device (meta params: meta pixels)
    pixels = params["backbone"]["head"]["w"].new_zeros(
        (batch_size, config.num_channels, side, side), dtype=torch.uint8)
    program = torch.export.export(_Serving(config, pcfg, quant), (params, pixels))
    program.example_inputs = None  # the trace's params: not part of the program
    if path is not None:
        torch.export.save(program, path)
    return program


def load_exported(path: str) -> Callable:
    """Reload an `export_serving` program: returns f(params, pixels_u8) ->
    logits. The call checks the inputs against the export (a wrong batch or
    dtype raises). The kernel operators are registered first, so that the
    program's vpt:: calls resolve."""
    from vit_pruning_tpu_torch.ops.cuda.library import load_ops

    load_ops()
    return torch.export.load(path).module()
