"""vit_pruning_tpu_torch — the PyTorch/CUDA port of vit_pruning_tpu.

The JAX package stays the reference; this package mirrors its module names
so that each function has an obvious counterpart. It imports torch and never
jax, and nothing of the JAX package. Two serving paths are ported: the
progressive top-k compaction (serving.serving_forward ->
models/pruned_vit.py::progressive_topk_forward) and the re-decide modes
(models/pruned_vit.py::pruned_vit_forward: mask, topk, oracle, random, with
every predictor kind). Both serve in float or int8 (`quant='int8'`, or
`quant_mode('int8')` around the call). The dense model's whole inference
surface is ported too: models/vit.py::vit_forward with head_mask and
output_hidden_states, vit_layer with return_probs, ops/attention.py::mha,
the soft-mask and importance helpers of ops/structured.py, and the
whole-encoder route (`encoder_fusion(True)` or VIT_PRUNING_TPU_ENCODER=1),
for DeiT-S and ViT-H/14 alike. The fused patch embeddings `embed_u8` (uint8
pixels) and `embed_fused` (float pixels) are entry points of their own. All
of it runs through nine CUDA C++ kernels written for Hopper (B1-B7, B8a,
B8b in ops/cuda/, sources in csrc/); everything else is plain PyTorch.
Params are built on the card unless the caller asks for 'cpu'.

Layout:
    configs    — the port's own copy of the model and pruning configs
    data       — the image normalisation constants
    models     — ViT forward, every skip predictor, the re-decide and
                 progressive forwards, weight bridge to and from the JAX
                 param tree
    ops        — patch embed, attention, masking and compaction, structured
                 pruning, int8 quantization, kernel dispatch and the serving
                 quant switch, and the CUDA kernels' wrappers (ops/cuda)
    serving    — uint8 pixels -> logits
"""

__version__ = "0.1.0"

from vit_pruning_tpu_torch.configs import (  # noqa: F401
    PruneConfig,
    ViTConfig,
    deit_small,
    vit_huge,
    vit_tiny,
)
from vit_pruning_tpu_torch.ops.dispatch import (  # noqa: F401
    encoder_fusion,
    encoder_fusion_enabled,
    kernel_mode,
    quant_mode,
    serving_quant,
    set_encoder_fusion,
    set_kernel_mode,
    set_serving_quant,
)
from vit_pruning_tpu_torch.ops.cuda.embed import embed_fused, embed_u8  # noqa: F401
from vit_pruning_tpu_torch.ops.quant import quantize_layer_params  # noqa: F401
