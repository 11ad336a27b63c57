"""vit_pruning_tpu_torch — the PyTorch/CUDA port of vit_pruning_tpu.

The JAX package stays the reference; this package mirrors its module names
so that each function has an obvious counterpart. It imports torch and never
jax. The serving path (patch embed -> progressive top-k compaction with the
cls_mlp predictor -> encoder -> CLS logits) runs through two CUDA C++ kernels
written for Hopper (ops/cuda/layer.py, csrc/layer.cu); everything else is
plain PyTorch.

Layout:
    configs    — re-exports the JAX package's pure-Python configs
    models     — ViT forward, cls_mlp predictor, progressive top-k forward,
                 weight bridge to and from the JAX param tree
    ops        — patch embed, attention, masking, structured pruning,
                 kernel dispatch, and the CUDA kernels' wrappers (ops/cuda)
    serving    — uint8 pixels -> logits
"""

__version__ = "0.1.0"

from vit_pruning_tpu_torch.configs import (  # noqa: F401
    PruneConfig,
    ViTConfig,
    deit_small,
    vit_tiny,
)
