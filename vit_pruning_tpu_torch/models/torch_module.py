"""torch.nn.Module adapter over the functional core.

Mirrors vit_pruning_tpu/models/flax_module.py, the JAX package's linen
adapter. The port's native surface is functional (explicit params +
`pruned_vit_forward`); this module is for users who put the pruned ViT
inside a larger PyTorch model, hand `model.parameters()` to an optimizer,
save and load it with `state_dict()`, or move and cast it with `.to()`.

The param tree is held one to one under the child `model`, as the linen
adapter holds it under `variables['params']['model']`: the JAX path
`params/model/backbone/layers/attn/q/w` is the state_dict key
`model.backbone.layers.attn.q.w`. Every float leaf is an `nn.Parameter`
(stacked [L, ...] layers stay stacked); `None` subtrees (no predictor) and
empty ones are recorded and come back as they were. `param_tree()` returns
the nested dict of the module's own Parameters, not copies, so every
functional utility applies unchanged: `train/freeze.py::masked_adam` and
`freeze_mask`, `ops/structured.py`, `parallel/steps.py`, and
`models/convert.py::params_to_numpy` back to a JAX tree.

forward() dispatches as the linen adapter does and returns the functional
core's dict unchanged. `train` is an argument, as there: the module's own
`self.training` flag (True after construction) is not read. The quant mode
is read from the dispatch switch (`quant_mode('int8')`).

Kernels: on the card the forward makes the functional forward's launches
(B1 on every layer, B3 in the budget-bounded re-decide modes, B4 under
int8, B5 where models/vit.py::encoder_route fuses). The Parameters require
grad, and kernels B2-B4 have no backward (nor have their TPU
counterparts): serve under `torch.inference_mode()` (or `torch.no_grad()`),
as any PyTorch model; outside it the re-decide and int8 modes raise.
Training (`train=True`) runs B1 and B5 under their autograd Functions
(ops/cuda/layer.py::RecomputedBackward), which carry the gradients to the
Parameters.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
from vit_pruning_tpu_torch.models.convert import check_device, params_from_jax, tree_to
from vit_pruning_tpu_torch.models.pruned_vit import (
    init_pruned_vit_params,
    progressive_topk_forward,
    pruned_vit_forward,
)


class _Node(nn.Module):
    """One dict of the param tree: float leaves as Parameters, other leaves
    as buffers, sub-dicts as child nodes; the keys in the dict's order,
    None entries among them."""

    def __init__(self, tree: dict):
        super().__init__()
        self.tree_keys = tuple(tree)
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, _Node(v))
            elif v is None:
                continue
            elif v.is_floating_point():
                self.register_parameter(k, nn.Parameter(v))
            else:
                self.register_buffer(k, v)

    def tree(self) -> dict:
        out = {}
        for k in self.tree_keys:
            if k in self._modules:
                out[k] = self._modules[k].tree()
            elif k in self._parameters:
                out[k] = self._parameters[k]
            else:
                out[k] = self._buffers.get(k)
        return out


class PrunedViT(nn.Module):
    """The pruned ViT as a torch.nn.Module over the functional core.

    params: a tensor tree of the port (init_pruned_vit_params' layout),
    moved to `device` and cast to `dtype` (models/convert.py::tree_to:
    integer leaves keep theirs); the module holds its tensors where no move
    or cast is needed. Without it the tree is init_pruned_vit_params(config,
    prune_config, generator (seed 0 when None), device, dtype). The device
    is the card unless the caller asks for the CPU; without a card the
    default raises.
    """

    def __init__(
        self,
        config: ViTConfig,
        prune_config: PruneConfig,
        *,
        params: Optional[dict] = None,
        generator: Optional[torch.Generator] = None,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.config, self.prune_config = config, prune_config
        device = check_device(device)
        if params is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            params = init_pruned_vit_params(config, prune_config, generator, device, dtype)
        else:
            params = tree_to(params, device, dtype)
        self.model = _Node(params)

    @classmethod
    def from_jax(cls, tree, config: ViTConfig, prune_config: PruneConfig, device="cuda",
                 dtype: torch.dtype = torch.float32) -> "PrunedViT":
        """The module over a JAX `variables['params']['model']` tree (numpy or
        numpy-convertible leaves), carried across by params_from_jax."""
        return cls(config, prune_config, params=params_from_jax(tree, device, dtype),
                   device=device, dtype=dtype)

    def param_tree(self) -> dict:
        """The param tree of the module's own Parameters (None where the tree
        has None), as the functional core and its utilities take it."""
        return self.model.tree()

    def forward(self, pixel_values: torch.Tensor, train: bool = False,
                compute_oracle: bool = False,
                generator: Optional[torch.Generator] = None) -> dict:
        """The functional core's output dict ('logits', 'keep_masks', 'scores',
        'last_hidden', 'cls', optional 'aux'). Mode 'topk_prog' outside
        training and the oracle instrumentation runs
        progressive_topk_forward; everything else pruned_vit_forward, whose
        mode 'random' draws from `generator`."""
        tree = self.param_tree()
        if self.prune_config.mode == "topk_prog" and not (train or compute_oracle):
            return progressive_topk_forward(tree, pixel_values, self.config, self.prune_config)
        return pruned_vit_forward(tree, pixel_values, self.config, self.prune_config,
                                  train=train, compute_oracle=compute_oracle,
                                  generator=generator)
