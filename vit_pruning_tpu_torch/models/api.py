"""Drop-in style class API mirroring the reference's ModifiedViTModel.

Mirrors vit_pruning_tpu/models/api.py on top of the functional core:

    model = ModifiedViTModel(config, sim_threshold, mlp_threshold, avg_threshold)
    out = model(pixel_values, compute_cosine=...)
    out.logits, out.boolean_masks
    model.mlp_train() / model.vit_train() / ...   # freeze policies

State is the param tree in `.params`; per-layer losses are explicit outputs
(`out.layer_losses`). The serving quantization is read from the dispatch
switch at every call, as the JAX wrapper re-reads it.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Optional

import torch

from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
from vit_pruning_tpu_torch.models.convert import torch_state_dict_to_params
from vit_pruning_tpu_torch.models.pruned_vit import init_pruned_vit_params, pruned_vit_forward
from vit_pruning_tpu_torch.ops.dispatch import serving_quant
from vit_pruning_tpu_torch.train.freeze import POLICIES


class ModifiedViTModel:
    def __init__(
        self,
        config: ViTConfig,
        sim_threshold: float = 0.9,
        mlp_threshold: float = 0.5,
        avg_threshold: float = 0.0,
        prune_config: Optional[PruneConfig] = None,
        params: Optional[dict] = None,
        seed: int = 0,
        device="cuda",
    ):
        self.config = config
        self.prune_config = (prune_config or PruneConfig()).replace(
            sim_threshold=sim_threshold, mlp_threshold=mlp_threshold,
            avg_threshold=avg_threshold)
        self.device = device
        self.params = params or init_pruned_vit_params(
            config, self.prune_config, torch.Generator().manual_seed(seed), device)
        self.policy = "vit_mlp_train"
        self._training = False

    def load_torch_state_dict(self, state_dict) -> "ModifiedViTModel":
        """The strict=False load with the 'vit.' prefix surgery: the backbone
        replaced (in the backbone's dtype), the predictor heads kept."""
        dtype = self.params["backbone"]["head"]["w"].dtype
        self.params["backbone"] = torch_state_dict_to_params(state_dict, self.config,
                                                             device=self.device, dtype=dtype)
        return self

    def __call__(self, pixel_values, compute_cosine: bool = False,
                 output_mask: Optional[bool] = None,
                 generator: Optional[torch.Generator] = None):
        if generator is None:
            generator = torch.Generator(device=pixel_values.device).manual_seed(0)
        out = pruned_vit_forward(
            self.params, pixel_values, self.config, self.prune_config, train=self._training,
            compute_oracle=compute_cosine, generator=generator, quant=serving_quant())
        res = SimpleNamespace(
            logits=out["logits"],
            boolean_masks=out["keep_masks"],  # [L, B, S], True = processed
            scores=out["scores"],
            last_hidden_state=out["last_hidden"],
        )
        if "aux" in out:
            res.layer_losses = out["aux"]["pred_loss"]
            res.mlp_confusion_matrix = out["aux"]["confusion"]
            res.similarity = out["aux"]["similarity"]
        return res

    def train(self):
        self._training = True
        return self

    def eval(self):
        self._training = False
        return self

    def _set_policy(self, p):
        if p not in POLICIES:
            raise ValueError(f"policy {p!r} not in {POLICIES}")
        self.policy = p
        return self

    def vit_mlp_train(self):
        return self._set_policy("vit_mlp_train")

    def vit_train(self):
        return self._set_policy("vit_train")

    def mlp_train(self):
        return self._set_policy("mlp_train")

    def classifier_train(self):
        return self._set_policy("classifier_train")

    def classifier_mlp_train(self):
        return self._set_policy("classifier_mlp_train")
