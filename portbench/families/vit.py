"""The model family `vit`: the pre-LN ViT that vit_pruning_tpu_torch serves
(HF ViTModel with q/k/v biases and exact GELU, a linear classifier on the
CLS token), with the system's token predictor. A configuration file without
a `family` key is a `vit`.

A model family is a file `portbench/families/<name>.py` that
portbench/cells.py loads by path when a configuration names it
(`"family": "<name>"`). It defines five functions:

  dims(cfg) -> m
      The sizes, from the configuration file's keys. The harness reads
      `layers`, `patches`, `image`, `channels`, `labels`, `hidden`,
      `predictor`, `predictor_hidden`, `image_mean`, `image_std` and
      `prefix`: the number of leading tokens (CLS, registers) that are never
      scored and never dropped. Anything else is the family's own.
  make_params(m, seed, device, dtype) -> params
      The weights from the seed, made on `device` in `dtype`, in the layout
      the family's `program` takes.
  forward(params, pixels_u8, m, sched, layers="f32", other="f32", follow=None)
      The plain reference: float32 with TF32 off, importing nothing of the
      program. `layers` and `other` take portbench/reference.py's levels of
      the weight products ('f32', 'int8', 'w4a8', 'fp8'), so that
      portbench/control.py's control runs in every family. `follow`: keep
      masks [L, B, prefix + patches] to follow at the drop layers. Returns
      {'logits' [B, labels], 'keep_masks' [L, B, prefix + patches] bool,
      'scores' [L, B, patches]: the predictor's scores at the positions
      after the prefix, -inf where a layer scored nothing}.
  model_flops(m, sched) -> float
      Operations per image of the served forward, as the program computes
      it (step_mfu's numerator).
  program(cell, params, quant) -> call
      The timed entry: call(pixels_u8) -> {'logits', 'keep_masks',
      'scores'}. `quant` None means the traffic's. The program is imported
      here, inside the function, and nowhere else in the family.

`sched` is portbench/work.py's schedule: the patches kept after each
layer's selection, 0 where no drop happens.

This family delegates: its weights, reference and operation count are the
frozen copies in portbench/weights.py, reference.py and work.py.
"""

from portbench import reference, weights, work

make_params = weights.make_params
forward = reference.forward
model_flops = work.model_flops


def dims(cfg: dict) -> dict:
    """The sizes the harness, the reference and the yardstick read, from a
    configuration file's keys (the source's own names)."""
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    if d % heads:
        raise ValueError(f"hidden_size {d} is not a multiple of num_attention_heads {heads}")
    if cfg["image_size"] % cfg["patch_size"]:
        raise ValueError("image_size is not a multiple of patch_size")
    if cfg.get("hidden_act", "gelu") != "gelu" or not cfg.get("qkv_bias", True):
        raise ValueError("the served model is a pre-LN ViT with exact GELU and q/k/v biases")
    grid = cfg["image_size"] // cfg["patch_size"]
    pred = cfg.get("predictor") or {"kind": "none", "hidden": 0}
    return {
        "hidden": d, "heads": heads, "head_dim": d // heads, "attn_width": d,
        "mlp": cfg["intermediate_size"], "layers": cfg["num_hidden_layers"],
        "labels": cfg["num_labels"], "eps": cfg["layer_norm_eps"],
        "image": cfg["image_size"], "patch": cfg["patch_size"], "channels": cfg["num_channels"],
        "patches": grid * grid, "patch_dim": cfg["num_channels"] * cfg["patch_size"] ** 2,
        "predictor": pred["kind"], "predictor_hidden": pred["hidden"],
        "image_mean": cfg["image_mean"], "image_std": cfg["image_std"], "prefix": 1,
    }


def program(cell: dict, params: dict, quant: str = None):
    """The timed entry: vit_pruning_tpu_torch.serving.serving_forward on the
    cell's model and traffic, in the program's default kernel mode. Under
    int8 the layers' int8 weights are attached once here, at set-up, as a
    deployment quantizes once at load. Returns f(pixels_u8) -> outputs."""
    from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
    from vit_pruning_tpu_torch.ops.quant import attach_int8_weights
    from vit_pruning_tpu_torch.serving import serving_forward

    m, traffic = cell["model"], cell["traffic"]
    quant = traffic["quant"] if quant is None else quant
    vcfg = ViTConfig(image_size=m["image"], patch_size=m["patch"], num_channels=m["channels"],
                     hidden_size=m["hidden"], num_layers=m["layers"], num_heads=m["heads"],
                     mlp_dim=m["mlp"], num_labels=m["labels"], layernorm_eps=m["eps"])
    sched = work.schedule(m, traffic["keep_fraction"])
    if traffic["keep_fraction"] is None:  # nothing drops: no predictor runs
        pcfg = PruneConfig(mode="topk_prog", keep_schedule=tuple(sched))
    else:  # one drop before layer 0, the PruneConfig default schedule
        pcfg = PruneConfig(mode="topk_prog", predictor=m["predictor"],
                           predictor_hidden=m["predictor_hidden"], top_k=sched[0])
    if quant == "int8":
        bb = params["backbone"]
        params = dict(params, backbone=dict(bb, layers=attach_int8_weights(bb["layers"])))

    def call(pixels):
        return serving_forward(params, pixels, vcfg, pcfg, logits_only=True, quant=quant)
    return call
