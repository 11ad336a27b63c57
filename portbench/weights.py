"""The benchmark's inputs, made on the device from the seed: the model's
weights and the pool of uint8 image batches.

The weights follow the rule of chip_smoke.py::vit_h_params (:433) and the
init it copies (vit_pruning_tpu_torch/models/vit.py::init_vit_params):
the patch projection, the classifier and the CLS and position embeddings
trunc-normal on [-2, 2] times 0.02; the predictor's matrices times
PREDICTOR_GAIN scaled by sqrt(384 / D) (chip_smoke.py:269 and :2420), so
that its scores neither sit at 0.5 nor saturate. Two changes:

  * the layers' matrices (q, k, v, o, fc1, fc2) are trunc-normal times
    1 / sqrt(fan-in), where 0.02 leaves each layer's update a small share of
    the residual stream, so that the logits hardly depend on the layers and
    the output check could not tell their arithmetic apart;
  * biases are 0.1 N(0, 1), layer-norm gains 1 + 0.1 N(0, 1) and their
    shifts 0.1 N(0, 1), where the init leaves them 0 and 1, which would hide
    a bias or gain dropped on either side of the comparison
    (chip_smoke.py::perturbed_layer's reason).

Everything is drawn on the card from one generator in two large calls,
then cast to the serving dtype.

The tree is the program's parameter layout (vit_pruning_tpu_torch/models/
vit.py's module docstring): linear weights [in, out], every layer leaf
stacked on a leading [L] axis, the cls_mlp predictor's two layers 'l0'
[2D, h] and 'l1' [h, 1] per layer.
"""

from __future__ import annotations

import math

import torch

PREDICTOR_GAIN = 10.0
BIAS_STD = 0.1


def _spec(m: dict) -> list:
    """(path, shape, kind) of every leaf, in drawing order. kind: 'w' a weight
    (trunc-normal 0.02), 'lw' a layer's matrix (trunc-normal / sqrt(fan-in)),
    'pw' a predictor weight, 'b' a bias or shift, 'g' a layer-norm gain."""
    d, mlp, L, s = m["hidden"], m["mlp"], m["layers"], m["patches"] + 1
    out = [(("backbone", "embed", "patch", "w"), (m["patch_dim"], d), "w"),
           (("backbone", "embed", "patch", "b"), (d,), "b"),
           (("backbone", "embed", "cls"), (1, 1, d), "w"),
           (("backbone", "embed", "pos"), (1, s, d), "w")]
    lay = ("backbone", "layers")
    for ln in ("ln1", "ln2"):
        out += [(lay + (ln, "g"), (L, d), "g"), (lay + (ln, "b"), (L, d), "b")]
    for name in "qkvo":
        out += [(lay + ("attn", name, "w"), (L, d, d), "lw"),
                (lay + ("attn", name, "b"), (L, d), "b")]
    out += [(lay + ("mlp", "fc1", "w"), (L, d, mlp), "lw"),
            (lay + ("mlp", "fc1", "b"), (L, mlp), "b"),
            (lay + ("mlp", "fc2", "w"), (L, mlp, d), "lw"),
            (lay + ("mlp", "fc2", "b"), (L, d), "b"),
            (("backbone", "ln_f", "g"), (d,), "g"), (("backbone", "ln_f", "b"), (d,), "b"),
            (("backbone", "head", "w"), (d, m["labels"]), "w"),
            (("backbone", "head", "b"), (m["labels"],), "b")]
    if m["predictor"] == "cls_mlp":
        h = m["predictor_hidden"]
        pre = ("predictor", "mlp")
        out += [(pre + ("l0", "w"), (L, 2 * d, h), "pw"), (pre + ("l0", "b"), (L, h), "b"),
                (pre + ("l1", "w"), (L, h, 1), "pw"), (pre + ("l1", "b"), (L, 1), "b")]
    elif m["predictor"] != "none":
        raise ValueError(f"no weight rule for predictor {m['predictor']!r}")
    return out


def make_params(m: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The model's weights from `seed`, on `device`, in `dtype`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    spec = _spec(m)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    trunc = [n for n, (_, _, kind) in zip(sizes, spec) if kind in ("w", "pw", "lw")]
    normal = [n for n, (_, _, kind) in zip(sizes, spec) if kind in ("b", "g")]
    t_flat = torch.empty(sum(trunc), device=device)
    torch.nn.init.trunc_normal_(t_flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    n_flat = torch.randn(sum(normal), device=device, generator=gen)
    gain = PREDICTOR_GAIN * math.sqrt(384 / m["hidden"])
    params: dict = {"predictor": None}
    t_off = n_off = 0
    for (path, shape, kind), n in zip(spec, sizes):
        if kind in ("w", "pw", "lw"):
            std = {"w": 0.02, "pw": 0.02 * gain, "lw": shape[-2] ** -0.5}[kind]
            v = t_flat[t_off:t_off + n] * std
            t_off += n
        else:
            v = n_flat[n_off:n_off + n] * BIAS_STD + (1.0 if kind == "g" else 0.0)
            n_off += n
        node = params
        for key in path[:-1]:
            if node.get(key) is None:
                node[key] = {}
            node = node[key]
        node[path[-1]] = v.view(shape).to(dtype)
    return params


def make_pool(m: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """[pool, batch, C, H, W] uint8 images from `seed`, uniform over 0..255,
    from a generator of their own (so the weights' draw does not move them)."""
    gen = torch.Generator(device=device).manual_seed(seed ^ 0x5EED)
    shape = (traffic["pool"], traffic["batch"], m["channels"], m["image"], m["image"])
    return torch.randint(0, 256, shape, generator=gen, device=device, dtype=torch.uint8)
