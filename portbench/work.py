"""The yardstick's arithmetic: an H100's peaks, the least time of a piece of
work, and the operations and bytes of the served model and of its kernels.

Frozen copies, so that a change to the program cannot move the yardstick:

  * the peaks and `bound` from chip_smoke.py (PEAK_* at :283-285, `bound`
    and `layer_work` at :4168-4178, `cls_work` at :4201, `bound_int8` at
    :4251), in seconds here where chip_smoke.py works in milliseconds;
  * `model_flops` from vit_pruning_tpu_torch/utils/flops.py::pruned_vit_flops,
    corrected for the served path: the last layer is counted as kernel B2
    computes it (K and V over every live token, the rest over the CLS row
    alone), and the predictor only at the layers where tokens drop.

A product of [m, k] by [k, n] counts 2 m k n operations. Bytes count each
input read once and each output written once.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_HBM_BYTES = 3.35e12


def bound(flops: float, nbytes: float) -> float:
    """The least seconds the card could take: operations at the bf16 peak or
    bytes at the memory peak, whichever is longer."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def bound_int8(int8_ops: float, bf16_flops: float, nbytes: float) -> float:
    """int8 products at the int8 peak plus the rest at the bf16 peak, against
    the bytes."""
    return max(int8_ops / PEAK_INT8_OPS + bf16_flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def products(m: dict, rows: float) -> float:
    """The four weight products of a layer (QKV, O, fc1, fc2) over `rows`."""
    d, kw, mlp = m["hidden"], m["attn_width"], m["mlp"]
    return 2.0 * rows * (3 * d * kw + kw * d + 2 * d * mlp)


def attention(m: dict, pairs: float) -> float:
    """QK^T and PV over `pairs` = sum over images and heads of queries x keys."""
    return 4.0 * pairs * m["head_dim"]


def layer_flops(m: dict, b: int, s: int) -> float:
    """A whole layer (kernel B1 / B4) on [b, s] tokens."""
    return products(m, b * s) + attention(m, b * m["heads"] * s * s)


def layer_weight_bytes(m: dict, weight_bytes: int) -> float:
    """One layer's weight matrices at `weight_bytes` a value, plus its biases
    and layer norms in the serving dtype (2 bytes)."""
    d, kw, mlp = m["hidden"], m["attn_width"], m["mlp"]
    mats = 4 * d * kw + 2 * d * mlp
    return mats * weight_bytes + 2 * (3 * kw + d + mlp + d + 4 * d)


def cls_flops(m: dict, b: int, s: int) -> float:
    """Kernel B2: K and V over all b*s rows; q, O, fc1, fc2 and the
    classifier on the b CLS rows; QK^T and PV of the CLS query."""
    d, kw, mlp = m["hidden"], m["attn_width"], m["mlp"]
    return (2.0 * b * s * d * 2 * kw + 2.0 * b * (d * kw + kw * d + 2 * d * mlp + d * m["labels"])
            + 4.0 * b * m["heads"] * s * m["head_dim"])


def b1_bound(m: dict, b: int, s: int, act_bytes: int = 2) -> float:
    nbytes = 2 * b * s * m["hidden"] * act_bytes + layer_weight_bytes(m, 2)
    return bound(layer_flops(m, b, s), nbytes)


def b4_bound(m: dict, b: int, s: int, act_bytes: int = 2) -> float:
    """int8 weights (1 byte) with f32 column scales."""
    nbytes = (2 * b * s * m["hidden"] * act_bytes + layer_weight_bytes(m, 1)
              + 4 * (3 * m["attn_width"] + m["hidden"] + m["mlp"] + m["hidden"]))
    return bound_int8(products(m, b * s), attention(m, b * m["heads"] * s * s), nbytes)


def b2_bound(m: dict, b: int, s: int, act_bytes: int = 2) -> float:
    d = m["hidden"]
    nbytes = (b * s * d * act_bytes + b * m["labels"] * act_bytes + layer_weight_bytes(m, 2)
              + 2 * (2 * d + d * m["labels"] + m["labels"]))
    return bound(cls_flops(m, b, s), nbytes)


def schedule(m: dict, keep_fraction) -> list:
    """Patches kept after each layer's selection, 0 where no drop happens:
    keep_fraction of the patches kept before layer 0, or no drop at all."""
    if keep_fraction is None:
        return [0] * m["layers"]
    return [round(m["patches"] * keep_fraction)] + [0] * (m["layers"] - 1)


def live_tokens(m: dict, sched: list) -> tuple:
    """(tokens through each layer, the `prefix` tokens (CLS, registers)
    included; the layers where tokens drop, with the tokens before the drop)."""
    p = m["prefix"]
    cur, live, drops = m["patches"] + p, [], []
    for i, k in enumerate(sched):
        if k and k < cur - p:
            drops.append((i, cur))
            cur = k + p
        live.append(cur)
    return live, drops


def model_flops(m: dict, sched: list) -> float:
    """Operations per image of the served forward (uint8 pixels -> logits)."""
    live, drops = live_tokens(m, sched)
    d, h = m["hidden"], m["predictor_hidden"]
    total = 2.0 * m["patches"] * m["patch_dim"] * d + 2.0 * d * m["labels"]
    for t in live[:-1]:
        total += layer_flops(m, 1, t)
    total += cls_flops(m, 1, live[-1]) - 2.0 * d * m["labels"]
    for _, cur in drops:  # the predictor, MLP([CLS ⊕ token]) -> 1, over the live patches
        total += 2.0 * (cur - m["prefix"]) * (2 * d * h + h)
    return total
