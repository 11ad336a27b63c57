"""The model family `dinov2`: DINOv2 with registers (facebook/dinov2-with-
registers-giant; DINOv2, arXiv:2304.07193; "Vision Transformers Need
Registers", arXiv:2309.16588) with DINOv2's linear-evaluation head and the
system's token predictor. The interface is families/vit.py's docstring's.

The model, from its published equations (the program's plain reference,
vit_pruning_tpu_torch/reference/dinov2.py, of which `forward` below is the
benchmark's own frozen copy, with reference.py's levels of the weight
products so that control.py's control runs):

  tokens  CLS + pos_0, then the registers with no position embedding, then
          the patches' projections + pos_1..N: S = 1 + R + N;
  layer   h = x + g1 * Attn(LN1(x)),
          y = h + g2 * (W_out(silu(u1) * u2) + b_out),
          [u1 | u2] = W_in LN2(h) + b_in, split in checkpoint order;
  head    LN_f, then Linear(2 D -> labels) on CLS ⊕ the mean of the patch
          tokens, the registers left out (with tokens dropped: the kept
          patches, the serving system's departure).

The configuration's keys this family reads: `hidden_size`,
`num_hidden_layers`, `num_attention_heads`, `mlp_ratio` (the SwiGLU width
is (int(ratio D 2 / 3) + 7) // 8 * 8), `use_swiglu_ffn` (true),
`num_register_tokens`, `image_size`, `patch_size`, `num_channels`,
`layer_norm_eps`, `qkv_bias`, `num_labels`, `predictor`, `image_mean` and
`image_std`. `b1_bound` (read by metrics/b1_swiglu_roofline.py) counts the
gated fc1 2 M wide.

`prefix` is 1 + R: CLS and the registers are never scored or dropped. The
weights (`make_params`) are the program's tree in checkpoint order, drawn
by portbench/weights.py's rule: matrices of the layers trunc-normal times
1 / sqrt(fan-in), the patch projection, the head, CLS, the registers and
the positions trunc-normal times 0.02, biases 0.1 N(0, 1), layer-norm gains
1 + 0.1 N(0, 1), the predictor's weights at weights.py's gain, and
LayerScale's gains per channel, 0.5 + 0.25 trunc-normal: a uniform gain
would let a program that drops a gain or swaps the two pass. The program's
set-up (`program`) interleaves fc1's columns once, as a deployment does at
load (vit_pruning_tpu_torch/ops/swiglu.py::with_gated_fc1).
"""

from __future__ import annotations

import math

import torch

from portbench import reference, work
from portbench.weights import BIAS_STD, PREDICTOR_GAIN


def swiglu_hidden(d: int, ratio: float) -> int:
    """DINOv2's SwiGLU width: 2/3 of ratio x D, rounded up to a multiple of 8."""
    return (int(ratio * d * 2 / 3) + 7) // 8 * 8


def dims(cfg: dict) -> dict:
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    if d % heads:
        raise ValueError(f"hidden_size {d} is not a multiple of num_attention_heads {heads}")
    if cfg["image_size"] % cfg["patch_size"]:
        raise ValueError("image_size is not a multiple of patch_size")
    if not cfg.get("use_swiglu_ffn") or not cfg.get("qkv_bias", True):
        raise ValueError("the dinov2 family is DINOv2's SwiGLU block with q/k/v biases")
    grid = cfg["image_size"] // cfg["patch_size"]
    r = cfg["num_register_tokens"]
    return {
        "hidden": d, "heads": heads, "head_dim": d // heads,
        "mlp": swiglu_hidden(d, cfg["mlp_ratio"]), "layers": cfg["num_hidden_layers"],
        "labels": cfg["num_labels"], "eps": cfg["layer_norm_eps"],
        "image": cfg["image_size"], "patch": cfg["patch_size"], "channels": cfg["num_channels"],
        "patches": grid * grid, "patch_dim": cfg["num_channels"] * cfg["patch_size"] ** 2,
        "predictor": cfg["predictor"]["kind"], "predictor_hidden": cfg["predictor"]["hidden"],
        "image_mean": cfg["image_mean"], "image_std": cfg["image_std"],
        "registers": r, "prefix": 1 + r,
    }


def _spec(m: dict) -> list:
    """(path, shape, kind) of every leaf, in drawing order. kind: 'w' trunc-
    normal 0.02, 'lw' a layer's matrix (trunc-normal / sqrt(fan-in)), 'pw' a
    predictor weight, 'ls' a LayerScale gain, 'b' a bias or shift, 'g' a
    layer-norm gain."""
    d, mlp, L = m["hidden"], m["mlp"], m["layers"]
    emb, lay = ("backbone", "embed"), ("backbone", "layers")
    out = [(emb + ("patch", "w"), (m["patch_dim"], d), "w"), (emb + ("patch", "b"), (d,), "b"),
           (emb + ("cls",), (1, 1, d), "w"), (emb + ("registers",), (1, m["registers"], d), "w"),
           (emb + ("pos",), (1, m["patches"] + 1, d), "w")]
    for ln in ("ln1", "ln2"):
        out += [(lay + (ln, "g"), (L, d), "g"), (lay + (ln, "b"), (L, d), "b")]
    for name in "qkvo":
        out += [(lay + ("attn", name, "w"), (L, d, d), "lw"),
                (lay + ("attn", name, "b"), (L, d), "b")]
    out += [(lay + ("mlp", "fc1", "w"), (L, d, 2 * mlp), "lw"),
            (lay + ("mlp", "fc1", "b"), (L, 2 * mlp), "b"),
            (lay + ("mlp", "fc2", "w"), (L, mlp, d), "lw"),
            (lay + ("mlp", "fc2", "b"), (L, d), "b"),
            (lay + ("ls1",), (L, d), "ls"), (lay + ("ls2",), (L, d), "ls"),
            (("backbone", "ln_f", "g"), (d,), "g"), (("backbone", "ln_f", "b"), (d,), "b"),
            (("backbone", "head", "w"), (2 * d, m["labels"]), "w"),
            (("backbone", "head", "b"), (m["labels"],), "b")]
    h, pre = m["predictor_hidden"], ("predictor", "mlp")
    out += [(pre + ("l0", "w"), (L, 2 * d, h), "pw"), (pre + ("l0", "b"), (L, h), "b"),
            (pre + ("l1", "w"), (L, h, 1), "pw"), (pre + ("l1", "b"), (L, 1), "b")]
    return out


TRUNC = ("w", "pw", "lw", "ls")


def make_params(m: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The model's weights from `seed`, on `device`, in `dtype`: one
    generator, one trunc-normal and one normal draw, as weights.py."""
    if m["predictor"] != "cls_mlp":
        raise ValueError(f"no weight rule for predictor {m['predictor']!r}")
    gen = torch.Generator(device=device).manual_seed(seed)
    spec = _spec(m)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    t_flat = torch.empty(sum(n for n, (_, _, k) in zip(sizes, spec) if k in TRUNC), device=device)
    torch.nn.init.trunc_normal_(t_flat, 0.0, 1.0, -2.0, 2.0, generator=gen)
    n_flat = torch.randn(sum(n for n, (_, _, k) in zip(sizes, spec) if k not in TRUNC),
                         device=device, generator=gen)
    gain = PREDICTOR_GAIN * math.sqrt(384 / m["hidden"])
    params: dict = {}
    t_off = n_off = 0
    for (path, shape, kind), n in zip(spec, sizes):
        if kind in TRUNC:
            v = t_flat[t_off:t_off + n]
            t_off += n
            v = 0.5 + 0.25 * v if kind == "ls" else v * {
                "w": 0.02, "pw": 0.02 * gain, "lw": shape[-2] ** -0.5}[kind]
        else:
            v = n_flat[n_off:n_off + n] * BIAS_STD + (1.0 if kind == "g" else 0.0)
            n_off += n
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v.view(shape).to(dtype)
    return params


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _attention(h, attn, heads, products):
    b, s, _ = h.shape

    def split(t):
        return t.reshape(b, s, heads, -1).transpose(1, 2)
    q, k, v = (split(reference.linear(h, attn[n]["w"], attn[n]["b"], products)) for n in "qkv")
    p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1)
    ctx = (p @ v).transpose(1, 2).reshape(b, s, -1)
    return reference.linear(ctx, attn["o"]["w"], attn["o"]["b"], products)


def block(x: torch.Tensor, lp: dict, m: dict, products: str = "f32") -> torch.Tensor:
    """One DINOv2 layer on every row, fc1 in checkpoint order."""
    eps = m["eps"]
    mlp = lp["mlp"]
    a = _attention(reference.layer_norm(x, lp["ln1"]["g"], lp["ln1"]["b"], eps), lp["attn"],
                   m["heads"], products)
    h = x + lp["ls1"].float() * a
    u = reference.linear(reference.layer_norm(h, lp["ln2"]["g"], lp["ln2"]["b"], eps),
                         mlp["fc1"]["w"], mlp["fc1"]["b"], products)
    u1, u2 = u.chunk(2, dim=-1)
    y = reference.linear(u1 * torch.sigmoid(u1) * u2, mlp["fc2"]["w"], mlp["fc2"]["b"], products)
    return h + lp["ls2"].float() * y


def embed(pixels_u8: torch.Tensor, emb: dict, m: dict, products: str = "f32") -> torch.Tensor:
    x = reference.embed(pixels_u8, emb, m, products)  # CLS + pos_0, the patches + pos
    b, _, d = x.shape
    reg = emb["registers"].float().expand(b, -1, d)
    return torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)


def scores(x: torch.Tensor, pred: dict, i: int, p: int, products: str = "f32") -> torch.Tensor:
    """The cls_mlp predictor of layer i on the live patches: [B, cur - p]."""
    lp = _layer(pred["mlp"], i)
    t = x[:, p:]
    z = torch.cat([x[:, :1].expand(-1, t.shape[1], -1), t], dim=-1)
    hid = torch.relu(reference.linear(z, lp["l0"]["w"], lp["l0"]["b"], products))
    return torch.sigmoid(reference.linear(hid, lp["l1"]["w"], lp["l1"]["b"], products))[..., 0]


def forward(params: dict, pixels_u8: torch.Tensor, m: dict, sched: list,
            layers: str = "f32", other: str = "f32", follow=None) -> dict:
    """The served model on one block of images, in float32 with TF32 off.
    layers: the products of the L layers; other: the patch projection, the
    predictor and the head. follow: keep masks [L, B, prefix + patches] to
    follow at the drop layers."""
    bb, L, p = params["backbone"], m["layers"], m["prefix"]
    with reference.exact_f32():
        x = embed(pixels_u8, bb["embed"], m, other)
        b, s, _ = x.shape
        orig = torch.arange(s, device=x.device).expand(b, s)
        masks, all_scores = [], []
        cur = s
        for i in range(L):
            k = sched[i]
            sc = torch.full((b, s - p), float("-inf"), device=x.device)
            if k and k < cur - p:
                live = scores(x, params["predictor"], i, p, other)
                sc.scatter_(1, orig[:, p:] - p, live)
                if follow is None:
                    keep = torch.cat([torch.ones_like(live[:, :1], dtype=torch.bool).expand(-1, p),
                                      reference.top_k(live, k)], dim=1)
                else:
                    keep = torch.gather(follow[i], 1, orig)
                rank = (~keep).to(torch.int64) * cur + torch.arange(cur, device=x.device)
                idx = torch.sort(rank, dim=1).indices[:, :k + p]
                x = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
                orig, cur = torch.gather(orig, 1, idx), k + p
            all_scores.append(sc)
            masks.append(torch.zeros((b, s), dtype=torch.bool, device=x.device)
                         .scatter(1, orig, True))
            x = block(x, _layer(bb["layers"], i), m, layers)
        x = reference.layer_norm(x, bb["ln_f"]["g"], bb["ln_f"]["b"], m["eps"])
        logits = reference.linear(torch.cat([x[:, 0], x[:, p:].mean(dim=1)], dim=-1),
                                  bb["head"]["w"], bb["head"]["b"], other)
    return {"logits": logits, "keep_masks": torch.stack(masks), "scores": torch.stack(all_scores)}


def layer_products(m: dict) -> int:
    """The weights of a layer's products: QKV and O (4 D^2), the gated fc1
    (D x 2M) and fc2 (M x D)."""
    d, mlp = m["hidden"], m["mlp"]
    return 4 * d * d + 3 * d * mlp


def layer_flops(m: dict, b: int, s: int) -> float:
    """A whole layer on [b, s] tokens: the products and QK^T, PV."""
    return 2.0 * b * s * layer_products(m) + 4.0 * b * m["heads"] * s * s * m["head_dim"]


def b1_bound(m: dict, b: int, s: int, act_bytes: int = 2) -> float:
    """Kernel B1's least time on an H100 for one DINOv2 layer on [b, s]:
    the products (the gated fc1 2M wide) and the attention at the bf16
    peak, or the bytes (x in, the layer out, the weights, the biases, the
    two LayerScale gains, the layer norms, in bf16) at the memory peak."""
    d, mlp = m["hidden"], m["mlp"]
    nbytes = (2 * b * s * d * act_bytes + 2 * layer_products(m)
              + 2 * (3 * d + d + 2 * mlp + d) + 2 * 2 * d + 2 * 4 * d)
    return work.bound(layer_flops(m, b, s), nbytes)


def model_flops(m: dict, sched: list) -> float:
    """Operations per image of the served forward: the patch projection,
    every layer whole at its live tokens (the last one too: the pooled head
    reads every row), the predictor over the live patches where tokens
    drop, and the 2 D-wide head."""
    live, drops = work.live_tokens(m, sched)
    d, h = m["hidden"], m["predictor_hidden"]
    total = 2.0 * m["patches"] * m["patch_dim"] * d + 2.0 * 2 * d * m["labels"]
    total += sum(layer_flops(m, 1, t) for t in live)
    return total + sum(2.0 * (cur - m["prefix"]) * (2 * d * h + h) for _, cur in drops)


def program(cell: dict, params: dict, quant: str = None):
    """The timed entry: vit_pruning_tpu_torch.serving.serving_forward on the
    cell's model and traffic, in the program's default kernel mode, after
    the set-up a deployment runs once at load: fc1's columns interleaved
    for B1's gated epilogue. bf16 products alone (the program serves DINOv2
    without int8)."""
    from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig
    from vit_pruning_tpu_torch.ops.swiglu import with_gated_fc1
    from vit_pruning_tpu_torch.serving import serving_forward

    m, traffic = cell["model"], cell["traffic"]
    quant = traffic["quant"] if quant is None else quant
    if quant != "none":
        raise ValueError(f"the dinov2 family serves with quant 'none', not {quant!r}")
    vcfg = ViTConfig(image_size=m["image"], patch_size=m["patch"], num_channels=m["channels"],
                     hidden_size=m["hidden"], num_layers=m["layers"], num_heads=m["heads"],
                     mlp_dim=m["mlp"], num_labels=m["labels"], layernorm_eps=m["eps"],
                     mlp_kind="swiglu", layerscale=True, num_registers=m["registers"],
                     head_pool="cls_mean")
    sched = work.schedule(m, traffic["keep_fraction"])
    if traffic["keep_fraction"] is None:
        pcfg = PruneConfig(mode="topk_prog", keep_schedule=tuple(sched))
    else:
        pcfg = PruneConfig(mode="topk_prog", predictor=m["predictor"],
                           predictor_hidden=m["predictor_hidden"], top_k=sched[0])
    bb = params["backbone"]
    params = dict(params, backbone=dict(bb, layers=with_gated_fc1(bb["layers"])))

    def call(pixels):
        return serving_forward(params, pixels, vcfg, pcfg, logits_only=True, quant=quant)
    return call
