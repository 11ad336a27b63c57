"""The plain reference of the served model: uint8 pixels -> logits, in plain
PyTorch and float32 with TF32 off. It imports nothing of the program.

The model is a pre-LN ViT (HF ViTModel + a linear classifier on the CLS
token): patch projection of the pixels normalised by the configuration's
mean and std, CLS and position embeddings, L layers of
LN -> multi-head attention -> residual -> LN -> Linear -> exact GELU ->
Linear -> residual, the final LN on CLS and the classifier. Progressive
token pruning (topk_prog): before a layer with a drop, a predictor
MLP([CLS ⊕ token]) -> sigmoid scores the live patches, and CLS with the k
highest-scoring patches goes on (ties to the lower position); dropped
tokens never return. Only the CLS row is needed after the last layer, so
the last layer's query, attention output and MLP run on that row alone (the
same numbers as running it on every row).

Weight products, chosen apart for the whole layers 0..L-2 (`layers`) and
for every other product (`other`: the patch projection, the predictor, the
CLS-only last layer and the classifier); everything between products stays
float32:
  'f32'   float32 operands;
  'int8'  symmetric per-column int8 weights (scale amax / 127) and
          symmetric per-row int8 activations (scale amax / 127), codes
          rounded half to even: the int8 serving scheme, for layers 0..L-2;
  'w4a8'  the same with 4-bit weights (scale amax / 7);
  'fp8'   both operands scaled by their amax (per row, per column) to
          float8 e4m3's range and rounded to it.
The reference of a bf16 cell is f32 / f32, of an int8 cell int8 / f32; the
controls one step below: fp8 / fp8 and w4a8 / fp8.

`forward` runs the model and chooses its own tokens, or follows a given set
of keep masks (the program's, when it judges the program) and returns its
own scores beside them.
"""

from __future__ import annotations

import contextlib
import math

import torch

WEIGHT_LEVELS = {"int8": 127, "w4a8": 7}
FP8_MAX = 448.0  # the largest float8 e4m3 value


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 inside the block."""
    cuda, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = cuda, cudnn


def _quant(t: torch.Tensor, levels: int, dim: int):
    """Symmetric quantization along `dim`'s amax: (codes as float, scale)."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / levels
    return torch.round(t / scale).clamp(-levels, levels), scale


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t scaled by its amax along `dim` to float8 e4m3's range, rounded to
    float8 e4m3 and scaled back."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, products: str = "f32"):
    """x [..., K] @ w [K, N] + b in float32, or with quantized operands."""
    w, b = w.float(), b.float()
    if products == "f32":
        return x @ w + b
    if products == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0) + b
    qw, sw = _quant(w, WEIGHT_LEVELS[products], 0)
    qx, sx = _quant(x, 127, -1)
    return (qx @ qw) * sx * sw + b


def layer_norm(x: torch.Tensor, g, b, eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * g.float() + b.float()


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, w = t.shape
    return t.reshape(b, s, heads, w // heads).transpose(1, 2)


def attend(q, k, v, heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v per head; q [B, Sq, W], k, v [B, S, W]."""
    q, k, v = (_heads(t, heads) for t in (q, k, v))
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    ctx = torch.softmax(logits, dim=-1) @ v
    b, h, s, hd = ctx.shape
    return ctx.transpose(1, 2).reshape(b, s, h * hd)


def _layer(lp: dict, i: int):
    """Layer i's leaves of the stacked tree."""
    def get(*path):
        node = lp
        for key in path:
            node = node[key]
        return node[i]
    return get


def block(x: torch.Tensor, get, m: dict, products: str = "f32") -> torch.Tensor:
    """One whole layer on every row."""
    eps, heads = m["eps"], m["heads"]
    h = layer_norm(x, get("ln1", "g"), get("ln1", "b"), eps)
    q, k, v = (linear(h, get("attn", n, "w"), get("attn", n, "b"), products) for n in "qkv")
    ctx = attend(q, k, v, heads)
    x = x + linear(ctx, get("attn", "o", "w"), get("attn", "o", "b"), products)
    h = layer_norm(x, get("ln2", "g"), get("ln2", "b"), eps)
    u = gelu(linear(h, get("mlp", "fc1", "w"), get("mlp", "fc1", "b"), products))
    return x + linear(u, get("mlp", "fc2", "w"), get("mlp", "fc2", "b"), products)


def cls_block(x: torch.Tensor, get, m: dict, products: str = "f32") -> torch.Tensor:
    """The last layer for the CLS row alone: K and V over every row."""
    eps, heads = m["eps"], m["heads"]

    def lin(t, *path):
        return linear(t, get(*path, "w"), get(*path, "b"), products)
    h = layer_norm(x, get("ln1", "g"), get("ln1", "b"), eps)
    q, k, v = lin(h[:, :1], "attn", "q"), lin(h, "attn", "k"), lin(h, "attn", "v")
    x1 = x[:, :1] + lin(attend(q, k, v, heads), "attn", "o")
    h = layer_norm(x1, get("ln2", "g"), get("ln2", "b"), eps)
    return (x1 + lin(gelu(lin(h, "mlp", "fc1")), "mlp", "fc2"))[:, 0]


def embed(pixels_u8: torch.Tensor, emb: dict, m: dict, products: str = "f32") -> torch.Tensor:
    b, c, hgt, wid = pixels_u8.shape
    p = m["patch"]
    x = (pixels_u8.float() / 255.0 - m["image_mean"]) / m["image_std"]
    x = x.reshape(b, c, hgt // p, p, wid // p, p).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, (hgt // p) * (wid // p), c * p * p)
    pos = emb["pos"].float()
    y = linear(x, emb["patch"]["w"], emb["patch"]["b"], products) + pos[:, 1:]
    cls = (emb["cls"].float() + pos[:, :1]).expand(b, 1, y.shape[-1])
    return torch.cat([cls, y], dim=1)


def scores(x: torch.Tensor, pred: dict, i: int, products: str = "f32") -> torch.Tensor:
    """The cls_mlp predictor of layer i on the live patches: [B, cur - 1]."""
    get = _layer(pred["mlp"], i)
    t = x[:, 1:]
    z = torch.cat([x[:, :1].expand(-1, t.shape[1], -1), t], dim=-1)
    hid = torch.relu(linear(z, get("l0", "w"), get("l0", "b"), products))
    return torch.sigmoid(linear(hid, get("l1", "w"), get("l1", "b"), products))[..., 0]


def top_k(s: torch.Tensor, k: int) -> torch.Tensor:
    """Mask of the k highest scores per row, ties to the lower index."""
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices[:, :k]
    return torch.zeros_like(s, dtype=torch.bool).scatter(1, order, True)


def forward(params: dict, pixels_u8: torch.Tensor, m: dict, sched: list,
            layers: str = "f32", other: str = "f32", follow=None) -> dict:
    """The served model on one block of images.

    sched: patches kept after each layer's selection (0: no drop there).
    layers, other: the weight products' precision (module docstring).
    follow: None, or keep masks [L, B, S] over original positions to follow
    at the drop layers (each row must keep CLS and k_i live patches).
    Returns logits [B, labels], keep_masks [L, B, S] bool, scores [L, B, N]
    (the predictor's scores at original patch positions, -inf where a
    layer scored nothing or the patch had dropped)."""
    bb, L = params["backbone"], m["layers"]
    with exact_f32():
        x = embed(pixels_u8, bb["embed"], m, other)
        b, s, _ = x.shape
        orig = torch.arange(s, device=x.device).expand(b, s)
        masks, all_scores = [], []
        cur = s
        for i in range(L):
            k_i = sched[i]
            sc = torch.full((b, s - 1), float("-inf"), device=x.device)
            if k_i and k_i < cur - 1:
                s_live = scores(x, params["predictor"], i, other)
                sc.scatter_(1, orig[:, 1:] - 1, s_live)
                if follow is None:
                    keep = torch.cat([torch.ones_like(s_live[:, :1], dtype=torch.bool),
                                      top_k(s_live, k_i)], dim=1)
                else:
                    keep = torch.gather(follow[i], 1, orig)
                # the kept rows, in token order
                rank = (~keep).to(torch.int64) * cur + torch.arange(cur, device=x.device)
                idx = torch.sort(rank, dim=1).indices[:, :k_i + 1]
                x = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
                orig = torch.gather(orig, 1, idx)
                cur = k_i + 1
            all_scores.append(sc)
            masks.append(torch.zeros((b, s), dtype=torch.bool, device=x.device)
                         .scatter(1, orig, True))
            if i < L - 1:
                x = block(x, _layer(bb["layers"], i), m, layers)
        cls = cls_block(x, _layer(bb["layers"], L - 1), m, other)
        cls = layer_norm(cls, bb["ln_f"]["g"], bb["ln_f"]["b"], m["eps"])
        logits = linear(cls, bb["head"]["w"], bb["head"]["b"], other)
    return {"logits": logits, "keep_masks": torch.stack(masks), "scores": torch.stack(all_scores)}
