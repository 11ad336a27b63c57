"""The plain reference of DINOv2 with registers as the port serves it: uint8
pixels -> logits, in plain PyTorch and float32 with TF32 off. It imports
nothing of the port's kernels or models (the parameter tree is the port's,
in checkpoint order: models/convert.py::load_dinov2_state_dict's layout).

The model (facebook/dinov2-with-registers-giant; DINOv2, arXiv:2304.07193;
"Vision Transformers Need Registers", arXiv:2309.16588), from its published
equations:

  tokens   x = [CLS + pos_0, r_1 .. r_R, P(p_1) + pos_1 .. P(p_N) + pos_N]:
           the registers after CLS with no position embedding, the patches
           projected (a linear map of each patch's (c, kh, kw) values) of
           the pixels normalised as (u8 / 255 - mean) / std;
  layer    h = x + g1 * Attn(LN1(x)),
           y = h + g2 * W_out(silu(u1) * u2) + g2 * b_out,
           [u1 | u2] = W_in LN2(h) + b_in, split in checkpoint order
           (chunk(2, -1)), g1 and g2 LayerScale's per-channel gains;
           Attn: q, k, v with biases, softmax(q k^T / sqrt(hd)) v over the
           heads, the output projection with its bias;
  head     LN_f, then Linear(2 D -> labels) on CLS ⊕ the mean of the patch
           tokens (the registers left out): DINOv2's linear-evaluation head.

Departures from the published model, the serving system's own:

  * the token predictor: before a layer whose keep schedule entry k is
    nonzero, an MLP([CLS ⊕ token]) -> sigmoid (the port's cls_mlp) scores
    the live patches, and CLS, the registers and the k highest-scoring
    patches go on in token order (ties to the lower position); dropped
    tokens never return. The registers are never scored and never dropped;
  * with tokens dropped, the head's mean runs over the kept patches.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 inside the block."""
    cuda, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = cuda, cudnn


def linear(x: torch.Tensor, lin: dict) -> torch.Tensor:
    """x @ w + b in float32 (w stored [in, out])."""
    return x @ lin["w"].float() + lin["b"].float()


def layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * p["g"].float() + p["b"].float()


def attention(h: torch.Tensor, attn: dict, heads: int) -> torch.Tensor:
    b, s, _ = h.shape

    def split(t):
        return t.reshape(b, s, heads, -1).transpose(1, 2)
    q, k, v = (split(linear(h, attn[n])) for n in "qkv")
    p = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1)
    return linear((p @ v).transpose(1, 2).reshape(b, s, -1), attn["o"])


def block(x: torch.Tensor, lp: dict, heads: int, eps: float) -> torch.Tensor:
    """One DINOv2 layer (SwiGLU MLP, LayerScale) on every row."""
    if "w" not in lp["mlp"]["fc1"]:
        raise ValueError("the reference takes fc1 in checkpoint order ([u1 | u2]), not "
                         "interleaved")
    h = x + lp["ls1"].float() * attention(layer_norm(x, lp["ln1"], eps), lp["attn"], heads)
    u1, u2 = linear(layer_norm(h, lp["ln2"], eps), lp["mlp"]["fc1"]).chunk(2, dim=-1)
    u = u1 * torch.sigmoid(u1) * u2
    return h + lp["ls2"].float() * linear(u, lp["mlp"]["fc2"])


def embed(pixels_u8: torch.Tensor, emb: dict, patch: int, mean: float, std: float):
    b, c, hgt, wid = pixels_u8.shape
    x = (pixels_u8.float() / 255.0 - mean) / std
    x = x.reshape(b, c, hgt // patch, patch, wid // patch, patch).permute(0, 2, 4, 1, 3, 5)
    x = x.reshape(b, (hgt // patch) * (wid // patch), c * patch * patch)
    pos = emb["pos"].float()
    y = linear(x, emb["patch"]) + pos[:, 1:]
    d = y.shape[-1]
    cls = (emb["cls"].float() + pos[:, :1]).expand(b, 1, d)
    reg = emb["registers"].float().expand(b, -1, d)
    return torch.cat([cls, reg, y], dim=1)


def scores(x: torch.Tensor, pred: dict, prefix: int) -> torch.Tensor:
    """The cls_mlp predictor's sigmoid scores of the live patches [B, n]."""
    t = x[:, prefix:]
    z = torch.cat([x[:, :1].expand(-1, t.shape[1], -1), t], dim=-1)
    hid = torch.relu(linear(z, pred["l0"]))
    return torch.sigmoid(linear(hid, pred["l1"]))[..., 0]


def _layer(tree: dict, i: int) -> dict:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def forward(params: dict, pixels_u8: torch.Tensor, config,
            keep_schedule: Optional[Sequence[int]] = None, mean: float = 0.5, std: float = 0.5,
            follow: Optional[torch.Tensor] = None) -> dict:
    """The model on a block of uint8 images [B, C, H, W].

    params: {'backbone': the port's tree in checkpoint order, 'predictor':
    {'mlp': {'l0', 'l1'}} stacked on [L] or None}; config: the sizes
    (patch_size, num_heads, num_layers, layernorm_eps, num_registers, as
    the port's ViTConfig has them). keep_schedule: patches kept after each
    layer's selection (0 or None: no drop). follow: keep masks [L, B, S]
    over the original positions to follow at the drop layers in place of
    the reference's own top k (the served ones, when a run is judged).
    Returns logits [B, labels], keep_masks [L, B, S] bool, scores [L, B, N]
    (the predictor's scores at the patch positions, -inf where a layer
    scored nothing or the patch had dropped) and last_hidden (LN_f's
    output over the live rows)."""
    bb = params["backbone"]
    L, p = config.num_layers, 1 + config.num_registers
    sched = list(keep_schedule or [0] * L)
    with exact_f32():
        x = embed(pixels_u8, bb["embed"], config.patch_size, mean, std)
        b, s, _ = x.shape
        orig = torch.arange(s, device=x.device).expand(b, s)
        masks, all_scores = [], []
        cur = s
        for i in range(L):
            k = sched[i]
            sc = torch.full((b, s - p), float("-inf"), device=x.device)
            if k and k < cur - p:
                live = scores(x, _layer(params["predictor"]["mlp"], i), p)
                sc.scatter_(1, orig[:, p:] - p, live)
                if follow is None:
                    order = torch.sort(live, dim=-1, descending=True, stable=True).indices[:, :k]
                    top = torch.zeros_like(live, dtype=torch.bool).scatter(1, order, True)
                    keep = torch.cat([torch.ones_like(top[:, :1]).expand(-1, p), top], dim=1)
                else:
                    keep = torch.gather(follow[i], 1, orig)
                rank = (~keep).to(torch.int64) * cur + torch.arange(cur, device=x.device)
                idx = torch.sort(rank, dim=1).indices[:, :k + p]
                x = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
                orig, cur = torch.gather(orig, 1, idx), k + p
            all_scores.append(sc)
            masks.append(torch.zeros((b, s), dtype=torch.bool, device=x.device)
                         .scatter(1, orig, True))
            x = block(x, _layer(bb["layers"], i), config.num_heads, config.layernorm_eps)
        x = layer_norm(x, bb["ln_f"], config.layernorm_eps)
        logits = linear(torch.cat([x[:, 0], x[:, p:].mean(dim=1)], dim=-1), bb["head"])
    return {"logits": logits, "keep_masks": torch.stack(masks),
            "scores": torch.stack(all_scores), "last_hidden": x}
