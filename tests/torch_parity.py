"""Shared set-up for the port's parity tests (tests/test_torch_*.py).

Inputs come from numpy seeds; weights are made by the JAX package and
handed to the port through models/convert.py, so both packages run the
same numbers.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vit_pruning_tpu.configs import PruneConfig, ViTConfig
from vit_pruning_tpu_torch.models.convert import params_from_jax


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def jax_and_torch_params(tree, dtype=jnp.float32):
    """(JAX tree in `dtype`, port tree from the same numbers)."""
    jtree = jax.tree.map(lambda a: a.astype(dtype), tree)
    tdtype = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jtree, params_from_jax(to_numpy(jtree), "cpu", tdtype)


def randn(seed: int, shape, dtype=np.float32) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(dtype)


def as_torch(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def as_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def init_pruned(config: ViTConfig, pcfg: PruneConfig, seed: int = 0) -> dict:
    from vit_pruning_tpu.models.pruned_vit import init_pruned_vit_params

    return init_pruned_vit_params(jax.random.PRNGKey(seed), config, pcfg)


# --- the arithmetic of the tensor-core bodies on f32 operands, in torch --------
# (csrc/wgmma.cuh::split_bf16x3, csrc/mlp.cu, csrc/attention.cu, csrc/split6.cuh's
# split body; the kernels themselves run only on the card)


def split_bf16x3(a: torch.Tensor):
    """An f32 tensor as hi + mid + lo, three bf16 tensors whose sum is `a`
    exactly: hi = bf16(a), mid = bf16(a - hi), lo = a - hi - mid (an
    infinite hi leaves mid = lo = 0), as the kernels split."""
    a = a.float()
    hi = a.to(torch.bfloat16)
    r1 = a - hi.float()
    r1 = torch.where(torch.isinf(hi), torch.zeros_like(r1), r1)
    mid = r1.to(torch.bfloat16)
    lo = r1 - mid.float()
    return hi, mid, lo.to(torch.bfloat16)


def split_product(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """acc + a @ b for f32 a and bf16-valued b, as three bf16 passes over
    a's split, the small planes first, each into the f32 running sum."""
    for plane in reversed(split_bf16x3(a)):
        acc = acc + plane.float() @ b.float()
    return acc


# csrc/split6.cuh's f32 split body: the six passes of a k-step as (A plane, W plane),
# 0 hi, 1 mid, 2 lo, the small terms first
SPLIT6_PASSES = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))


def split6_product(a: torch.Tensor, w: torch.Tensor, step: int = 64) -> torch.Tensor:
    """a @ w for f32 a [..., K] and w [K, N] as the split body forms it: both
    operands split into three bf16 planes, the six passes of each 64-deep
    k-step summed in f32 (each bf16 x bf16 product exact), each step's sum
    added to the running f32 sum."""
    pa = [t.float() for t in split_bf16x3(a)]
    pw = [t.float() for t in split_bf16x3(w)]
    out = torch.zeros((*a.shape[:-1], w.shape[1]), dtype=torch.float32)
    for k0 in range(0, a.shape[-1], step):
        acc = torch.zeros_like(out)
        for i, j in SPLIT6_PASSES:
            acc = acc + pa[i][..., k0:k0 + step] @ pw[j][k0:k0 + step]
        out = out + acc
    return out


def fused_mlp_emulated(x, w1, b1, w2, b2, chunk: int = 64) -> torch.Tensor:
    """B7's tensor-core body: the hidden dimension in chunks of 64, h =
    erf-GELU(x W1[:, c] + b1[c]) in f32, acc += split(h) W2[c, :]; the
    result + b2, cast to x's dtype."""
    xf = x.float()
    acc = torch.zeros(x.shape[0], w2.shape[1])
    for c in range(0, w1.shape[1], chunk):
        h = torch.nn.functional.gelu(xf @ w1[:, c:c + chunk].float() + b1[c:c + chunk].float())
        acc = split_product(h, w2[c:c + chunk], acc)
    return (acc + b2.float()).to(x.dtype)


def fused_attention_emulated(q, k, v, token_mask=None, chunk: int = 64) -> torch.Tensor:
    """B6's tensor-core body: logits scaled after the product, masked keys
    -1e30, keys padded to a multiple of 64 at -inf; pass 1 takes the row max
    and the sum chunk by chunk (the sum rescaled when the max grows); pass
    2 forms P = exp(l - max) / sum per chunk and adds split(P) V; cast to
    q's dtype."""
    s = q.shape[-2]
    logits = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if token_mask is not None:
        logits = torch.where(token_mask[:, None, None, :], logits, -1e30)
    pad = -s % chunk
    logits = torch.nn.functional.pad(logits, (0, pad), value=-math.inf)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad))
    mx = torch.full(logits.shape[:-1] + (1,), -math.inf)
    total = torch.zeros_like(mx)
    for c in range(0, s + pad, chunk):
        lc = logits[..., c:c + chunk]
        m = torch.maximum(mx, lc.amax(-1, keepdim=True))
        total = total * torch.exp(mx - m) + torch.exp(lc - m).sum(-1, keepdim=True)
        mx = m
    out = torch.zeros(q.shape)
    for c in range(0, s + pad, chunk):
        p = torch.exp(logits[..., c:c + chunk] - mx) / total
        out = split_product(p, vf[..., c:c + chunk, :], out)
    return out.to(q.dtype)


def split_attention_emulated(q, k, v, mask=None, counts=None, normalized=True,
                             passes=SPLIT6_PASSES, pv_passes=None, lo_planes=True,
                             chunk: int = 64) -> torch.Tensor:
    """csrc/split_attention.cuh's body (B1-B5's f32 attention, B6's split
    body) on q, k, v [B, H, S, hd]: each operand as the split pass writes
    its planes (f32: hi, mid, lo; bf16: the values, mid = lo = 0), the
    logits of each 64-key chunk one f32 sum over the passes (`passes`, the
    small terms first) of plane products, scaled after it; masked keys
    (`mask` [B, S] False, or keys j >= counts[b]) -1e30; the max over the
    whole row; staged2 (normalized False): e = exp(l - max), the context
    (sum over chunks of each chunk's PV passes over split(e) and V's planes)
    times 1 / sum(e); normalised: P = e / sum, then the same PV. The sum is
    taken over the whole row where the kernel keeps the logits resident (hd
    <= 64, S <= 256), else chunk by chunk, rescaled as the max grows (the
    streamed body's first pass) when normalised. pv_passes defaults to
    `passes`; lo_planes False zeroes q's, k's and v's lo planes (a planted
    fault). Cast to q's dtype."""
    b, h, s, hd = q.shape
    pv_passes = passes if pv_passes is None else pv_passes

    def planes(t):
        if t.dtype == torch.bfloat16:
            return [t.float(), torch.zeros_like(t, dtype=torch.float32),
                    torch.zeros_like(t, dtype=torch.float32)]
        pl = [p.float() for p in split_bf16x3(t)]
        if not lo_planes:
            pl[2] = torch.zeros_like(pl[2])
        return pl

    pq, pk, pv = planes(q), planes(k), planes(v)
    if counts is not None:
        mask = torch.arange(s)[None, :] < counts[:, None]
    scale = 1.0 / math.sqrt(hd)
    logits = []
    for c in range(0, s, chunk):
        acc = torch.zeros(b, h, s, min(chunk, s - c))
        for i, j in passes:
            acc = acc + pq[i] @ pk[j][..., c:c + chunk, :].transpose(-1, -2)
        lc = acc * scale
        if mask is not None:
            lc = torch.where(mask[:, None, None, c:c + chunk], lc, -1e30)
        logits.append(lc)
    resident = hd <= 64 and s <= 4 * chunk
    mx = torch.cat(logits, -1).amax(-1, keepdim=True)
    e = [torch.exp(lc - mx) for lc in logits]
    if normalized and not resident:
        run_mx = torch.full_like(mx, -math.inf)
        total = torch.zeros_like(mx)
        for lc in logits:
            m = torch.maximum(run_mx, lc.amax(-1, keepdim=True))
            total = total * torch.exp(run_mx - m) + torch.exp(lc - m).sum(-1, keepdim=True)
            run_mx = m
    else:
        total = torch.cat(e, -1).sum(-1, keepdim=True)
    out = torch.zeros(b, h, s, hd)
    for n, ec in enumerate(e):
        p = ec / total if normalized else ec
        pp = [t.float() for t in split_bf16x3(p)]
        oc = torch.zeros_like(out)
        for i, j in pv_passes:
            oc = oc + pp[i] @ pv[j][..., n * chunk:n * chunk + ec.shape[-1], :]
        out = out + oc
    if not normalized:
        out = out * (1.0 / total)
    return out.to(q.dtype)


def cls_logits_f32_emulated(x, layer: dict, lnf: dict, head: dict, num_heads: int,
                            eps: float = 1e-12, passes=SPLIT6_PASSES, step: int = 32,
                            lo_planes: bool = True) -> torch.Tensor:
    """Kernel B2's float32 route (csrc/cls_logits.cu) in torch, on x [B, S, D]
    f32: LN1 in f32; K and V of every token and q of the CLS row as the split
    body forms them (split6_product: both operands split into three bf16
    planes, the `passes` of each `step`-deep k-step summed, each step's sum
    added to a running f32 sum) + bias; the CLS logits q . k in f32 times
    1 / sqrt(hd); P = exp(l - max) / sum; ctx = P V; then the tail with every
    product split the same way: x1 = x_cls + (ctx Wo + bo), LN2, erf GELU(h W1
    + b1), x2 = x1 + (m1 W2 + b2), LN_f, the classifier. lo_planes False
    zeroes every weight's lo plane (a planted fault). Returns [B, labels]."""
    def prod(a, w):
        if not lo_planes:
            hi, mid, _ = split_bf16x3(w)
            w = hi.float() + mid.float()
        out = torch.zeros((*a.shape[:-1], w.shape[1]), dtype=torch.float32)
        pa = [t.float() for t in split_bf16x3(a)]
        pw = [t.float() for t in split_bf16x3(w)]
        for k0 in range(0, a.shape[-1], step):
            acc = torch.zeros_like(out)
            for i, j in passes:
                acc = acc + pa[i][..., k0:k0 + step] @ pw[j][k0:k0 + step]
            out = out + acc
        return out

    def ln(t, p):
        mean = t.mean(-1, keepdim=True)
        var = ((t - mean) ** 2).mean(-1, keepdim=True)
        return (t - mean) * torch.rsqrt(var + eps) * p["g"].float() + p["b"].float()

    a, mlp = layer["attn"], layer["mlp"]
    b, s, _ = x.shape
    h1 = ln(x.float(), layer["ln1"])
    k, v = ((prod(h1, a[n]["w"].float()) + a[n]["b"].float()).reshape(b, s, num_heads, -1)
            .transpose(1, 2) for n in "kv")  # [B, H, S, hd]
    q = (prod(h1[:, :1], a["q"]["w"].float()) + a["q"]["b"].float()).reshape(
        b, 1, num_heads, -1).transpose(1, 2)
    logits = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(k.shape[-1]))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    ctx = ((e / e.sum(-1, keepdim=True)) @ v).transpose(1, 2).reshape(b, -1)
    x1 = x[:, 0].float() + (prod(ctx, a["o"]["w"].float()) + a["o"]["b"].float())
    m1 = torch.nn.functional.gelu(prod(ln(x1, layer["ln2"]), mlp["fc1"]["w"].float())
                                  + mlp["fc1"]["b"].float())
    x2 = x1 + (prod(m1, mlp["fc2"]["w"].float()) + mlp["fc2"]["b"].float())
    return prod(ln(x2, lnf), head["w"].float()) + head["b"].float()
