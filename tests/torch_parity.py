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


# --- the arithmetic of kernels B6 and B7's tensor-core bodies, in torch ------
# (csrc/wgmma.cuh::split_bf16x3, csrc/mlp.cu, csrc/attention.cu; the kernels
# themselves run only on the card)


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
