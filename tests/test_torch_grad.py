"""Gradients through the port's kernels, on the CPU.

B1 and B5 train through ops/cuda/layer.py::RecomputedBackward, the port's
counterpart of the JAX package's custom VJPs (differentiable_fused_layer,
differentiable_fused_encoder): forward the kernel (on the CPU its plain
version), backward the eager layer (loop) recomputed and differentiated.
Their gradients are held to the JAX VJPs' with the Pallas kernels in
interpret mode, at tests/test_pallas.py's tolerances (atol 2e-4, rtol 1e-3),
and to the eager layer's own gradient for the same upstream gradient,
exactly. The routes of vit_layer / vit_forward under autograd go through
the Function. The kernels without a VJP (B2, B3, B4, B6, B7, B8a, B8b)
raise for a CUDA input that requires grad: here the wrapper's launch check
is stubbed to take the CPU tensor as a card's, and the library loader to
fail, so a call that gets past the guard shows it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import as_numpy, jax_and_torch_params, randn
from vit_pruning_tpu.configs import ViTConfig
from vit_pruning_tpu.models.vit import init_vit_params
from vit_pruning_tpu.ops.pallas.layer import differentiable_fused_layer
from vit_pruning_tpu.ops.pallas.model import differentiable_fused_encoder
from vit_pruning_tpu_torch.configs import ViTConfig as TViTConfig
from vit_pruning_tpu_torch.models.convert import flatten_tree, unflatten_tree
from vit_pruning_tpu_torch.models import vit as tvit
from vit_pruning_tpu_torch.ops.cuda import attention as tatt
from vit_pruning_tpu_torch.ops.cuda import build as tbuild
from vit_pruning_tpu_torch.ops.cuda import embed as temb
from vit_pruning_tpu_torch.ops.cuda import layer as tl
from vit_pruning_tpu_torch.ops.cuda import layer_int8 as t8
from vit_pruning_tpu_torch.ops.cuda import mlp as tmlp
from vit_pruning_tpu_torch.ops.cuda import model as tmod
from vit_pruning_tpu_torch.ops.dispatch import encoder_fusion
from vit_pruning_tpu_torch.ops.quant import quantize_layer_params

CFG = ViTConfig(image_size=32, patch_size=8, hidden_size=64, num_layers=2, num_heads=2,
                mlp_dim=128, num_labels=10)
TCFG = TViTConfig(**{f: getattr(CFG, f) for f in ("image_size", "patch_size", "hidden_size",
                                                  "num_layers", "num_heads", "mlp_dim",
                                                  "num_labels")})


def _case(seed=0):
    params = init_vit_params(jax.random.PRNGKey(seed), CFG)
    x = randn(1, (2, 17, 64))
    mask = np.random.RandomState(2).rand(2, 17) > 0.3
    mask[:, 0] = True
    return params, x, mask


def _torch_grads(fn, x, tree):
    """d/d(x, leaves) of sum(where(mask, y, x)^2) for y = fn(x, tree)."""
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = [t for _, t in flatten_tree(tree)]
    for t in leaves:
        t.requires_grad_(True)
    y, m = fn(xt, tree)
    loss = (torch.where(m[..., None], y, xt) ** 2).sum()
    return y, torch.autograd.grad(loss, [xt] + leaves)


@pytest.mark.parametrize("route", ["b1", "b5"])
def test_function_grads_match_jax_custom_vjp(route):
    params, x, mask = _case()
    jm, tm = jnp.asarray(mask), torch.from_numpy(mask)
    if route == "b1":
        jtree, ttree = jax_and_torch_params(jax.tree.map(lambda a: a[0], params["layers"]))
        f = differentiable_fused_layer(CFG.num_heads, CFG.layernorm_eps, interpret=True)
        tfn = lambda x_, p_: (tl.fused_vit_layer(x_, p_, 2, CFG.layernorm_eps, tm), tm)  # noqa
    else:
        jtree, ttree = jax_and_torch_params(params["layers"])
        f = differentiable_fused_encoder(CFG.num_heads, CFG.layernorm_eps, interpret=True)
        tfn = lambda x_, p_: (tmod.fused_vit_encoder(x_, p_, 2, CFG.layernorm_eps, tm), tm)  # noqa

    def loss(x_, p_):
        return (jnp.where(jm[..., None], f(x_, p_, jm), x_) ** 2).sum()

    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jtree)
    y, grads = _torch_grads(tfn, x, ttree)
    assert y.grad_fn is not None and "RecomputedBackward" in y.grad_fn.name()
    want = [gx] + jax.tree.leaves(gp)
    assert len(want) == len(grads)
    for a, b in zip(grads, want):
        np.testing.assert_allclose(as_numpy(a), np.asarray(b), atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("route", ["b1", "b5"])
def test_function_backward_is_the_eager_layers_for_the_same_upstream(route):
    """The Function's gradients equal eager_layer's (eager_encoder's) bit for
    bit, for one upstream gradient: the backward is that layer's."""
    params, x, mask = _case(3)
    tm = torch.from_numpy(mask)
    tree = jax_and_torch_params(params["layers"] if route == "b5"
                                else jax.tree.map(lambda a: a[0], params["layers"]))[1]
    kernel = tl.fused_vit_layer if route == "b1" else tmod.fused_vit_encoder
    eager = tl.eager_layer if route == "b1" else tmod.eager_encoder
    g = torch.from_numpy(randn(5, (2, 17, 64)))
    res = []
    for fn in (kernel, eager):
        xt = torch.from_numpy(x).requires_grad_(True)
        leaves = [t.detach().requires_grad_(True) for _, t in flatten_tree(tree)]
        p = unflatten_tree([pth for pth, _ in flatten_tree(tree)], leaves)
        y = fn(xt, p, 2, CFG.layernorm_eps, tm)
        res.append(torch.autograd.grad(y, [xt] + leaves, g))
    for a, b in zip(*res):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_no_graph_without_grad_and_mask_gets_none():
    """Under no_grad (and for inputs that need none) the wrapper runs its
    kernel directly; the token mask is not an input autograd differentiates."""
    params, x, mask = _case()
    tree = jax_and_torch_params(jax.tree.map(lambda a: a[0], params["layers"]))[1]
    y = tl.fused_vit_layer(torch.from_numpy(x), tree, 2, CFG.layernorm_eps,
                           torch.from_numpy(mask))
    assert y.grad_fn is None
    assert not tl.grad_needed(torch.from_numpy(x), tree)
    xt = torch.from_numpy(x).requires_grad_(True)
    with torch.no_grad():
        assert not tl.grad_needed(xt, tree)
    assert tl.grad_needed(xt, tree)


def test_model_routes_take_the_functions(monkeypatch):
    """vit_layer and vit_forward (layer loop and, with encoder fusion, B5)
    under autograd go through RecomputedBackward, once per kernel call."""
    params = init_vit_params(jax.random.PRNGKey(0), CFG)
    tparams = jax_and_torch_params(params)[1]
    for _, t in flatten_tree(tparams):
        t.requires_grad_(True)
    calls = []
    real = tl.recomputed

    def counting(kernel, eager, x, p, m):
        calls.append(x.shape)
        return real(kernel, eager, x, p, m)

    monkeypatch.setattr(tl, "recomputed", counting)
    monkeypatch.setattr(tmod, "recomputed", counting)
    pix = torch.from_numpy(randn(4, (2, 3, 32, 32)))
    out = tvit.vit_forward(tparams, pix, TCFG)
    out["logits"].sum().backward()
    assert len(calls) == CFG.num_layers
    assert tparams["layers"]["attn"]["q"]["w"].grad.abs().max() > 0
    calls.clear()
    with encoder_fusion(True):
        tvit.vit_forward(tparams, pix, TCFG)["logits"].sum().backward()
    assert len(calls) == 1
    calls.clear()
    with torch.no_grad():
        tvit.vit_forward(tparams, pix, TCFG)
    assert not calls


def _no_grad_cases():
    params = init_vit_params(jax.random.PRNGKey(0), CFG)
    _, tp = jax_and_torch_params(params)
    lp = tvit.layer_slice(tp["layers"], 0)
    qp = quantize_layer_params(lp)
    x = torch.from_numpy(randn(1, (2, 17, 64)))
    kept = torch.ones(2, 17, dtype=torch.bool)
    dest = torch.arange(17).expand(2, 17).contiguous()
    q = torch.from_numpy(randn(2, (2, 2, 17, 32)))
    w1, b1 = lp["mlp"]["fc1"]["w"], lp["mlp"]["fc1"]["b"]
    w2, b2 = lp["mlp"]["fc2"]["w"], lp["mlp"]["fc2"]["b"]
    pw, pb = tp["embed"]["patch"]["w"], tp["embed"]["patch"]["b"]
    pos = tp["embed"]["pos"][0, 1:]
    patches = torch.from_numpy(randn(3, (2, 16, 192)))
    u8 = torch.randint(0, 255, (2, 16, 192), dtype=torch.uint8)
    return {
        "B2": (tl, lambda t: tl.fused_vit_layer_cls_logits(t, lp, tp["ln_f"], tp["head"], 2), x),
        "B3": (tl, lambda t: tl.fused_vit_layer_bucketed(t, lp, dest, kept, 9, 2), x),
        "B4": (t8, lambda t: t8.fused_vit_layer_int8(t, qp, 2), x),
        "B6": (tatt, lambda t: tatt.fused_attention(t, q, q), q),
        "B7": (tmlp, lambda t: tmlp.fused_mlp(t, w1, b1, w2, b2), x[0]),
        "B8a": (temb, lambda t: temb.fused_patch_embed_u8(u8, t, pb, pos), pw),
        "B8b": (temb, lambda t: temb.fused_patch_embed_f(patches, t, pb, pos), pw),
    }


class _NoLibrary(Exception):
    pass


@pytest.mark.parametrize("kernel", ["B2", "B3", "B4", "B6", "B7", "B8a", "B8b"])
def test_kernels_without_a_backward_refuse_grad(kernel, monkeypatch):
    mod, call, t = _no_grad_cases()[kernel]
    monkeypatch.setattr(mod, "launch_kernel_for", lambda _t: True)

    def no_library():
        raise _NoLibrary

    monkeypatch.setattr(tbuild, "load_library", no_library)
    with pytest.raises(RuntimeError, match="no backward"):
        call(t.clone().requires_grad_(True))
    # without grad the call goes on to its launch: the kernel's registered
    # operator, which has no CPU implementation and names itself
    with pytest.raises(NotImplementedError, match="vpt::"):
        with torch.no_grad():
            call(t.clone().requires_grad_(True))
    with pytest.raises(NotImplementedError, match="vpt::"):
        call(t)
