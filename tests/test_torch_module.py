"""The port's torch.nn.Module adapter (vit_pruning_tpu_torch/models/torch_module.py::
PrunedViT) against the JAX package's linen adapter (vit_pruning_tpu/models/
flax_module.py::PrunedViT), float32 on the CPU at vit_tiny (3 layers, D 64,
4 heads, 32 px, patch 8).

The linen adapter is initialised with PRNGKey(0); its variables['params']
['model'] tree crosses to the port by PrunedViT.from_jax, and the same numpy
inputs go through module.apply and the port's module: logits, last_hidden
and scores within atol 2e-5, keep masks equal (every decision asserted at
least MIN_GAP from its cut in the JAX run; the predictor's weights are
scaled by GAIN to spread its scores). Mode 'random' cannot share JAX's
random bits: it is held, as every mode, to the port's functional forward on
module.param_tree(), bit for bit. Then the state_dict's keys against the
JAX paths, the round trip back to the linen adapter, one train step against
jax.grad and against the port's train step on the functional tree, the cast,
the default device, and the module's imports.
"""

import functools
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import randn
from vit_pruning_tpu.configs import PruneConfig as JPruneConfig
from vit_pruning_tpu.configs import vit_tiny as jax_vit_tiny
from vit_pruning_tpu_torch.configs import PruneConfig, vit_tiny
from vit_pruning_tpu_torch.models import pruned_vit as tp
from vit_pruning_tpu_torch.models.convert import (
    flatten_tree,
    params_from_jax,
    params_to_numpy,
    tree_to,
)
from vit_pruning_tpu_torch.models.torch_module import PrunedViT
from vit_pruning_tpu_torch.ops.dispatch import quant_mode

pytest.importorskip("flax")
from vit_pruning_tpu.models import flax_module  # noqa: E402

ATOL = 2e-5
MIN_GAP = 1e-6
GAIN = 10.0
CFG = vit_tiny()
B = 4

# name -> (PruneConfig fields, forward keywords)
MODES = {
    "mask": (dict(mode="mask"), {}),
    "topk": (dict(mode="topk", top_k=8), {}),
    "topk_prog": (dict(mode="topk_prog", top_k=8, keep_schedule=(10, 6, 0)), {}),
    "topk_prog_oracle": (dict(mode="topk_prog", top_k=8), {"compute_oracle": True}),
    "none": (dict(mode="none", predictor="none"), {}),
}


def _pixels(seed=1):
    return randn(seed, (B, 3, CFG.image_size, CFG.image_size))


def _jax_variables(fields, seed=0):
    """The linen adapter and its variables (PRNGKey(seed)), the predictor's
    weights scaled by GAIN, as numpy leaves."""
    jm = flax_module.PrunedViT(config=jax_vit_tiny(), prune_config=JPruneConfig(**fields))
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(_pixels()))
    tree = jax.tree.map(np.asarray, v["params"]["model"])
    if tree.get("predictor") is not None:
        tree["predictor"] = jax.tree.map(lambda a: a * GAIN, tree["predictor"])
    return jm, {"params": {"model": tree}}


def _rank_gap(sc: np.ndarray, k: int) -> float:
    """Smallest gap between the k-th and (k+1)-th largest finite score of a row."""
    srt = -np.sort(-np.where(np.isfinite(sc), sc, -np.inf), axis=-1)
    if k >= sc.shape[-1]:
        return np.inf
    nxt = srt[:, k]
    live = np.isfinite(nxt)
    return float((srt[:, k - 1] - nxt)[live].min()) if live.any() else np.inf


def _decision_gap(scores: np.ndarray, fields: dict, train: bool = False,
                  compute_oracle: bool = False) -> float:
    """Smallest distance of a keep decision from its cut in the JAX run
    (topk_prog trains, and runs the oracle instrumentation, as topk)."""
    mode, gaps = fields["mode"], [np.inf]
    if mode == "topk_prog" and not (train or compute_oracle):
        for i, k in enumerate(fields.get("keep_schedule") or (fields["top_k"],)):
            if k:
                gaps.append(_rank_gap(scores[i], k))
    elif mode in ("topk", "topk_prog"):
        gaps += [_rank_gap(sc, fields["top_k"]) for sc in scores]
    elif mode == "mask":
        gaps.append(float(np.abs(scores - 0.5).min()))  # the default mlp_threshold
    return min(gaps)


@pytest.mark.parametrize("name", list(MODES))
def test_module_matches_the_linen_adapter(name):
    """(a) the same variables and pixels through both adapters."""
    fields, call = MODES[name]
    jm, variables = _jax_variables(fields)
    x = _pixels()
    want = jm.apply(variables, jnp.asarray(x), **call)
    assert _decision_gap(np.asarray(want["scores"]), fields, **call) > MIN_GAP
    module = PrunedViT.from_jax(variables["params"]["model"], CFG, PruneConfig(**fields),
                                device="cpu")
    got = module(torch.from_numpy(x), **call)
    assert sorted(got) == sorted(want)
    for key in ("logits", "last_hidden", "scores"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]), rtol=0,
                                   atol=ATOL, err_msg=key)
    np.testing.assert_array_equal(got["keep_masks"].numpy(), np.asarray(want["keep_masks"]))
    if "aux" in want:
        assert sorted(got["aux"]) == sorted(want["aux"])
        np.testing.assert_allclose(got["aux"]["pred_loss"].detach().numpy(),
                                   np.asarray(want["aux"]["pred_loss"]), rtol=1e-5, atol=ATOL)


FUNCTIONAL = {
    **MODES,
    "random": (dict(mode="random", top_k=8), {}),
    "mask_budget": (dict(mode="mask", mask_budget=6), {}),
    "topk_prog_train": (dict(mode="topk_prog", top_k=8), {"train": True}),
}


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("name", list(FUNCTIONAL))
def test_module_is_the_functional_forward(name, quant):
    """(b) the module's output is the functional core's on param_tree(), bit
    for bit: progressive_topk_forward for topk_prog inference, else
    pruned_vit_forward; the quant mode read from the switch; mode random
    with one seeded generator for both calls."""
    fields, call = FUNCTIONAL[name]
    pcfg = PruneConfig(**fields)
    module = PrunedViT(CFG, pcfg, generator=torch.Generator().manual_seed(3), device="cpu")
    x = torch.from_numpy(_pixels())
    with torch.no_grad(), quant_mode(quant):
        got = module(x, generator=torch.Generator().manual_seed(7), **call)
        if pcfg.mode == "topk_prog" and not call:
            want = tp.progressive_topk_forward(module.param_tree(), x, CFG, pcfg)
        else:
            want = tp.pruned_vit_forward(module.param_tree(), x, CFG, pcfg,
                                         generator=torch.Generator().manual_seed(7), **call)
    assert sorted(got) == sorted(want)
    for key in want:
        pairs = zip(got[key].values(), want[key].values()) if key == "aux" else [
            (got[key], want[key])]
        assert all(torch.equal(a, b) for a, b in pairs), key


def _jax_paths(tree) -> list:
    """The flattened JAX paths of a tree, '/'-joined."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return ["/".join(str(k.key) for k in path) for path, _ in flat]


@pytest.mark.parametrize("predictor", ["cls_mlp", "none"])
def test_state_dict_round_trips(predictor):
    """(c) state_dict keys are the JAX paths with '.' for '/'; the tree
    carried back to the linen adapter gives its logits unchanged;
    load_state_dict of a second module reproduces the first; a None
    predictor comes back as None."""
    fields = dict(mode="topk", top_k=8, predictor=predictor)
    jm, variables = _jax_variables(fields)
    module = PrunedViT.from_jax(variables["params"]["model"], CFG, PruneConfig(**fields),
                                device="cpu")
    keys = list(module.state_dict())
    paths = _jax_paths(variables)
    assert len(keys) == len(paths) == len(set(keys))
    assert sorted(keys) == sorted(p.replace("/", ".")[len("params."):] for p in paths)
    assert {k for k, _ in module.named_parameters()} == set(keys)
    assert (module.param_tree()["predictor"] is None) == (predictor == "none")

    x = jnp.asarray(_pixels())
    back = {"params": {"model": params_to_numpy(module.param_tree())}}
    np.testing.assert_array_equal(np.asarray(jm.apply(back, x)["logits"]),
                                  np.asarray(jm.apply(variables, x)["logits"]))

    other = PrunedViT(CFG, PruneConfig(**fields), generator=torch.Generator().manual_seed(5),
                      device="cpu")
    xt = torch.from_numpy(_pixels())
    with torch.no_grad():
        assert not torch.equal(other(xt)["logits"], module(xt)["logits"])
        other.load_state_dict(module.state_dict())
        a, b = other(xt), module(xt)
    for key in ("logits", "keep_masks", "scores"):
        assert torch.equal(a[key], b[key]), key


def test_param_tree_holds_the_modules_parameters():
    """param_tree() returns the module's Parameters themselves, in the tree's
    key order; with params given, the module holds the tree's tensors."""
    pcfg = PruneConfig(mode="mask")
    params = tp.init_pruned_vit_params(CFG, pcfg, torch.Generator().manual_seed(0), "cpu")
    module = PrunedViT(CFG, pcfg, params=params, device="cpu")
    tree = module.param_tree()
    own = {id(p) for p in module.parameters()}
    assert [path for path, _ in flatten_tree(tree)] == [path for path, _ in flatten_tree(params)]
    assert all(isinstance(t, torch.nn.Parameter) and id(t) in own for _, t in flatten_tree(tree))
    assert len(own) == len(flatten_tree(tree))
    assert all(t.data_ptr() == p.data_ptr()
               for (_, t), (_, p) in zip(flatten_tree(tree), flatten_tree(params)))


def test_one_train_step_matches_jax_and_the_functional_step():
    """(d) one train=True step in mode mask (loss: cross-entropy plus the
    predictor losses, 'both'): the gradients of every Parameter against
    jax.grad of the linen adapter's loss within 1e-4 of each leaf's max
    |grad|; after one masked_adam step over param_tree(), the Parameters
    equal the port's make_train_step on the functional tree."""
    from vit_pruning_tpu.train import losses as jlosses
    from vit_pruning_tpu_torch.train import harness as th
    from vit_pruning_tpu_torch.train.freeze import masked_adam
    from vit_pruning_tpu_torch.train.losses import cross_entropy

    fields = dict(mode="mask")
    jm, variables = _jax_variables(fields)
    x = _pixels()
    labels = np.random.RandomState(2).randint(0, CFG.num_labels, B).astype(np.int32)

    def jloss(v):
        out = jm.apply(v, jnp.asarray(x), train=True)
        return (jlosses.cross_entropy(out["logits"], jnp.asarray(labels))
                + th.COSINE_LOSS_RATIO * out["aux"]["pred_loss"].sum()), out

    (jv, jout), jgrad = jax.value_and_grad(jloss, has_aux=True)(variables)
    assert _decision_gap(np.asarray(jout["scores"]), fields, train=True) > MIN_GAP
    sim = np.asarray(jout["aux"]["similarity"])
    assert np.abs(sim - PruneConfig().sim_threshold).min() > MIN_GAP

    pcfg = PruneConfig(**fields)
    tree = variables["params"]["model"]
    module = PrunedViT.from_jax(tree, CFG, pcfg, device="cpu")
    opt = masked_adam(module.param_tree(), "vit_mlp_train", 1e-3)
    xt, yt = torch.from_numpy(x), torch.from_numpy(labels).long()
    opt.zero_grad(set_to_none=True)
    out = module(xt, train=True)
    loss = cross_entropy(out["logits"], yt) + th.COSINE_LOSS_RATIO * out["aux"]["pred_loss"].sum()
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5, atol=ATOL)
    grads = dict(zip(_jax_paths(jgrad), jax.tree.leaves(jgrad)))
    named = dict(module.named_parameters())
    assert len(named) == len(grads)
    for name, p in named.items():
        want = np.asarray(grads["params/" + name.replace(".", "/")])
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        # + 1e-8: the key bias's exact gradient is 0; both sides hold f32 noise there
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()) + 1e-8, err_msg=name)
    opt.step()

    functional = params_from_jax(tree, "cpu")
    step = th.make_train_step(CFG, pcfg, "both", masked_adam(functional, "vit_mlp_train", 1e-3))
    metrics = step(functional, {"pixel_values": xt, "labels": yt})
    assert float(metrics["loss"]) == float(loss.detach())
    moved = 0
    for (path, a), (_, b) in zip(flatten_tree(module.param_tree()), flatten_tree(functional)):
        assert torch.equal(a.detach(), b.detach()), path
        moved += not np.array_equal(a.detach().numpy(), functools.reduce(dict.get, path, tree))
    assert moved > 0


def test_cast_matches_tree_to():
    """(e) module.to(torch.bfloat16) leaves the dtypes and values of
    tree_to(tree, dtype=torch.bfloat16)."""
    pcfg = PruneConfig(mode="topk", top_k=8, skip_correction="updatenet")
    params = tp.init_pruned_vit_params(CFG, pcfg, torch.Generator().manual_seed(0), "cpu")
    want = tree_to(params, dtype=torch.bfloat16)
    module = PrunedViT(CFG, pcfg, params=tree_to(params, "cpu"), device="cpu")
    assert module.to(torch.bfloat16) is module
    got = module.param_tree()
    for (pa, a), (pb, b) in zip(flatten_tree(got), flatten_tree(want)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a.detach(), b), pa
    assert all(isinstance(t, torch.nn.Parameter) for _, t in flatten_tree(got))


def test_the_card_is_the_default_device(monkeypatch):
    """(f) without a card, the default device raises instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pcfg = PruneConfig(mode="topk", top_k=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrunedViT(CFG, pcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PrunedViT.from_jax(_jax_variables(dict(mode="topk", top_k=8))[1]["params"]["model"],
                           CFG, pcfg)
    assert PrunedViT(CFG, pcfg, device="cpu").param_tree()["backbone"]["ln_f"]["g"].is_cpu


IMPORT_MODULE = """
import pkgutil, sys
import vit_pruning_tpu_torch as p
names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]
import vit_pruning_tpu_torch.models.torch_module
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'vit_pruning_tpu'))
print('vit_pruning_tpu_torch.models.torch_module' in names, bad)
"""


def test_module_imports_nothing_of_jax():
    """(g) the module's file names neither jax, flax nor the JAX package, and
    importing it (a module the package walk finds) loads none of them."""
    src = Path(__file__).resolve().parents[1] / "vit_pruning_tpu_torch/models/torch_module.py"
    pattern = re.compile(r"^\s*(import|from)\s+(jax|flax|vit_pruning_tpu)(\s|\.|$)", re.M)
    assert not pattern.findall(src.read_text())
    out = subprocess.run([sys.executable, "-c", IMPORT_MODULE], capture_output=True, text=True,
                         check=True, cwd=src.parents[2])
    assert out.stdout.strip() == "True []", out.stdout + out.stderr
