"""The port's training path (vit_pruning_tpu_torch/train/, the training
branches of models/pruned_vit.py, checkpoint.py, models/api.py) against the
JAX package's, float32 on the CPU.

total_loss_fn's value (atol 2e-5 + rtol 1e-5) and its gradient on every leaf
(within 1e-4 of the leaf's largest |gradient|) in modes mask / topk / oracle
/ none, for every loss type and every predictor loss; the optimizer's update
for identical gradients against optax's (masked_adam with a schedule and
clipping, per_predictor_adam), 1e-6; gradient accumulation against the full
batch; the detached cosine step against the generic one; the distilled
loss under bf16 compute; checkpoints and an exact resume; the eval
metrics against the JAX ones. On the CPU the
layer kernels' wrappers run their plain versions, B1 and B5 through their
autograd Function (forward the plain version, backward the eager layer).

A keep mask or an oracle label is only comparable where no score or
similarity sits on its cut: the loss cases assert a gap above 1e-5 in the
JAX run. Predictor weights are scaled (GAIN) to spread the scores.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import as_numpy, init_pruned, jax_and_torch_params, randn
from vit_pruning_tpu.configs import PruneConfig, ViTConfig
from vit_pruning_tpu.train import freeze as jfreeze
from vit_pruning_tpu.train import harness as jharness
from vit_pruning_tpu.train import metrics as jmetrics
from vit_pruning_tpu_torch import checkpoint as tckpt
from vit_pruning_tpu_torch.models import pruned_vit as tp
from vit_pruning_tpu_torch.models.convert import params_to_numpy
from vit_pruning_tpu_torch.models.convert import flatten_tree
from vit_pruning_tpu_torch.train import freeze as tfreeze
from vit_pruning_tpu_torch.train import harness as th
from vit_pruning_tpu_torch.train import metrics as tmetrics

CFG = ViTConfig(image_size=16, patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
                mlp_dim=64, num_labels=4)
GAIN = 10.0
MIN_GAP = 1e-5


def _params(pcfg, seed=0):
    params = init_pruned(CFG, pcfg, seed)
    params["predictor"] = jax.tree.map(lambda a: a * GAIN, params["predictor"])
    return jax_and_torch_params(params)


def _batch(seed=1, b=4):
    x = randn(seed, (b, 3, 16, 16))
    labels = np.random.RandomState(seed + 100).randint(0, CFG.num_labels, b).astype(np.int32)
    return ({"pixel_values": jnp.asarray(x), "labels": jnp.asarray(labels)},
            {"pixel_values": torch.from_numpy(x), "labels": torch.from_numpy(labels).long()})


def _leaves(tree):
    return [t for _, t in flatten_tree(tree)]


def _grad_case(pcfg, loss_type):
    """(JAX value, JAX grads, port value, port grads, JAX metrics, port
    metrics) of total_loss_fn on one batch."""
    jparams, tparams = _params(pcfg)
    jb, tb = _batch()
    (jv, jm), jg = jax.value_and_grad(jharness.total_loss_fn, has_aux=True)(
        jparams, jb, CFG, pcfg, loss_type, jax.random.PRNGKey(0))
    leaves = _leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    tv, tm = th.total_loss_fn(tparams, tb, CFG, pcfg, loss_type,
                              torch.Generator().manual_seed(0))
    grads = (torch.autograd.grad(tv, leaves, allow_unused=True) if tv.requires_grad
             else [None] * len(leaves))
    tg = [torch.zeros_like(t) if g is None else g for t, g in zip(leaves, grads)]
    return jv, jg, tv, tg, jm, tm


def _assert_gaps(pcfg):
    """No predictor score and no oracle similarity within MIN_GAP of its cut
    (in the JAX run)."""
    from vit_pruning_tpu.models.pruned_vit import pruned_vit_forward

    jparams, _ = _params(pcfg)
    jb, _ = _batch()
    out = pruned_vit_forward(jparams, jb["pixel_values"], CFG, pcfg, train=True,
                             oracle=True, rng=jax.random.PRNGKey(0))
    sim = np.asarray(out["aux"]["similarity"])
    scores = np.asarray(out["scores"])
    active = np.ones(CFG.num_layers, bool) if pcfg.mode != "none" else np.zeros(
        CFG.num_layers, bool)
    gaps = [np.abs(sim[active] - pcfg.sim_threshold).min()] if active.any() else []
    if pcfg.mode == "mask":
        gaps.append(np.abs(scores - pcfg.mlp_threshold).min())
    if pcfg.mode == "topk":
        srt = -np.sort(-scores, axis=-1)
        gaps.append((srt[..., pcfg.top_k - 1] - srt[..., pcfg.top_k]).min())
    assert not gaps or min(gaps) > MIN_GAP, f"a decision within {MIN_GAP} of its cut: {gaps}"


LOSSES = ("bce_oracle", "mse_cosine", "mse_attention", "focal")
MODES = ("mask", "topk", "oracle", "none")
# every mode with every loss type, the predictor loss rotating so that each
# mode also meets every predictor loss (the fourth under 'both')
CASES = [(mode, lt, LOSSES[(i + j) % 4]) for i, mode in enumerate(MODES)
         for j, lt in enumerate(("cosine", "classification", "both"))]
CASES += [(mode, "both", LOSSES[(i + 3) % 4]) for i, mode in enumerate(MODES)]


@pytest.mark.parametrize("mode,loss_type,loss", CASES)
def test_total_loss_value_and_grads_match_jax(mode, loss_type, loss):
    pcfg = PruneConfig(mode=mode, predictor="cls_mlp" if mode != "none" else "none",
                       loss=loss, top_k=2, mlp_threshold=0.5, sim_threshold=0.6)
    _assert_gaps(pcfg)
    jv, jg, tv, tg, jm, tm = _grad_case(pcfg, loss_type)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5, atol=2e-5)
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]))
    if "confusion" in jm:
        np.testing.assert_array_equal(tm["confusion"].numpy(), np.asarray(jm["confusion"]))
    assert ("confusion" in tm) == ("confusion" in jm)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(tg)
    for a, b in zip(tg, jleaves):
        b = np.asarray(b)
        scale = float(np.abs(b).max())
        # + 1e-8: the key bias's exact gradient is 0 (a constant added to every
        # logit of a row leaves its softmax unchanged); both sides hold f32
        # noise of ~1e-12 there
        np.testing.assert_allclose(as_numpy(a), b, rtol=0, atol=1e-4 * scale + 1e-8)


def test_topk_prog_trains_as_topk_and_random_draws_outside():
    """topk_prog under training is topk (same outputs), and mode random's
    loss is finite with a graph to the backbone and the predictor."""
    pcfg = PruneConfig(mode="topk", predictor="cls_mlp", loss="bce_oracle", top_k=2)
    _, tparams = _params(pcfg)
    _, tb = _batch()
    a = tp.pruned_vit_forward(tparams, tb["pixel_values"], CFG, pcfg, train=True)
    b = tp.pruned_vit_forward(tparams, tb["pixel_values"], CFG, pcfg.replace(mode="topk_prog"),
                              train=True)
    torch.testing.assert_close(a["logits"], b["logits"], rtol=0, atol=0)
    torch.testing.assert_close(a["aux"]["pred_loss"], b["aux"]["pred_loss"], rtol=0, atol=0)
    pr = pcfg.replace(mode="random")
    leaves = _leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    loss, m = th.total_loss_fn(tparams, tb, CFG, pr, "both", torch.Generator().manual_seed(0))
    loss.backward()
    assert torch.isfinite(loss)
    assert tparams["backbone"]["layers"]["attn"]["q"]["w"].grad.abs().max() > 0
    assert tparams["predictor"]["mlp"]["l0"]["w"].grad.abs().max() > 0


@pytest.mark.parametrize("mode", ["mask", "topk", "random"])
def test_remat_gives_the_same_loss_and_grads(mode):
    """remat=True recomputes each layer (torch.utils.checkpoint): the same
    loss and gradients; mode random's mask is drawn outside the
    checkpointed layer, so the recompute sees it."""
    pcfg = PruneConfig(mode=mode, predictor="cls_mlp", loss="mse_cosine", top_k=2)
    _, tparams = _params(pcfg)
    _, tb = _batch()
    leaves = _leaves(tparams)
    for t in leaves:
        t.requires_grad_(True)
    res = []
    for remat in (False, True):
        loss, _ = th.total_loss_fn(tparams, tb, CFG, pcfg, "both",
                                   torch.Generator().manual_seed(7), remat=remat)
        res.append((loss.detach(), torch.autograd.grad(loss, leaves, allow_unused=True)))
    torch.testing.assert_close(res[0][0], res[1][0], rtol=0, atol=0)
    for a, b in zip(res[0][1], res[1][1]):
        if a is None or b is None:
            assert a is None and b is None
        else:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _opt_case(kind):
    pcfg = PruneConfig(mode="mask", predictor="cls_mlp", loss="bce_oracle")
    jparams, tparams = _params(pcfg)
    if kind == "clip_schedule":
        sched = optax.warmup_cosine_decay_schedule(1e-4, 1e-2, 2, 10, 1e-4)
        jopt = jfreeze.masked_adam(jparams, "vit_mlp_train", sched, clip_norm=1.0)
        topt = tfreeze.masked_adam(tparams, "vit_mlp_train", lambda c: float(sched(c)),
                                   clip_norm=1.0)
    elif kind == "per_predictor":
        scales = [0.5, 2.0]
        jopt = jfreeze.per_predictor_adam(jparams, 1e-3, scales)
        topt = tfreeze.per_predictor_adam(tparams, 1e-3, scales)
    else:
        jopt = jfreeze.masked_adam(jparams, kind, 1e-3)
        topt = tfreeze.masked_adam(tparams, kind, 1e-3)
    return jparams, tparams, jopt, topt


@pytest.mark.parametrize("kind", ["vit_train", "mlp_train", "classifier_mlp_train",
                                  "clip_schedule", "per_predictor"])
def test_optimizer_update_matches_optax(kind):
    """Given identical gradients, three updates of the port's Adam equal
    optax's, leaf for leaf (1e-6), frozen leaves none (and no state)."""
    jparams, tparams, jopt, topt = _opt_case(kind)
    state = jopt.init(jparams)
    mask = jax.tree.leaves(jfreeze.freeze_mask(jparams, kind if kind in jfreeze.POLICIES
                                               else ("mlp_train" if kind == "per_predictor"
                                                     else "vit_mlp_train")))
    tleaves = _leaves(tparams)
    for step in range(3):
        g_np = [np.random.RandomState(10 * step + i).randn(*np.shape(a)).astype(np.float32)
                * (1e3 if kind == "clip_schedule" else 1.0)
                for i, a in enumerate(jax.tree.leaves(jparams))]
        jg = jax.tree.unflatten(jax.tree.structure(jparams), [jnp.asarray(g) for g in g_np])
        jupd, state = jopt.update(jg, state, jparams)
        for t, g, m in zip(tleaves, g_np, mask):
            t.grad = torch.from_numpy(g) if m else None
        tupd = iter(topt.updates())
        for t, u, m in zip(tleaves, jax.tree.leaves(jupd), mask):
            assert t.requires_grad == bool(m)
            if m:
                np.testing.assert_allclose(as_numpy(next(tupd)), np.asarray(u), rtol=0,
                                           atol=1e-6)
            else:
                assert float(np.abs(np.asarray(u)).max()) == 0.0
    n_trainable = sum(bool(m) for m in mask)
    assert len(topt.state) == n_trainable


def _steps(pcfg, loss_type, policy, **kw):
    _, tparams = _params(pcfg)
    opt = tfreeze.masked_adam(tparams, policy, 1e-2)
    return tparams, opt, th.make_train_step(CFG, pcfg, loss_type, opt, **kw)


def test_grad_accumulation_matches_full_batch():
    pcfg = PruneConfig(mode="mask", predictor="cls_mlp", loss="bce_oracle")
    _, tb = _batch(b=8)
    res = []
    for accum in (1, 2):
        tparams, opt, step = _steps(pcfg, "both", "vit_mlp_train", accum_steps=accum)
        m = step(tparams, tb, torch.Generator().manual_seed(0))
        res.append((tparams, m, [p.grad for p in _leaves(tparams)]))
    (p1, m1, g1), (p2, m2, g2) = res
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(m1["confusion"], m2["confusion"], rtol=0, atol=0)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for a, b in zip(_leaves(p1), _leaves(p2)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="not divisible"):
        _steps(pcfg, "both", "vit_mlp_train", accum_steps=3)[2](p1, tb)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("mode", ["mask", "topk"])
def test_detached_cosine_step_matches_generic(mode, loss):
    """The detached predictor step updates the params as the generic step."""
    pcfg = PruneConfig(mode=mode, predictor="cls_mlp", loss=loss, top_k=2)
    _, tb = _batch()
    res = []
    for detach in (False, True):
        tparams, opt, step = _steps(pcfg, "cosine", "mlp_train", detach_cosine=detach)
        m = step(tparams, tb, torch.Generator().manual_seed(3))
        res.append((tparams, m))
    (pg, mg), (pd, md) = res
    np.testing.assert_allclose(float(mg["pred_loss"]), float(md["pred_loss"]), rtol=1e-5)
    torch.testing.assert_close(mg["confusion"], md["confusion"], rtol=0, atol=0)
    for a, b in zip(_leaves(pg), _leaves(pd)):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-6)


def test_mixed_precision_step_keeps_f32_master_params():
    pcfg = PruneConfig(mode="mask", predictor="cls_mlp", loss="bce_oracle")
    tparams, opt, step = _steps(pcfg, "both", "vit_mlp_train", compute_dtype=torch.bfloat16)
    before = [t.detach().clone() for t in _leaves(tparams)]
    m = step(tparams, _batch()[1], torch.Generator().manual_seed(0))
    assert np.isfinite(float(m["loss"]))
    assert all(t.dtype == torch.float32 for t in _leaves(tparams))
    assert max(float((a.detach() - b).abs().max())
               for a, b in zip(_leaves(tparams), before)) > 0


def test_distilled_loss_under_bf16_compute_matches_jax():
    """A bf16 student (compute_dtype casts params and pixels) distilled from
    an f32 teacher, as quality_torch.py --bf16 recovers a structured preset:
    the teacher runs in its own dtype on the cast pixels, as jnp promotes
    bf16 pixels against f32 weights. The loss within bf16's rounding
    (rtol 2e-2: 8 mantissa bits through two layers) of the JAX package's."""
    pcfg = PruneConfig(mode="mask", predictor="cls_mlp", loss="bce_oracle")
    (jp, tp), (jt, tt) = _params(pcfg), _params(pcfg, seed=1)
    jb, tb = _batch()
    jv, _ = jharness.total_loss_fn(
        jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp),
        dict(jb, pixel_values=jb["pixel_values"].astype(jnp.bfloat16)), CFG, pcfg,
        "classification", jax.random.PRNGKey(0), distill=(jt, CFG, 0.5, 2.0))
    tv, _ = th.total_loss_fn(
        th._cast(tp, torch.bfloat16), dict(tb, pixel_values=tb["pixel_values"].bfloat16()),
        CFG, pcfg, "classification", torch.Generator().manual_seed(0),
        distill=(tt, CFG, 0.5, 2.0))
    np.testing.assert_allclose(float(tv.float()), float(jv), rtol=2e-2)


def _loader(seed=0, n=4, b=4):
    rs = np.random.RandomState(seed)
    return [{"pixel_values": torch.from_numpy(rs.randn(b, 3, 16, 16).astype(np.float32)),
             "labels": torch.from_numpy(rs.randint(0, 4, b)).long()} for _ in range(n)]


def test_checkpoint_roundtrip_and_best(tmp_path):
    pcfg = PruneConfig(mode="mask", predictor="cls_mlp", loss="bce_oracle")
    _, tparams = _params(pcfg)
    path = str(tmp_path / "ckpt" / "params")
    tckpt.save_checkpoint(path, {"params": tparams, "epoch": 3})
    zeroed = jax.tree.map(torch.zeros_like, tparams)
    got = tckpt.restore_checkpoint(path, {"params": zeroed})
    assert got["epoch"] == 3 and got["params"]["backbone"]["head"]["w"] is \
        zeroed["backbone"]["head"]["w"]  # restored in place
    for a, b in zip(_leaves(tparams), _leaves(zeroed)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    best = tckpt.BestCheckpoint()
    assert best.update(0.5, tparams) and not best.update(0.4, tparams)
    with torch.no_grad():
        tparams["backbone"]["head"]["w"].add_(1.0)  # the step updates in place
    assert not torch.equal(best.best_params["backbone"]["head"]["w"],
                           tparams["backbone"]["head"]["w"])


@pytest.mark.parametrize("loss_type", ["cosine", "alternate"])
def test_train_resume_exact(tmp_path, loss_type):
    """Two epochs straight equal one epoch, then a resume from state_dir for
    the second: params, optimizer state and epoch restored."""
    pcfg = PruneConfig(mode="mask", predictor="cls_mlp", loss="bce_oracle")
    data = _loader()
    kw = dict(loss_type=loss_type, lr=1e-3, full_testing=False)
    p_full = th.train(_params(pcfg)[1], data, data[:1], CFG, pcfg, num_epochs=2,
                      state_dir=str(tmp_path / "full"), **kw)
    th.train(_params(pcfg)[1], data, data[:1], CFG, pcfg, num_epochs=1,
             state_dir=str(tmp_path / "r"), **kw)
    lines = []
    p2 = th.train(_params(pcfg)[1], data, data[:1], CFG, pcfg, num_epochs=2,
                  state_dir=str(tmp_path / "r"), log=lines.append, **kw)
    assert any("resumed" in ln and "epoch 1" in ln for ln in lines)
    for a, b in zip(_leaves(p_full), _leaves(p2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_phased_train_runs_both_phases(tmp_path):
    """phased_train on the CPU: the predictor phase moves only the
    predictors, the classification phase the backbone; the reports print."""
    pcfg = PruneConfig(mode="mask", predictor="cls_mlp", loss="bce_oracle")
    _, tparams = _params(pcfg)
    before = params_to_numpy(tparams)
    data = _loader(n=2)
    lines = []
    best = tckpt.BestCheckpoint(str(tmp_path), "run")
    th.phased_train(tparams, data, data[:1], CFG, pcfg, num_epochs=(1, 1), lrs=(1e-3, 1e-3),
                    log=lines.append, best=best)
    text = "\n".join(lines)
    assert "Skip ratio" in text and "Confusion matrix for each layer" in text
    assert "Per-predictor training accuracy" in text
    after = params_to_numpy(tparams)
    assert np.abs(after["predictor"]["mlp"]["l0"]["w"]
                  - before["predictor"]["mlp"]["l0"]["w"]).max() > 0
    assert np.abs(after["backbone"]["layers"]["mlp"]["fc1"]["w"]
                  - before["backbone"]["layers"]["mlp"]["fc1"]["w"]).max() > 0
    # viz_dir: each epoch's keep-mask montages of the first test batch's first two images
    th.train(tparams, data, data, CFG, pcfg, num_epochs=2, viz_dir=str(tmp_path / "v"))
    assert sorted(p.name for p in (tmp_path / "v").iterdir()) == [
        f"step{e}_img{i}.png" for e in (0, 1) for i in (0, 1)]


def test_eval_metrics_match_jax():
    """EvalAccumulator and MLPTracker: the port's copy against the JAX
    package's on the same counts, reports included."""
    rs = np.random.RandomState(0)
    ja, ta = jmetrics.EvalAccumulator(3), tmetrics.EvalAccumulator(3)
    jt, tt = jmetrics.MLPTracker(3), tmetrics.MLPTracker(3)
    for _ in range(3):
        conf = rs.randint(0, 50, (3, 2, 2))
        km = rs.rand(3, 4, 5) > 0.4
        for acc in (ja, ta):
            acc.update(correct=7, batch=10, confusion=conf, keep_masks=km)
        jt.update(conf)
        tt.update(conf)
    for name in ("accuracy", "mlp_accuracy"):
        assert getattr(ja, name) == getattr(ta, name)
    for name in ("oracle_skip_per_layer", "measured_skip_per_layer", "mlp_accuracy_per_layer",
                 "class_accuracy_per_layer"):
        np.testing.assert_array_equal(getattr(ta, name), getattr(ja, name))
    assert ta.report() == ja.report() and tt.report() == jt.report()
    for name in ("samples", "positives", "accuracy", "class_accuracy"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))


@pytest.mark.parametrize("policy", tfreeze.POLICIES)
def test_freeze_mask_matches_jax(policy):
    pcfg = PruneConfig(mode="mask", predictor="cls_mlp", skip_correction="updatenet")
    params = init_pruned(CFG, pcfg)
    jm = jfreeze.freeze_mask(params, policy)
    tm = tfreeze.freeze_mask(jax_and_torch_params(params)[1], policy)
    assert jax.tree.structure(jm) == jax.tree.structure(tm)
    assert jax.tree.leaves(jm) == jax.tree.leaves(tm)
    for lt in ("cosine", "classification", "both", "alternate"):
        assert tfreeze.policy_for_loss_type(lt) == jfreeze.policy_for_loss_type(lt)
    with pytest.raises(ValueError, match="policy"):
        tfreeze.freeze_mask(params, "freeze_all")


def test_param_count_and_predictor_filter_match_jax():
    from vit_pruning_tpu.models import predictors as jpred
    from vit_pruning_tpu.models import vit as jvit
    from vit_pruning_tpu_torch.models import predictors as tpred
    from vit_pruning_tpu_torch.models import vit as tvit

    params = init_pruned(CFG, PruneConfig(mode="mask", predictor="cls_mlp"))
    assert tvit.param_count(jax_and_torch_params(params)[1]) == jvit.param_count(params)
    for path in ("predictor/mlp/l0/w", "backbone/head/w", "predictors", "updatenet/w"):
        assert tpred.predictor_param_filter(path) == jpred.predictor_param_filter(path)


@pytest.mark.parametrize("name", ["bce_with_logits", "weighted_bce_oracle", "focal_loss",
                                  "mse_cosine_loss", "mse_attention_loss", "cross_entropy",
                                  "distillation_kl"])
def test_losses_match_jax(name):
    from vit_pruning_tpu.train import losses as jl
    from vit_pruning_tpu_torch.train import losses as tl_

    rs = np.random.RandomState(0)
    s = (1.0 / (1.0 + np.exp(-rs.randn(4, 9)))).astype(np.float32)
    keep = rs.rand(4, 9) > 0.4
    tgt = rs.rand(4, 9).astype(np.float32)
    logits, other = rs.randn(2, 4, 10).astype(np.float32)
    labels = rs.randint(0, 10, 4).astype(np.int32)
    args = {"bce_with_logits": (s, keep.astype(np.float32), 1.7),
            "weighted_bce_oracle": (s, keep), "focal_loss": (s, keep), "mse_cosine_loss": (s, tgt),
            "mse_attention_loss": (s, tgt), "cross_entropy": (logits, labels),
            "distillation_kl": (logits, other)}[name]
    want = float(getattr(jl, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                      for a in args)))
    def as_t(a):
        if not isinstance(a, np.ndarray):
            return a
        return torch.from_numpy(a).long() if a.dtype == np.int32 else torch.from_numpy(a)

    got = getattr(tl_, name)(*(as_t(a) for a in args))
    np.testing.assert_allclose(float(got), want, rtol=1e-6, atol=1e-7)


def test_modified_vit_model_matches_jax(tmp_path):
    """ModifiedViTModel: an HF state dict loaded into the backbone (the
    predictor kept), eval and train calls against the JAX wrapper's, and
    the freeze-policy methods."""
    from transformers import ViTConfig as HFViTConfig
    from transformers import ViTForImageClassification

    from vit_pruning_tpu.models.api import ModifiedViTModel as JModel
    from vit_pruning_tpu_torch.configs import ViTConfig as TViTConfig
    from vit_pruning_tpu_torch.models.api import ModifiedViTModel as TModel

    torch.manual_seed(0)
    hf = ViTForImageClassification(HFViTConfig(
        image_size=16, patch_size=8, hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, num_labels=4, attn_implementation="eager")).eval()
    pcfg = PruneConfig(mode="topk", predictor="cls_mlp", loss="bce_oracle", top_k=2)
    jparams, tparams = _params(pcfg)
    tcfg = TViTConfig(image_size=16, patch_size=8, hidden_size=32, num_layers=2, num_heads=2,
                      mlp_dim=64, num_labels=4)
    jm = JModel(CFG, prune_config=pcfg, params=jparams).load_torch_state_dict(hf.state_dict())
    tm = TModel(tcfg, prune_config=pcfg, params=tparams, device="cpu").load_torch_state_dict(
        hf.state_dict())
    x = randn(9, (4, 3, 16, 16))
    for train, cos in ((False, False), (False, True), (True, False)):
        ja, ta = (jm.train() if train else jm.eval()), (tm.train() if train else tm.eval())
        jo = ja(jnp.asarray(x), compute_cosine=cos)
        with torch.no_grad():
            to = ta(torch.from_numpy(x), compute_cosine=cos)
        np.testing.assert_allclose(as_numpy(to.logits), np.asarray(jo.logits), atol=1e-4,
                                   rtol=1e-4)
        np.testing.assert_array_equal(to.boolean_masks.numpy(), np.asarray(jo.boolean_masks))
        assert hasattr(to, "layer_losses") == hasattr(jo, "layer_losses")
        if hasattr(jo, "layer_losses"):
            np.testing.assert_allclose(as_numpy(to.layer_losses), np.asarray(jo.layer_losses),
                                       atol=2e-5, rtol=1e-5)
    for policy in tfreeze.POLICIES:
        assert getattr(tm, policy)().policy == policy
    with pytest.raises(ValueError, match="policy"):
        tm._set_policy("freeze_all")
