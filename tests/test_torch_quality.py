"""quality_torch.py, the port's quality gate, on the CPU: the counterparts of
tests/test_quality.py's nine tests; the warmup-cosine schedule against
optax's at every step; the calibration and measurement helpers on params
from params_from_jax against quality.py's; and a tiny real run whose JSON
line has the keys quality.py's main writes."""

import argparse
import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import quality  # noqa: E402
import quality_torch  # noqa: E402
from vit_pruning_tpu.configs import PruneConfig as JPrune  # noqa: E402
from vit_pruning_tpu.configs import ViTConfig as JViT  # noqa: E402
from vit_pruning_tpu.models.pruned_vit import init_pruned_vit_params as j_init  # noqa: E402
from vit_pruning_tpu_torch.configs import PruneConfig, ViTConfig, schedule_live  # noqa: E402
from vit_pruning_tpu_torch.models.convert import (  # noqa: E402
    flatten_tree,
    params_from_jax,
    unflatten_tree,
)
from vit_pruning_tpu_torch.models.pruned_vit import (  # noqa: E402
    init_pruned_vit_params,
    pruned_vit_forward,
)
from vit_pruning_tpu_torch.ops.dispatch import set_kernel_mode  # noqa: E402

GEOM = dict(image_size=16, patch_size=4, hidden_size=32, num_layers=4, num_heads=2, mlp_dim=64,
            num_labels=8)
CFG, JCFG = ViTConfig(**GEOM), JViT(**GEOM)
# the calibration helpers' values: medians / quantiles of f32 activations and
# scores, which the two packages compute in another order
CAL_TOL = 2e-5


def _init(pcfg, seed=0):
    return init_pruned_vit_params(CFG, pcfg, torch.Generator().manual_seed(seed), "cpu")


def _pixels(seed, b=16):
    return np.random.RandomState(seed).randn(b, 3, 16, 16).astype(np.float32)


@pytest.fixture(autouse=True)
def _restore_kernel_mode():
    yield
    set_kernel_mode("auto")


def test_calibrate_serving_mask_threshold_pins_keep_rate_and_budget():
    pcfg = PruneConfig(mode="topk", predictor="cls_mlp", top_k=8)
    params = _init(pcfg)
    x = torch.from_numpy(_pixels(1))
    mt = quality_torch.calibrate_serving_mask_threshold(params, {"pixel_values": x}, CFG, pcfg,
                                                        keep_rate=0.5)
    assert len(mt) == CFG.num_layers
    serve = pcfg.replace(mode="mask", mlp_threshold=mt, mask_budget=8, keep_schedule=None)
    masks = pruned_vit_forward(params, x, CFG, serve)["keep_masks"].numpy()  # [L, B, S]
    assert masks[:, :, 1:].sum(-1).max() <= 8
    assert 0.2 <= masks[:, :, 1:].mean() <= 0.62


def _fake_train_and_eval(calls):
    def fake(config, pcfg, train_b, test_b, args, log, base_params=None, structured=False,
             teacher=None):
        params = _init(pcfg, 42) if config.num_labels == CFG.num_labels else \
            init_pruned_vit_params(config, pcfg, torch.Generator().manual_seed(42), "cpu")
        calls["trained"].append(pcfg.mode)
        calls["pcfgs"].append(pcfg)
        calls["train_params"].append(params)
        if pcfg.keep_schedule:
            live = schedule_live(pcfg.keep_schedule, config.num_patches)
            skip = 1.0 - (sum(live) / len(live)) / (config.num_patches + 1)
        else:
            skip = 0.5
        extra = {"predictor_capture_min": 0.9} if structured else {}
        return (0.9, 0.9, 0.9, skip, 0.88 if structured else None, params, extra)
    return fake


def _fake_measure(calls):
    def fake(params, eval_cfg, pcfg, train_b, test_b, args, log, structured):
        calls["measured"].append(pcfg)
        calls["pcfgs"].append(pcfg)
        calls["measured_params"].append(params)
        return (0.9, 0.9, 0.9, 0.5, None, params, {})
    return fake


def _run_faked(monkeypatch, capsys, tmp_path, extra=()):
    calls = {k: [] for k in ("trained", "pcfgs", "train_params", "measured", "measured_params")}
    monkeypatch.setattr(quality_torch, "train_and_eval", _fake_train_and_eval(calls))
    monkeypatch.setattr(quality_torch, "measure_preset", _fake_measure(calls))
    rc = quality_torch.main(["--preset", "all", "--train_size", "64", "--test_size", "32",
                             "--batch", "16", "--device", "cpu", "--cache_dir", str(tmp_path),
                             *extra])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1]), calls


def test_quality_mask_preset_serves_headline_weights(monkeypatch, capsys, tmp_path):
    rc, results, calls = _run_faked(monkeypatch, capsys, tmp_path)
    assert rc == 0
    assert calls["trained"] == ["none", "topk", "topk_prog", "topk_prog"]
    assert len(calls["measured"]) == 1
    serve = calls["measured"][0]
    assert serve.mode == "mask" and serve.mask_budget is not None
    assert isinstance(serve.mlp_threshold, tuple) and len(serve.mlp_threshold) == 6
    assert calls["measured_params"][0] is calls["train_params"][1]
    m = results["presets"]["mask"]
    assert m["serving_config"]["mode"] == "mask" and m["serving_config"]["mask_budget"] == 32
    assert set(m["gates"]) >= {"delta", "delta_int8", "skip", "predictor"}
    assert results["pass"] is True


def test_quality_merge_dropped_flag_flips_topk_prog_presets(monkeypatch, capsys, tmp_path):
    rc, results, calls = _run_faked(monkeypatch, capsys, tmp_path, ["--merge_dropped"])
    assert rc == 0
    by_mode = {}
    for pc in calls["pcfgs"]:
        by_mode.setdefault(pc.mode, pc)
    assert by_mode["topk_prog"].merge_dropped is True
    assert by_mode["topk"].merge_dropped is False
    assert by_mode["mask"].merge_dropped is False
    assert results["presets"]["composed"]["serving_config"]["merge_dropped"] is True
    assert results["presets"]["headline"]["serving_config"]["merge_dropped"] is False


def test_faked_run_writes_quality_pys_json(monkeypatch, capsys, tmp_path):
    """The same faked preset results through both mains: the same JSON line
    (key for key, value for value) and exit code."""
    rc_t, results_t, _ = _run_faked(monkeypatch, capsys, tmp_path, ["--merge_ablation"])

    def jfake_train(config, pcfg, train_b, test_b, args, log, base_params=None,
                    structured=False, teacher=None):
        if pcfg.keep_schedule:
            from vit_pruning_tpu.configs import schedule_live as j_live

            live = j_live(pcfg.keep_schedule, config.num_patches)
            skip = 1.0 - (sum(live) / len(live)) / (config.num_patches + 1)
        else:
            skip = 0.5
        extra = {"predictor_capture_min": 0.9} if structured else {}
        return (0.9, 0.9, 0.9, skip, 0.88 if structured else None, {"p": 1}, extra)

    monkeypatch.setattr(quality, "train_and_eval", jfake_train)
    monkeypatch.setattr(quality, "measure_preset",
                        lambda params, *a, **k: (0.9, 0.9, 0.9, 0.5, None, params, {}))
    monkeypatch.setattr(quality_torch.tempfile, "gettempdir", lambda: str(tmp_path))
    monkeypatch.setattr(quality, "_cached_synthetic", quality_torch._cached_synthetic)
    monkeypatch.setattr(quality, "DeviceBatches", lambda *a, **k: [{"pixel_values": None}])
    monkeypatch.setattr(quality, "calibrate_serving_mask_threshold",
                        lambda params, probe, config, pcfg, keep_rate: results_t["presets"][
                            "mask"]["serving_config"]["mlp_threshold"])
    rc_j = quality.main(["--preset", "all", "--train_size", "64", "--test_size", "32",
                         "--batch", "16", "--merge_ablation"])
    results_j = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    set_kernel_mode("auto")
    from vit_pruning_tpu.ops.dispatch import set_kernel_mode as j_set

    j_set("auto")
    assert rc_t == rc_j == 0
    assert results_t == results_j


def test_cached_synthetic_roundtrip_byte_identical(tmp_path, monkeypatch):
    from vit_pruning_tpu_torch.data.datasets import synthetic_localized_dataset

    monkeypatch.setattr(quality_torch.tempfile, "gettempdir", lambda: str(tmp_path))
    kw = dict(seed=3, label_noise=0.1, signal_patches=8, cell=4)
    fresh = synthetic_localized_dataset(32, 32, 16, **kw)
    built = quality_torch._cached_synthetic(32, 32, 16, **kw)
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].startswith("torch_synth_localized_")
    cached = quality_torch._cached_synthetic(32, 32, 16, **kw)
    for a, b, c in zip(fresh, built, cached):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    # another task is another key; --cache_dir's directory is made when missing
    quality_torch._cached_synthetic(32, 32, 16, task="distributed", **kw)
    assert len(os.listdir(tmp_path)) == 2
    quality_torch._cached_synthetic(8, 32, 16, directory=str(tmp_path / "flag"), **kw)
    assert len(os.listdir(tmp_path / "flag")) == 1


def test_build_task_bench_scale_models(tmp_path, monkeypatch):
    base = dict(image_size=64, data_path=None, train_size=32, test_size=32, batch=16,
                label_noise=0.1, device="cpu", cache_dir=str(tmp_path))
    for name, dims in (("deit_small", (384, 12, 6, 1536)), ("deit_base", (768, 12, 12, 3072)),
                       ("vit_large", (1024, 24, 16, 4096))):
        config, train_b, test_b = quality_torch.build_task(
            argparse.Namespace(gate_model=name, **base))
        assert (config.hidden_size, config.num_layers, config.num_heads, config.mlp_dim) == dims
        assert config.num_labels == 128 and config.image_size == 64
        b = next(iter(train_b))
        assert tuple(b["pixel_values"].shape) == (16, 3, 64, 64)


def test_build_task_gate_model_batches_equal_quality_pys(tmp_path, monkeypatch):
    """The gate model's task: the same config and the same batches, in order,
    as quality.py's build_task (pixels within the preprocess tolerance)."""
    monkeypatch.setattr(quality_torch.tempfile, "gettempdir", lambda: str(tmp_path))
    monkeypatch.setattr(quality, "_cached_synthetic", quality_torch._cached_synthetic)
    base = dict(gate_model="gate", image_size=None, data_path=None, train_size=48,
                test_size=32, batch=16, label_noise=0.1, signal_patches=None)
    for task in ("localized", "distributed"):
        ct, tt, et = quality_torch.build_task(argparse.Namespace(task=task, device="cpu", **base))
        cj, tj, ej = quality.build_task(argparse.Namespace(task=task, **base))
        assert ct.to_json() == cj.to_json()
        for bt, bj in zip(list(tt) + list(et), list(tj) + list(ej)):
            np.testing.assert_array_equal(bt["labels"].numpy(), np.asarray(bj["labels"]))
            np.testing.assert_allclose(bt["pixel_values"].numpy(), np.asarray(bj["pixel_values"]),
                                       rtol=0, atol=1e-6)


def test_merge_results_preserves_presets_at_both_levels():
    silent = lambda *a: None  # noqa: E731
    run1 = {"dense_top1": 0.9, "presets": {"composed": {"pass": True}}, "pass": True}
    run2 = {"dense_top1": 0.9, "presets": {"headline": {"pass": True}}, "pass": True}
    f = dict(run1)
    f["old_section"] = {"presets": {"x": {"pass": False}}, "pass": False}
    quality_torch.merge_results(f, run2, None, silent)
    assert set(f["presets"]) == {"composed", "headline"} and f["pass"] is True
    assert f["old_section"]["presets"] == {"x": {"pass": False}}
    run3 = {"dense_top1": 0.9, "presets": {"headline": {"pass": False}}, "pass": False}
    quality_torch.merge_results(f, run3, None, silent)
    assert set(f["presets"]) == {"composed", "headline"} and f["pass"] is False
    g = {"s": dict(run1)}
    quality_torch.merge_results(g, run2, "s", silent)
    assert set(g["s"]["presets"]) == {"composed", "headline"} and g["s"]["pass"] is True
    run4 = {"dense_top1": 0.8, "presets": {"mask": {"pass": True, "dense_top1": 0.8}},
            "pass": True}
    g["s"]["presets"]["headline"]["dense_top1"] = 0.9
    quality_torch.merge_results(g, run4, "s", silent)
    assert g["s"]["mixed_dense_baselines"] == [0.8, 0.9]
    # and the schema validator is quality.py's
    assert quality_torch.SCHEMA_VERSION == quality.SCHEMA_VERSION
    assert quality_torch.validate_section({}) == quality.validate_section({})


def test_per_predictor_adam_skips_shared_subtrees():
    from vit_pruning_tpu_torch.train.freeze import masked_adam, per_predictor_adam

    L, scales = 3, (1.0, 2.0, 4.0)

    def params():
        return {"backbone": {"w": torch.ones(4, 4)},
                "predictor": {"mlp": {"w": torch.ones(L, 5, 5)},
                              "shared_net": {"b": torch.ones(L)}}}

    updates = []
    for make in (lambda p: per_predictor_adam(p, 1e-3, lr_scales=scales),
                 lambda p: masked_adam(p, "mlp_train", 1e-3)):
        p = params()
        opt = make(p)
        for _, leaf in flatten_tree(p):
            leaf.grad = torch.ones_like(leaf)
        updates.append(opt.updates())
    (stacked, shared), (ref_stacked, ref_shared) = updates
    for i, s in enumerate(scales):
        torch.testing.assert_close(stacked[i], ref_stacked[i] * s, rtol=1e-6, atol=0)
    torch.testing.assert_close(shared, ref_shared, rtol=1e-6, atol=0)


def test_measure_preset_merge_ablation_records_both_variants():
    pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention", top_k=8,
                       keep_schedule=(8, 4, 0, 0))
    params = _init(pcfg)
    rs = np.random.RandomState(2)
    batch = [{"pixel_values": torch.from_numpy(_pixels(1)),
              "labels": torch.from_numpy(rs.randint(0, 8, 16))}]
    out = {}
    for flag in ("merge_dropped", "merge_ablation"):
        args = SimpleNamespace(merge_ablation=(flag == "merge_ablation"))
        pc = pcfg.replace(merge_dropped=(flag == "merge_dropped"))
        acc, _, _, _, _, _, extra = quality_torch.measure_preset(
            params, CFG, pc, batch, batch, args, lambda *a: None, structured=False)
        out[flag] = (acc, extra)
    (acc_m, extra_m), (acc_u, extra_u) = out["merge_dropped"], out["merge_ablation"]
    assert extra_m["pruned_top1_nomerge"] == pytest.approx(acc_u, abs=1e-4)
    assert extra_u["pruned_top1_merged"] == pytest.approx(acc_m, abs=1e-4)
    assert extra_m["merge_gain"] == pytest.approx(extra_u["merge_gain"], abs=1e-4)
    assert extra_m["merge_gain"] == pytest.approx(acc_m - acc_u, abs=1e-4)


def test_structured_preset_inherits_trained_predictor(monkeypatch):
    from vit_pruning_tpu_torch.train import harness

    pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention", top_k=8,
                       keep_schedule=(8, 4, 4, 2))
    base = _init(pcfg)
    flat = flatten_tree(base["predictor"])  # sentinel: the trained predictor is all 7.0
    base["predictor"] = unflatten_tree([p for p, _ in flat], [torch.full_like(t, 7.0)
                                                              for _, t in flat])
    batches = [{"pixel_values": torch.from_numpy(_pixels(1, 8)),
                "labels": torch.zeros(8, dtype=torch.long)}]
    train_calls, captured = [], {}

    def fake_train(params, train_b, test_b, config, pc, *, loss_type, **kw):
        train_calls.append(loss_type)
        return params

    def fake_measure(params, eval_cfg, pc, train_b, test_b, args, log, structured):
        captured["params"] = params
        return (0.9, 0.9, 0.9, 0.5, 0.9, params, {})

    monkeypatch.setattr(harness, "train", fake_train)
    monkeypatch.setattr(quality_torch, "measure_preset", fake_measure)
    args = SimpleNamespace(bf16=False, gate_model="gate", epochs=2, pred_epochs=2, pred_lr=3e-3,
                           recover_epochs=1, fresh_structured_predictor=False, device="cpu")
    quality_torch.train_and_eval(CFG, pcfg, batches, batches, args, lambda *a: None,
                                 base_params=base, structured=True, teacher=None)
    assert train_calls == ["classification"]
    pred = flatten_tree(captured["params"]["predictor"])
    assert all(bool((t == 7.0).all()) for _, t in pred), "inherited predictor re-initialized"
    q_w = captured["params"]["backbone"]["layers"]["attn"]["q"]["w"]
    assert q_w.shape[-1] == CFG.hidden_size // 2
    # the base tree is untouched (the preset works on a copy)
    assert base["backbone"]["layers"]["attn"]["q"]["w"].shape[-1] == CFG.hidden_size

    train_calls.clear()
    args.fresh_structured_predictor = True
    quality_torch.train_and_eval(CFG, pcfg, batches, batches, args, lambda *a: None,
                                 base_params=base, structured=True, teacher=None)
    assert train_calls == ["cosine", "classification"]
    pred = flatten_tree(captured["params"]["predictor"])
    assert not all(bool((t == 7.0).all()) for _, t in pred)


@pytest.mark.parametrize("init,peak,warmup,decay,end", [
    (0.0, 5e-4 * 128 / 512, 320, 640, 5e-4 * 128 / 512 * 0.01),  # the bench-scale recipe
    (0.0, 3e-4, 5, 7, 3e-6),
    (1e-5, 1e-3, 0, 100, 0.0),
    (0.0, 1e-3, 33, 1000, 1e-5),
])
def test_warmup_cosine_decay_schedule_against_optax(init, peak, warmup, decay, end):
    """Every step of the schedule (and past its end) within 1e-7 relative of
    optax's, optax evaluated in float64 (the port's schedule returns Python
    floats; in float32 optax's own rounding near the end of the decay
    exceeds 1e-7)."""
    import optax

    ours = quality_torch.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
    steps = np.arange(decay + 20)
    with jax.enable_x64(True):
        ref = optax.warmup_cosine_decay_schedule(init, peak, warmup, decay, end)
        want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)))
    assert want.dtype == np.float64
    got = np.array([ours(int(s)) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    with pytest.raises(ValueError):
        quality_torch.warmup_cosine_decay_schedule(0.0, 1e-3, 10, 10)


def _jax_and_port_params(pcfg_kwargs, gain=10.0):
    """One JAX param tree (PRNGKey 5) for both packages; the predictor's
    weights scaled so that its scores spread away from 0.5."""
    jp = JPrune(**pcfg_kwargs)
    tree = jax.device_get(j_init(jax.random.PRNGKey(5), JCFG, jp))
    tree["predictor"] = jax.tree.map(lambda a: np.asarray(a) * gain, tree["predictor"])
    return tree, params_from_jax(tree, "cpu"), jp, PruneConfig(**pcfg_kwargs)


def test_calibration_helpers_against_quality_py():
    tree, params, jp, tp = _jax_and_port_params(dict(mode="topk", predictor="cls_mlp", top_k=8))
    x = _pixels(3)
    jb, tb = {"pixel_values": jnp.asarray(x)}, {"pixel_values": torch.from_numpy(x)}
    st_j = quality.calibrate_sim_threshold(tree, jb, JCFG, jp)
    st_t = quality_torch.calibrate_sim_threshold(params, tb, CFG, tp)
    np.testing.assert_allclose(st_t, st_j, rtol=0, atol=CAL_TOL)
    # mlp thresholds at the calibrated oracle (the oracle's keep rates must agree first)
    jp2, tp2 = jp.replace(sim_threshold=st_j), tp.replace(sim_threshold=st_j)
    mt_j = quality.calibrate_mlp_threshold(tree, jb, JCFG, jp2)
    mt_t = quality_torch.calibrate_mlp_threshold(params, tb, CFG, tp2)
    np.testing.assert_allclose(mt_t, mt_j, rtol=0, atol=CAL_TOL)
    for rate in (0.5, 0.25):
        sm_j = quality.calibrate_serving_mask_threshold(tree, jb, JCFG, jp, keep_rate=rate)
        sm_t = quality_torch.calibrate_serving_mask_threshold(params, tb, CFG, tp, keep_rate=rate)
        np.testing.assert_allclose(sm_t, sm_j, rtol=0, atol=CAL_TOL)


@pytest.mark.parametrize("sched", [None, (8, 4, 4, 2)])
def test_attention_topk_agreement_against_quality_py(sched):
    kw = dict(mode="topk_prog", predictor="cls_mlp", loss="mse_attention", top_k=8,
              keep_schedule=sched)
    tree, params, jp, tp = _jax_and_port_params(kw)
    xs = [_pixels(10 + i, 8) for i in range(2)]
    jbs = [{"pixel_values": jnp.asarray(x)} for x in xs]
    tbs = [{"pixel_values": torch.from_numpy(x)} for x in xs]
    cap_j, agree_j, by_j = quality.attention_topk_agreement(tree, jbs, JCFG, jp)
    cap_t, agree_t, by_t = quality_torch.attention_topk_agreement(params, tbs, CFG, tp)
    assert list(by_t) == list(by_j)
    np.testing.assert_allclose([cap_t, agree_t] + list(by_t.values()),
                               [cap_j, agree_j] + list(by_j.values()), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="no active"):
        quality_torch.attention_topk_agreement(params, tbs, CFG, tp.replace(
            keep_schedule=(0, 0, 0, 0)))


@pytest.mark.parametrize("loss", ["bce_oracle", "mse_attention"])
def test_measure_preset_against_quality_py(loss):
    """Serving accuracy in float and int8, measured skip and predictor
    fidelity of one set of weights: the same accuracies (within one image
    of the 32: int8 rounding may flip a near-tied prediction) and fidelity
    within 1e-4."""
    kw = dict(mode="topk", predictor="cls_mlp", loss=loss, top_k=8)
    tree, params, jp, tp = _jax_and_port_params(kw)
    rs = np.random.RandomState(4)
    xs = [(_pixels(20 + i), rs.randint(0, 8, 16)) for i in range(2)]
    jbs = [{"pixel_values": jnp.asarray(x), "labels": jnp.asarray(y)} for x, y in xs]
    tbs = [{"pixel_values": torch.from_numpy(x), "labels": torch.from_numpy(y)} for x, y in xs]
    args = SimpleNamespace(merge_ablation=False)
    res_j = quality.measure_preset(tree, JCFG, jp, jbs, jbs, args, lambda *a: None, False)
    res_t = quality_torch.measure_preset(params, CFG, tp, tbs, tbs, args, lambda *a: None, False)
    from vit_pruning_tpu.ops.dispatch import set_kernel_mode as j_set

    j_set("auto")
    (acc_j, i8_j, mlp_j, skip_j, _, _, ex_j), (acc_t, i8_t, mlp_t, skip_t, _, _, ex_t) = \
        res_j, res_t
    assert abs(acc_t - acc_j) <= 1 / 32 and abs(i8_t - i8_j) <= 1 / 32
    assert skip_t == pytest.approx(skip_j, abs=1e-6)
    assert mlp_t == pytest.approx(mlp_j, abs=1e-4)
    assert ex_t.keys() == ex_j.keys()


def test_tiny_real_run_json_has_quality_pys_keys(tmp_path, capsys):
    """A real (tiny) quality_torch run on the CPU: exit 0 or 1 through the
    gates, never the at-chance refusal; its JSON line has the keys
    quality.py's main writes for the same preset and passes quality.py's
    schema validator."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        rc = quality_torch.main([
            "--preset", "headline", "--image_size", "16", "--num_labels", "8", "--train_size",
            "256", "--test_size", "64", "--batch", "32", "--epochs", "3", "--pred_epochs", "1",
            "--device", "cpu", "--cache_dir", str(tmp_path)])
    finally:
        torch.set_num_threads(threads)
    results = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc in (0, 1) and results["dense_top1"] >= 5 / 8
    assert quality.validate_section(results) == []
    assert set(results) == {"schema_version", "dense_top1", "dense_top1_int8", "dataset",
                            "gate_model", "image_size", "gate_max_drop", "presets", "task_params",
                            "pass"}
    row = results["presets"]["headline"]
    assert set(row) == {"serving_config", "pruned_top1", "pruned_top1_int8", "delta",
                        "delta_int8", "dense_top1", "budget", "predictor_accuracy",
                        "predictor_metric", "measured_skip", "target_skip", "gates", "pass"}
    assert set(row["gates"]) == {"delta", "delta_int8", "predictor", "skip"}
    assert set(row["serving_config"]) == set(json.loads(JPrune().to_json()))
    assert all(np.isfinite(row[k]) for k in ("pruned_top1", "pruned_top1_int8",
                                             "predictor_accuracy", "measured_skip"))


def test_gate_witness_runs_quality_torch_from_the_jax_init(tmp_path, capsys):
    """tests/gate_witness.py: `export` saves the JAX package's PRNGKey(42)
    init of the gate model (backbone and the headline's cls_mlp predictor)
    bit for bit; `run` starts quality_torch.main from it (the dense baseline
    and the headline preset both take it) and exits through the gates."""
    import gate_witness

    path = str(tmp_path / "init.pt")
    assert gate_witness.main(["export", path, "--image_size", "16", "--num_labels", "8"]) == 0
    cfg = ViTConfig.from_json(gate_witness.gate_config_json(16, 8))
    want = params_from_jax(j_init(jax.random.PRNGKey(42), JViT.from_json(cfg.to_json()),
                                  JPrune(mode="topk", predictor="cls_mlp")), "cpu")
    got = torch.load(path, weights_only=True)["params"]
    assert dict(flatten_tree(got)).keys() == dict(flatten_tree(want)).keys()
    assert all(torch.equal(v, dict(flatten_tree(want))[k]) for k, v in flatten_tree(got))
    capsys.readouterr()
    threads = torch.get_num_threads()
    torch.set_num_threads(min(threads, 2))
    try:
        rc = gate_witness.main([
            "run", path, "--preset", "headline", "--image_size", "16", "--num_labels", "8",
            "--train_size", "256", "--test_size", "64", "--batch", "32", "--epochs", "3",
            "--pred_epochs", "1", "--device", "cpu", "--cache_dir", str(tmp_path)])
    finally:
        torch.set_num_threads(threads)
    out, err = capsys.readouterr()
    assert rc in (0, 1)
    assert [ln for ln in err.splitlines() if ln.startswith("init:")] == [
        "init: the JAX package's PRNGKey(42) draw (none, predictor none)",
        "init: the JAX package's PRNGKey(42) draw (topk, predictor cls_mlp)"]
    assert quality.validate_section(json.loads(out.strip().splitlines()[-1])) == []
    assert quality_torch._init_params.__name__ == "_init_params"  # restored


def test_gate_witness_reseed_draws_every_init_at_its_seed(monkeypatch):
    """tests/gate_witness.py reseed: quality_torch.main runs with every
    _init_params call drawn from torch.Generator at the given seed, and the
    seed-42 default comes back afterwards."""
    import gate_witness

    pcfg = PruneConfig(mode="topk", predictor="cls_mlp")
    seen = []

    def fake_main(argv):
        seen.append((argv, quality_torch._init_params(CFG, pcfg, "cpu")))
        return 1

    monkeypatch.setattr(quality_torch, "main", fake_main)
    assert gate_witness.main(["reseed", "7", "--kernels", "eager"]) == 1
    (argv, got), = seen
    want = init_pruned_vit_params(CFG, pcfg, torch.Generator().manual_seed(7), "cpu")
    assert argv == ["--kernels", "eager"]
    assert all(torch.equal(v, dict(flatten_tree(want))[k]) for k, v in flatten_tree(got))
    again = dict(flatten_tree(quality_torch._init_params(CFG, pcfg, "cpu")))
    assert all(torch.equal(v, again[k]) for k, v in flatten_tree(
        init_pruned_vit_params(CFG, pcfg, torch.Generator().manual_seed(42), "cpu")))
