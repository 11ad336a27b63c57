"""The port's utils (vit_pruning_tpu_torch/utils) against the JAX package's:
FLOPs exactly equal for every config and schedule preset, run logging and
housekeeping writing the same files, the sweep grid, profiling on the CPU."""

import os

import numpy as np
import pytest
import torch

import vit_pruning_tpu.configs as jc
import vit_pruning_tpu_torch.configs as tc
from vit_pruning_tpu.utils import flops as jflops
from vit_pruning_tpu_torch.utils import flops as tflops

CONFIGS = ["deit_tiny", "deit_small", "deit_base", "vit_base_patch16_224", "vit_large",
           "vit_huge", "vit_tiny"]


def _prune_presets(cfg_mod, config):
    """Every schedule preset and serving mode flops.py distinguishes, with
    every predictor kind."""
    n, L = config.num_patches, config.num_layers
    P = cfg_mod.PruneConfig
    out = [P(mode=m) for m in ("mask", "oracle", "none")]
    out += [P(mode="topk", top_k=max(1, n // 2)), P(mode="random", top_k=max(1, n // 3)),
            P(mode="topk_prog", top_k=max(1, n // 2))]
    for fn in ("composed_schedule", "ultra_schedule", "token50_schedule"):
        sched = getattr(cfg_mod, fn)(n, L)
        out.append(P(mode="topk_prog", top_k=sched[0], keep_schedule=sched))
    for kind in cfg_mod.PREDICTOR_KINDS:
        out.append(P(mode="mask", predictor=kind))
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_flops_equal_every_config_and_preset(name):
    for labels in (10, 100, 1000):
        t, j = getattr(tc, name)(labels), getattr(jc, name)(labels)
        assert tflops.vit_flops(t) == jflops.vit_flops(j)
        for tp, jp in zip(_prune_presets(tc, t), _prune_presets(jc, j)):
            assert tp.to_json() == jp.to_json()
            assert tflops.pruned_vit_flops(t, tp) == jflops.pruned_vit_flops(j, jp), tp
            # measured live tokens, as the CLI passes them
            tokens = np.linspace(t.seq_len, 2, t.num_layers)
            assert tflops.pruned_vit_flops(t, tp, tokens) == jflops.pruned_vit_flops(j, jp, tokens)


def test_flops_of_structurally_pruned_configs_equal():
    """attn_width and the halved mlp_dim of a head/channel-pruned model."""
    t = tc.deit_small(100).replace(num_heads=3, attn_head_dim=64, mlp_dim=768)
    j = jc.deit_small(100).replace(num_heads=3, attn_head_dim=64, mlp_dim=768)
    sched = tc.composed_schedule(t.num_patches, t.num_layers)
    tp = tc.PruneConfig(mode="topk_prog", top_k=sched[0], keep_schedule=sched)
    jp = jc.PruneConfig(mode="topk_prog", top_k=sched[0], keep_schedule=sched)
    assert tflops.vit_flops(t) == jflops.vit_flops(j)
    assert tflops.pruned_vit_flops(t, tp) == jflops.pruned_vit_flops(j, jp)


def test_run_logging_writes_what_the_reference_writes(tmp_path):
    from vit_pruning_tpu.utils import run_logging as jr
    from vit_pruning_tpu_torch.utils import run_logging as tr

    args = ("desc", "both", "mask-cls_mlp", ["cosine", "classification"], [1e-3, 1e-5], 0.9,
            0.5, 0.0, 32, 64, None)
    name_t = tr.encode_run_name(*args, timestamp="2024-01-01_00-00-00")
    assert name_t == jr.encode_run_name(*args, timestamp="2024-01-01_00-00-00")
    for mod, sub in ((tr, "t"), (jr, "j")):
        log = mod.RunLogger(name_t, str(tmp_path / sub), quiet=True)
        log("line one")
        log("line <two>")
        log.close()
        mod.append_stats(str(tmp_path / sub / "stats.csv"), name_t, 0.5, 0.75)
        mod.append_stats(str(tmp_path / sub / "stats.csv"), name_t, 0.25, 1.0)
    for f in (f"{name_t}.txt", "stats.csv"):
        assert (tmp_path / "t" / f).read_text() == (tmp_path / "j" / f).read_text()
    # the HTML sink (timestamps differ by the clock; the escaping and layout do not)
    html = tr.RunLogger("h", str(tmp_path / "h"), quiet=True, html=True)
    html("a <b>")
    html.close()
    text = (tmp_path / "h" / "h.html").read_text()
    assert text.startswith("<html><head><title>h</title>") and "a &lt;b&gt;" in text


@pytest.mark.parametrize("dry_run", [False, True])
def test_remove_unwanted_same_as_reference(tmp_path, dry_run):
    from vit_pruning_tpu.utils.housekeeping import remove_unwanted as j_remove
    from vit_pruning_tpu_torch.utils.housekeeping import remove_unwanted as t_remove

    removed = {}
    for sub, fn in (("t", t_remove), ("j", j_remove)):
        logs, models = tmp_path / sub / "logs", tmp_path / sub / "models"
        logs.mkdir(parents=True)
        models.mkdir()
        (logs / "short.txt").write_text("one line\n")
        (logs / "long.txt").write_text("\n".join(["line"] * 20))
        (logs / "short2.txt").write_text("")
        (models / "short").mkdir()
        (models / "long").mkdir()
        (models / "short2.pth").write_text("x")
        removed[sub] = (sorted(fn(str(logs), str(models), min_lines=10, dry_run=dry_run)),
                        sorted(os.listdir(logs)), sorted(os.listdir(models)))
    assert removed["t"] == removed["j"]
    assert removed["t"][0] == ["short", "short2"]


def test_remove_unwanted_takes_the_ports_checkpoint_files(tmp_path):
    """The port's checkpoints are single files (checkpoint.py), removed with
    their log."""
    from vit_pruning_tpu_torch.utils.housekeeping import remove_unwanted

    (tmp_path / "logs").mkdir()
    (tmp_path / "models").mkdir()
    (tmp_path / "logs" / "run.txt").write_text("x\n")
    (tmp_path / "models" / "run").write_bytes(b"ckpt")
    assert remove_unwanted(str(tmp_path / "logs"), str(tmp_path / "models")) == ["run"]
    assert not (tmp_path / "models" / "run").exists()


def test_export_test_images_same_files(tmp_path):
    from vit_pruning_tpu.utils.housekeeping import export_test_images as j_export
    from vit_pruning_tpu_torch.data.datasets import synthetic_dataset
    from vit_pruning_tpu_torch.utils.housekeeping import export_test_images as t_export

    images, labels = synthetic_dataset(n=10, image_size=16)
    ti, tl = t_export(images, labels, str(tmp_path / "t"), limit=5)
    ji, jl = j_export(images, labels, str(tmp_path / "j"), limit=5)
    assert sorted(os.listdir(ti)) == sorted(os.listdir(ji)) and len(os.listdir(ti)) == 5
    assert open(tl).read() == open(jl).read()
    for f in os.listdir(ti):
        assert open(os.path.join(ti, f), "rb").read() == open(os.path.join(ji, f), "rb").read()


def test_pick_device(monkeypatch):
    from vit_pruning_tpu_torch.utils.housekeeping import pick_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pick_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pick_device() == torch.device("cuda", 0)
    assert pick_device(1) == torch.device("cuda", 1)
    with pytest.raises(RuntimeError, match="card 2"):
        pick_device(2)


def test_grid_equal():
    from vit_pruning_tpu.utils.sweep import grid as jgrid
    from vit_pruning_tpu_torch.utils.sweep import grid as tgrid

    axes = dict(sim_threshold=[0.85, 0.9], mode=["mask", "topk"], top_k=[4])
    assert tgrid(**axes) == jgrid(**axes)
    assert len(tgrid(**axes)) == 4


def test_sweep_runs_on_the_cpu():
    from vit_pruning_tpu_torch.data.datasets import Batches, synthetic_dataset
    from vit_pruning_tpu_torch.utils.sweep import grid, sweep

    cfg = tc.ViTConfig(image_size=16, patch_size=8, hidden_size=32, num_layers=2,
                       num_heads=2, mlp_dim=64, num_labels=4)
    images, labels = synthetic_dataset(n=32, image_size=16, num_labels=4)
    data = Batches(images, labels, batch_size=16, image_size=16, device="cpu")
    df = sweep(grid(sim_threshold=[0.9], mlp_threshold=[0.4, 0.6]), cfg,
               tc.PruneConfig(mode="mask", predictor="cls_mlp"), data, data,
               train_type="mlp", num_epochs=(1, 0), device="cpu")
    assert len(df) == 2
    assert {"accuracy", "mlp_accuracy", "mean_skip"} <= set(df.columns)
    assert list(df["mlp_threshold"]) == [0.4, 0.6]
    assert ((df["accuracy"] >= 0) & (df["accuracy"] <= 1)).all()


def test_throughput_complexity_and_trace(tmp_path):
    from vit_pruning_tpu.utils.profiling import complexity_report as j_report
    from vit_pruning_tpu_torch.utils.profiling import (
        complexity_report, throughput, torch_trace, xla_trace)

    r = throughput(lambda x: x * 2, (torch.ones(4, 4),), batch_size=4, iters=3, warmup=1)
    assert r["images_per_sec"] > 0 and r["ms_per_batch"] == pytest.approx(r["sec_per_batch"] * 1e3)
    cfg_t = tc.ViTConfig(image_size=16, patch_size=8, hidden_size=32, num_layers=2,
                         num_heads=2, mlp_dim=64, num_labels=4)
    cfg_j = jc.ViTConfig(image_size=16, patch_size=8, hidden_size=32, num_layers=2,
                         num_heads=2, mlp_dim=64, num_labels=4)
    for kw in ({}, {"images_per_sec": 100.0}, {"tokens_per_layer": [3.0, 2.0]}):
        t = complexity_report(cfg_t, tc.PruneConfig(mode="topk", top_k=2), **kw)
        j = j_report(cfg_j, jc.PruneConfig(mode="topk", top_k=2), **kw)
        assert t == j
    assert complexity_report(cfg_t) == j_report(cfg_j)
    assert xla_trace is torch_trace
    with torch_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
