"""The port's visualization suite (vit_pruning_tpu_torch/viz/) on the CPU:
the counterparts of tests/test_viz.py's eight tests, and parity with the
JAX package's viz on the same inputs (the numeric helpers and the report's
tables equal, the similarity profile within 1e-5 on the same weights)."""

import os
import re

import jax
import numpy as np
import pytest
import torch

from torch_parity import jax_and_torch_params
from vit_pruning_tpu.configs import PruneConfig, vit_tiny
from vit_pruning_tpu.models.pruned_vit import init_pruned_vit_params, pruned_vit_forward
from vit_pruning_tpu.viz import analysis as jax_analysis
from vit_pruning_tpu.viz import blackout as jax_blackout
from vit_pruning_tpu.viz import heatmaps as jax_heatmaps
from vit_pruning_tpu.viz import report as jax_report
from vit_pruning_tpu_torch.models.pruned_vit import pruned_vit_forward as t_pruned_vit_forward
from vit_pruning_tpu_torch.viz.analysis import (
    layer_similarity_profile,
    plot_similarity_distributions,
    plot_training_curves,
)
from vit_pruning_tpu_torch.viz.blackout import (
    blackout_image,
    blackout_montage,
    layer_strips,
    skips_per_layer_chart,
    training_mask_dump,
)
from vit_pruning_tpu_torch.viz.heatmaps import (
    mask_frequency,
    misclassified_heatmaps,
    skipped_heatmaps,
    to_skip_heatmaps,
)
from vit_pruning_tpu_torch.viz.report import inference_report

CFG = vit_tiny()  # 32px, patch 8 -> 4x4 grid, 3 layers


@pytest.fixture(scope="module")
def run():
    """The JAX package's run of tests/test_viz.py, its outputs as numpy, and
    the port's params from the same weights."""
    pcfg = PruneConfig(mode="mask", predictor="cls_mlp")
    params = init_pruned_vit_params(jax.random.PRNGKey(0), CFG, pcfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 3, 32, 32))
    out = pruned_vit_forward(params, x, CFG, pcfg, compute_oracle=True,
                             rng=jax.random.PRNGKey(2))
    _, tparams = jax_and_torch_params(params)
    out = {"keep_masks": np.asarray(out["keep_masks"]), "logits": np.asarray(out["logits"]),
           "oracle_keep": np.asarray(out["aux"]["oracle_keep"])}
    return params, tparams, pcfg, np.array(x), out


def test_mask_frequency_shape_and_parity():
    ev = np.random.RandomState(0).rand(3, 8, 16) > 0.5
    f = mask_frequency(ev)
    assert f.shape == (3, 4, 4)
    assert 0 <= f.min() and f.max() <= 1
    np.testing.assert_array_equal(f, jax_heatmaps.mask_frequency(ev))


def test_heatmap_files(run, tmp_path):
    *_, out = run
    km, ok = out["keep_masks"], out["oracle_keep"]
    p1 = skipped_heatmaps(km, str(tmp_path / "sk"))
    p2 = to_skip_heatmaps(ok, str(tmp_path / "ts"))
    p3 = misclassified_heatmaps(km, ok, str(tmp_path / "mc"))
    for paths in (p1, p2, p3):
        assert len(paths) == CFG.num_layers
        assert all(os.path.getsize(p) > 1000 for p in paths)
    assert p1[0].endswith("layer_0_skipped_heatmap.png")


def test_blackout_paints_skipped_and_parity():
    img = np.zeros((32, 32, 3))
    keep = np.ones(16, bool)
    keep[0] = False  # top-left patch skipped
    out = blackout_image(img, keep, patch_size=8)
    assert out[0, 0, 0] > 0.5  # painted red
    assert out[0, 0, 1] < 0.2
    assert out[16, 16, 0] == 0  # kept patch untouched
    rs = np.random.RandomState(1)
    img, keep = rs.randint(0, 256, (3, 32, 32)), rs.rand(16) > 0.5
    np.testing.assert_array_equal(blackout_image(img, keep, 8),
                                  jax_blackout.blackout_image(img, keep, 8))


def test_montage_and_chart(run, tmp_path):
    *_, x, out = run
    km = out["keep_masks"]
    path = str(tmp_path / "montage.png")
    blackout_montage(x[0], km[:, 0], CFG.patch_size, out_path=path)
    assert os.path.getsize(path) > 1000
    fig, avg = skips_per_layer_chart(km, str(tmp_path / "chart.png"))
    assert avg.shape == (CFG.num_layers,)
    np.testing.assert_array_equal(avg, jax_blackout.skips_per_layer_chart(km)[1])


def test_layer_strips_and_parity(run):
    *_, x, out = run
    km = out["keep_masks"][:, 0]
    strips = layer_strips(x[0], km, CFG.patch_size)
    assert len(strips) == CFG.num_layers
    assert strips[0].shape == (32, 32, 3)
    for got, want in zip(strips, jax_blackout.layer_strips(x[0], km, CFG.patch_size)):
        np.testing.assert_array_equal(got, want)


def _tables(html: str) -> str:
    """The report without its images (PNG bytes depend on the plotting
    library's build, not on the numbers drawn)."""
    return re.sub(r"data:image/png;base64,[A-Za-z0-9+/=]*", "data:image/png;base64,", html)


def test_inference_report_and_parity(run, tmp_path):
    *_, x, out = run
    imgs = [xi.transpose(1, 2, 0) for xi in x]
    path = inference_report(imgs, out["keep_masks"], out["logits"], CFG.patch_size,
                            out_path=str(tmp_path / "report.html"))
    html = open(path).read()
    assert "Token-skip inference report" in html
    assert html.count("data:image/png;base64") >= 5
    jpath = jax_report.inference_report(imgs, out["keep_masks"], out["logits"], CFG.patch_size,
                                        out_path=str(tmp_path / "jax_report.html"))
    assert _tables(html) == _tables(open(jpath).read())


def test_similarity_profile_and_plots(run, tmp_path):
    params, tparams, _, x, _ = run
    sims = layer_similarity_profile(tparams["backbone"], torch.from_numpy(x), CFG)
    assert sims.shape == (CFG.num_layers, 4, CFG.num_patches)
    assert np.isfinite(sims).all() and np.abs(sims).max() <= 1.001
    want = jax_analysis.layer_similarity_profile(params["backbone"], x, CFG)
    np.testing.assert_allclose(sims, want, atol=1e-5)
    p = plot_similarity_distributions(sims, str(tmp_path / "cs.png"))
    assert os.path.getsize(p) > 1000
    p = plot_training_curves(
        {"run_a": {"accuracy": [0.5, 0.6, 0.7], "loss": [2.0, 1.5, 1.2]}},
        str(tmp_path / "train.png"),
    )
    assert os.path.getsize(p) > 1000


def test_inference_report_class_names_and_batch_table(run, tmp_path):
    """V6 parity: class-name display + multi-image batch summary + top-5,
    the tables equal to the JAX package's report."""
    from vit_pruning_tpu_torch.data.cifar100_labels import CIFAR100_FINE_LABELS

    *_, x, out = run
    imgs = [xi.transpose(1, 2, 0) for xi in x]
    logits = out["logits"]
    names = CIFAR100_FINE_LABELS[: logits.shape[-1]]
    path = inference_report(imgs, out["keep_masks"], logits, CFG.patch_size,
                            class_names=names, out_path=str(tmp_path / "report.html"))
    html = open(path).read()
    assert "Batch inference summary" in html
    assert "Top-5:" in html
    for p in logits.argmax(-1):
        assert names[p] in html
    assert "mean skip" in html
    jpath = jax_report.inference_report(imgs, out["keep_masks"], logits, CFG.patch_size,
                                        class_names=names,
                                        out_path=str(tmp_path / "jax_report.html"))
    assert _tables(html) == _tables(open(jpath).read())


def test_port_forward_feeds_the_suite(run, tmp_path):
    """The port's own forward on the same weights gives the JAX package's
    keep masks (mode mask: no random draws), and its arrays draw the
    training montages (V9)."""
    _, tparams, pcfg, x, out = run
    with torch.no_grad():
        tout = t_pruned_vit_forward(tparams, torch.from_numpy(x), CFG, pcfg, compute_oracle=True)
    km = tout["keep_masks"].numpy()
    np.testing.assert_array_equal(km, out["keep_masks"])
    np.testing.assert_array_equal(tout["aux"]["oracle_keep"].numpy(), out["oracle_keep"])
    paths = training_mask_dump(list(x[:2]), km, CFG.patch_size, str(tmp_path / "v"), step=3)
    assert [os.path.basename(p) for p in paths] == ["step3_img0.png", "step3_img1.png"]
    assert all(os.path.getsize(p) > 1000 for p in paths)


def test_demo_app_without_streamlit(monkeypatch, capsys):
    """streamlit is imported only inside main(); without it main() says
    so and returns 1."""
    import builtins

    from vit_pruning_tpu_torch.viz import demo_app

    real_import = builtins.__import__

    def no_streamlit(name, *a, **kw):
        if name == "streamlit":
            raise ImportError("no streamlit")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_streamlit)
    assert demo_app.main([]) == 1
    assert "inference_report" in capsys.readouterr().err
