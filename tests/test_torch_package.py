"""Package-level contracts of the port: nothing of jax or of the JAX package
at import (by module name and by file), lazy kernel build, the card as the
default device, and the kernel wrappers' CPU behaviour."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from vit_pruning_tpu_torch.configs import PruneConfig, vit_tiny
from vit_pruning_tpu_torch.models.vit import init_vit_params, layer_slice
from vit_pruning_tpu_torch.ops.cuda import layer as tl
from vit_pruning_tpu_torch.ops.dispatch import kernel_mode, set_kernel_mode

PORT_DIR = Path(__file__).resolve().parents[1] / "vit_pruning_tpu_torch"

IMPORT_ALL = """
import importlib, os, pkgutil, sys
import vit_pruning_tpu_torch as p
names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]
for n in names:
    importlib.import_module(n)
assert len(names) >= 24, names
assert {'vit_pruning_tpu_torch.data.preprocess', 'vit_pruning_tpu_torch.ops.cuda.embed'} <= set(names)
jax_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(p.__file__))),
                       'vit_pruning_tpu') + os.sep
jax_pkg = [m for m in sys.modules if m == 'vit_pruning_tpu' or m.startswith('vit_pruning_tpu.')]
jax_files = sorted(n for n, m in list(sys.modules.items())
                   if os.path.abspath(getattr(m, '__file__', None) or '').startswith(jax_dir))
lazy = sorted(m for m in ('pandas', 'transformers') if m in sys.modules)
print('jax' in sys.modules, jax_pkg, jax_files, lazy)
"""


def test_import_leaves_jax_out():
    """Importing every module of the port loads neither jax nor the JAX
    package, under any module name: no loaded module's file lies in
    vit_pruning_tpu/ (the port keeps its own copy of what it needs). Nor
    pandas or transformers, which the machine with the card lacks: the
    metrics tables and load_hf_vit import them when called."""
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "False [] [] []", out.stdout + out.stderr


def test_no_source_builds_a_path_into_the_jax_package():
    """No source file of the port names the JAX package's directory as a
    path or loads a module from a file."""
    bad = []
    for path in sorted(PORT_DIR.rglob("*.py")):
        text = path.read_text()
        for needle in ('"vit_pruning_tpu"', "'vit_pruning_tpu'", '"vit_pruning_tpu/',
                       "spec_from_file_location", "exec_module"):
            if needle in text:
                bad.append(f"{path.relative_to(PORT_DIR)}: {needle}")
    assert not bad, bad


def test_build_covers_every_kernel_source():
    """Every csrc/*.cu is compiled and hashed (an edited kernel rebuilds),
    and every C entry point the wrappers declare is defined in one of them."""
    from vit_pruning_tpu_torch.ops.cuda import build

    names = {p.name for p in build.sources()}
    assert {"layer.cu", "layer_attention.cu", "layer_int8.cu", "encoder.cu", "attention.cu",
            "mlp.cu", "embed.cu", "common.cuh"} <= names
    text = "".join(p.read_text() for p in build.sources())
    missing = [fn for fn in build.SIGNATURES if f" {fn}(" not in text]
    assert not missing, missing


def _layer_and_head():
    cfg = vit_tiny()
    params = init_vit_params(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(2, 9, cfg.hidden_size, generator=torch.Generator().manual_seed(1))
    return cfg, params, layer_slice(params["layers"], 0), x


def test_init_functions_default_to_the_card(monkeypatch):
    """Without a card, the default device raises instead of falling back."""
    from vit_pruning_tpu_torch.models.convert import params_from_jax
    from vit_pruning_tpu_torch.models.predictors import init_predictor_params
    from vit_pruning_tpu_torch.models.pruned_vit import init_pruned_vit_params

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, gen = vit_tiny(), torch.Generator().manual_seed(0)
    for make in (lambda: init_vit_params(cfg, gen),
                 lambda: init_predictor_params(cfg, PruneConfig(), gen),
                 lambda: init_pruned_vit_params(cfg, PruneConfig(), gen),
                 lambda: params_from_jax({"w": [1.0]})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert init_vit_params(cfg, gen, "cpu")["ln_f"]["g"].device.type == "cpu"


def test_an_edited_kernel_source_rebuilds(tmp_path, monkeypatch):
    """The library's name is keyed by the hash of every source, embed.cu
    included: an edit there names another library, which build() makes."""
    from vit_pruning_tpu_torch.ops.cuda import build

    for src in build.sources():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build.source_hash()
    embed_cu = tmp_path / "embed.cu"
    embed_cu.write_text(embed_cu.read_text() + "\n// edited\n")
    assert build.source_hash() != before


def test_package_exports_the_embed_entry_points():
    import vit_pruning_tpu_torch as port
    from vit_pruning_tpu_torch.ops.cuda import embed as te

    assert port.embed_u8 is te.embed_u8 and port.embed_fused is te.embed_fused


def test_cpu_tensors_run_plain_versions_without_launching():
    cfg, params, lp, x = _layer_and_head()
    b1, b2 = tl.fused_vit_layer.launches, tl.fused_vit_layer_cls_logits.launches
    b3 = tl.fused_vit_layer_bucketed.launches
    y = tl.fused_vit_layer(x, lp, cfg.num_heads, cfg.layernorm_eps)
    torch.testing.assert_close(y, tl.fused_vit_layer_ref(x, lp, cfg.num_heads,
                                                         cfg.layernorm_eps), rtol=0, atol=0)
    z = tl.fused_vit_layer_cls_logits(x, lp, params["ln_f"], params["head"], cfg.num_heads,
                                      cfg.layernorm_eps)
    assert z.shape == (2, cfg.num_labels)
    kept = torch.tensor([[1, 0, 1, 1, 0, 0, 1, 0, 0]] * 2, dtype=torch.bool)
    dest = torch.tensor([[0, 4, 1, 2, 5, 6, 3, 7, 8]] * 2, dtype=torch.int32)
    u = tl.fused_vit_layer_bucketed(x, lp, dest, kept, 4, cfg.num_heads, cfg.layernorm_eps)
    torch.testing.assert_close(u[~kept], x[~kept], rtol=0, atol=0)
    assert (tl.fused_vit_layer.launches, tl.fused_vit_layer_cls_logits.launches,
            tl.fused_vit_layer_bucketed.launches) == (b1, b2, b3)


def test_kernel_mode_rejects_cpu_tensors():
    cfg, params, lp, x = _layer_and_head()
    kept = torch.ones(2, 9, dtype=torch.bool)
    dest = torch.arange(9).expand(2, 9)
    with kernel_mode("kernel"):
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tl.fused_vit_layer(x, lp, cfg.num_heads)
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tl.fused_vit_layer_cls_logits(x, lp, params["ln_f"], params["head"], cfg.num_heads)
        with pytest.raises(RuntimeError, match="CUDA tensors"):
            tl.fused_vit_layer_bucketed(x, lp, dest, kept, 9, cfg.num_heads)


def test_kernel_mode_names_are_checked():
    with pytest.raises(ValueError, match="kernel mode"):
        set_kernel_mode("pallas")


def test_unported_options_raise(tmp_path):
    """What earlier slices left out runs now: the oracle instrumentation
    (A.9) and the training harness's per-epoch mask montages (viz, A.11),
    which write the JAX package's files."""
    from vit_pruning_tpu_torch.models.pruned_vit import init_pruned_vit_params, pruned_vit_forward
    from vit_pruning_tpu_torch.train.harness import train

    cfg = vit_tiny()
    pcfg = PruneConfig(mode="topk", predictor="token_mlp", top_k=8)
    params = init_pruned_vit_params(cfg, pcfg, torch.Generator().manual_seed(0), "cpu")
    pix = torch.zeros(1, 3, cfg.image_size, cfg.image_size)
    for kw in ({"train": True}, {"compute_oracle": True}, {"oracle": True}):
        out = pruned_vit_forward(params, pix, cfg, pcfg, **kw)
        assert out["aux"]["pred_loss"].shape == (cfg.num_layers,)
    batch = [{"pixel_values": pix, "labels": torch.zeros(1, dtype=torch.long)}]
    train(params, batch, batch, cfg, pcfg, num_epochs=1, viz_dir=str(tmp_path / "viz"))
    names = sorted(p.name for p in (tmp_path / "viz").iterdir())
    assert names == ["step0_img0.png"]  # a batch of one image
    assert (tmp_path / "viz" / names[0]).stat().st_size > 1000


IMPORT_ENTRY_POINTS = """
import os, sys
sys.path.insert(0, os.getcwd())
import quality_torch
import vit_pruning_tpu_torch.cli, vit_pruning_tpu_torch.data, vit_pruning_tpu_torch.native
import vit_pruning_tpu_torch.utils.housekeeping, vit_pruning_tpu_torch.utils.profiling
import vit_pruning_tpu_torch.utils.sweep, vit_pruning_tpu_torch.data.fetch
import vit_pruning_tpu_torch.viz, vit_pruning_tpu_torch.viz.analysis
import vit_pruning_tpu_torch.viz.demo_app, vit_pruning_tpu_torch.serving
import vit_pruning_tpu_torch.ops.cuda.library
import vit_pruning_tpu_torch.parallel, vit_pruning_tpu_torch.parallel.pipeline
import dryrun_multichip_torch
vit_pruning_tpu_torch.ops.cuda.library.load_ops()
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'vit_pruning_tpu', 'pandas',
                                                           'transformers', 'optax', 'PIL',
                                                           'matplotlib', 'streamlit'))
print(bad)
"""


def test_entry_points_load_no_jax():
    """The user's entry points (the CLI, the data pipeline, the utils, the
    native bindings, quality_torch.py, the viz suite, the serving export,
    the kernels' operators, the parallel package and
    dryrun_multichip_torch.py) load neither jax nor the JAX package, nor what
    they import only when used (pandas, transformers, PIL, matplotlib,
    streamlit), nor optax (the gate's schedule is the port's own)."""
    out = subprocess.run([sys.executable, "-c", IMPORT_ENTRY_POINTS], capture_output=True,
                         text=True, check=True, cwd=PORT_DIR.parent)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_scripts_import_nothing_of_jax():
    """quality_torch.py, chip_smoke.py, dryrun_multichip_torch.py and the
    port's examples import
    neither jax nor the JAX package, at module level or inside a function."""
    import re

    pattern = re.compile(r"^\s*(import|from)\s+(jax|optax|vit_pruning_tpu)(\s|\.|$)", re.M)
    for name in ("quality_torch.py", "chip_smoke.py", "dryrun_multichip_torch.py",
                 "examples/deploy_serving_torch.py",
                 "examples/serve_http_torch.py", "examples/train_skip_predictor_torch.py"):
        text = (PORT_DIR.parent / name).read_text()
        assert not pattern.findall(text), (name, pattern.findall(text))


def test_cli_viz_raises_naming_the_roadmap_item(tmp_path):
    """`cli viz` (ROADMAP A.11, ported) writes the JAX package's artifacts:
    the three heatmap directories, montages, the skip chart, the similarity
    plot and report.html."""
    from vit_pruning_tpu_torch import cli

    out = tmp_path / "viz"
    assert cli.main(["viz", "--device", "cpu", "--num_images", "6", "--out_dir", str(out)]) == 0
    L = vit_tiny().num_layers
    for d, name in (("skipped_heatmaps", "skipped"), ("to_skip_heatmaps", "to_skip"),
                    ("misclassified_heatmaps", "misclassified")):
        assert sorted(p.name for p in (out / d).iterdir()) == sorted(
            f"layer_{i}_{name}_heatmap.png" for i in range(L))
    files = {p.name for p in out.iterdir() if p.is_file()}
    assert files == {"skips_per_layer.png", "cosine_similarity.png", "report.html",
                     *(f"blackout_img{i}.png" for i in range(4))}
    assert "Token-skip inference report" in (out / "report.html").read_text()


def test_cli_runs_on_the_card_unless_asked(monkeypatch, tmp_path):
    """Without --device the CLI asks for the card, and without one it
    raises instead of falling back to the CPU."""
    from vit_pruning_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.build_parser().parse_args(["eval", "--checkpoint", "x"]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "-d", "x", "--preset", "smoke", "--quiet",
                  "--log_dir", str(tmp_path), "--models_dir", str(tmp_path)])
