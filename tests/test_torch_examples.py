"""The port's examples (examples/*_torch.py) run end to end on the CPU at
their sizes (vit_tiny, as the JAX package's examples), each in a process of
its own with `--device cpu`, from a scratch working directory."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _run(tmp_path, script: str, *args) -> str:
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script), "--device", "cpu",
                          *args], capture_output=True, text=True, cwd=tmp_path, timeout=600)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    return out.stdout


def test_deploy_serving_example(tmp_path):
    """float and int8 serving of the composed preset, then the export round
    trip, bit-identical."""
    out = _run(tmp_path, "deploy_serving_torch.py", "--out", str(tmp_path / "serving.pt2"))
    assert "int8 serving logits: (8, 100)" in out
    assert "bit-identical = True" in out
    assert (tmp_path / "serving.pt2").stat().st_size > 0


def test_serve_http_example_selftest(tmp_path):
    """The batching HTTP server answers 12 concurrent requests with the
    direct forward's labels (on a port the system picks)."""
    out = _run(tmp_path, "serve_http_torch.py", "--selftest", "--port", "0")
    assert "selftest: 12/12 labels match the direct forward" in out


def test_train_skip_predictor_example(tmp_path):
    """Both phases, the final eval, stats.csv and the viz artifacts."""
    out = _run(tmp_path, "train_skip_predictor_torch.py")
    assert "done: accuracy=" in out
    assert (tmp_path / "stats.csv").read_text().startswith("Model, Accuracy, MLP Accuracy")
    heat = sorted(p.name for p in (tmp_path / "viz_out" / "skipped_heatmaps").iterdir())
    assert heat == [f"layer_{i}_skipped_heatmap.png" for i in range(3)]
    assert (tmp_path / "viz_out" / "skips_per_layer.png").stat().st_size > 1000


@pytest.mark.parametrize("script", ["deploy_serving_torch.py", "serve_http_torch.py",
                                    "train_skip_predictor_torch.py"])
def test_examples_ask_for_the_card(script, tmp_path):
    """Without --device the examples run on the card; this host has none, so
    they exit with an error instead of falling back to the CPU."""
    args = ["--selftest", "--port", "0"] if script == "serve_http_torch.py" else []
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script), *args],
                         capture_output=True, text=True, cwd=tmp_path, timeout=600)
    assert out.returncode != 0
    assert "CUDA" in out.stderr or "cuda" in out.stderr
