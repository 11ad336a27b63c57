"""The port's CLI (python -m vit_pruning_tpu_torch.cli) on the CPU: a smoke
train -> eval through the config sidecar; the JAX CLI's exported backbone
evaluated by the port's CLI with the JAX CLI's accuracy; and both CLIs'
export of one set of params, bit for bit."""

import json
import os
import re

import torch

from vit_pruning_tpu_torch import cli


def _paths(tmp_path, tag):
    return ["--models_dir", str(tmp_path / f"models_{tag}"), "--log_dir", str(tmp_path / "logs"),
            "--csv_path", str(tmp_path / f"stats_{tag}.csv")]


def _accuracy_from_stats(path) -> float:
    return float(open(path).read().strip().splitlines()[-1].split(", ")[1])


def test_train_eval_roundtrip_with_config_sidecar(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    rc = cli.main(["train", "-d", "smoke_cli", "--preset", "smoke", "--quiet", "--device", "cpu"]
                  + _paths(tmp_path, "t"))
    assert rc == 0
    files = os.listdir(tmp_path / "models_t")
    ckpt = [f for f in files if not f.endswith(".config.json")]
    assert len(ckpt) == 1 and f"{ckpt[0]}.config.json" in files
    side = json.loads((tmp_path / "models_t" / f"{ckpt[0]}.config.json").read_text())
    assert set(side) == {"vit", "prune"}
    assert json.loads(side["vit"])["hidden_size"] == 64  # vit_tiny
    assert _accuracy_from_stats(tmp_path / "stats_t.csv") >= 0.0
    capsys.readouterr()

    # eval rebuilds the trained config from the sidecar even when --model disagrees
    rc = cli.main(["eval", "--checkpoint", str(tmp_path / "models_t" / ckpt[0]), "--model",
                   "vit_base", "--dataset", "synthetic", "--test_batch_size", "16",
                   "--device", "cpu"])
    assert rc == 0
    assert re.search(r"accuracy=\d\.\d{4} mlp_accuracy=\d\.\d{4}", capsys.readouterr().out)


def test_jax_exported_backbone_evaluates_to_the_jax_accuracy(tmp_path, monkeypatch, capsys):
    """The JAX CLI trains a dense smoke backbone and exports it; the port's
    CLI loads the .pth (--torch_checkpoint, --train_type none, --mode none)
    and reports the accuracy the JAX CLI's eval of the checkpoint prints."""
    from vit_pruning_tpu.cli import main as jax_main

    monkeypatch.chdir(tmp_path)
    # the best checkpoint is kept by the first (predictor) phase, which a dense
    # model runs without moving; the backbone phase then trains on
    rc = jax_main(["train", "-d", "jax_dense", "--preset", "smoke", "--quiet", "--mode", "none",
                   "--lr", "1e-3", "1e-3"] + _paths(tmp_path, "j"))
    assert rc == 0
    ckpt = [p for p in (tmp_path / "models_j").iterdir() if p.is_dir()][0]
    pth = tmp_path / "export" / "jax_backbone.pth"
    assert jax_main(["export", "--checkpoint", str(ckpt), "--out", str(pth)]) == 0
    capsys.readouterr()
    assert jax_main(["eval", "--checkpoint", str(ckpt), "--test_batch_size", "16",
                     "--full_testing"]) == 0
    jax_acc = float(re.search(r"accuracy=(\d\.\d{4})", capsys.readouterr().out).group(1))

    rc = cli.main(["train", "-d", "from_jax", "--preset", "smoke", "--quiet", "--device", "cpu",
                   "--torch_checkpoint", str(pth), "--train_type", "none", "--mode", "none",
                   "--test_size", "128"]  # the JAX eval's synthetic test split
                  + _paths(tmp_path, "p"))
    assert rc == 0
    assert round(_accuracy_from_stats(tmp_path / "stats_p.csv"), 4) == jax_acc


def test_exports_of_one_param_tree_bitwise_equal(tmp_path, capsys):
    """One JAX param tree, saved by each package's checkpoint code beside its
    config sidecar, exported by each CLI: the same keys, bit for bit."""
    import jax

    from vit_pruning_tpu.checkpoint import save_checkpoint as jax_save
    from vit_pruning_tpu.cli import _save_config_sidecar as jax_sidecar
    from vit_pruning_tpu.cli import main as jax_main
    from vit_pruning_tpu.configs import PruneConfig as JPrune
    from vit_pruning_tpu.configs import vit_tiny as j_tiny
    from vit_pruning_tpu.models.pruned_vit import init_pruned_vit_params
    from vit_pruning_tpu_torch.checkpoint import save_checkpoint
    from vit_pruning_tpu_torch.configs import PruneConfig, vit_tiny
    from vit_pruning_tpu_torch.models.convert import params_from_jax

    jcfg, jp = j_tiny(), JPrune(mode="topk", predictor="cls_mlp", top_k=8)
    jtree = init_pruned_vit_params(jax.random.PRNGKey(3), jcfg, jp)
    jckpt = str(tmp_path / "jax_ckpt")
    jax_save(jckpt, jtree)
    jax_sidecar(jckpt, jcfg, jp)
    tckpt = str(tmp_path / "torch_ckpt")
    save_checkpoint(tckpt, params_from_jax(jax.device_get(jtree), "cpu"))
    cli._save_config_sidecar(tckpt, vit_tiny(), PruneConfig(mode="topk", predictor="cls_mlp",
                                                           top_k=8))
    for extra in ([], ["--no_classifier"]):
        jout, tout = str(tmp_path / "j.pth"), str(tmp_path / "t.pth")
        assert jax_main(["export", "--checkpoint", jckpt, "--out", jout] + extra) == 0
        assert cli.main(["export", "--checkpoint", tckpt, "--out", tout, "--device", "cpu"]
                        + extra) == 0
        jsd, tsd = torch.load(jout), torch.load(tout)
        assert list(tsd) == list(jsd) and len(tsd) == (56 if not extra else 54)
        for k in jsd:
            assert tsd[k].dtype == jsd[k].dtype and tsd[k].shape == jsd[k].shape, k
            assert torch.equal(tsd[k], jsd[k]), k
    assert "wrote 54 tensors" in capsys.readouterr().out
