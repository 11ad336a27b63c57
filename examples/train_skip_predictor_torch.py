"""Worked example: train a cls_mlp skip predictor, evaluate, visualize, with
the PyTorch/CUDA port (the port's counterpart of
examples/train_skip_predictor.py).

The hi_main.py flow (phase 1 predictor training against the similarity
oracle, phase 2 backbone fine-tune) on a small config. On the card by
default; `--device cpu` runs the plain PyTorch layers. Swap in
`vit_base_patch16_224()` + CIFAR-100 data + an HF checkpoint for the full
reproduction:

    python examples/train_skip_predictor_torch.py [--device cpu]

Writes logs/, models/, stats.csv and viz_out/ under the working directory
(viz_out/ where matplotlib is installed: the viz suite's one dependency,
which a serving host may lack).
"""

import argparse
import importlib.util
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch

from vit_pruning_tpu_torch.checkpoint import BestCheckpoint
from vit_pruning_tpu_torch.configs import PruneConfig, vit_tiny
from vit_pruning_tpu_torch.data.datasets import Batches, synthetic_dataset
from vit_pruning_tpu_torch.models.convert import check_device
from vit_pruning_tpu_torch.models.pruned_vit import init_pruned_vit_params, pruned_vit_forward
from vit_pruning_tpu_torch.train.harness import evaluate, phased_train
from vit_pruning_tpu_torch.utils.run_logging import RunLogger, append_stats, encode_run_name
from vit_pruning_tpu_torch.viz import skipped_heatmaps, skips_per_layer_chart


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' asks for the CPU)")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    config = vit_tiny(num_labels=10)
    pcfg = PruneConfig(mode="mask", predictor="cls_mlp", loss="bce_oracle",
                       sim_threshold=0.9, mlp_threshold=0.5)

    run_name = encode_run_name(
        "example", "both", "mask-cls_mlp", ["cosine", "classification"],
        [1e-3, 1e-5], pcfg.sim_threshold, pcfg.mlp_threshold, 0.0, 16, 128, 64,
    )
    log = RunLogger(run_name, log_dir="logs")

    images, labels = synthetic_dataset(n=128, image_size=config.image_size,
                                       num_labels=10, seed=0)
    timages, tlabels = synthetic_dataset(n=64, image_size=config.image_size,
                                         num_labels=10, seed=1)
    train_b = Batches(images, labels, batch_size=16, image_size=config.image_size,
                      shuffle=True, device=device)
    test_b = Batches(timages, tlabels, batch_size=16, image_size=config.image_size,
                     device=device)

    params = init_pruned_vit_params(config, pcfg, torch.Generator().manual_seed(42), device)
    best = BestCheckpoint("models", run_name)

    params = phased_train(
        params, train_b, test_b, config, pcfg,
        train_type="both", num_epochs=(2, 1), lrs=(1e-3, 1e-5),
        log=log, best=best,
    )

    accuracy, mlp_accuracy, _ = evaluate(
        params, test_b, config, pcfg, full_testing=True, log=log
    )
    append_stats("stats.csv", run_name, accuracy, mlp_accuracy)

    # visualization artifacts
    batch = next(iter(test_b))
    with torch.no_grad():
        out = pruned_vit_forward(params, batch["pixel_values"], config, pcfg,
                                 compute_oracle=True,
                                 generator=torch.Generator(device=device).manual_seed(0))
    keep_masks = out["keep_masks"].cpu().numpy()
    if importlib.util.find_spec("matplotlib") is None:
        log("matplotlib is not installed: no viz artifacts")
    else:
        skipped_heatmaps(keep_masks, "viz_out/skipped_heatmaps")
        skips_per_layer_chart(keep_masks, "viz_out/skips_per_layer.png")
    log(f"done: accuracy={accuracy:.2%} predictor-accuracy={mlp_accuracy:.2%}")
    log.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
