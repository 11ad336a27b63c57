"""Experiment CLI — the reference's hi_main.py as an entry point.

    python -m vit_pruning_tpu_torch.cli train -d my_experiment [--preset smoke] ...
    python -m vit_pruning_tpu_torch.cli eval --checkpoint models/<run>
    python -m vit_pruning_tpu_torch.cli export --checkpoint models/<run> --out backbone.pth
    python -m vit_pruning_tpu_torch.cli viz [--checkpoint models/<run>] --out_dir viz_out

Mirrors vit_pruning_tpu/cli.py (himanshu/hi_main.py:36-187): config,
run-name encoding, optional pretrained-weight surgery, phase-1 predictor
training, phase-2 backbone fine-tune, final eval, stats.csv append, FLOPs
comparison. The flags, the MODELS table, `--preset smoke` and the config
sidecar's JSON are the reference's. Everything runs on the card unless
`--device cpu` is given; the seed draws the params from a torch.Generator;
`--bf16` computes in torch.bfloat16 over float32 master params. A
checkpoint is one file (checkpoint.py), with `<checkpoint>.config.json`
beside it. `viz` writes the visualization suite (viz/) of one forward.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from vit_pruning_tpu_torch.checkpoint import BestCheckpoint, restore_checkpoint
from vit_pruning_tpu_torch.configs import (
    PruneConfig,
    ViTConfig,
    deit_base,
    deit_small,
    deit_tiny,
    vit_base_patch16_224,
    vit_huge,
    vit_large,
    vit_tiny,
)
from vit_pruning_tpu_torch.data.datasets import (
    Batches,
    PrefetchBatches,
    load_cifar100,
    load_image_folder,
    synthetic_dataset,
)
from vit_pruning_tpu_torch.models.convert import check_device, tree_to
from vit_pruning_tpu_torch.models.pruned_vit import init_pruned_vit_params
from vit_pruning_tpu_torch.train.harness import evaluate, phased_train
from vit_pruning_tpu_torch.utils.flops import pruned_vit_flops, vit_flops
from vit_pruning_tpu_torch.utils.run_logging import RunLogger, append_stats, encode_run_name

MODELS = {
    "vit_base": vit_base_patch16_224,
    "deit_tiny": deit_tiny,
    "deit_small": deit_small,
    "deit_base": deit_base,
    "vit_large": vit_large,
    "vit_huge": vit_huge,
    "vit_tiny": vit_tiny,
}
DATASETS = ["cifar100", "imagefolder", "synthetic"]


def _device_flag(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: the card; 'cpu' asks for the CPU)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vit_pruning_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="phased train (hi_main.py flow)")
    t.add_argument("--model_desc", "-d", type=str, required=True, help="Desc of model")
    t.add_argument("--model", choices=sorted(MODELS), default="vit_base")
    t.add_argument("--dataset", choices=DATASETS, default="synthetic")
    t.add_argument("--data_path", default="./data")
    t.add_argument("--preset", choices=["smoke", "full"], default="full")
    # hi_main.py:88-108 constants as flags
    t.add_argument("--train_type", choices=["mlp", "vit", "both", "none"], default="both")
    t.add_argument("--loss_type", nargs=2, default=["cosine", "classification"])
    t.add_argument("--num_epochs", nargs=2, type=int, default=[10, 10])
    t.add_argument("--lr", nargs=2, type=float, default=[1e-3, 1e-5])
    t.add_argument("--train_batch_size", type=int, default=32)
    t.add_argument("--test_batch_size", type=int, default=128)
    t.add_argument("--train_size", type=int, default=None)
    t.add_argument("--test_size", type=int, default=None)
    t.add_argument("--sim_threshold", type=float, default=0.9)
    t.add_argument("--mlp_threshold", type=float, default=0.5)
    t.add_argument("--avg_threshold", type=float, default=0.0)
    t.add_argument("--mode", choices=["mask", "topk", "topk_prog", "oracle", "random", "none"],
                   default="mask")
    t.add_argument("--predictor", default="cls_mlp")
    t.add_argument("--loss", default="bce_oracle",
                   help="predictor loss: bce_oracle|mse_cosine|mse_attention|focal")
    t.add_argument("--top_k", type=int, default=150)
    t.add_argument("--mask_budget", type=int, default=None,
                   help="mode=mask per-image density cap: keep at most this "
                        "many highest-scoring above-threshold tokens")
    t.add_argument("--per_layer_lr_scales", nargs="*", type=float, default=None,
                   help="M19 per-predictor learning-rate multipliers, one per "
                        "layer (mukunda/deit.py:131-156); applies to the "
                        "predictor phase")
    t.add_argument("--accum_steps", type=int, default=1,
                   help="gradient accumulation: microbatches per optimizer "
                        "step (full-batch gradient in one microbatch's "
                        "activation memory)")
    t.add_argument("--pretrained_checkpoint", default=None,
                   help="resume from a checkpoint of this CLI (hi_main.py:138-139)")
    t.add_argument("--torch_checkpoint", default=None,
                   help="initialize backbone from an HF torch state_dict .pth "
                        "(vit.-prefix surgery, hi_main.py:130-137)")
    t.add_argument("--csv_path", default="stats.csv")
    t.add_argument("--log_dir", default="logs")
    t.add_argument("--models_dir", default="models")
    t.add_argument("--seed", type=int, default=42)
    t.add_argument("--prefetch", type=int, default=0, metavar="DEPTH",
                   help="asynchronous input prefetch depth (0 = off; 2 "
                        "double-buffers — the DataLoader num_workers "
                        "equivalent)")
    t.add_argument("--bf16", action="store_true",
                   help="mixed-precision training (bf16 compute, fp32 master params)")
    t.add_argument("--quiet", action="store_true")
    _device_flag(t)

    e = sub.add_parser("eval", help="evaluate a checkpoint (test() equivalent)")
    e.add_argument("--model", choices=sorted(MODELS), default="vit_base")
    e.add_argument("--dataset", choices=DATASETS, default="synthetic")
    e.add_argument("--data_path", default="./data")
    e.add_argument("--mode", default="mask")
    e.add_argument("--predictor", default="cls_mlp")
    e.add_argument("--checkpoint", required=True)
    e.add_argument("--test_batch_size", type=int, default=128)
    e.add_argument("--full_testing", action="store_true")
    _device_flag(e)

    x = sub.add_parser(
        "export", help="export a checkpoint's backbone to an HF torch "
                       "state_dict .pth (inverse of --torch_checkpoint)"
    )
    x.add_argument("--checkpoint", required=True,
                   help="checkpoint file (train writes a .config.json sidecar next to it)")
    x.add_argument("--out", required=True, help="output .pth path")
    x.add_argument("--model", choices=sorted(MODELS), default="vit_base",
                   help="geometry fallback when no config sidecar exists")
    x.add_argument("--dataset", choices=DATASETS, default="synthetic",
                   help="only sets num_labels fallback")
    x.add_argument("--no_classifier", action="store_true",
                   help="emit a bare-ViTModel-style dict (no classifier keys)")
    _device_flag(x)

    v = sub.add_parser(
        "viz", help="generate the visualization suite (heatmaps, montages, report)"
    )
    v.add_argument("--model", choices=sorted(MODELS), default="vit_tiny")
    v.add_argument("--dataset", choices=DATASETS, default="synthetic")
    v.add_argument("--data_path", default="./data")
    v.add_argument("--checkpoint", default=None)
    v.add_argument("--mode", default="mask")
    v.add_argument("--predictor", default="cls_mlp")
    v.add_argument("--num_images", type=int, default=32)
    v.add_argument("--out_dir", default="viz_out")
    _device_flag(v)
    return p


def _build_config(args) -> ViTConfig:
    """Model config consistent across train/eval: CIFAR-100 implies a
    100-way head (the reference's num_labels=100, hi_main.py:96)."""
    if getattr(args, "dataset", None) == "cifar100":
        return MODELS[args.model](num_labels=100)
    return MODELS[args.model]()


def _sidecar_path(checkpoint_path: str) -> str:
    return checkpoint_path.rstrip("/") + ".config.json"


def _save_config_sidecar(checkpoint_path: str, config: ViTConfig, pcfg: PruneConfig):
    with open(_sidecar_path(checkpoint_path), "w") as fh:
        json.dump({"vit": config.to_json(), "prune": pcfg.to_json()}, fh)


def _load_config_sidecar(checkpoint_path: str):
    """(ViTConfig, PruneConfig) recorded at train time, or None."""
    p = _sidecar_path(checkpoint_path)
    if not os.path.exists(p):
        return None
    with open(p) as fh:
        d = json.load(fh)
    return ViTConfig.from_json(d["vit"]), PruneConfig.from_json(d["prune"])


def _load_data(args, config: ViTConfig, device):
    if args.dataset == "synthetic":
        n_train = args.train_size or 256
        n_test = args.test_size or 128
        tr = synthetic_dataset(n=n_train, image_size=config.image_size,
                               num_labels=config.num_labels, seed=0)
        te = synthetic_dataset(n=n_test, image_size=config.image_size,
                               num_labels=config.num_labels, seed=1)
    elif args.dataset == "cifar100":
        tr = load_cifar100(args.data_path, train=True, size=args.train_size)
        te = load_cifar100(args.data_path, train=False, size=args.test_size)
    else:
        tr = load_image_folder(args.data_path, "train", size=args.train_size,
                               image_size=config.image_size)
        te = load_image_folder(args.data_path, "val", size=args.test_size,
                               image_size=config.image_size)
    train_b = Batches(*tr, batch_size=args.train_batch_size, image_size=config.image_size,
                      shuffle=True, seed=args.seed, device=device)
    test_b = Batches(*te, batch_size=min(args.test_batch_size, len(te[1])),
                     image_size=config.image_size, device=device)
    if getattr(args, "prefetch", 0):
        train_b = PrefetchBatches(train_b, depth=args.prefetch)
        test_b = PrefetchBatches(test_b, depth=args.prefetch)
    return train_b, test_b


def _describe(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def _restore(path: str, device) -> dict:
    """A checkpoint's params, on `device`."""
    return tree_to(restore_checkpoint(path), device)


def cmd_train(args) -> int:
    if args.preset == "smoke":
        args.model = "vit_tiny"
        args.dataset = "synthetic"
        args.num_epochs = [1, 1]
        args.train_batch_size = 16
        args.test_batch_size = 16
        args.train_size = args.train_size or 64
        args.test_size = args.test_size or 32
        args.top_k = min(args.top_k, 8)

    device = check_device(args.device)
    config = _build_config(args)
    pcfg = PruneConfig(
        mode=args.mode, predictor=args.predictor if args.mode != "none" else "none",
        loss=args.loss, sim_threshold=args.sim_threshold,
        mlp_threshold=args.mlp_threshold, avg_threshold=args.avg_threshold,
        top_k=args.top_k, mask_budget=args.mask_budget,
    )
    if args.per_layer_lr_scales is not None and len(
        args.per_layer_lr_scales
    ) != config.num_layers:
        raise SystemExit(
            f"--per_layer_lr_scales needs exactly one value per layer "
            f"({config.num_layers} for --model {args.model})"
        )

    run_name = encode_run_name(
        args.model_desc, args.train_type, f"{args.mode}-{args.predictor}",
        args.loss_type, args.lr, args.sim_threshold, args.mlp_threshold,
        args.avg_threshold, args.train_batch_size, args.train_size, args.test_size,
    )
    log = RunLogger(run_name, args.log_dir, quiet=args.quiet)
    log(f"device: {_describe(device)}  argv: {' '.join(sys.argv)}")

    params = init_pruned_vit_params(config, pcfg, torch.Generator().manual_seed(args.seed),
                                    device)
    if args.torch_checkpoint:
        from vit_pruning_tpu_torch.models.convert import torch_state_dict_to_params

        sd = torch.load(args.torch_checkpoint, map_location="cpu", weights_only=True)
        params["backbone"] = torch_state_dict_to_params(sd, config, device=device)
    elif args.pretrained_checkpoint:
        params = restore_checkpoint(args.pretrained_checkpoint, params)

    train_b, test_b = _load_data(args, config, device)
    os.makedirs(args.models_dir, exist_ok=True)
    best = BestCheckpoint(args.models_dir, run_name)
    if best.path:
        # record the exact configs next to the checkpoint so eval can
        # rebuild the same model (classifier-head shape included)
        _save_config_sidecar(best.path, config, pcfg)

    params = phased_train(
        params, train_b, test_b, config, pcfg,
        train_type=args.train_type, loss_types=tuple(args.loss_type),
        num_epochs=tuple(args.num_epochs), lrs=tuple(args.lr),
        log=log, best=best,
        compute_dtype=torch.bfloat16 if args.bf16 else None,
        per_layer_lr_scales=args.per_layer_lr_scales,
        accum_steps=args.accum_steps,
    )

    accuracy, mlp_accuracy, acc = evaluate(params, test_b, config, pcfg, full_testing=True,
                                           log=log)
    append_stats(args.csv_path, run_name, accuracy, mlp_accuracy)

    dense = vit_flops(config)
    tokens = (1.0 - acc.measured_skip_per_layer) * config.seq_len
    pruned = pruned_vit_flops(config, pcfg, tokens_per_layer=tokens)
    log(f"FLOPs/image: pruned {pruned / 1e9:.4g} GFLOPs vs dense {dense / 1e9:.4g} GFLOPs "
        f"({pruned / dense:.1%})")
    log.close()
    return 0


def cmd_eval(args) -> int:
    device = check_device(args.device)
    side = _load_config_sidecar(args.checkpoint)
    if side is not None:
        config, pcfg = side
    else:
        config = _build_config(args)
        pcfg = PruneConfig(mode=args.mode, predictor=args.predictor)
    params = _restore(args.checkpoint, device)
    args.train_batch_size = args.test_batch_size
    args.train_size = args.test_size = None
    args.seed = 0
    _, test_b = _load_data(args, config, device)
    accuracy, mlp_accuracy, _ = evaluate(params, test_b, config, pcfg,
                                         full_testing=args.full_testing, log=print)
    print(f"accuracy={accuracy:.4f} mlp_accuracy={mlp_accuracy:.4f}")
    return 0


def cmd_export(args) -> int:
    """Checkpoint -> HF torch state_dict: the export half of the reference's
    weight surgery (hi_main.py:130-137 only imports), so backbones
    fine-tuned here flow back into the torch/HF serving stack."""
    from vit_pruning_tpu_torch.models.convert import params_to_torch_state_dict

    side = _load_config_sidecar(args.checkpoint)
    config = side[0] if side is not None else _build_config(args)
    params = _restore(args.checkpoint, check_device(args.device))
    sd = params_to_torch_state_dict(params, config, classifier=not args.no_classifier)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(sd, args.out)
    print(f"wrote {len(sd)} tensors to {args.out} "
          f"(load_state_dict into ViTForImageClassification, strict="
          f"{'False' if args.no_classifier else 'True'})")
    return 0


def cmd_viz(args) -> int:
    """Generate V1-V8 artifacts: skip/oracle/error heatmaps, blackout
    montages, skip bar chart, similarity analysis, HTML report."""
    import numpy as np

    from vit_pruning_tpu_torch.data.preprocess import vit_preprocess
    from vit_pruning_tpu_torch.models.pruned_vit import pruned_vit_forward
    from vit_pruning_tpu_torch.viz import (
        blackout_montage,
        inference_report,
        misclassified_heatmaps,
        skipped_heatmaps,
        skips_per_layer_chart,
        to_skip_heatmaps,
    )
    from vit_pruning_tpu_torch.viz.analysis import (
        layer_similarity_profile,
        plot_similarity_distributions,
    )

    device = check_device(args.device)
    side = _load_config_sidecar(args.checkpoint) if args.checkpoint else None
    if side is not None:
        config, pcfg = side
    else:
        config = _build_config(args)
        pcfg = PruneConfig(mode=args.mode, predictor=args.predictor)
    if args.checkpoint:
        params = _restore(args.checkpoint, device)
    else:
        params = init_pruned_vit_params(config, pcfg, torch.Generator().manual_seed(0), device)

    if args.dataset == "synthetic":
        images, labels = synthetic_dataset(
            n=args.num_images, image_size=config.image_size, num_labels=config.num_labels
        )
    elif args.dataset == "cifar100":
        images, labels = load_cifar100(args.data_path, train=False, size=args.num_images)
    else:
        images, labels = load_image_folder(
            args.data_path, size=args.num_images, image_size=config.image_size
        )

    with torch.no_grad():
        x = vit_preprocess(torch.from_numpy(images).to(device), config.image_size)
        out = pruned_vit_forward(params, x, config, pcfg, compute_oracle=True,
                                 generator=torch.Generator(device=device).manual_seed(0))
    km = out["keep_masks"].cpu().numpy()
    ok = out["aux"]["oracle_keep"].cpu().numpy()
    xs = x.cpu().numpy()

    o = args.out_dir
    skipped_heatmaps(km, os.path.join(o, "skipped_heatmaps"))
    to_skip_heatmaps(ok, os.path.join(o, "to_skip_heatmaps"))
    misclassified_heatmaps(km, ok, os.path.join(o, "misclassified_heatmaps"))
    skips_per_layer_chart(km, os.path.join(o, "skips_per_layer.png"))
    for bi in range(min(4, len(images))):
        blackout_montage(
            xs[bi], km[:, bi], config.patch_size,
            out_path=os.path.join(o, f"blackout_img{bi}.png"),
        )
    sims = layer_similarity_profile(params["backbone"], x, config)
    plot_similarity_distributions(sims, os.path.join(o, "cosine_similarity.png"))
    hwc = [xi.transpose(1, 2, 0) * 0.5 + 0.5 for xi in xs[:4]]
    class_names = None
    if config.num_labels == 100:
        from vit_pruning_tpu_torch.data.cifar100_labels import CIFAR100_FINE_LABELS

        class_names = CIFAR100_FINE_LABELS
    inference_report(
        hwc, km[:, :4], out["logits"][:4].float().cpu().numpy(), config.patch_size,
        class_names=class_names,
        out_path=os.path.join(o, "report.html"),
    )
    print(f"viz artifacts written to {o}/")
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.command == "train":
        return cmd_train(args)
    if args.command == "viz":
        return cmd_viz(args)
    if args.command == "export":
        return cmd_export(args)
    return cmd_eval(args)


if __name__ == "__main__":
    raise SystemExit(main())
