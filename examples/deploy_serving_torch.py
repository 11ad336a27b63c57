"""Worked example: the deployment serving path of the PyTorch/CUDA port, end
to end (the port's counterpart of examples/deploy_serving.py).

Takes a (trained) model and serves raw uint8 images through the fastest
configuration the port offers:

  1. uint8 pixels -> the device, normalised and patch-projected there
     (`serving.serving_forward`);
  2. progressive top-k compaction (the sequence physically shrinks per the
     keep schedule: the composed configuration, half the heads and half the
     MLP channels);
  3. optionally int8 weight products (`quant_mode('int8')`, kernel B4 on
     the card);
  4. the whole uint8 -> logits program staged out with torch.export
     (`serving.export_serving`), the kernels in it as vpt:: operators, and
     reloaded (`serving.load_exported`).

On the card (the default) the layers run the CUDA kernels; `--device cpu`
runs their plain versions:

    python examples/deploy_serving_torch.py [--device cpu] [--out serving.pt2]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from vit_pruning_tpu_torch.configs import PruneConfig, composed_schedule, vit_tiny
from vit_pruning_tpu_torch.models.convert import check_device, tree_to
from vit_pruning_tpu_torch.models.pruned_vit import init_pruned_vit_params
from vit_pruning_tpu_torch.ops.dispatch import quant_mode
from vit_pruning_tpu_torch.ops.structured import prune_heads, prune_mlp_channels
from vit_pruning_tpu_torch.serving import export_serving, load_exported, serving_forward


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' asks for the CPU)")
    ap.add_argument("--out", default=None,
                    help="where to write the exported program (default: a temporary file)")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    config = vit_tiny(num_labels=100)
    # composed preset: structured halving + deep token schedule
    schedule = composed_schedule(config.num_patches, config.num_layers)
    pcfg = PruneConfig(mode="topk_prog", predictor="cls_mlp", loss="mse_attention",
                       top_k=schedule[0], keep_schedule=schedule)
    params = init_pruned_vit_params(config, pcfg, torch.Generator().manual_seed(0), "cpu")
    # in deployment: params = restore_checkpoint(...) / load_hf_vit(...)
    bb, served_config = prune_heads(
        params["backbone"], config, [list(range(0, config.num_heads, 2))] * config.num_layers)
    params["backbone"] = prune_mlp_channels(
        bb, [list(range(0, config.mlp_dim, 2))] * config.num_layers)
    # bf16 on the card; the CPU keeps float32, whose plain path is exact enough to compare
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    params = tree_to(params, device, dtype)

    images = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, (8, 3, config.image_size, config.image_size), np.uint8)).to(device)

    with torch.no_grad():
        logits = serving_forward(params, images, served_config, pcfg)["logits"]
        print(f"{dtype} serving logits: {tuple(logits.shape)} {logits.dtype}")
        with quant_mode("int8"):
            logits8 = serving_forward(params, images, served_config, pcfg)["logits"]
    lf, l8 = logits.float(), logits8.float()
    drift = float(torch.linalg.vector_norm(l8 - lf) / torch.linalg.vector_norm(lf))
    print(f"int8 serving logits: {tuple(logits8.shape)}; relative drift {drift:.4f}")
    agree = float((l8.argmax(-1) == lf.argmax(-1)).float().mean())
    print(f"argmax agreement {dtype} vs int8: {agree:.2%}")

    # 4. stage the whole program out: the serve-time host needs no model code,
    #    only torch.export.load (and the port's operators, for the kernels) + the weights
    path = args.out or os.path.join(tempfile.mkdtemp(), "vit_serving.pt2")
    export_serving(params, served_config, pcfg, batch_size=8, path=path)
    exported_logits = load_exported(path)(params, images)
    same = bool(torch.equal(exported_logits, logits))
    print(f"exported program {path}: bit-identical = {same}")
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
