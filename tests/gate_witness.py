"""Witnesses for quality_torch.py's headline gate. `run`: the same run,
started from the JAX package's init (PRNGKey(42), as quality.py draws it)
instead of the port's torch.Generator(42) init. Everything else is the
port's: the datasets (byte-equal to quality.py's), the batch order, the
training and the evaluation. If the port's delta comes down to quality.py's
from this init, the init is what differs; if it does not, the recipe or
the numerics do.

    # where jax is installed (the CPU is enough: it only draws the init)
    python tests/gate_witness.py export tmp/gate_witness_init.pt
    # on the card (or with --device cpu), any quality_torch.py flags after the file
    python tests/gate_witness.py run tmp/gate_witness_init.pt --kernels eager

A third command measures how far the port's own init moves the gate:

    python tests/gate_witness.py reseed 43 --kernels eager

runs quality_torch.main with every init drawn from torch.Generator seeded
43 instead of 42.

`export` draws the gate model's backbone and the headline preset's cls_mlp
predictor with the JAX package's init_pruned_vit_params and saves them as
torch tensors (models/convert.py::params_from_jax). `run` swaps
quality_torch._init_params for a function that returns those tensors (the
predictor only where the preset asks for one) after checking the config and
every leaf's shape against the port's own init, then calls
quality_torch.main with the flags given. Only the default gate geometry
(or the --image_size / --num_labels given to both commands) is exported.
"""

import argparse
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def gate_config_json(image_size: int, num_labels: int) -> str:
    """quality_torch.build_task's gate model at these sizes, as JSON."""
    from vit_pruning_tpu_torch.configs import ViTConfig

    return ViTConfig(image_size=image_size, patch_size=4, hidden_size=128, num_layers=6,
                     num_heads=4, mlp_dim=256, num_labels=num_labels).to_json()


def export(path: str, image_size: int, num_labels: int, predictor_hidden: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from vit_pruning_tpu.configs import PruneConfig as JPruneConfig
    from vit_pruning_tpu.configs import ViTConfig as JViTConfig
    from vit_pruning_tpu.models.pruned_vit import init_pruned_vit_params
    from vit_pruning_tpu_torch.models.convert import params_from_jax

    cfg_json = gate_config_json(image_size, num_labels)
    pcfg = JPruneConfig(mode="topk", predictor="cls_mlp", predictor_hidden=predictor_hidden)
    tree = init_pruned_vit_params(jax.random.PRNGKey(42), JViTConfig.from_json(cfg_json), pcfg)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"config": cfg_json, "predictor": "cls_mlp",
                "predictor_hidden": predictor_hidden,
                "params": params_from_jax(tree, "cpu")}, path)
    print(f"wrote the JAX PRNGKey(42) init of {cfg_json} to {path}")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def run(path: str, argv) -> int:
    import quality_torch
    from vit_pruning_tpu_torch.models.convert import tree_to

    own = quality_torch._init_params

    def jax_init(config, pcfg, device, seed: int = 42) -> dict:
        like = own(config, pcfg, device, seed)
        saved = torch.load(path, map_location="cpu", weights_only=True)  # fresh tensors
        if seed != 42 or config.to_json() != saved["config"]:
            raise ValueError(f"no JAX init exported for seed {seed}, {config.to_json()}")
        tree = {"backbone": saved["params"]["backbone"], "predictor": None}
        if pcfg.predictor != "none":
            if (pcfg.predictor, pcfg.predictor_hidden) != (saved["predictor"],
                                                           saved["predictor_hidden"]):
                raise ValueError(f"no JAX init exported for predictor {pcfg.predictor} "
                                 f"(hidden {pcfg.predictor_hidden})")
            tree["predictor"] = saved["params"]["predictor"]
        got, want = dict(_leaves(tree)), dict(_leaves(like))
        shapes = {k: None if v is None else tuple(v.shape) for k, v in got.items()}
        if shapes != {k: None if v is None else tuple(v.shape) for k, v in want.items()}:
            raise ValueError("the exported JAX init does not match the port's tree")
        print(f"init: the JAX package's PRNGKey(42) draw ({pcfg.mode}, predictor "
              f"{pcfg.predictor})", file=sys.stderr, flush=True)
        return tree_to(tree, device)

    quality_torch._init_params = jax_init
    try:
        return quality_torch.main(argv)
    finally:
        quality_torch._init_params = own


def reseed(seed: int, argv) -> int:
    import quality_torch

    own = quality_torch._init_params
    quality_torch._init_params = lambda config, pcfg, device, _=42: own(config, pcfg, device, seed)
    try:
        return quality_torch.main(argv)
    finally:
        quality_torch._init_params = own


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="gate_witness")
    sub = ap.add_subparsers(dest="command", required=True)
    e = sub.add_parser("export", help="draw the JAX init (needs jax)")
    e.add_argument("path")
    e.add_argument("--image_size", type=int, default=32)
    e.add_argument("--num_labels", type=int, default=128)
    e.add_argument("--predictor_hidden", type=int, default=64)
    r = sub.add_parser("run", help="quality_torch.main from the exported init")
    r.add_argument("path")
    s = sub.add_parser("reseed", help="quality_torch.main from the port's init at this seed")
    s.add_argument("seed", type=int)
    args, rest = ap.parse_known_args(argv)
    if args.command == "export":
        export(args.path, args.image_size, args.num_labels, args.predictor_hidden)
        return 0
    if args.command == "reseed":
        return reseed(args.seed, rest)
    return run(args.path, rest)


if __name__ == "__main__":
    raise SystemExit(main())
