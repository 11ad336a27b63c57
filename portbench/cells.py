"""Finding a cell's parts by name: BENCHMARK.json names the cells, and each
configuration, traffic mix, set of limits and per-layer metric is a file of
its own under the benchmark's directory:

    BENCHMARK.json's `configs[*].file`   the configuration (sizes, source)
    portbench/traffic/<traffic>.json     the traffic mix
    portbench/limits/<cell>.json         the limits of the output check
    portbench/metrics/<metric>.py        a per-layer metric's reader

A cell, mix, configuration or metric is added by adding files and entries;
no code here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def model_dims(cfg: dict) -> dict:
    """The sizes the harness, the reference and the yardstick read, from a
    configuration file's keys (the source's own names)."""
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    if d % heads:
        raise ValueError(f"hidden_size {d} is not a multiple of num_attention_heads {heads}")
    if cfg["image_size"] % cfg["patch_size"]:
        raise ValueError("image_size is not a multiple of patch_size")
    if cfg.get("hidden_act", "gelu") != "gelu" or not cfg.get("qkv_bias", True):
        raise ValueError("the served model is a pre-LN ViT with exact GELU and q/k/v biases")
    grid = cfg["image_size"] // cfg["patch_size"]
    pred = cfg.get("predictor") or {"kind": "none", "hidden": 0}
    return {
        "hidden": d, "heads": heads, "head_dim": d // heads, "attn_width": d,
        "mlp": cfg["intermediate_size"], "layers": cfg["num_hidden_layers"],
        "labels": cfg["num_labels"], "eps": cfg["layer_norm_eps"],
        "image": cfg["image_size"], "patch": cfg["patch_size"], "channels": cfg["num_channels"],
        "patches": grid * grid, "patch_dim": cfg["num_channels"] * cfg["patch_size"] ** 2,
        "predictor": pred["kind"], "predictor_hidden": pred["hidden"],
        "image_mean": cfg["image_mean"], "image_std": cfg["image_std"],
    }


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """Everything a run of cell `name` reads: the workload entry, the
    configuration (file and model dims), the traffic mix, the limits, the
    end-to-end and per-layer metrics it reports."""
    bench = _json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(work)})")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    cfg = _json(root / conf["file"])
    bench_dir = root / Path(conf["file"]).parts[0]
    traffic = _json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = _json(bench_dir / "limits" / f"{name}.json")

    def reports(metric: dict) -> bool:
        return name in metric["workloads"] if "workloads" in metric else True

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if m["moves"] in e2e_names and reports(m)]
    return {"name": name, "workload": w, "config": cfg, "model": model_dims(cfg),
            "traffic": traffic, "limits": limits, "end_to_end": e2e, "per_layer": per_layer,
            "bench_dir": bench_dir}


def reader(bench_dir: Path, metric: str):
    """The `read(records)` function of portbench/metrics/<metric>.py."""
    path = bench_dir / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
