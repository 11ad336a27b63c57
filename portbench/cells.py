"""Finding a cell's parts by name: BENCHMARK.json names the cells, and each
configuration, traffic mix, set of limits and per-layer metric is a file of
its own under the benchmark's directory:

    BENCHMARK.json's `configs[*].file`   the configuration (sizes, source)
    portbench/traffic/<traffic>.json     the traffic mix
    portbench/limits/<cell>.json         the limits of the output check
    portbench/metrics/<metric>.py        a per-layer metric's reader
    portbench/families/<family>.py       a model family: sizes, weights, plain
                                         reference, operation count, entry
                                         (the configuration's `family`, else vit)

A cell, mix, configuration or metric is added by adding files and entries;
no code here names one.
"""

from __future__ import annotations

import functools
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def family(bench_dir: Path, name: str):
    """The model family `name`: portbench/families/<name>.py, loaded by path
    (its interface: families/vit.py's docstring)."""
    return _family(str(Path(bench_dir) / "families" / f"{name}.py"))


@functools.lru_cache(maxsize=None)
def _family(path: str):
    if not Path(path).is_file():
        raise FileNotFoundError(f"no model family file {path}")
    module = f"portbench_family_{Path(path).stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family_of(cell: dict):
    """The cell's family; a cell dict built without one is a `vit`."""
    return cell.get("family") or family(BENCH_DIR, "vit")


def model_dims(cfg: dict) -> dict:
    """The sizes the harness, the reference and the yardstick read, from a
    configuration file's keys, by the configuration's family (`vit` where
    it names none)."""
    return family(BENCH_DIR, cfg.get("family", "vit")).dims(cfg)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> dict:
    """Everything a run of cell `name` reads: the workload entry, the
    configuration (file, model family and model dims), the traffic mix, the
    limits, the end-to-end and per-layer metrics it reports."""
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
    fam = family(bench_dir, cfg.get("family", "vit"))
    return {"name": name, "workload": w, "config": cfg, "family": fam, "model": fam.dims(cfg),
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
