r"""Readings for a cell's limits: the output check's numbers of sound runs of
the program on many seeds and of the cell's lower-precision control on a
few, in one process, at the cell's own sizes and load.

    python3 portbench/control.py --workload <cell> --seeds 1-12 \
        --control-seeds 101-103 [--int8-path 201-203] [--seconds 2]

The control is the reference in the program's place, its weight products
one step below the cell's precision: float8 e4m3 for a cell served in
bf16; 4-bit weights (int8 activations) in the int8 layers and float8 e4m3
in the rest for a cell served with int8 products. A cell served in bf16
also reads the program's own int8 path (`--int8-path`). Each run is a
short window of the cell's own closed loop, judged as a benchmark run
judges it. Prints one JSON line per run and, last, for each number the
largest sound reading, the smallest control reading and their ratio. The
benchmark's runs never run this.
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse  # noqa: E402
import json  # noqa: E402


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def control_precision(cell: dict) -> dict:
    """One step below the cell's: bfloat16 -> float8 e4m3, int8 -> 4-bit weights."""
    return {"layers": "w4a8" if cell["traffic"]["quant"] == "int8" else "fp8", "other": "fp8"}


def reference_call(cell: dict, params: dict, products: dict):
    """The reference of the cell's model family in the program's place, with
    the given weight products."""
    from portbench import cells, harness

    sched, forward = harness.prune_schedule(cell), cells.family_of(cell).forward
    return lambda pixels: forward(params, pixels, cell["model"], sched, **products)


def control(cell: dict):
    """serve(cell, params) -> call of the cell's control."""
    return lambda c, params: reference_call(c, params, control_precision(c))


def int8_path(cell: dict, params: dict):
    from portbench import harness

    return harness.program_call(cell, params, quant="int8")


def readings(cell: dict, seed_list: list, serve, seconds: float, device, label: str) -> list:
    from portbench import harness

    out = []
    for seed in seed_list:
        result, info = harness.run_cell(cell, seed, seconds, False, device, time.perf_counter(),
                                        serve=serve)
        nums = {k: v["value"] for k, v in result["checks"].items()}
        out.append(nums)
        print(json.dumps({"run": label, "seed": seed, "correct": result["correct"],
                          "failed": result["failed"], "checks": nums,
                          "checked_images": info["checked_images"]}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="101-103")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--int8-path", default="", help="seeds for the program's int8 path")
    args = ap.parse_args(argv)

    import torch

    from portbench import cells

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    sound = readings(cell, seeds(args.seeds), None, args.seconds, dev, "program")
    ctl = readings(cell, seeds(args.control_seeds), control(cell), args.seconds, dev, "control")
    int8 = (readings(cell, seeds(args.int8_path), int8_path, args.seconds, dev, "int8_path")
            if args.int8_path else [])
    summary = {}
    for name in sound[0]:
        lo, up = max(r[name] for r in sound), min(r[name] for r in ctl)
        summary[name] = {"lower": lo, "upper": up, "ratio": up / lo if lo else None}
        if int8:
            summary[name]["int8_path"] = min(r[name] for r in int8)
    print(json.dumps({"workload": args.workload, "readings": summary}), flush=True)
    return 0


if __name__ == "__main__":
    from portbench.run import BYTECODE

    sys.pycache_prefix, sys.dont_write_bytecode = str(BYTECODE), False
    sys.exit(main())
