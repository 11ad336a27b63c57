"""Benchmark of vit_pruning_tpu_torch serving on the card: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the chips the cell asks
for. The last line of standard output is the result: correct, attempted,
failed, the cell's end-to-end metrics (--trace 0) or per-layer metrics
(--trace 1), the device and, traced, the breakdown; the numbers of the output
check and their limits come last there and as the last lines of standard
error. No result is printed, and the exit code is not 0, when CUDA or the
cell's chips are missing, when a JAX module is loaded, or when the program
cannot be imported.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# Python's bytecode, cached inside the checkout at a fixed path: the
# installation may ship torch without .pyc files (and with writing them off),
# and compiling its modules again costs seconds of every run's set-up
BYTECODE = ROOT / ".bytecode"


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi not read: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import cells, harness

    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    chips = cell["workload"]["chips"]
    if torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} chips, {torch.cuda.device_count()} seen",
              file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    result, info = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                    torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    print(f"portbench: {args.workload} seed {args.seed}; card: {card_line()}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}", file=sys.stderr)
    print("portbench: " + json.dumps(info), file=sys.stderr)
    print(f"portbench: correct {result['correct']}, the numbers compared and their limits:",
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"  {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.pycache_prefix, sys.dont_write_bytecode = str(BYTECODE), False
    sys.exit(main())
