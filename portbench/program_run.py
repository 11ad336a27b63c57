"""One traced run of a cell with the program stretch (portbench/program.py)
beside portbench/trace.py's two. Run from the root of a checkout, on the
card:

    python3 portbench/program_run.py --workload deit_s.headline.bf16.b512 --seed 12345 \
        --out chiprun_out/program.json

It stands in for harness.run_cell until that records the program stretch
itself (PERF.md, Open questions), and goes with that change. It sets the
cell up as portbench/run.py does (no output check), runs trace.py's two
stretches and the program stretch, and reads from them other_device_ms,
device_idle_share and the six metrics of the program's spans
(embed_device_ms, prep_device_ms, select_device_ms, outputs_device_ms,
entry_idle_ms, layer_row_ns); besides, the share of other_device_ms the
four device-time spans cover, the stretch's idle split by the innermost
span and each span's host self time a batch.

Prints one JSON object as the last line of standard output and writes it
to --out.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PROGRAM_METRICS = ("embed_device_ms", "prep_device_ms", "select_device_ms",
                   "outputs_device_ms", "entry_idle_ms", "layer_row_ns")
OTHER_SPANS = ("embed", "prep", "select", "outputs")  # their device time is other_device_ms'


def serving(cell: dict, seed: int, device):
    """The cell's closed loop on the program, warmed up over the pool."""
    from portbench import harness, weights
    from portbench.serve import Server
    from vit_pruning_tpu_torch.ops.cuda.build import load_library

    m, traffic = cell["model"], cell["traffic"]
    load_library()
    params = cell["family"].make_params(m, seed, device, harness.DTYPES[traffic["dtype"]])
    pool = weights.make_pool(m, traffic, seed, device)
    server = Server(cell["family"].program(cell, params, None), pool, traffic["in_flight"])
    server.run(batches=traffic["pool"] + traffic["in_flight"])
    return server


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from portbench import cells, harness, program
    from portbench.run import card_line

    if not torch.cuda.is_available():
        print("program_run: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    cell = cells.load_cell(args.workload)
    server = serving(cell, args.seed % (1 << 63), torch.device("cuda", 0))
    timeline, rec = harness.traced_stretches(server, cell)
    prog = program.stretch(server, cell)
    sched = harness.prune_schedule(cell)
    records = {"model": cell["model"], "traffic": cell["traffic"], "schedule": sched,
               "window": None, "flops_per_image": cell["family"].model_flops(cell["model"], sched),
               "trace": rec, "timeline": timeline, "program": prog}
    metrics = {name: cells.reader(cell["bench_dir"], name)(records)
               for name in ("other_device_ms", "device_idle_share") + PROGRAM_METRICS}
    batches = prog["window"]["batches"]
    window_ops = [d for d in prog["device_ops"]
                  if d["end"] > 0 and d["start"] < prog["window"]["t1"]]
    spans_per_batch = sum(sp["call"] in set(prog["counted"]) for sp in prog["spans"]) / batches
    covered = sum(metrics[f"{n}_device_ms"] or 0.0 for n in OTHER_SPANS)
    out = {
        "workload": args.workload, "seed": args.seed, "card": card_line(),
        "torch": torch.__version__, "metrics": metrics,
        "coverage": covered / metrics["other_device_ms"] if metrics["other_device_ms"] else None,
        "program_idle_share": program.idle_share(prog),
        "program_idle_ms": 1e3 * sum(g for g, _ in program.idle_gaps(prog)) / batches,
        "idle_split_ms": program.idle_split(prog),
        "host_self_ms": program.host_self_ms(prog),
        "device_ms_by_span": {n: program.device_ms(prog, n)
                              for n in sorted({sp["name"] for sp in prog["spans"]})},
        "window_ops": len(window_ops),
        "window_ops_in_a_span": sum(d["span"] is not None for d in window_ops),
        "unplaced": prog["unplaced"], "device_ops": len(prog["device_ops"]),
        "spans_per_batch": spans_per_batch, "dropped": prog["dropped"], "batches": batches,
        "seconds": time.perf_counter() - T_START,
    }
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
