"""select_device_ms: device milliseconds per batch of the operations the
program launched inside its `select` spans (models/pruned_vit.py's
progressive_drop, and merge_dropped_tokens where on: the predictor, the
keep projection, the compaction gather), over the program stretch's counted
batches (portbench/program.py); None where no token drops.
Not run by any cell until harness.run_cell records the program stretch;
None until then."""

from portbench import program


def read(records):
    prog = records.get("program")
    return None if prog is None else program.device_ms(prog, "select")
