"""layer_row_ns: device nanoseconds per token row per layer of the
operations the program launched inside its `layers` spans (models/
pruned_vit.py's run_segment: kernels B1, B4 or B5), over the token rows
those spans ran (their `rows` count: batch x live tokens x layers), in the
program stretch's counted batches (portbench/program.py): the layer
kernels' time at the width of the cell, whatever the drop schedule.
Not run by any cell until harness.run_cell records the program stretch;
None until then."""

from portbench import program


def read(records):
    prog = records.get("program")
    return None if prog is None else program.layer_row_ns(prog)
