"""outputs_device_ms: device milliseconds per batch of the operations the
program launched inside its `outputs` spans (models/pruned_vit.py::
progressive_topk_forward's keep masks and scores over the original
positions, and their final stacks), over the program stretch's counted
batches (portbench/program.py).
Not run by any cell until harness.run_cell records the program stretch;
None until then."""

from portbench import program


def read(records):
    prog = records.get("program")
    return None if prog is None else program.device_ms(prog, "outputs")
