"""embed_device_ms: device milliseconds per batch of the operations the program
launched inside its `embed` span (serving.py::embed_from_u8: the normalise,
the patch projection, the position add, CLS), over the program stretch's
counted batches (portbench/program.py).
Not run by any cell until harness.run_cell records the program stretch;
None until then."""

from portbench import program


def read(records):
    prog = records.get("program")
    return None if prog is None else program.device_ms(prog, "embed")
