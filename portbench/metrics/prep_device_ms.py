"""prep_device_ms: device milliseconds per batch of the operations the program
launched inside its `prep` spans: the per-call weight preparation of
models/vit.py::layers_for (under int8 kernel B4's K-major layout) and of the
B1-B4 wrappers before their vpt:: operator (padding, B1's QKV and B2's K/V
concatenations, the classifier's pad), over the program stretch's counted
batches (portbench/program.py).
Not run by any cell until harness.run_cell records the program stretch;
None until then."""

from portbench import program


def read(records):
    prog = records.get("program")
    return None if prog is None else program.device_ms(prog, "prep")
