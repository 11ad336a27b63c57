"""entry_idle_ms: milliseconds per batch in which the card was idle while the
host was inside the program's `serve` span (serving.py::serving_forward):
the idle gaps of the program stretch's window whose midpoint falls inside
the call, where the program's own dispatch kept the card waiting
(portbench/program.py).
Not run by any cell until harness.run_cell records the program stretch;
None until then."""

from portbench import program


def read(records):
    prog = records.get("program")
    return None if prog is None else program.entry_idle_ms(prog)
