"""On the card: every cell of BENCHMARK.json at its own size and load, a
sound run judged correct and the cell's lower-precision control judged not
correct on three seeds (portbench/control.py's control: the program's own
int8 path for a bf16 cell, the reference with 4-bit weights for an int8
cell). Skips without a card."""

import json
import time

import pytest

from portbench import cells, control, harness

CELLS = [w["name"] for w in json.loads((cells.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_passes(card, name):
    cell = cells.load_cell(name)
    sound, _ = harness.run_cell(cell, 2 ** 31 + 11, 2.0, False, card, time.perf_counter())
    assert sound["correct"], sound["checks"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        ctl, _ = harness.run_cell(cell, seed, 2.0, False, card, time.perf_counter(),
                                  serve=control.control(cell))
        assert not ctl["correct"], (seed, ctl["checks"])
