"""On the card: the control comes out not correct and the program correct, each as the
cell's own comparison (``harness.verdict``) judges it, on three seeds at a size that a test
run holds (``python -m pytest -c /dev/null perfbench/tests -m chip``).

The control is the reference in the precision below the one the configuration states, put
in the program's place (``calibrate.py``); the limits were set from the same readings at the
cells' full sizes."""

import pytest

from perfbench import calibrate, harness

SEEDS = (2**31 + 501, 2**31 + 502, 2**31 + 503)
# Rows a test run holds: at least 261,633 float64 rows, so that msd still streams.
ROWS = {"higgs.fit": 1_048_576, "msd.fit": 300_000}


@pytest.mark.chip
@pytest.mark.parametrize("name", sorted(ROWS))
def test_the_control_fails_and_the_program_passes(name, cuda_device):
    cell = harness.load_cell(name)
    cell.config["n_train"] = ROWS[name]
    for seed in SEEDS:
        found = calibrate.readings(cell, seed, cuda_device, controls=True)
        program = next(r for r in found if r["reading"] == "program")
        controls = [r for r in found if r["reading"].startswith("control_")]
        assert program["correct"], (seed, program)
        assert controls and not any(c["correct"] for c in controls), (seed, controls)
