"""A run whose timed path is broken underneath comes out not correct: the rest of a cell's
run on the CPU, at a tiny size, with each fault the cell can have planted in the program
(``perfbench/faults.py``), against the cell's own limits. A fit has no state that steps
return, and one chip no exchange between chips: those faults do not apply to these cells."""

import pytest

from perfbench import faults
from perfbench.tests.test_perfbench_reference import tiny_run

CASES = [(name, fault) for name in ("higgs.fit", "msd.fit") for fault in sorted(faults.FAULTS)]


@pytest.mark.parametrize(("name", "fault"), CASES)
def test_a_broken_fit_is_not_correct(name, fault, small_streaming_fits):
    with faults.planted(fault) as number:
        out = tiny_run(name)
    assert out["correct"] is False
    assert out["compared"][number]["value"] > out["compared"][number]["limit"]
