"""The control of each cell's comparison fails the cell's limits, on the
card at the cell's own size: the reference in the precision below the
one the configuration states put in the program's place (or the
program's own lower-precision path), a short window, one seed. The
readings the limits were set from ran the same code over more seeds
(``benchmark/control.py``)."""

import pytest

from benchmark import harness
from benchmark.control import outcome
from conftest import CELLS, load_cell


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(name, card):
    cell = load_cell(name)
    correct, checks = harness.judge(outcome(cell, 2 ** 31 + 101, 1.0, card),
                                    cell.limits)
    assert not correct, checks


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_program_within_the_limits(name, card):
    cell = load_cell(name)
    correct, checks = harness.judge(
        outcome(cell, 2 ** 31 + 102, 1.0, card, program=True), cell.limits)
    assert correct, checks
