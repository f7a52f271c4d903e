"""At a tiny size on the CPU, the port's CPU path and the plain
reference agree within each cell's limits, through the whole run: set-up,
window, the reference and the comparison."""

import pytest

from benchmark import harness
from conftest import CELLS, cpu_run, tiny_cell


@pytest.mark.parametrize("name", CELLS)
def test_cpu_path_agrees_with_reference(name):
    # the CPU path computes in float32 (the train step as configured would
    # run bf16 through the kernels' slow plain versions)
    cell = tiny_cell(name, **{"train.compute_dtype": "float32"})
    _, out = cpu_run(cell)
    correct, checks = harness.judge(out, cell.limits)
    assert out.attempted > 0
    assert correct, checks
