"""The control of ``correct``: the plain model at low precision (for the
U-Net, float8) in the program's place, through the kind module's
``control_readings``, has to fail one of each cell's limits. On the CPU at
a small size, and on the card at the cell's own size (marked ``card``)."""

import pytest

from portbench import spec
from portbench.tests.conftest import ROOT
from portbench.tests.test_portbench_harness import CELLS, _tiny
from portbench.tools.control import control_readings


def _fails(readings, cell):
    limits = spec.limits_of(ROOT, cell)
    return [k for k, v in readings.items() if v > limits[k]]


@pytest.mark.parametrize("seed", [5, 2**31 + 3])
@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_fails_at_a_small_size(cell, seed):
    readings = control_readings(ROOT, cell, seed, "cpu", _tiny(cell))
    assert _fails(readings, cell), readings


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_float8_control_fails_at_the_cells_size(cell, card):
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        readings = control_readings(ROOT, cell, seed, card)
        assert _fails(readings, cell), (seed, readings)
