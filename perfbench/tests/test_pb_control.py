"""Each cell's control, at a size a CPU test can hold: the plain
reference in the program's place at the precision below the
configuration's (ids in ``b - 1`` bytes; the GCN's dense products in
bfloat16, as a CPU has no TF32) must come out not correct where the
program's own run is correct, and so must the training cell's planted
fault (half of the batch left out)."""

import pytest

from perfbench import control
from perfbench.tests.conftest import TINY


@pytest.mark.parametrize("workload", sorted(TINY))
def test_the_control_fails_where_the_program_passes(bench, workload):
    r = control.readings(bench, workload, 20260101, 0.5, "cpu",
                         updates=TINY[workload])
    assert r["program"]["correct"], r["program"]
    controls = {k: v for k, v in r.items() if k != "program"}
    assert controls
    for side, got in controls.items():
        assert not got["correct"], (side, got)
