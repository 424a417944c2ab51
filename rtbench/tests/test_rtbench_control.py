"""The control, the reference in bfloat16 put in the program's place, fails
every cell's limits (tiny frames on the CPU)."""

import pytest

from rtbench import control


@pytest.mark.parametrize("cell", ["capture.step60", "flythrough4k.orbit8",
                                  "capture.gtruth_batch4"])
def test_the_control_fails_the_limits(tiny_root, cell):
    out = control.control(cell, 2**31 + 7, 40, "cpu", root=tiny_root)
    assert not out["passes_limits"], out
    assert out["checks"]
