"""A run with the timed path broken underneath comes out not correct, once
for each fault a cell can have (the exchange between chips: no cell runs
on more than one); the same run with nothing broken comes out correct.
Tiny frames on the CPU, the harness's look for a card skipped."""

import time

import pytest

from rtbench import run
from rtbench.tests import faults

CELLS = ("capture.step60", "flythrough4k.orbit8", "capture.gtruth_batch4")


def one_run(root, cell, seed=2**31 + 11):
    res, _ = run.run(cell, seed, 0.01, 0, device="cpu", root=root,
                     t_start=time.perf_counter())
    return res


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(tiny_root, cell):
    res = one_run(tiny_root, cell)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_caught(tiny_root, monkeypatch, cell, fault):
    faults.FAULTS[fault](monkeypatch)
    res = one_run(tiny_root, cell)
    assert not res["correct"], res["checks"]
