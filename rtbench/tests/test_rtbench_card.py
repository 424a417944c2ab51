"""On the card: one short run of each cell, correct and complete."""

import time

import pytest

from rtbench import manifest, run


@pytest.mark.cuda
@pytest.mark.parametrize("cell", manifest.names("workloads", ".json"))
def test_a_cell_runs_on_the_card(cuda_device, cell):
    res, _ = run.run(cell, 2**31 + 19, 2.0, 0, device=cuda_device,
                     t_start=time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["metrics"]["frames_per_s"]["value"] > 0
