"""The port's scenario ladder (`experiments.configs.SCENARIOS`) is the JAX
package's: the same names, sizes, depths, samples, cameras, per-frame
camera sequences and scenes."""

import numpy as np
import pytest

from toroidal_ray_tracing_tpu.experiments.configs import (
    SCENARIOS as JAX_SCENARIOS)
from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS


def _pose(cam):
    return np.asarray(cam.eye, np.float64), np.asarray(cam.center,
                                                       np.float64)


def test_same_ladder():
    assert sorted(SCENARIOS) == sorted(JAX_SCENARIOS) == list(range(1, 9))


@pytest.mark.parametrize("num", range(1, 9))
def test_scenario_matches_jax(num):
    sc, ref = SCENARIOS[num], JAX_SCENARIOS[num]
    for field in ("name", "width", "height", "max_depth", "spp",
                  "animate_frames", "tile_rows"):
        assert getattr(sc, field) == getattr(ref, field), field
    assert sc.settings().max_depth == ref.settings().max_depth
    for a, b in zip(_pose(sc.camera_at(0)), _pose(ref.camera_at(0))):
        np.testing.assert_array_equal(a, b)
    cams, ref_cams = sc.cameras_seq(4), ref.cameras_seq(4)
    assert len(cams) == len(ref_cams) == 4
    for c, r in zip(cams, ref_cams):
        for a, b in zip(_pose(c), _pose(r)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    if num != 8:   # config 8's 1.18M-triangle mesh: its function below
        sd, ref_sd = sc.scene(), ref.scene()
        assert len(sd.models) == len(ref_sd.models)
        assert len(sd.instances) == len(ref_sd.instances)
        for m, r in zip(sd.models, ref_sd.models):
            assert type(m).__name__ == type(r).__name__
            if hasattr(r, "positions"):
                np.testing.assert_array_equal(m.positions, r.positions)


def test_config8_scene_function():
    assert (SCENARIOS[8].scene.__name__ == JAX_SCENARIOS[8].scene.__name__
            == "scene_hires_mesh")
