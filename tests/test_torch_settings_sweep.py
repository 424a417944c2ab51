"""The port's settings sweep (`experiments/settings_sweep.py`, the
reference's ImGui tweak panel): the JAX package's tests
(tests/test_settings_sweep.py) mirrored, and the port's sweep held against
the JAX `sweep` (RMSE < 1e-5)."""

import os

import numpy as np
import torch

from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.experiments.settings_sweep import (
    sweep as jax_sweep)
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu.scene import build_scene as jax_build_scene
from toroidal_ray_tracing_tpu.scene import procedural as jax_procedural
from toroidal_ray_tracing_tpu_torch import PinholeCamera, render
from toroidal_ray_tracing_tpu_torch.experiments.settings_sweep import (
    _apply, main, sweep)
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings, build_scene,
                                                  procedural,
                                                  scene_from_numpy,
                                                  settings_from_numpy)

torch.set_num_threads(2)

RES = 64


def test_sweep_matches_individual_renders():
    scene = build_scene(procedural.scene_torus_plane())
    cam = PinholeCamera(eye=(7.0, 4.0, 7.0), center=(0.0, 0.5, 0.0))
    st = RenderSettings.default(max_depth=2)
    values = [20.0, 100.0, 250.0]
    out = sweep(scene, cam, RES, RES, st, "light_intensity", values,
                device="cpu")
    imgs = out["images"].numpy()
    assert imgs.shape == (3, RES, RES, 3)
    for i, v in enumerate(values):
        ref = render(scene, cam, RES, RES, _apply(st, "light_intensity", v),
                     device="cpu")
        np.testing.assert_allclose(imgs[i], ref["image"].numpy(), atol=1e-6)
        assert int(out["rays_traced"][i]) == ref["rays_traced"]
    # brighter light, brighter frame
    assert imgs[2].mean() > imgs[0].mean()


def test_sweep_params_cover_reference_panel():
    st = RenderSettings.default()
    assert float(_apply(st, "light_y", 3.0).light.position[1]) == 3.0
    assert float(st.light.position[1]) == 15.0    # the base is not changed
    assert int(_apply(st, "light_type", 1).light.type) == 1
    assert int(_apply(st, "max_depth", 4).max_depth) == 4
    assert float(_apply(st, "rho", 6.5).rho) == 6.5
    assert _apply(st, "light_intensity", 0.1).light.intensity == float(
        np.float32(0.1))


def test_sweep_cli(tmp_path):
    files = main(["--scene", "torus_plane", "--param", "light_type",
                  "--values", "0", "1", "--out", str(tmp_path),
                  "--width", "64", "--height", "64", "--max-depth", "1",
                  "--eye", "7", "4", "7", "--center", "0", "0.5", "0",
                  "--device", "cpu", "--backend", "torch"])
    assert len(files) == 2
    assert all(os.path.exists(f) for f in files)


def test_sweep_equals_jax():
    """Light positions on the port and the JAX package at 32x32, both
    backends' default paths (torch / jnp)."""
    values = [2.0, 6.0, 10.0]
    jscene = jax_build_scene(jax_procedural.scene_torus_plane())
    jst = JaxSettings.default(max_depth=2)
    want = np.asarray(jax_sweep(
        jscene, JaxPinhole(eye=(7.0, 4.0, 7.0), center=(0.0, 0.5, 0.0)),
        32, 32, jst, "light_x", values)["images"])
    out = sweep(scene_from_numpy(jscene),
                PinholeCamera(eye=(7.0, 4.0, 7.0), center=(0.0, 0.5, 0.0)),
                32, 32, settings_from_numpy(jst), "light_x", values,
                device="cpu")
    got = out["images"].numpy()
    assert got.shape == want.shape == (3, 32, 32, 3)
    for i in range(len(values)):
        rmse = float(np.sqrt(np.mean((got[i] - want[i]) ** 2)))
        assert rmse < 1e-5, (values[i], rmse)
    assert not np.allclose(got[0], got[2])        # the light moved
