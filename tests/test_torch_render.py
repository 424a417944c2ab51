"""The port's `render` on the CPU, both backends, against the JAX package's
`render` (jnp backend) on the same scene state, and against the checked-in
goldens.

Bounds: image RMSE < 1e-5 at 24x24 (tests/test_pallas.py's pallas-vs-jnp
bound); rays_traced exactly equal; hit_position / ray_origin / ray_dir
within atol 1e-5; goldens max |diff| < 5e-4 at 32x32 (tests/test_golden.py's
bound)."""

import os

import numpy as np
import pytest
import torch

from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.render import render as jax_render
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu.scene import build_scene as jax_build
from toroidal_ray_tracing_tpu.scene import procedural as jax_proc
from toroidal_ray_tracing_tpu_torch import render
from toroidal_ray_tracing_tpu_torch.cameras import (PinholeCamera,
                                                    ToroidalCamera)
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings, build_scene,
                                                  procedural,
                                                  scene_from_numpy,
                                                  settings_from_numpy)

torch.set_num_threads(2)

RES = 24
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# the five scenes of tests/test_pallas.py::test_pallas_matches_jnp
SCENES = {
    "multi_torus": (lambda p: p.scene_multi_torus(True), 2),
    "cornellish": (lambda p: p.scene_cornellish(), 2),
    "torus_plane": (lambda p: p.scene_torus_plane(True), 1),
    "instanced": (lambda p: p.scene_instanced_torus_grid(n=32), 2),
    "instanced_gated": (lambda p: p.scene_instanced_torus_grid(n=128), 2),
}


def rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_matches_jax(name, backend):
    sd, depth = SCENES[name]
    jscene = jax_build(sd(jax_proc))
    jst = JaxSettings.default(max_depth=depth)
    eye, center = (8.0, 5.0, 8.0), (0.0, 0.5, 0.0)
    ref = jax_render(jscene, JaxPinhole(eye=eye, center=center), RES, RES,
                     jst)
    out = render(scene_from_numpy(jscene),
                 PinholeCamera(eye=eye, center=center), RES, RES,
                 settings_from_numpy(jst), backend=backend)
    assert out["image"].shape == (RES, RES, 3)
    err = rmse(out["image"].numpy(), ref["image"])
    assert err < 1e-5, f"{name}/{backend}: rmse {err}"
    assert out["rays_traced"] == int(float(ref["rays_traced"]))
    for key in ("hit_position", "ray_origin", "ray_dir"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(ref[key]),
                                   atol=1e-5, rtol=0, err_msg=key)


# tests/test_golden.py's cases, built by the port's own scene build
GOLDEN_CASES = {
    "multi_torus_pinhole": (
        lambda: procedural.scene_multi_torus(True),
        PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0)),
        dict(max_depth=3)),
    "cornellish_toroidal": (
        procedural.scene_cornellish,
        ToroidalCamera(eye=(0.0, 1.0, 0.0), center=(8.0, 0.0, 0.0)),
        dict(max_depth=2, rho=5.0)),
    "torus_plane_shadow": (
        lambda: procedural.scene_torus_plane(True),
        PinholeCamera(eye=(7.0, 4.0, 7.0), center=(0.0, 0.5, 0.0)),
        dict(max_depth=1, light_position=(6.0, 10.0, 2.0))),
    "textured_mesh": (
        procedural.scene_textured_mesh,
        PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0)),
        dict(max_depth=3)),
}


# every golden on the torch backend; the untextured ones on the kernel
# backend too (textures on the kernel path wait for the K4 port)
@pytest.mark.parametrize("name,backend", (
    [(name, "torch") for name in sorted(GOLDEN_CASES)]
    + [(name, "kernel") for name in sorted(GOLDEN_CASES)
       if name != "textured_mesh"]))
def test_golden(name, backend):
    sd, cam, kw = GOLDEN_CASES[name]
    want = np.load(os.path.join(GOLDEN, f"{name}.npz"))["image"]
    got = render(build_scene(sd()), cam, 32, 32,
                 RenderSettings.default(**kw), backend=backend)["image"]
    err = np.abs(got.numpy() - want).max()
    assert err < 5e-4, f"{name}/{backend}: max pixel diff {err}"


@pytest.mark.parametrize("backend", ["torch", "kernel"])
def test_max_depth_zero_traces_one_segment(backend):
    """The raygen loop is a do-while (rgen:75-108): max_depth=0 still
    traces the primary segment, exactly like max_depth=1."""
    scene = build_scene(procedural.scene_multi_torus(True))
    cam = PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0))
    a = render(scene, cam, 16, 16, RenderSettings.default(max_depth=0),
               backend=backend)
    b = render(scene, cam, 16, 16, RenderSettings.default(max_depth=1),
               backend=backend)
    assert a["rays_traced"] >= 16 * 16
    assert a["rays_traced"] == b["rays_traced"]
    torch.testing.assert_close(a["image"], b["image"], rtol=0, atol=0)


def test_banded_and_spp_render():
    """tile_rows banding reproduces the full-frame image; spp > 1 adds
    seeded jittered samples (same seed, same image)."""
    scene = build_scene(procedural.scene_torus_plane(True))
    cam = PinholeCamera(eye=(7.0, 4.0, 7.0), center=(0.0, 0.5, 0.0))
    st = RenderSettings.default(max_depth=2)
    full = render(scene, cam, 24, 16, st)
    banded = render(scene, cam, 24, 16, st, tile_rows=5)
    assert banded["rays_traced"] == full["rays_traced"]
    for key in ("image", "hit_position", "ray_origin", "ray_dir"):
        torch.testing.assert_close(banded[key], full[key], rtol=0, atol=1e-6)
    a = render(scene, cam, 24, 16, st, spp=3, seed=7)
    b = render(scene, cam, 24, 16, st, spp=3, seed=7)
    torch.testing.assert_close(a["image"], b["image"], rtol=0, atol=0)
    assert a["rays_traced"] > full["rays_traced"]
    assert rmse(a["image"].numpy(), full["image"].numpy()) > 0


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    scene = build_scene(procedural.scene_torus_plane(True))
    with pytest.raises(RuntimeError, match="CUDA"):
        render(scene, PinholeCamera(), 8, 8, device="cuda")
