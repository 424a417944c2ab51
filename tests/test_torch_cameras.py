"""The PyTorch port's raygen against the JAX package's (called with
xp=numpy): pinhole and toroidal rays, block-major pixel order."""

import numpy as np
import pytest
import torch

from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.cameras import ToroidalCamera as JaxToroidal
from toroidal_ray_tracing_tpu.cameras import generate_rays as jax_generate
from toroidal_ray_tracing_tpu.cameras import pinhole as jax_pinhole
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu_torch import render
from toroidal_ray_tracing_tpu_torch.cameras import (PinholeCamera,
                                                    ToroidalCamera,
                                                    generate_rays)
from toroidal_ray_tracing_tpu_torch.cameras import pinhole
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings, build_scene,
                                                  procedural)

torch.set_num_threads(2)


@pytest.mark.parametrize("kw,w,h", [
    (dict(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0)), 32, 24),
    (dict(eye=(25.0, 18.0, 25.0), center=(0.0, 0.0, 0.0)), 48, 27),
    (dict(eye=(0.0, 0.0, 5.0), center=(0.0, 0.0, 0.0), fov_deg=90.0), 33, 17),
])
def test_pinhole_rays_match(kw, w, h):
    o_ref, d_ref = jax_generate(JaxPinhole(**kw), w, h, JaxSettings.default(),
                                xp=np)
    o, d = generate_rays(PinholeCamera(**kw), w, h, RenderSettings.default())
    np.testing.assert_allclose(o.numpy(), o_ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(d.numpy(), d_ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("eye,center,rho", [
    ((0.0, 1.0, 0.0), (8.0, 0.0, 0.0), 4.0),      # pitched: theta applies
    ((1.0, 2.0, 3.0), (5.0, 2.0, -1.0), 6.0),     # level, temp.z < 0 flip
    ((0.0, 2.0, 0.0), (-4.0, 3.0, 2.0), 10.0),
])
def test_toroidal_rays_match(eye, center, rho):
    ref_cam = JaxToroidal(eye=eye, center=center)
    cam = ToroidalCamera(eye=eye, center=center)
    assert cam.offsets(rho) == ref_cam.offsets(rho)
    o_ref, d_ref = jax_generate(ref_cam, 40, 20,
                                JaxSettings.default(rho=rho), xp=np)
    o, d = generate_rays(cam, 40, 20, RenderSettings.default(rho=rho))
    np.testing.assert_allclose(o.numpy(), o_ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(d.numpy(), d_ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("w,h", [(48, 24), (30, 18), (24, 24)])
def test_block_order_and_unswizzle_exact(w, h):
    block = pinhole.pick_block(w, h)
    assert block == jax_pinhole.pick_block(w, h) and block > 1
    px, py = pinhole.pixel_coords(w, h, block)
    px_ref, py_ref = jax_pinhole.pixel_coords(np, w, h, block)
    np.testing.assert_array_equal(px.numpy(), px_ref)
    np.testing.assert_array_equal(py.numpy(), py_ref)
    a = np.arange(w * h * 3, dtype=np.float32).reshape(w * h, 3)
    np.testing.assert_array_equal(
        pinhole.block_unswizzle(torch.from_numpy(a), w, h, block).numpy(),
        jax_pinhole.block_unswizzle(np, a, w, h, block))


def test_toroidal_eye_equals_center_stays_finite():
    """eye == center gives NaN directions; the render swallows them as
    misses and stays finite (the verify skill's probe)."""
    scene = build_scene(procedural.scene_torus_plane(True))
    cam = ToroidalCamera(eye=(0.0, 1.0, 0.0), center=(0.0, 1.0, 0.0))
    for backend in ("torch", "kernel"):
        out = render(scene, cam, 8, 8, RenderSettings.default(max_depth=2),
                     backend=backend, device="cpu")
        assert torch.isfinite(out["image"]).all(), backend
