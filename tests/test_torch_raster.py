"""The port's raster debug view (`render/raster.py`): the JAX package's
raster tests (tests/test_raster.py) mirrored against the port's own ray
tracer with the same bounds, and the port's `raster_render` held against
the JAX `raster_render` on the same scenes (hit masks equal but at most
0.2% of pixels, max |diff| < 1e-4 where both hit)."""

import dataclasses

import numpy as np
import pytest
import torch

from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.experiments.configs import (
    SCENARIOS as JAX_SCENARIOS)
from toroidal_ray_tracing_tpu.render.raster import (
    raster_render as jax_raster_render)
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu.scene import build_scene as jax_build_scene
from toroidal_ray_tracing_tpu.scene import procedural as jax_procedural
from toroidal_ray_tracing_tpu_torch import render
from toroidal_ray_tracing_tpu_torch.cameras import PinholeCamera
from toroidal_ray_tracing_tpu_torch.render import raster
from toroidal_ray_tracing_tpu_torch.render.raster import raster_render
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings, build_scene,
                                                  procedural,
                                                  scene_from_numpy,
                                                  settings_from_numpy)

torch.set_num_threads(2)

RES = 48


def _both(scene, cam, st, w=RES, h=RES):
    ray = render(scene, cam, w, h, st, device="cpu")["image"].numpy()
    ras = raster_render(scene, cam, w, h, st, device="cpu")["image"].numpy()
    return ray, ras


def _plane_scene(proc, size, **mat):
    sd = proc.SceneDef()
    sd.add_model(proc.plane(size, material=proc.matte(**mat)))
    return sd


def _textured_scene(proc):
    base = proc.plane(3.0, material=proc.matte(
        (0.9, 0.9, 0.9), illum=1, specular=(0, 0, 0)))
    tex = np.zeros((8, 8, 3), np.float32)
    tex[::2, ::2] = (1.0, 0.2, 0.2)
    tex[1::2, 1::2] = (1.0, 0.2, 0.2)
    tex[tex.sum(-1) == 0] = (0.2, 0.2, 1.0)
    mats = [dict(base.materials[0], texture_id=0)]
    sd = proc.SceneDef()
    sd.add_model(dataclasses.replace(base, materials=mats, textures=[tex]))
    return sd


def _zbuffer_scene(proc):
    sd = proc.SceneDef()
    sd.add_model(proc.plane(3.0, y=0.0, material=proc.matte(
        (1.0, 0.0, 0.0), illum=0, specular=(0, 0, 0))))
    sd.add_model(proc.plane(1.0, y=1.0, material=proc.matte(
        (0.0, 1.0, 0.0), illum=0, specular=(0, 0, 0))))
    return sd


# (the scene made from a procedural module, eye, center, settings kwargs)
CASES = {
    "unshadowed": (
        lambda p: _plane_scene(p, 3.0, diffuse=(0.6, 0.5, 0.4), illum=2,
                               shininess=16.0, specular=(0.3, 0.3, 0.3)),
        (6.0, 7.0, 6.5), (0.0, 0.0, 0.0),
        dict(max_depth=1, light_position=(2.0, 9.0, 1.0),
             light_intensity=80.0)),
    "textured": (
        _textured_scene, (4.0, 5.0, 4.5), (0.0, 0.0, 0.0),
        dict(max_depth=1, light_position=(2.0, 9.0, 1.0),
             light_intensity=80.0)),
    "near_clip": (
        lambda p: _plane_scene(p, 50.0, diffuse=(0.6, 0.5, 0.4), illum=1,
                               specular=(0, 0, 0)),
        (0.0, 1.5, 0.0), (8.0, 0.0, 0.0),
        dict(max_depth=1, light_type=1, light_position=(0.0, 1.0, 0.0),
             light_intensity=1.0)),
    "zbuffer": (
        _zbuffer_scene, (0.0, 6.0, 0.01), (0.0, 0.0, 0.0),
        dict(max_depth=1, light_type=1, light_position=(0.0, 1.0, 0.0),
             light_intensity=1.0)),
}


def _port_case(name):
    make, eye, center, kw = CASES[name]
    return (build_scene(make(procedural)),
            PinholeCamera(eye=eye, center=center),
            RenderSettings.default(**kw))


def _diff_where_both_hit(ray, ras):
    """Raster and ray views over the pixels both hit (the ray tracer's miss
    is clear * 0.8, the raster's the clear color)."""
    ray_hit = np.abs(ray - 0.8).max(axis=-1) > 1e-5
    ras_hit = np.abs(ras - 1.0).max(axis=-1) > 1e-5
    both = ray_hit & ras_hit
    return both, ras_hit, np.abs(ray - ras).max(axis=-1)[both]


def test_raster_matches_ray_where_unshadowed():
    # a single plane lit from above: no occluders, so raster (no shadow
    # rays) and ray tracing agree
    ray, ras = _both(*_port_case("unshadowed"))
    both, _, diff = _diff_where_both_hit(ray, ras)
    assert both.mean() > 0.1
    assert np.median(diff) < 1e-3
    assert np.percentile(diff, 95) < 5e-3


def test_raster_textured_matches_ray():
    """The raster view modulates diffuse by the material texture
    (frag_shader.frag:86-91) with the ray tracer's trilinear sampler."""
    ray, ras = _both(*_port_case("textured"))
    both, _, diff = _diff_where_both_hit(ray, ras)
    assert both.mean() > 0.1
    r, b = ras[..., 0][both], ras[..., 2][both]
    assert (r > b * 1.4).any() and (b > r * 1.4).any()
    assert np.median(diff) < 1e-3
    assert np.percentile(diff, 95) < 5e-3


def test_raster_near_plane_clipping():
    """Interior camera: the big plane's two triangles pierce the near
    plane; the clipper keeps their front parts."""
    ray, ras = _both(*_port_case("near_clip"))
    both, ras_hit, diff = _diff_where_both_hit(ray, ras)
    assert ras_hit.mean() > 0.3
    assert both.mean() > 0.3
    assert np.median(diff) < 1e-3
    assert np.percentile(diff, 95) < 5e-3


def test_raster_zbuffer_ordering():
    # nearer geometry wins the z-buffer
    scene, cam, st = _port_case("zbuffer")
    img = raster_render(scene, cam, 32, 32, st, device="cpu")["image"]
    c = img[16, 16]
    assert c[1] > c[0]  # green (upper plane) wins at the center
    corner = img[2, 2]
    assert corner[0] > corner[1]  # red plane visible at the edges


def _against_jax(jscene, jcam, jst, w, h):
    want = np.asarray(jax_raster_render(jscene, jcam, w, h, jst)["image"])
    cam = PinholeCamera(eye=tuple(jcam.eye), center=tuple(jcam.center))
    got = raster_render(scene_from_numpy(jscene), cam, w, h,
                        settings_from_numpy(jst), device="cpu")["image"]
    got = got.numpy()
    assert got.shape == want.shape == (h, w, 3)
    clear = np.asarray(jst.clear_color, np.float32)[:3]
    hit_got = np.abs(got - clear).max(axis=-1) > 0
    hit_want = np.abs(want - clear).max(axis=-1) > 0
    assert (hit_got != hit_want).mean() <= 0.002
    both = hit_got & hit_want
    assert both.mean() > 0.1
    assert np.abs(got - want).max(axis=-1)[both].max() < 1e-4


@pytest.mark.parametrize("name", sorted(CASES))
def test_raster_equals_jax(name):
    make, eye, center, kw = CASES[name]
    _against_jax(jax_build_scene(make(jax_procedural)),
                 JaxPinhole(eye=eye, center=center),
                 JaxSettings.default(**kw), RES, RES)


def test_raster_equals_jax_config7():
    sc = JAX_SCENARIOS[7]
    _against_jax(sc.build(), sc.camera, sc.settings(), 64, 36)


def test_raster_does_not_depend_on_chunking(monkeypatch):
    """The z-buffer keeps the least z and, on ties, the lowest triangle,
    whatever the chunk size and the band budget; the screen-box cull draws
    what the full test draws."""
    scene = build_scene(procedural.scene_cornellish())
    cam = PinholeCamera(eye=(0.0, 1.0, 5.0), center=(0.0, 1.0, 0.0))
    st = RenderSettings.default()
    ref = raster_render(scene, cam, 40, 30, st, device="cpu")["image"]
    monkeypatch.setattr(raster, "TRI_CHUNK", 7)
    monkeypatch.setattr(raster, "PAIR_BUDGET", 50)
    small = raster_render(scene, cam, 40, 30, st, device="cpu")["image"]
    assert torch.equal(ref, small)

    def full_screen(xs, ys, tri_ok, width, height, n_chunks):
        return np.tile([0, width, 0, height], (n_chunks, 1))

    monkeypatch.setattr(raster, "_screen_boxes", full_screen)
    assert torch.equal(ref, raster_render(scene, cam, 40, 30, st,
                                          device="cpu")["image"])


def test_raster_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene, cam, st = _port_case("zbuffer")
    with pytest.raises(RuntimeError, match="CUDA"):
        raster_render(scene, cam, 8, 8, st)
