"""End-to-end parity of the port: its `render` on both backends
(backend="torch", and backend="kernel", whose plain twins run on the CPU)
against the port's own oracle (`oracle.render_oracle`), the mirror of
tests/test_parity.py and of the oracle tests of tests/test_mipmaps.py, at
their sizes and their bounds: per-pixel RMSE < 1e-3 (the scene's own
rmse_bound where it sets one, x50 for hit positions clipped to +-1e4) and
RMSE < 2e-4 after dropping the worst 0.1% of pixels (at least one).

Each scene's oracle is computed once and shared by the two backends."""

import functools
import types

import numpy as np
import pytest
import torch

from toroidal_ray_tracing_tpu_torch import render
from toroidal_ray_tracing_tpu_torch.cameras import (PinholeCamera,
                                                    ToroidalCamera)
from toroidal_ray_tracing_tpu_torch.oracle import render_oracle
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings, build_scene,
                                                  procedural)
from toroidal_ray_tracing_tpu_torch.scene.types import SceneDef, Torus
from toroidal_ray_tracing_tpu_torch.utils import math3d

torch.set_num_threads(2)

RES = 48
BACKENDS = ["torch", "kernel"]

# the scene-building names both packages define alike
PORT = types.SimpleNamespace(procedural=procedural, SceneDef=SceneDef,
                             Torus=Torus, math3d=math3d)

# tests/test_parity.py's SCENES: name -> (scene, camera class, camera
# keywords, settings keywords, bounds)
SCENES = {
    "config1_single_torus": (
        lambda k: k.procedural.scene_single_torus(analytic=True),
        "pinhole", dict(eye=(6.0, 3.0, 6.0)), dict(max_depth=1), {}),
    "config2_torus_plane_shadows": (
        lambda k: k.procedural.scene_torus_plane(analytic=True),
        "pinhole", dict(eye=(7.0, 4.0, 7.0), center=(0.0, 0.5, 0.0)),
        dict(max_depth=1, light_position=(6.0, 10.0, 2.0)),
        dict(rmse_bound=2e-2)),
    "config3_multi_torus_reflect": (
        lambda k: k.procedural.scene_multi_torus(analytic=True),
        "pinhole", dict(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0)),
        dict(max_depth=3), dict(rmse_bound=2e-2)),
    "mesh_cornellish_reflect": (
        lambda k: k.procedural.scene_cornellish(),
        "pinhole", dict(eye=(6.0, 4.0, 6.0)), dict(max_depth=4), {}),
    "toroidal_camera_mesh": (
        lambda k: k.procedural.scene_cornellish(),
        "toroidal", dict(eye=(0.0, 1.0, 0.0), center=(8.0, 0.0, 0.0)),
        dict(max_depth=2, rho=4.0), dict(rmse_bound=1e-2, exclude=0.01)),
    "torus_mesh_variant": (
        lambda k: k.procedural.scene_torus_plane(analytic=False),
        "pinhole", dict(eye=(7.0, 4.0, 7.0), center=(0.0, 0.5, 0.0)),
        dict(max_depth=1), {}),
    "infinite_light": (
        lambda k: k.procedural.scene_torus_plane(analytic=True),
        "pinhole", dict(eye=(7.0, 4.0, 7.0), center=(0.0, 0.5, 0.0)),
        dict(max_depth=1, light_type=1, light_position=(1.0, 1.0, 0.3),
             light_intensity=2.0), {}),
    # tests/test_parity.py::test_instanced_grid_parity
    "instanced_grid": (
        lambda k: k.procedural.scene_instanced_torus_grid(n=64,
                                                          analytic=True),
        "pinhole", dict(eye=(10.0, 8.0, 10.0), center=(0.0, 0.0, 0.0)),
        dict(max_depth=2), {}),
}


def fuzz_scene(kit, seed):
    """tests/test_parity.py::test_random_scene_fuzz_parity's scene for
    `seed`, built with `kit`'s procedural / SceneDef / Torus / math3d.
    Returns (scene def, camera keywords, settings keywords)."""
    p, m3 = kit.procedural, kit.math3d
    rng = np.random.default_rng(100 + seed)
    sd = kit.SceneDef()
    for _ in range(int(rng.integers(1, 5))):                       # tori
        R = float(rng.uniform(0.6, 1.8))
        r = float(rng.uniform(0.15, 0.45)) * R
        mat = (p.mirror() if rng.random() < 0.3 else
               p.matte(tuple(rng.uniform(0.2, 0.9, 3))))
        tr = m3.compose(
            m3.translation(tuple(rng.uniform(-3, 3, 3) * (1, 0.3, 1)
                                 + (0, R + 0.2, 0))),
            m3.rotation_x(float(rng.uniform(0, 90))))
        sd.add_model(kit.Torus(R, r, [mat]), tr)
    for _ in range(int(rng.integers(0, 3))):                       # cubes
        s = float(rng.uniform(0.5, 1.4))
        sd.add_model(p.cube(
            s, materials=[p.matte(tuple(rng.uniform(0.2, 0.9, 3)))]),
            m3.translation(tuple(rng.uniform(-3, 3, 3) * (1, 0, 1)
                                 + (0, s / 2, 0))))
    if rng.random() < 0.7:
        sd.add_model(p.plane(10.0, material=p.matte(
            tuple(rng.uniform(0.4, 0.8, 3)))))
    st = dict(
        max_depth=int(rng.integers(1, 4)),
        light_position=tuple(rng.uniform(-8, 8, 3) * (1, 0, 1) + (0, 9, 0)),
        light_intensity=float(rng.uniform(40, 120)))
    cam = dict(eye=tuple(rng.uniform(5, 9, 3) * (1, 0.6, 1)),
               center=(0.0, 0.5, 0.0))
    return sd, cam, st


def textured_floor_scene(p):
    """tests/test_mipmaps.py's minification floor: a checker tiled 40x."""
    tex = p.checker_texture(64, 16, (0.15,) * 3, (1.0,) * 3)
    mesh = p.plane(40.0, material=p.matte(
        (1.0, 1.0, 1.0), illum=1, specular=(0, 0, 0), texture_id=0))
    mesh.uvs = mesh.uvs * 40.0
    mesh.textures = [tex]
    sd = p.SceneDef()
    sd.add_model(mesh)
    return sd


# the oracle tests of tests/test_mipmaps.py: name -> (scene, camera
# keywords, settings keywords, resolution)
MIP_SCENES = {
    "textured_scenario": (
        lambda p: p.scene_textured_mesh(),
        dict(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0)),
        dict(max_depth=3), 64),
    "mipped_floor": (
        textured_floor_scene,
        dict(eye=(0.0, 2.0, 14.0), center=(0.0, 0.0, -10.0)),
        dict(max_depth=1, light_type=1, light_position=(0.0, 1.0, 0.0),
             light_intensity=1.0), 32),
}


def parity_errors(a, b, exclude=0.001):
    """(plain RMSE, RMSE after dropping the worst `exclude` fraction of
    pixels, at least one) of two (H, W, 3) arrays."""
    err2 = ((np.asarray(a) - np.asarray(b)) ** 2).mean(axis=-1).ravel()
    k = max(1, int(len(err2) * exclude))
    return (float(np.sqrt(err2.mean())),
            float(np.sqrt(np.sort(err2)[:-k].mean())))


def assert_parity(d, o, rmse_bound=1e-3, robust_bound=2e-4, exclude=0.001):
    """tests/test_parity.py's rule on a render `d` against an oracle `o`:
    `exclude` drops the worst fraction of pixels before the robust bound
    (rays that graze shared triangle edges legitimately tie-break to the
    neighboring primitive vs the oracle)."""
    for key in ("image", "hit_position"):
        a = d[key].numpy()
        b = o[key].numpy()
        if key == "hit_position":
            a = np.clip(a, -1e4, 1e4)
            b = np.clip(b, -1e4, 1e4)
        rmse, robust = parity_errors(a, b, exclude)
        assert robust < robust_bound, f"{key}: robust rmse {robust}"
        assert rmse < rmse_bound * (50 if key == "hit_position" else 1), \
            f"{key}: rmse {rmse}"


def camera(kind, kw):
    return (ToroidalCamera if kind == "toroidal" else PinholeCamera)(**kw)


@functools.lru_cache(maxsize=None)
def case(name):
    """(scene, camera, settings, bounds, oracle output) of a SCENES entry,
    or of "fuzz<seed>"; the oracle runs once per file."""
    if name.startswith("fuzz"):
        sd, cam_kw, st_kw = fuzz_scene(PORT, int(name[4:]))
        kind, bounds = "pinhole", dict(rmse_bound=2e-2)
    else:
        sd_fn, kind, cam_kw, st_kw, bounds = SCENES[name]
        sd = sd_fn(PORT)
    scene = build_scene(sd)
    cam = camera(kind, cam_kw)
    st = RenderSettings.default(**st_kw)
    return scene, cam, st, bounds, render_oracle(scene, cam, RES, RES, st,
                                                 device="cpu")


@functools.lru_cache(maxsize=None)
def mip_case(name):
    sd_fn, cam_kw, st_kw, res = MIP_SCENES[name]
    scene = build_scene(sd_fn(procedural))
    cam = PinholeCamera(**cam_kw)
    st = RenderSettings.default(**st_kw)
    return scene, cam, st, res, render_oracle(scene, cam, res, res, st,
                                              device="cpu")


def _parity(name, backend):
    scene, cam, st, bounds, o = case(name)
    d = render(scene, cam, RES, RES, st, backend=backend, device="cpu")
    assert_parity(d, o, **bounds)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(set(SCENES) - {"instanced_grid"}))
def test_scene_parity(name, backend):
    _parity(name, backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_instanced_grid_parity(backend):
    _parity("instanced_grid", backend)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_scene_fuzz_parity(seed, backend):
    """Randomized mixed scenes (tori + mesh boxes + a plane, random
    transforms/materials/light) vs the oracle."""
    _parity(f"fuzz{seed}", backend)


@pytest.mark.parametrize("backend", BACKENDS)
def test_max_depth_do_while(backend):
    """maxDepth <= 0 still traces the primary segment (rgen do-while), in
    the render and in the oracle alike."""
    scene = build_scene(procedural.scene_single_torus(analytic=True))
    cam = PinholeCamera(eye=(6.0, 3.0, 6.0))
    st = RenderSettings.default(max_depth=0)
    img = render(scene, cam, 32, 32, st, backend=backend,
                 device="cpu")["image"]
    assert float(img.max()) > 0.1  # not black
    o = render_oracle(scene, cam, 32, 32, st, device="cpu")["image"]
    assert float((img - o).abs().max()) < 1e-4


@pytest.mark.parametrize("backend", BACKENDS)
def test_reflection_accumulation_order(backend):
    """A mirror's own shade is multiplied by its own specular (the chit
    updates prd.attenuation before rgen accumulates, rchit:127 / rgen:92):
    a single mirror plane, an infinite light straight up, the camera at 45
    degrees, shininess 4, 9x9 so pixel (4, 4) is the exact center ray, a
    black clear color."""
    sd = SceneDef()
    mat = dict(diffuse=(0.4, 0.4, 0.4), ambient=(0.01, 0.01, 0.01),
               specular=(0.5, 0.5, 0.5), illum=3, shininess=4.0)
    sd.add_model(procedural.plane(50.0, material=mat))
    scene = build_scene(sd)
    cam = PinholeCamera(eye=(0.0, 3.0, 3.0), center=(0.0, 0.0, 0.0))
    st = RenderSettings.default(max_depth=2, light_type=1,
                                light_position=(0.0, 1.0, 0.0),
                                light_intensity=1.0,
                                clear_color=(0.0, 0.0, 0.0, 0.0))
    out = render(scene, cam, 9, 9, st, backend=backend, device="cpu")
    oracle = render_oracle(scene, cam, 9, 9, st, device="cpu")
    np.testing.assert_allclose(out["image"].numpy(),
                               oracle["image"].numpy(), rtol=1e-4, atol=1e-6)
    # center ray: N=L=R=(0,1,0), V=(0,1,1)/sqrt(2)
    energy = (2.0 + 4.0) / (2.0 * np.pi)
    spec = energy * (1.0 / np.sqrt(2.0)) ** 4
    s1 = (0.4 * 1.0 + 0.01) + 0.5 * spec
    expect = 0.5 * s1  # scaled by the mirror's own specular (the key check)
    for img in (out["image"], oracle["image"]):
        np.testing.assert_allclose(float(img[4, 4, 0]), expect, rtol=1e-3)


@pytest.mark.parametrize("backend", BACKENDS)
def test_point_light_falloff(backend):
    """Point light: intensity / d^2 (rchit:61-67), in the render and in the
    oracle."""
    sd = SceneDef()
    sd.add_model(procedural.plane(50.0, material=procedural.matte(
        (1.0, 1.0, 1.0), ambient=(0.0, 0.0, 0.0), illum=1,
        specular=(0.0, 0.0, 0.0))))
    cam = PinholeCamera(eye=(0.0, 5.0, 0.01), center=(0.0, 0.0, 0.0))
    img = {}
    for h in (10.0, 20.0):
        st = RenderSettings.default(light_position=(0.0, h, 0.0),
                                    light_intensity=100.0, max_depth=1)
        for fn, kw in ((render, dict(backend=backend)), (render_oracle, {})):
            out = fn(build_scene(sd), cam, 4, 4, st, device="cpu", **kw)
            img[fn, h] = float(out["image"][2, 2, 0])
    for fn in (render, render_oracle):
        assert img[fn, 10.0] / img[fn, 20.0] == pytest.approx(4.0, rel=0.02)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(MIP_SCENES))
def test_mipmapped_scene_matches_oracle(name, backend):
    """tests/test_mipmaps.py's oracle gates: the config-7 ladder scene
    (textured mesh torus + mirror + tiled floor) at 64x64 and the
    minification floor at 32x32, plain RMSE < 1e-3 (the same lod math on
    both sides)."""
    scene, cam, st, res, o = mip_case(name)
    d = render(scene, cam, res, res, st, backend=backend, device="cpu")
    rmse = float((d["image"] - o["image"]).pow(2).mean().sqrt())
    assert rmse < 1e-3, rmse
