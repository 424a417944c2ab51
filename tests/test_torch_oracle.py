"""The port's oracle (`oracle.render_oracle`) and what it adds to the port
(`geom.triangle.moller_trumbore` / `ray_aabb`, float64 `torus_intersect`,
`TextureAtlas.data` / `.data4`) against the JAX package's, on the same
inputs, on the CPU.

Renders: both oracles trace the very same rays (the port camera's, handed
to the JAX oracle; raygen is held to the JAX cameras on its own in
tests/test_torch_cameras.py) over one scene state (the JAX build carried
across with `scene_from_numpy`). Bounds: image and hit position plain RMSE
< 1e-4, and < 1e-6 after dropping the worst 0.1% of pixels (at least one).
The two differ only where pow / log2 / cbrt / arccos round differently.
Geometry: exact hit masks, t within 1 ulp (float32), within 1e-12
relative (float64 tori)."""

import types

import numpy as np
import pytest
import torch

from test_torch_parity import (MIP_SCENES, RES, SCENES, fuzz_scene,
                               parity_errors, textured_floor_scene)
from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.cameras import ToroidalCamera as JaxToroidal
from toroidal_ray_tracing_tpu.geom import torus as jax_torus
from toroidal_ray_tracing_tpu.geom.triangle import moller_trumbore as jax_mt
from toroidal_ray_tracing_tpu.geom.triangle import ray_aabb as jax_aabb
from toroidal_ray_tracing_tpu.oracle import render_oracle as jax_oracle
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu.scene import build_scene as jax_build
from toroidal_ray_tracing_tpu.scene import procedural as jax_proc
from toroidal_ray_tracing_tpu.scene.types import SceneDef as JaxSceneDef
from toroidal_ray_tracing_tpu.scene.types import Torus as JaxTorus
from toroidal_ray_tracing_tpu.utils import math3d as jax_math3d
from toroidal_ray_tracing_tpu_torch.cameras import (PinholeCamera,
                                                    ToroidalCamera)
from toroidal_ray_tracing_tpu_torch.geom import torus
from toroidal_ray_tracing_tpu_torch.geom.triangle import (moller_trumbore,
                                                          ray_aabb)
from toroidal_ray_tracing_tpu_torch.oracle import cpu_renderer, render_oracle
from toroidal_ray_tracing_tpu_torch.scene import (build_scene, procedural,
                                                  scene_from_numpy,
                                                  settings_from_numpy)

torch.set_num_threads(2)

F32 = np.float32
TMIN = float(F32(1e-3))
JAX = types.SimpleNamespace(procedural=jax_proc, SceneDef=JaxSceneDef,
                            Torus=JaxTorus, math3d=jax_math3d)


class SameRays:
    """A JAX camera that hands the JAX oracle the given rays; every other
    attribute (pixel_spread) is the wrapped camera's."""

    def __init__(self, camera, origins, dirs):
        self.camera, self.origins, self.dirs = camera, origins, dirs

    def __getattr__(self, name):
        return getattr(self.camera, name)

    def generate_rays(self, width, height, settings=None, xp=None):
        return self.origins, self.dirs


def _case(name):
    """(JAX scene def, toroidal?, camera keywords, settings keywords,
    resolution) of a scene of tests/test_torch_parity.py."""
    if name in SCENES:
        sd_fn, kind, cam_kw, st_kw, _ = SCENES[name]
        return sd_fn(JAX), kind == "toroidal", cam_kw, st_kw, RES
    if name.startswith("fuzz"):
        sd, cam_kw, st_kw = fuzz_scene(JAX, int(name[4:]))
        return sd, False, cam_kw, st_kw, RES
    sd_fn, cam_kw, st_kw, res = MIP_SCENES[name]
    return sd_fn(jax_proc), False, cam_kw, st_kw, res


@pytest.mark.parametrize(
    "name", sorted(SCENES) + ["fuzz0", "fuzz1", "fuzz2"] + sorted(MIP_SCENES))
def test_oracle_matches_jax(name):
    sd, toroidal, cam_kw, st_kw, res = _case(name)
    jscene = jax_build(sd)
    jst = JaxSettings.default(**st_kw)
    cam = (ToroidalCamera if toroidal else PinholeCamera)(**cam_kw)
    jcam = (JaxToroidal if toroidal else JaxPinhole)(**cam_kw)
    out = render_oracle(scene_from_numpy(jscene), cam, res, res,
                        settings_from_numpy(jst), device="cpu")
    o, d = (out[k].reshape(-1, 3).numpy() for k in ("ray_origin", "ray_dir"))
    ref = jax_oracle(jscene, SameRays(jcam, o, d), res, res, jst)
    for key in ("image", "hit_position", "ray_origin", "ray_dir"):
        got = out[key].numpy()
        assert got.shape == (res, res, 3) and got.dtype == np.float32, key
        rmse, robust = parity_errors(got, ref[key])
        differ = int((got != ref[key]).any(axis=-1).sum())
        print(f"{name} {key}: rmse {rmse:.3e}, robust {robust:.3e}, "
              f"{differ} of {res * res} pixels differ")
        assert rmse < 1e-4 and robust < 1e-6, (key, rmse, robust)


# tests/test_geom.py's triangle cases: (v0, e1, e2, origin, dir, tmax,
# expected (t, u, v) or None for a miss)
MT_CASES = {
    "known_hit": ((0, 0, 5), (2, 0, 0), (0, 2, 0), (0.5, 0.5, 0), (0, 0, 1),
                  1e4, (5.0, 0.25, 0.25)),
    "miss_outside": ((0, 0, 5), (1, 0, 0), (0, 1, 0), (2, 2, 0), (0, 0, 1),
                     1e4, None),
    "degenerate": ((0, 0, 5), (1, 0, 0), (2, 0, 0), (0, 0, 0), (0, 0, 1),
                   1e4, None),
    "tmax_respected": ((0, 0, 5), (2, 0, 0), (0, 2, 0), (0.5, 0.5, 0),
                       (0, 0, 1), 4.0, None),
}


def _same_mt(got, ref):
    """Exact hit masks; t, u, v within 1 ulp where both hit."""
    t, u, v, hit = (a.numpy() for a in got)
    np.testing.assert_array_equal(hit, ref[3])
    assert hit.any() or not ref[3].any()
    for a, b in zip((t, u, v), ref[:3]):
        np.testing.assert_array_max_ulp(a[hit], b[hit].astype(a.dtype),
                                        maxulp=1)


@pytest.mark.parametrize("name", sorted(MT_CASES))
def test_moller_trumbore_cases(name):
    *arrays, tmax, expect = MT_CASES[name]
    v0, e1, e2, o, d = (np.asarray([a], F32) for a in arrays)
    ref = jax_mt(np, o, d, v0, e1, e2, F32(TMIN), F32(tmax))
    got = moller_trumbore(*(torch.from_numpy(a) for a in (o, d, v0, e1, e2)),
                          TMIN, tmax)
    _same_mt(got, ref)
    assert bool(got[3][0, 0]) == (expect is not None)
    if expect is not None:
        np.testing.assert_allclose([float(a[0, 0]) for a in got[:3]], expect,
                                   rtol=1e-5)


def _random_tris(seed, T=128, N=256):
    """tests/test_geom.py::test_woop_matches_mt_random's triangles and
    rays, with per-ray tmax cutting some hits."""
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=(T, 3)).astype(F32) * 2
    e1 = rng.normal(size=(T, 3)).astype(F32)
    e2 = rng.normal(size=(T, 3)).astype(F32)
    o = rng.normal(size=(N, 3)).astype(F32) * 4
    d = rng.normal(size=(N, 3)).astype(F32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(1.0, 12.0, (N, 1)).astype(F32)
    return v0, e1, e2, o, d, tmax


@pytest.mark.parametrize("seed", [3, 4])
def test_moller_trumbore_random(seed):
    v0, e1, e2, o, d, tmax = _random_tris(seed)
    ref = jax_mt(np, o, d, v0, e1, e2, F32(TMIN), tmax)
    got = moller_trumbore(*(torch.from_numpy(a)
                            for a in (o, d, v0, e1, e2)), TMIN,
                          torch.from_numpy(tmax))
    assert got[0].dtype == torch.float32 and got[3].sum() > 0
    _same_mt(got, ref)


def test_moller_trumbore_float64():
    """On float64 inputs the test runs in float64: the JAX function on the
    same float64 inputs computes in float64 and rounds to float32 at the
    end, so its float32 results are the port's rounded."""
    v0, e1, e2, o, d, tmax = (a.astype(np.float64)
                              for a in _random_tris(5))
    ref = jax_mt(np, o, d, v0, e1, e2, TMIN, tmax)
    got = moller_trumbore(*(torch.from_numpy(a)
                            for a in (o, d, v0, e1, e2)), TMIN,
                          torch.from_numpy(tmax))
    assert all(a.dtype == torch.float64 for a in got[:3])
    hit = got[3].numpy()
    np.testing.assert_array_equal(hit, ref[3])
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a.numpy()[hit].astype(F32), b[hit])


def _inv(d):
    return np.where(d != 0, 1.0 / np.where(d == 0, 1, d), np.inf).astype(F32)


@pytest.mark.parametrize("case", ["slab", "random"])
def test_ray_aabb_matches_jax(case):
    if case == "slab":  # tests/test_geom.py::TestAABB::test_slab
        o = np.array([[0.0, 0.0, -5.0], [3.0, 0.0, -5.0]], F32)
        d = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], F32)
        lo = np.array([[-1.0, -1.0, -1.0]], F32)
        hi = np.array([[1.0, 1.0, 1.0]], F32)
        tmax = F32(1e4)
    else:  # axis-aligned and oblique rays, origins on box faces
        rng = np.random.default_rng(9)
        lo = rng.normal(size=(64, 3)).astype(F32) * 3
        hi = lo + rng.random((64, 3)).astype(F32) * 2
        o = rng.normal(size=(512, 3)).astype(F32) * 4
        o[:16] = lo[:16]
        d = rng.normal(size=(512, 3)).astype(F32)
        d[::3, rng.integers(0, 3)] = 0.0
        tmax = rng.uniform(0.5, 10.0, (512, 1)).astype(F32)
    with np.errstate(invalid="ignore"):  # 0 * inf on the box faces
        ref = jax_aabb(np, o, _inv(d), lo, hi, 0.0, tmax)
    got = ray_aabb(*(torch.from_numpy(a) for a in (o, _inv(d), lo, hi)),
                   0.0, torch.from_numpy(np.asarray(tmax)))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.any() and not ref.all()
    if case == "slab":
        assert ref[0, 0] and not ref[1, 0]


@pytest.mark.parametrize("R,r", [(2.0, 0.6), (1.0, 0.45), (0.8, 0.15)])
def test_torus_intersect_float64_matches_jax(R, r):
    """The oracle's torus query: float64 rays, the trig resolvent, 3
    Newton polishes, per-ray tmax."""
    rng = np.random.default_rng(int(R * 100 + r * 10))
    n = 20000
    o = rng.normal(size=(n, 3)) * 4.0
    d = rng.normal(size=(n, 3)) - o / 4.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = rng.uniform(2.0, 12.0, n)
    tr, hr = jax_torus.torus_intersect(np, o, d, R, r, TMIN, tmax,
                                       newton_iters=3)
    t, h = torus.torus_intersect(torch.from_numpy(o), torch.from_numpy(d),
                                 R, r, TMIN, torch.from_numpy(tmax),
                                 newton_iters=3, cubic="trig")
    assert t.dtype == torch.float64
    np.testing.assert_array_equal(h.numpy(), hr)
    assert 0 < hr.sum() < n
    np.testing.assert_allclose(t.numpy()[hr], tr[hr], rtol=1e-12, atol=0)
    np.testing.assert_array_equal(t.numpy() < 1e30, tr < 1e30)


@pytest.mark.parametrize("name", ["textured_mesh", "mipped_floor"])
def test_atlas_views_bit_equal(name):
    fn = (textured_floor_scene if name == "mipped_floor"
          else lambda p: p.scene_textured_mesh())
    jatlas = jax_build(fn(jax_proc)).textures
    atlas = build_scene(fn(procedural)).textures
    for view in ("data", "data4"):
        got, ref = getattr(atlas, view).numpy(), getattr(jatlas, view)
        assert got.dtype == np.float32 and got.shape == ref.shape, view
        np.testing.assert_array_equal(got.view(np.int32),
                                      ref.view(np.int32), err_msg=view)


def test_oracle_independent_of_trace_and_ops(monkeypatch):
    """The oracle runs none of the renderer's intersection, shading or
    kernel code: with those patched to raise it still renders the same
    image, and it holds no reference to `trace/` or `ops/`."""
    from toroidal_ray_tracing_tpu_torch.ops import trace_kernel
    from toroidal_ray_tracing_tpu_torch.trace import intersect, shade, wavefront

    scene = build_scene(procedural.scene_textured_mesh())
    cam = PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0))
    before = render_oracle(scene, cam, 16, 16, device="cpu")["image"]

    def boom(*args, **kwargs):
        raise AssertionError("the oracle ran the renderer's code")

    for mod, fn in ((intersect, "closest_hit"), (intersect, "any_hit"),
                    (shade, "shade"), (trace_kernel, "closest_hit_kernel"),
                    (wavefront, "trace_rays")):
        monkeypatch.setattr(mod, fn, boom)
    after = render_oracle(scene, cam, 16, 16, device="cpu")["image"]
    assert torch.equal(before, after) and float(after.max()) > 0.1
    for name, value in vars(cpu_renderer).items():
        where = getattr(value, "__module__", None) or getattr(
            value, "__name__", "")
        assert not where.startswith(("toroidal_ray_tracing_tpu_torch.trace",
                                     "toroidal_ray_tracing_tpu_torch.ops")), \
            name


def test_render_oracle_defaults_to_cuda(monkeypatch):
    """Like `render`, the oracle runs on the card unless the caller passes
    device="cpu", and raises without one (no fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = build_scene(procedural.scene_single_torus(analytic=True))
    cam = PinholeCamera(eye=(6.0, 3.0, 6.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        render_oracle(scene, cam, 8, 8)
    out = render_oracle(scene, cam, 8, 8, device="cpu")
    assert out["image"].device.type == "cpu"
