"""K2's and K3's plain PyTorch twins (the CPU side of `ops.torus_kernel`)
against the JAX package's Pallas torus kernels run in interpret mode.

Tolerances are those of tests/test_pallas.py: t rtol 1e-4 / atol 1e-3,
idx equal on hits, attr normals atol 1e-4; material rows exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.ops import torus_kernel as jax_tk
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu.scene import build_scene, procedural
from toroidal_ray_tracing_tpu.scene.types import SceneDef, Torus
from toroidal_ray_tracing_tpu.utils import math3d
from toroidal_ray_tracing_tpu_torch.ops import torus_kernel as tk

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tori(scene):
    tor = scene.tori
    return tor.world_to_obj, tor.major_radius, tor.minor_radius


def _mat(K):
    return np.arange(K * 12, dtype=np.float32).reshape(K, 12) * 0.25


def _compare(got, ref, mode, tmax):
    hit_ref, hit = ref[0] < 1e30, got[0] < 1e30
    assert not hit[tmax <= 1e-3].any(), "dead rays must miss"
    if mode == "occlusion":
        np.testing.assert_array_equal(hit, hit_ref)
        return
    agree = hit == hit_ref
    assert (~agree).sum() <= max(4, hit.size // 2000), (~agree).sum()
    both = hit & hit_ref
    assert both.sum() > 0
    np.testing.assert_allclose(got[0][both], ref[0][both], rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_array_equal(got[1][both], ref[1][both])
    if mode == "attrs":
        np.testing.assert_allclose(got[2][0:3, both], ref[2][0:3, both],
                                   atol=1e-4)
        np.testing.assert_array_equal(got[2][3:, both], ref[2][3:, both])
        np.testing.assert_array_equal(got[2][:, ~hit], 0.0)


def _camera_rays(eye, w=64, h=32):
    cam = JaxPinhole(eye=eye, center=(0.0, 0.0, 0.0))
    o, d = cam.generate_rays(w, h, JaxSettings.default(), xp=np)
    tmax = np.full((w * h,), 1e4, np.float32)
    tmax[::7] = 0.0
    return np.ascontiguousarray(o.T), np.ascontiguousarray(d.T), tmax


def _torus_grid(K, seed=3):
    """K instanced tori on a grid with random yaw (no two coincide: a
    coincident pair would make the winner a float32 coin toss)."""
    sd = SceneDef()
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(K)))
    base = sd.add_model(Torus(0.35, 0.12, [procedural.matte((0.8, 0.5, 0.2))]),
                        math3d.translation((-(side - 1) * 0.6, 0.15,
                                            -(side - 1) * 0.6)))
    for k in range(1, K):
        i, j = divmod(k, side)
        sd.add_instance(base, math3d.compose(
            math3d.translation(((i - (side - 1) / 2) * 1.2, 0.15,
                                (j - (side - 1) / 2) * 1.2)),
            math3d.rotation_y(float(rng.uniform(0, 360)))))
    return build_scene(sd)


@pytest.mark.parametrize("K", [32, 128])           # ungated / gated
@pytest.mark.parametrize("mode", ["closest", "attrs", "occlusion"])
def test_chunked_twin_matches_pallas(K, mode):
    scene = _torus_grid(K)
    w2o, major, minor = _tori(scene)
    assert major.shape[0] == K
    o, d, tmax = _camera_rays((12.0, 9.0, 12.0) if K > 64 else (6.0, 5.0, 6.0))
    mat = _mat(K) if mode == "attrs" else None
    ref = jax_tk.torus_closest_hit_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), w2o, major, minor,
        scene.tori.center, scene.tori.bound_radius,
        mat_table=None if mat is None else jnp.asarray(mat),
        occlusion=mode == "occlusion")
    got = tk.torus_closest_hit_chunked(
        _t(o), _t(d), _t(tmax), tk.torus_tables(
            _t(w2o), _t(major), _t(minor),
            mat_table=None if mat is None else _t(mat)),
        want_attrs=mat is not None, occlusion=mode == "occlusion")
    _compare([x.numpy() for x in got], [np.asarray(x) for x in ref], mode,
             tmax)


def _edge_case_scene():
    """K = 5 (odd) tori, as tests/test_pallas.py's small-kernel edge cases."""
    sd = SceneDef()
    for i, (R, r) in enumerate([(1.8, 0.5), (1.2, 0.4), (0.9, 0.3),
                                (0.7, 0.25), (1.1, 0.33)]):
        sd.add_model(Torus(R, r, [procedural.matte((0.5, 0.5, 0.5))]),
                     math3d.translation((2.5 * (i - 2), 0.6, 1.3 * (i % 3))))
    return build_scene(sd)


@pytest.mark.parametrize("setup", ["multi_torus_k4", "edge_k5"])
@pytest.mark.parametrize("mode", ["closest", "attrs", "occlusion"])
def test_small_twin_matches_pallas(setup, mode):
    if setup == "multi_torus_k4":
        scene = build_scene(procedural.scene_multi_torus(True))
        o, d, tmax = _camera_rays((8.0, 5.0, 8.0))
    else:
        scene = _edge_case_scene()
        n = jax_tk.TORUS_SMALL_TILE                      # exactly one tile
        rng = np.random.default_rng(11)
        o = np.asarray(rng.normal(size=(3, n)) * 6.0, np.float32)
        d = rng.normal(size=(3, n)).astype(np.float32)
        d /= np.linalg.norm(d, axis=0, keepdims=True)
        tmax = np.full((n,), 1e4, np.float32)
        tmax[::7] = 0.0                                  # dead rays
        d[:, 5::13] = np.nan                             # eye==center rows
    w2o, major, minor = _tori(scene)
    K = major.shape[0]
    assert K <= tk.TORUS_SMALL_MAX_K
    assert tk.use_small_kernel(o.shape[1], K)
    mat = _mat(K) if mode == "attrs" else None
    ref = jax_tk.torus_closest_hit_small(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), w2o, major, minor,
        mat_table=None if mat is None else jnp.asarray(mat),
        occlusion=mode == "occlusion")
    got = tk.torus_closest_hit_small(
        _t(o), _t(d), _t(tmax), tk.torus_tables(
            _t(w2o), _t(major), _t(minor),
            mat_table=None if mat is None else _t(mat)),
        want_attrs=mat is not None, occlusion=mode == "occlusion")
    got = [x.numpy() for x in got]
    assert not (got[0] < 1e30)[np.isnan(d[0])].any(), "NaN rays must miss"
    _compare(got, [np.asarray(x) for x in ref], mode, tmax)


def test_route_follows_tpu_launcher():
    """K3 for K <= 8 up to max(2^20, 4*2^20/K) padded rays, K2 beyond."""
    assert tk.use_small_kernel(2048, 4)
    assert tk.use_small_kernel(512 * 512, 4)
    assert not tk.use_small_kernel(2074624, 4)           # 1080p, padded
    assert tk.use_small_kernel(2074624, 2)
    assert not tk.use_small_kernel(2048, 9)
