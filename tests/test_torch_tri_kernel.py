"""K1's plain PyTorch twin (the CPU side of `ops.tri_kernel.tri_closest_hit`)
against the JAX package's Pallas triangle kernel run in interpret mode, as
tests/test_pallas.py runs it.

Tolerances: t rtol 1e-5 / atol 1e-5; idx equal where both hit; attrs rtol
1e-5 / atol 1e-5; any-hit: the masks t < 1e30 are equal. u/v (atol 1e-4:
u = o'x + t d'x cancels) are compared only without attrs (with attrs the
TPU kernel leaves them at 0)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.ops import tri_kernel as jax_tk
from toroidal_ray_tracing_tpu.ops.trace_kernel import (
    _tri_attr_tables as jax_tables)
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu.scene import build_scene, procedural
from toroidal_ray_tracing_tpu.scene.types import SceneDef
from toroidal_ray_tracing_tpu.trace import intersect as jax_isect
from toroidal_ray_tracing_tpu.utils import math3d
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import LAUNCHES
from toroidal_ray_tracing_tpu_torch.ops.tri_kernel import (tri_closest_hit,
                                                           tri_tables)

torch.set_num_threads(2)


def _coarse_torus_mesh():
    """Ungated set-up: a 1,024-triangle, 8-cluster mesh (<= 2048 tris)."""
    sd = SceneDef()
    sd.add_model(procedural.torus_mesh(1.6, 0.5, seg_major=32, seg_minor=16),
                 math3d.translation((0.0, 0.6, 0.0)))
    return sd


SETUPS = {
    "ungated_torus_mesh": (_coarse_torus_mesh, (6.0, 4.0, 6.0)),
    "gated_cornellish": (procedural.scene_cornellish, (0.0, 1.0, 3.5)),
}


def _case(name):
    sd, eye = SETUPS[name]
    scene = build_scene(sd())
    cam = JaxPinhole(eye=eye, center=(0.0, 0.6, 0.0))
    o, d = cam.generate_rays(64, 32, JaxSettings.default(), xp=np)
    o, d = np.ascontiguousarray(o.T), np.ascontiguousarray(d.T)
    tmax = np.full((o.shape[1],), 1e4, np.float32)
    tmax[::9] = 0.0                                   # dead rays stay misses
    tmax[1::9] = 3.0                                  # short segments
    return scene, o, d, tmax


def _ref(scene, o, d, tmax, attrs, occlusion):
    geom = jax_isect.geom_from_scene(scene)
    tables = jax_tables(scene, geom) if attrs else None
    out = jax_tk.tri_closest_hit_pallas(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), geom.woop_o,
        geom.woop_d, geom.cluster_lo, geom.cluster_hi, scene.cluster_size,
        attr_tables=tables, occlusion=occlusion)
    return [np.asarray(x) for x in out], tables


def _port(scene, o, d, tmax, tables, occlusion):
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tri = scene.triangles
    out = tri_closest_hit(
        t(o), t(d), t(tmax), tri_tables(
            t(tri.woop_o), t(tri.woop_d), t(scene.cluster_lo),
            t(scene.cluster_hi), scene.cluster_size,
            tuple(t(a) for a in (tri.v0, tri.e1, tri.e2, tri.valid))),
        attr_tables=None if tables is None else tuple(t(a) for a in tables),
        occlusion=occlusion)
    return [x.numpy() for x in out]


@pytest.mark.parametrize("name", sorted(SETUPS))
@pytest.mark.parametrize("mode", ["closest", "attrs", "occlusion"])
def test_tri_twin_matches_pallas(name, mode):
    scene, o, d, tmax = _case(name)
    T = scene.triangles.woop_o.shape[2]
    assert (T > jax_tk.TRI_GATE_MIN) == name.startswith("gated")
    assert scene.cluster_lo.shape[0] > 1
    launches = dict(LAUNCHES)
    ref, tables = _ref(scene, o, d, tmax, mode == "attrs",
                       mode == "occlusion")
    got = _port(scene, o, d, tmax, tables, mode == "occlusion")
    assert LAUNCHES == launches        # CPU tensors: the twin, no launch

    hit_ref, hit = ref[0] < 1e30, got[0] < 1e30
    assert not hit[tmax == 0.0].any()
    if mode == "occlusion":
        np.testing.assert_array_equal(hit, hit_ref)
        return
    np.testing.assert_array_equal(hit, hit_ref)
    np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1][hit], ref[1][hit])
    assert got[1].dtype == np.int32
    if mode == "closest":
        # u = o'x + t d'x cancels, so barycentrics get atol 1e-4
        np.testing.assert_allclose(got[2], ref[2], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got[3], ref[3], rtol=1e-5, atol=1e-4)
    else:
        assert got[4].shape == (21, o.shape[1])
        np.testing.assert_allclose(got[4], ref[4], rtol=1e-5, atol=1e-5)
