"""The port's kernel-backend orchestration, `closest_hit(backend="kernel")`
(on the CPU: the kernels' plain twins), against the JAX package's
`closest_hit_pallas` (interpret mode): closest hit with attrs and any-hit,
on an all-loose scene, the multi-torus scene and a miniature mesh scene.

Tolerances as tests/test_pallas.py's hoist test: t (clamped to 1e4) rtol
1e-5 / atol 1e-4; kind and prim equal; attrs atol 1e-4 on hits."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.ops.trace_kernel import closest_hit_pallas
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu.scene import build_scene, procedural
from toroidal_ray_tracing_tpu.scene.types import SceneDef
from toroidal_ray_tracing_tpu.trace import intersect as jax_isect
from toroidal_ray_tracing_tpu.utils import math3d
from toroidal_ray_tracing_tpu_torch.ops import trace_kernel as tk
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import LAUNCHES
from toroidal_ray_tracing_tpu_torch.ops.shade_kernel import shade_attrs
from toroidal_ray_tracing_tpu_torch.scene import scene_from_numpy
from toroidal_ray_tracing_tpu_torch.trace.intersect import closest_hit

torch.set_num_threads(2)


def _mini_mesh():
    """Miniature config 6: a tessellated torus over a loose mirror plane."""
    sd = SceneDef()
    sd.add_model(procedural.torus_mesh(1.4, 0.5, seg_major=24, seg_minor=12,
                                       material=procedural.matte(
                                           (0.8, 0.45, 0.15))),
                 math3d.translation((0.0, 0.55, 0.0)))
    sd.add_model(procedural.plane(10.0, material=procedural.mirror(
        (0.6, 0.6, 0.6), (0.25, 0.25, 0.28))))
    return sd


SCENES = {
    "torus_plane": lambda: procedural.scene_torus_plane(True),
    "multi_torus": lambda: procedural.scene_multi_torus(True),
    "mini_mesh": _mini_mesh,
}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_backend_matches_pallas(name, monkeypatch):
    jscene = build_scene(SCENES[name]())
    scene = scene_from_numpy(jscene)
    calls = []
    tri = tk.tri_closest_hit
    monkeypatch.setattr(tk, "tri_closest_hit",
                        lambda *a, **k: calls.append(1) or tri(*a, **k))
    launches = dict(LAUNCHES)

    cam = JaxPinhole(eye=(7.0, 4.0, 7.0), center=(0.0, 0.5, 0.0))
    o, d = cam.generate_rays(48, 32, JaxSettings.default(), xp=np)
    o, d = np.ascontiguousarray(o.T), np.ascontiguousarray(d.T)
    n = o.shape[1]
    tmax = np.full((n,), 1e4, np.float32)
    tmax[::11] = 0.0
    geom = jax_isect.geom_from_scene(jscene)
    ref = closest_hit_pallas(jscene, geom, jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(tmax), want_attrs=True)
    got = closest_hit(scene, torch.from_numpy(o), torch.from_numpy(d),
                      torch.from_numpy(tmax), backend="kernel",
                      want_attrs=True)

    np.testing.assert_array_equal(got.kind.numpy(), np.asarray(ref.kind))
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_allclose(np.minimum(got.t.numpy(), 1e4),
                               np.minimum(np.asarray(ref.t), 1e4),
                               rtol=1e-5, atol=1e-4)
    hit = got.kind.numpy() >= 0
    assert hit.sum() > 100
    attrs = shade_attrs(got, got.attrs)
    for field in ("pos", "nrm", "uv", "ambient", "diffuse", "specular",
                  "shininess", "illum", "texture_id", "tex_density"):
        a = getattr(attrs, field).numpy()
        b = np.asarray(getattr(ref.attrs, field))
        assert a.dtype == b.dtype, field
        np.testing.assert_allclose(a[..., hit], b[..., hit], atol=1e-4,
                                   err_msg=field)

    occ = closest_hit(scene, torch.from_numpy(o), torch.from_numpy(d),
                      torch.from_numpy(tmax), backend="kernel",
                      occlusion=True)
    occ_ref = closest_hit_pallas(jscene, geom, jnp.asarray(o),
                                 jnp.asarray(d), jnp.asarray(tmax),
                                 occlusion=True)
    np.testing.assert_array_equal(occ.kind.numpy() >= 0,
                                  np.asarray(occ_ref.kind) >= 0)

    if name == "mini_mesh":
        assert calls
    else:                              # plane-only triangle set: no K1 call
        assert scene.loose_tris == 2 and not calls
    assert LAUNCHES["tri_closest_hit"] == launches["tri_closest_hit"]


def test_streamed_size_mesh_raises_naming_k5(monkeypatch):
    """At the real threshold (no patched TRI_STREAM_MIN), a mesh above
    65,536 triangles takes the streamed route on the kernel backend,
    `tri_closest_hit_stream` and never K1, and its hits match the JAX
    package's `closest_hit_pallas`, which streams the same mesh."""
    jscene = build_scene(procedural.scene_hires_mesh(seg=185))  # 68,450 tris
    scene = scene_from_numpy(jscene)
    assert scene.triangles.count > tk.TRI_STREAM_MIN
    calls = []
    stream = tk.tri_closest_hit_stream
    monkeypatch.setattr(tk, "tri_closest_hit_stream",
                        lambda *a, **k: calls.append(1) or stream(*a, **k))
    monkeypatch.setattr(tk, "tri_closest_hit",
                        lambda *a, **k: pytest.fail("K1 route taken"))
    o = np.array([[0.3, -0.2, 2.1, 0.0], [5.0, 5.0, 5.0, 5.0],
                  [0.1, 1.7, 0.2, 4.0]], np.float32)
    d = np.ascontiguousarray(np.broadcast_to(
        np.array([[0.0], [-1.0], [0.0]], np.float32), (3, 4)))
    tmax = np.full((4,), 1e4, np.float32)
    ref = closest_hit_pallas(jscene, jax_isect.geom_from_scene(jscene),
                             jnp.asarray(o), jnp.asarray(d),
                             jnp.asarray(tmax), want_attrs=True)
    hit = closest_hit(scene, torch.from_numpy(o), torch.from_numpy(d),
                      torch.from_numpy(tmax), backend="kernel",
                      want_attrs=True)
    assert calls
    assert (hit.kind >= 0).all()
    np.testing.assert_array_equal(hit.kind.numpy(), np.asarray(ref.kind))
    np.testing.assert_array_equal(hit.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_allclose(hit.t.numpy(), np.asarray(ref.t), rtol=1e-5,
                               atol=1e-4)
    attrs = shade_attrs(hit, hit.attrs)
    for field in ("pos", "nrm", "uv", "diffuse"):
        np.testing.assert_allclose(getattr(attrs, field).numpy(),
                                   np.asarray(getattr(ref.attrs, field)),
                                   atol=1e-4, err_msg=field)
