"""K5/K6's plain PyTorch twin (the CPU side of
`ops.tri_stream.tri_closest_hit_stream`) against the JAX package's streamed
Pallas triangle kernels in interpret mode, on the 23k-triangle mesh, as
tests/test_pallas.py runs them; and the orchestration's stream route.

Tolerances as tests/test_torch_tri_kernel.py: t rtol 1e-5 / atol 1e-5 on
hits; the hit masks equal; idx equal where both hit; attrs rtol 1e-5 /
atol 1e-5; u/v (compared only without attrs, where the TPU kernel emits
them) atol 1e-4. The JAX launcher is jitted and reads module globals at
trace time, so every patched run has a ray shape of its own."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.ops import trace_kernel as jax_tk
from toroidal_ray_tracing_tpu.ops import tri_stream as jax_ts
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu.scene import build_scene, procedural
from toroidal_ray_tracing_tpu.trace import intersect as jax_isect
from toroidal_ray_tracing_tpu_torch.ops import trace_kernel as port_tk
from toroidal_ray_tracing_tpu_torch.ops import tri_stream as port_ts
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import LAUNCHES
from toroidal_ray_tracing_tpu_torch.ops.shade_kernel import shade_attrs
from toroidal_ray_tracing_tpu_torch.scene import scene_from_numpy
from toroidal_ray_tracing_tpu_torch.trace.intersect import closest_hit

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mesh():
    scene = build_scene(procedural.scene_multi_torus(False))   # 23k tris
    return scene, jax_isect.geom_from_scene(scene)


def _rays(width, height):
    cam = JaxPinhole(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0))
    o, d = cam.generate_rays(width, height, JaxSettings.default(), xp=np)
    o, d = np.ascontiguousarray(o.T), np.ascontiguousarray(d.T)
    tmax = np.full((o.shape[1],), 1e4, np.float32)
    tmax[::9] = 0.0                                   # dead rays stay misses
    tmax[1::9] = 3.0                                  # short segments
    return o, d, tmax


def _compare(mesh, o, d, tmax, mode):
    scene, geom = mesh
    attrs, occl = mode == "attrs", mode == "occlusion"
    tables = jax_tk._tri_attr_tables(scene, geom) if attrs else None
    ref = [np.asarray(x) for x in jax_ts.tri_closest_hit_stream(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax), geom.woop_o,
        geom.woop_d, geom.cluster_lo, geom.cluster_hi, scene.cluster_size,
        attr_tables=tables, occlusion=occl)]
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tri = scene.triangles
    launches = dict(LAUNCHES)
    st = port_ts.stream_tables(t(tri.woop_o), t(tri.woop_d),
                               t(scene.cluster_lo), t(scene.cluster_hi),
                               scene.cluster_size)
    got = [x.numpy() for x in port_ts.tri_closest_hit_stream(
        t(o), t(d), t(tmax), st,
        attr_tables=None if tables is None else tuple(t(a) for a in tables),
        occlusion=occl, n_batch=o.shape[1])]
    assert LAUNCHES == launches        # CPU tensors: the twin, no launch

    hit_ref, hit = ref[0] < 1e30, got[0] < 1e30
    assert not hit[tmax == 0.0].any()
    np.testing.assert_array_equal(hit, hit_ref)
    assert hit.sum() > o.shape[1] // 4
    if occl:
        return
    np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[1][hit], ref[1][hit])
    assert got[1].dtype == np.int32
    if attrs:
        assert got[4].shape == (21, o.shape[1])
        np.testing.assert_allclose(got[4], ref[4], rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got[2], ref[2], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(got[3], ref[3], rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("mode", ["closest", "attrs", "occlusion"])
def test_stream_twin_matches_pallas(mesh, mode):
    assert port_ts.superblocks(torch.from_numpy(mesh[0].cluster_lo),
                               torch.from_numpy(mesh[0].cluster_hi),
                               128)[0] == 1      # 181 clusters: g = 1
    _compare(mesh, *_rays(64, 32), mode)


def test_stream_twin_matches_grouped_pallas(mesh, monkeypatch):
    """The JAX grouped kernel (K6's TPU counterpart); the port's twin is
    the function of both K5 and K6."""
    monkeypatch.setattr(jax_ts, "STREAM_GROUP", 16)
    _compare(mesh, *_rays(64, 48), "attrs")


@pytest.mark.parametrize("mode", ["attrs", "occlusion"])
def test_stream_twin_matches_pallas_padded_superblocks(mesh, mode,
                                                       monkeypatch):
    """STREAM_GATE_BOXES = 32 in both packages: g = 4 clusters per
    superblock over 181 clusters, so the last superblock is padded and its
    pad clusters are masked out of the superblock box."""
    for mod in (jax_ts, port_ts):
        monkeypatch.setattr(mod, "STREAM_GATE_BOXES", 32)
    g, S, clo, _, sb_lo, sb_hi = port_ts.superblocks(
        torch.from_numpy(mesh[0].cluster_lo),
        torch.from_numpy(mesh[0].cluster_hi), 128)
    assert (g, S, clo.shape[0]) == (4, 46, 184)
    assert bool((sb_hi[:-1] < 1e29).all()) and bool((sb_lo <= sb_hi).all())
    _compare(mesh, *_rays(32, 32), mode)


def test_orchestration_takes_stream_route(mesh, monkeypatch):
    """With TRI_STREAM_MIN patched low in both packages, the 23k mesh (with
    its loose floor hoisted in front) goes through the stream route in
    both, and the kernel backend matches closest_hit_pallas."""
    scene, geom = mesh
    for mod in (jax_tk, port_tk):
        monkeypatch.setattr(mod, "TRI_STREAM_MIN", 1024)
    calls = []
    stream = port_tk.tri_closest_hit_stream
    monkeypatch.setattr(port_tk, "tri_closest_hit_stream",
                        lambda *a, **k: calls.append(1) or stream(*a, **k))
    monkeypatch.setattr(port_tk, "tri_closest_hit",
                        lambda *a, **k: pytest.fail("K1 route taken"))
    assert scene.loose_tris > 0
    o, d, tmax = _rays(40, 24)
    ref = jax_tk.closest_hit_pallas(scene, geom, jnp.asarray(o),
                                    jnp.asarray(d), jnp.asarray(tmax),
                                    want_attrs=True)
    port = scene_from_numpy(scene)
    got = closest_hit(port, torch.from_numpy(o), torch.from_numpy(d),
                      torch.from_numpy(tmax), backend="kernel",
                      want_attrs=True)
    assert calls
    np.testing.assert_array_equal(got.kind.numpy(), np.asarray(ref.kind))
    np.testing.assert_array_equal(got.prim.numpy(), np.asarray(ref.prim))
    np.testing.assert_allclose(np.minimum(got.t.numpy(), 1e4),
                               np.minimum(np.asarray(ref.t), 1e4),
                               rtol=1e-5, atol=1e-4)
    hit = got.kind.numpy() >= 0
    assert hit.sum() > 100
    attrs = shade_attrs(got, got.attrs)
    for field in ("pos", "nrm", "uv", "diffuse", "tex_density"):
        np.testing.assert_allclose(
            getattr(attrs, field).numpy()[..., hit],
            np.asarray(getattr(ref.attrs, field))[..., hit], atol=1e-4,
            err_msg=field)
    occ = closest_hit(port, torch.from_numpy(o), torch.from_numpy(d),
                      torch.from_numpy(tmax), backend="kernel",
                      occlusion=True)
    occ_ref = jax_tk.closest_hit_pallas(scene, geom, jnp.asarray(o),
                                        jnp.asarray(d), jnp.asarray(tmax),
                                        occlusion=True)
    np.testing.assert_array_equal(occ.kind.numpy() >= 0,
                                  np.asarray(occ_ref.kind) >= 0)
