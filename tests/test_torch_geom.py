"""The PyTorch port's intersection math against the JAX package's
geom functions called with xp=numpy. Where both sides hit, t agrees to
rtol 1e-5; hit masks agree except at most 0.1% of rays (grazing rays and
contact circles, where one float32 rounding decides)."""

import numpy as np
import pytest
import torch

from toroidal_ray_tracing_tpu.geom import torus as jax_torus
from toroidal_ray_tracing_tpu.geom.triangle import intersect_woop as jax_woop
from toroidal_ray_tracing_tpu.scene import build_scene, procedural
from toroidal_ray_tracing_tpu_torch.geom import torus
from toroidal_ray_tracing_tpu_torch.geom.triangle import intersect_woop

torch.set_num_threads(2)

MASK_TOL = 1e-3


def _rays(n, seed, spread=4.0):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * spread).astype(np.float32)
    target = rng.normal(size=(n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def _compare_t(t_port, t_ref, hit_port, hit_ref, rtol=1e-5):
    hit_port, hit_ref = np.asarray(hit_port), np.asarray(hit_ref)
    assert (hit_port != hit_ref).mean() <= MASK_TOL
    both = hit_port & hit_ref
    assert both.sum() > 0
    np.testing.assert_allclose(np.asarray(t_port)[both],
                               np.asarray(t_ref)[both], rtol=rtol)


def test_intersect_woop_matches():
    scene = build_scene(procedural.scene_cornellish())
    o, d = _rays(1024, 0, spread=3.0)
    wo, wd = scene.triangles.woop_o, scene.triangles.woop_d
    tmax = np.full((1024, 1), 1e4, np.float32)
    tr, ur, vr, hr = jax_woop(np, o, d, wo, wd, np.float32(1e-3), tmax)
    t, u, v, h = intersect_woop(torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(wo), torch.from_numpy(wd),
                                1e-3, torch.from_numpy(tmax))
    _compare_t(t.numpy(), tr, h.numpy(), hr)
    # u = o'x + t d'x cancels: a 1e-5-relative t moves u by ~1e-5 absolute
    both = h.numpy() & hr
    np.testing.assert_allclose(u.numpy()[both], ur[both], atol=1e-4)
    np.testing.assert_allclose(v.numpy()[both], vr[both], atol=1e-4)


@pytest.mark.parametrize("cubic", ["trig", "newton"])
def test_quartic_min_positive_matches(cubic):
    o, d = _rays(20000, 3)
    b3, b2, b1, b0, ts = jax_torus.torus_coefficients(
        np, o, d, np.float32(2.0), np.float32(0.6))
    lo, hi = np.float32(1e-3) - ts, np.float32(1e4) - ts
    ref = jax_torus.quartic_min_positive(np, b3, b2, b1, b0, lo, hi,
                                         cubic=cubic)
    tt = [torch.from_numpy(np.ascontiguousarray(a))
          for a in (b3, b2, b1, b0, lo, hi)]
    got = torus.quartic_min_positive(*tt, cubic=cubic).numpy()
    _compare_t(got, ref, got < 1e30, ref < 1e30)


def test_quartic_roots_matches():
    o, d = _rays(4096, 5)
    b3, b2, b1, b0, _ = jax_torus.torus_coefficients(
        np, o, d, np.float32(1.5), np.float32(0.5))
    ref, vref = jax_torus.quartic_roots(np, b3, b2, b1, b0)
    got, vgot = torus.quartic_roots(*(torch.from_numpy(a)
                                      for a in (b3, b2, b1, b0)))
    got, vgot = got.numpy(), vgot.numpy()
    _compare_t(got, ref, vgot, vref, rtol=1e-4)


def test_torus_intersect_and_normal_match():
    o, d = _rays(20000, 7)
    tr, hr = jax_torus.torus_intersect(np, o, d, np.float32(2.0),
                                       np.float32(0.6), np.float32(1e-3),
                                       np.float32(1e4))
    t, h = torus.torus_intersect(torch.from_numpy(o), torch.from_numpy(d),
                                 2.0, 0.6, 1e-3, 1e4)
    _compare_t(t.numpy(), tr, h.numpy(), hr)
    both = h.numpy() & hr
    p = (o + np.minimum(tr, 1e8)[:, None] * d)[both]
    n_ref = jax_torus.torus_normal(np, p, np.float32(2.0))
    n = torus.torus_normal(torch.from_numpy(p), 2.0).numpy()
    np.testing.assert_allclose(n, n_ref, atol=1e-5)
