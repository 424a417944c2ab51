"""The port's roofline work model (`utils/roofline.py`) against the JAX
package's: the same brute-force and post-cull counts on the ladder's
scenes, the same torus chunk boxes, and an mfu that stays a
utilization."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toroidal_ray_tracing_tpu.experiments.configs import (
    SCENARIOS as JAX_SCENARIOS)
from toroidal_ray_tracing_tpu.ops.torus_kernel import (
    _torus_boxes as jax_torus_boxes)
from toroidal_ray_tracing_tpu.utils import roofline as jax_roofline
from toroidal_ray_tracing_tpu_torch.cameras import generate_rays
from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
from toroidal_ray_tracing_tpu_torch.ops.torus_kernel import _tables
from toroidal_ray_tracing_tpu_torch.scene import scene_from_numpy
from toroidal_ray_tracing_tpu_torch.utils import roofline

torch.set_num_threads(2)

N_RAYS = 4096


def _rays(eye, seed):
    """A seeded batch: origins scattered about the eye, directions toward
    the scene's middle with a spread, a few axis-aligned (zero
    components, the reciprocal's special case)."""
    rng = np.random.default_rng(seed)
    eye = np.asarray(eye, np.float32)
    o = eye + rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 0.2
    d = -o + rng.normal(size=(N_RAYS, 3)).astype(np.float32) * 2.0
    d[:16, 0] = 0.0
    d[16:32, 1] = 0.0
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.fixture(scope="module", params=[1, 2, 3, 4, 6])
def scenes(request):
    num = request.param
    jscene = JAX_SCENARIOS[num].build()
    return num, jscene, scene_from_numpy(jscene)


def test_work_counts_equal_jax(scenes):
    num, jscene, scene = scenes
    o, d = _rays(JAX_SCENARIOS[num].camera_at(0).eye, seed=num)
    assert (roofline.brute_flops_per_ray(scene)
            == jax_roofline.brute_flops_per_ray(jscene))
    got = roofline.measured_flops_per_ray(scene, torch.from_numpy(o),
                                          torch.from_numpy(d))
    want = jax_roofline.measured_flops_per_ray(jscene, o, d)
    assert got == want, (got, want)
    # the gates found candidate pairs: more than shading is counted
    assert roofline.SHADE_FLOPS_PER_RAY < got
    np.testing.assert_allclose(roofline.cull_speedup(scene, (o, d)),
                               jax_roofline.cull_speedup(jscene, (o, d)),
                               rtol=1e-6)


def test_mfu_is_a_utilization(scenes):
    """On the scenario's own primary rays (an eighth of its frame size),
    as the bench counts them: mfu in [0, 1], capped, and the gates cut
    work."""
    num, _, scene = scenes
    sc = SCENARIOS[num]
    rays = generate_rays(sc.camera_at(0), sc.width // 8, sc.height // 8,
                         sc.settings())
    m = roofline.mfu(300.0, scene, rays=rays)
    assert 0.0 < m <= 1.0
    assert 0.0 < roofline.mfu(300.0, scene) <= 1.0
    assert roofline.mfu(1e12, scene, rays=rays) == 1.0   # capped
    assert roofline.cull_speedup(scene, rays) >= 1.0


def test_model_constants_equal_jax():
    for name in ("TRI_FLOPS_PER_PAIR", "TORUS_FLOPS_PER_PAIR",
                 "SHADE_FLOPS_PER_RAY", "GATE_FLOPS_PER_BOX",
                 "MAX_SAMPLE_RAYS"):
        assert getattr(roofline, name) == getattr(jax_roofline, name), name
    assert (roofline.PEAK_F32, roofline.PEAK_BYTES) == (67e12, 3.35e12)


def _random_tori(K, seed):
    rng = np.random.default_rng(seed)
    w2o = np.zeros((K, 3, 4), np.float32)
    for k in range(K):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        w2o[k, :, :3] = q * rng.uniform(0.5, 2.0)
        w2o[k, :, 3] = rng.normal(size=3) * 5.0
    major = rng.uniform(0.5, 2.0, K).astype(np.float32)
    minor = rng.uniform(0.05, 0.4, K).astype(np.float32)
    minor[::7] = -1.0                                   # dead rows
    return torch.from_numpy(w2o), torch.from_numpy(major), \
        torch.from_numpy(minor)


@pytest.mark.parametrize("case", ["config3", "config4", "seeded_13",
                                  "seeded_100"])
def test_torus_boxes_equal_jax(case):
    if case.startswith("config"):
        tori = scene_from_numpy(JAX_SCENARIOS[int(case[-1])].build()).tori
        w2o, major, minor = (tori.world_to_obj, tori.major_radius,
                             tori.minor_radius)
    else:
        K = int(case.split("_")[1])
        w2o, major, minor = _random_tori(K, seed=K)
    K = major.shape[0]
    chunk = (roofline.GATED_TORUS_CHUNK if K > 64
             else roofline.TORUS_CHUNK)
    w2o_rows, rad = _tables(w2o, major, minor, chunk)
    got = roofline._torus_boxes(w2o_rows, rad, chunk)
    want = jax_torus_boxes(jnp.asarray(w2o_rows.numpy()),
                           jnp.asarray(rad.numpy()), chunk)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_slab_hits_equal_jax():
    rng = np.random.default_rng(7)
    lo = rng.uniform(-5, 4, (300, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.01, 2.0, (300, 3)).astype(np.float32)
    o, d = _rays((9.0, 6.0, 8.0), seed=11)
    d[32:48, 2] = 1e-31                        # below the reciprocal's cut
    got = roofline._slab_hits(torch.from_numpy(lo), torch.from_numpy(hi),
                              torch.from_numpy(o), torch.from_numpy(d))
    assert got == jax_roofline._slab_hits(lo, hi, o, d)
    assert got > 0
