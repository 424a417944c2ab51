"""K3 (`csrc/torus_hit.cu` torus_closest_hit_small): its plain twin
`torus_small_plain` against the JAX package's Pallas kernel (run in
interpret mode, as tests/test_torch_torus_kernel.py runs it) at K = 1, 4,
5 and 8, and the twin's work counts, which the CUDA kernel's counters
match: one union-box test per ray, then one slab test per torus the walk
reaches and one quartic per torus box passed.

The kernel and the twin walk the K tori in index order, each box at the
ray's running best, a strict t < best: the lowest index wins a tie in t.
Any-hit stops at the first hit and writes idx 0, as the JAX kernel does.
Tolerances are those of tests/test_pallas.py (`_compare`)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_torus_kernel import _camera_rays, _compare
from toroidal_ray_tracing_tpu.ops import torus_kernel as jax_tk
from toroidal_ray_tracing_tpu.scene import build_scene, procedural
from toroidal_ray_tracing_tpu_torch.ops import torus_kernel as tk
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import BIG, TMIN

torch.set_num_threads(2)

CONFIG3_EYE = (8.0, 5.0, 8.0)   # experiments/configs.py SCENARIOS[3]
N_RAYS = jax_tk.TORUS_SMALL_TILE  # one tile of the JAX kernel: 2,048 rays


def _t(a):
    return torch.from_numpy(np.array(a))


def _config3_tori(K):
    """Config 3's 4 analytic tori (procedural.scene_multi_torus); above 4,
    torus k is torus k % 4 moved by (k // 4) * 2.5 along x."""
    tor = build_scene(procedural.scene_multi_torus(True)).tori
    w2o, major, minor = (np.asarray(a, np.float32) for a in (
        tor.world_to_obj, tor.major_radius, tor.minor_radius))
    ks = np.arange(K) % 4
    w2o, major, minor = w2o[ks].copy(), major[ks], minor[ks]
    shift = (np.arange(K) // 4)[:, None] * np.float32([2.5, 0.0, 0.0])
    w2o[:, :, 3] -= np.einsum("kab,kb->ka", w2o[:, :, :3], shift)
    return w2o, major, minor


def _random_tori(K, seed=7):
    """K tori with random rotations, centres in [-2, 2] x [0, 1] x [-2, 2]
    and radii, as world-to-object (K, 3, 4) rows."""
    rng = np.random.default_rng(seed)
    w2o = np.zeros((K, 3, 4), np.float32)
    for k in range(K):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        q *= np.sign(np.linalg.det(q))
        c = rng.uniform([-2.0, 0.0, -2.0], [2.0, 1.0, 2.0])
        w2o[k, :, :3] = q.T
        w2o[k, :, 3] = -q.T @ c
    major = rng.uniform(0.5, 1.2, K).astype(np.float32)
    minor = rng.uniform(0.15, 0.4, K).astype(np.float32)
    return w2o, major, minor


def _random_rays(n=N_RAYS, seed=5):
    """Rays from a sphere of radius 7 toward points of the tori's region,
    every 7th dead (tmax 0)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(3, n))
    o *= 7.0 / np.linalg.norm(o, axis=0, keepdims=True)
    target = rng.uniform([-3.0, -0.5, -3.0], [3.0, 1.5, 3.0], (n, 3)).T
    d = target - o
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    tmax = np.full((n,), 1e4, np.float32)
    tmax[::7] = 0.0
    return o.astype(np.float32), d.astype(np.float32), tmax


def _config3_rays():
    """64 x 64 rays of config 3's camera, every 7th dead."""
    return _camera_rays(CONFIG3_EYE, 64, 64)


def _inputs(name, K):
    tori = _config3_tori(K) if name == "config3" else _random_tori(K)
    rays = _config3_rays() if name == "config3" else _random_rays()
    return tori, rays


def _jax(rays, tori, mat=None, occlusion=False):
    return [np.asarray(x) for x in jax_tk.torus_closest_hit_small(
        *(jnp.asarray(a) for a in rays), *tori,
        mat_table=None if mat is None else jnp.asarray(mat),
        occlusion=occlusion)]


def _twin(rays, tori, mat=None, occlusion=False, counts=None):
    par = tk.small_params(*(_t(a) for a in tori),
                          None if mat is None else _t(mat))
    return tk.torus_small_plain(*(_t(a) for a in rays), par, mat is not None,
                                occlusion, counts=counts)


@pytest.mark.parametrize("name", ["config3", "random"])
@pytest.mark.parametrize("K", [1, 4, 5, 8])
def test_twin_matches_pallas_with_attrs(name, K):
    tori, rays = _inputs(name, K)
    mat = np.arange(K * 12, dtype=np.float32).reshape(K, 12) * 0.25
    got = [x.numpy() for x in _twin(rays, tori, mat)]
    hit = got[0] < BIG
    assert int(hit.sum()) > 50
    if K > 1:
        assert len(np.unique(got[1][hit])) > 1
    _compare(got, _jax(rays, tori, mat), "attrs", rays[2])


def test_duplicated_torus_lowest_index_wins():
    """Torus 1 of config 3 copied to row 4: the same t from both, so only
    the index decides, and the lower one wins every such ray, in the twin
    and in the JAX kernel."""
    tori = [np.concatenate([a, a[1:2]]) for a in _config3_tori(4)]
    rays = _config3_rays()
    got = [x.numpy() for x in _twin(rays, tori)]
    ref = _jax(rays, tori)
    _compare(got, ref, "closest", rays[2])
    for idx, t in ((got[1], got[0]), (ref[1], ref[0])):
        assert int(((t < BIG) & (idx == 1)).sum()) >= 50
        assert not (idx == 4).any()


def test_rays_with_tmax_zero_take_no_work():
    """Dead rays (tmax 0) miss in the twin and the JAX kernel, and take no
    slab test past the union box and no quartic: the counts on all the
    rays are those of the live rays alone plus one union test each."""
    tori, (o, d, tmax) = _inputs("config3", 4)
    tmax = tmax.copy()
    tmax[1::2] = 0.0
    dead = tmax <= TMIN
    counts, live_counts = {}, {}
    got = [x.numpy() for x in _twin((o, d, tmax), tori, counts=counts)]
    _twin((o[:, ~dead], d[:, ~dead], tmax[~dead]), tori, counts=live_counts)
    ref = _jax((o, d, tmax), tori)
    assert int(dead.sum()) > 1000 and live_counts["prim"] > 100
    assert counts["prim"] == live_counts["prim"]
    assert counts["box"] == live_counts["box"] + int(dead.sum())
    for t, idx in ((got[0], got[1]), (ref[0], ref[1])):
        assert not (t[dead] < BIG).any() and not idx[dead].any()
    _compare(got, ref, "closest", tmax)


@pytest.mark.parametrize("name", ["config3", "random"])
@pytest.mark.parametrize("K", [1, 4])
def test_anyhit_mask_and_zero_idx(name, K):
    """Any-hit: the twin's mask is the JAX kernel's, and idx is 0 on every
    ray in both (the CUDA kernel writes 0 too; chip_smoke.py checks it on
    the card)."""
    tori, rays = _inputs(name, K)
    got = [x.numpy() for x in _twin(rays, tori, occlusion=True)]
    ref = _jax(rays, tori, occlusion=True)
    assert int((got[0] < BIG).sum()) > 50
    _compare(got, ref, "occlusion", rays[2])
    for idx in (got[1], ref[1]):
        assert not idx.any()


def test_wrapper_refuses_counters_on_cpu():
    w2o, major, minor = _config3_tori(4)
    tb = tk.torus_tables(_t(w2o), _t(major), _t(minor))
    o, d, tmax = (_t(a) for a in _config3_rays())
    with pytest.raises(ValueError, match="counters"):
        tk.torus_closest_hit_small(o, d, tmax, tb,
                                   counters=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError, match="shape"):
        tk.torus_closest_hit_small(o, d, tmax, tb,
                                   counters=torch.zeros(3, dtype=torch.int64))


@pytest.mark.parametrize("K", range(1, tk.TORUS_SMALL_MAX_K + 1))
def test_counts_when_every_ray_passes_every_box(K):
    """K concentric tori, every ray starting at their common centre, inside
    every box: closest-hit tests every box and runs every quartic (1 + K
    slab tests and K quartics per ray); any-hit stops at a ray's first hit,
    so its quartics are its slab tests past the union box, and at most the
    closest-hit walk's."""
    w2o = np.zeros((K, 3, 4), np.float32)
    rng = np.random.default_rng(K)
    for k in range(K):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        w2o[k, :, :3] = q.T * np.sign(np.linalg.det(q))
    tori = (w2o, np.linspace(1.0, 2.0, K, dtype=np.float32),
            np.full((K,), 0.3, np.float32))
    n = 80
    d = rng.normal(size=(3, n)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    rays = (np.zeros((3, n), np.float32), d, np.full((n,), 1e4, np.float32))
    closest, occl = {}, {}
    got = _twin(rays, tori, counts=closest)
    anyhit = _twin(rays, tori, occlusion=True, counts=occl)
    hit = got[0] < BIG
    assert int(hit.sum()) > n // 4
    assert torch.equal(anyhit[0] < BIG, hit)
    assert closest == {"box": n * (1 + K), "prim": n * K}
    assert occl["prim"] == occl["box"] - n
    assert int(hit.sum()) <= occl["prim"] <= n * K
    if K > 1:
        assert occl["prim"] < n * K
