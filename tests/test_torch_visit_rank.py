"""The visit-rank kernel V1 (`ops.visit_kernel`) through its plain twin on
the CPU, and the query folds its segment's kernels write beside their hits.

(a) Order against the JAX package: the twin's ranks over the box sets the
    tree kernels walk (config 3's and config 4's K2 chunk boxes, config
    6's K1 cluster boxes with the hoisted loose tail's far boxes, and a
    small K5 mesh's superblocks) equal `jnp.argsort(jnp.argsort(cdist))`
    with cdist as the JAX launchers compute it (`ops/tri_kernel.py:398-404`)
    from the same anchor (the port's `batch_anchor` of seeded origins, the
    camera's eye) and the same boxes: equal, every rank.
(b) The rewritten distance (`kernel_common.box_distance`, the fixed-order
    elementwise form V1 computes) ranks those sets as the old
    `torch.linalg.vector_norm` formula did.
(c) Edge cases: ties keep index order (duplicate boxes, boxes holding the
    anchor, far boxes), a NaN anchor gives torch's stable order (every
    distance NaN), a NaN box sorts after every number, -0.0 equals 0.0;
    the wrapper's checks; synthetic sets at the sizes the kernel splits on
    (1-3,340 boxes), against the JAX order and a Python model of the
    kernel's share-sort-and-count rank.
(d) Folds: each kernel twin's new outputs (S1, K1, K5, K2, K3; closest and
    any-hit) through their wrappers equal the torch formulation they
    replace, bit for bit: the next kernel's tmax `torch.minimum(tmax, t)`
    or `torch.where(occ, 0, tmax)`, the occlusion byte `t < BIG`, ORed
    into the earlier kernels' byte.
(e) One V1 a segment: `trace_state` on the kernel backend ranks a
    segment's sets once for both its queries (the box sets
    `trace_kernel.segment_routes` names for the segment's route), and no
    wrapper ranks its own set.
(f) The sweep script's edits of csrc/visit.cu match the source once, and
    the wrapper's constants are the source's.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toroidal_ray_tracing_tpu_torch import render
from toroidal_ray_tracing_tpu_torch.cameras import PinholeCamera
from toroidal_ray_tracing_tpu_torch.experiments import v1_cluster_sweep
from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
from toroidal_ray_tracing_tpu_torch.ops import kernel_common as kc
from toroidal_ray_tracing_tpu_torch.ops import segment_plan as sp
from toroidal_ray_tracing_tpu_torch.ops import trace_kernel as tk
from toroidal_ray_tracing_tpu_torch.ops import visit_kernel as vk
from toroidal_ray_tracing_tpu_torch.ops.loose_kernel import loose_hit
from toroidal_ray_tracing_tpu_torch.ops.torus_kernel import (
    torus_closest_hit_chunked, torus_closest_hit_small, torus_tables)
from toroidal_ray_tracing_tpu_torch.ops.tri_kernel import (tri_closest_hit,
                                                           tri_tables)
from toroidal_ray_tracing_tpu_torch.ops.tri_stream import (
    stream_tables, tri_closest_hit_stream)
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings, build_scene,
                                                  procedural)
from toroidal_ray_tracing_tpu_torch.trace import wavefront as wf
from toroidal_ray_tracing_tpu_torch.trace.intersect import geom_from_scene
from toroidal_ray_tracing_tpu_torch.utils import math3d

torch.set_num_threads(2)

BIG = kc.BIG
_SCENES: dict = {}


def _scene(name):
    if name not in _SCENES:
        if name == "k5":
            # 2 * 200 * 200 = 80,000 triangles: above TRI_STREAM_MIN, 625
            # clusters in superblocks of 2
            _SCENES[name] = build_scene(procedural.scene_hires_mesh(200))
        else:
            _SCENES[name] = SCENARIOS[int(name[-1])].build()
    return _SCENES[name]


def _box_set(name):
    """(lo, hi, eye) of the set the tree kernels walk in the scene."""
    scene = _scene(name)
    geom = geom_from_scene(scene)
    if name in ("config3", "config4"):
        tb = tk._torus_tables(scene, geom)
        lo, hi = tb.clo, tb.chi
    else:
        mesh = tk._tri_plan(scene, geom).mesh
        lo, hi = ((mesh.sb_lo, mesh.sb_hi) if name == "k5"
                  else (mesh.clo, mesh.chi))
    eye = (SCENARIOS[8] if name == "k5"
           else SCENARIOS[int(name[-1])]).camera.eye
    return lo, hi, eye


def _anchors(lo, hi, eye, seed=0):
    """The port's anchors over seeded origins: rays from the eye, a spread
    wavefront about the boxes' centre, and points inside the boxes' hull
    (ties between the boxes holding them)."""
    rng = np.random.default_rng(seed)
    real = (lo[:, 0] < 1e29).numpy()
    blo = lo.numpy()[real].min(axis=0)
    bhi = hi.numpy()[real].max(axis=0)
    sets = [np.tile(np.asarray(eye, np.float32)[:, None], (1, 3000))]
    sets.append(rng.uniform(blo, bhi, (5000, 3)).T.astype(np.float32))
    for k in range(8):
        p = rng.uniform(blo, bhi).astype(np.float32)
        sets.append(p[:, None] + rng.normal(0, 0.3, (3, 777)).astype(
            np.float32))
    out = []
    for o in sets:
        o = torch.from_numpy(np.ascontiguousarray(o))
        n_batch = kc.round_up(o.shape[1], 2048)
        out.append((o, n_batch, kc.batch_anchor(o, n_batch)))
    return out


def _jax_rank(lo, hi, anchor):
    """`jnp.argsort(jnp.argsort(cdist))` as the JAX launchers compute it
    (ops/tri_kernel.py:398-404), from the given anchor."""
    clo, chi = jnp.asarray(lo.numpy()), jnp.asarray(hi.numpy())
    mean_o = jnp.asarray(anchor.numpy())
    cdist = jnp.linalg.norm(
        jnp.maximum(jnp.maximum(clo - mean_o[None, :],
                                mean_o[None, :] - chi), 0.0), axis=1)
    return np.asarray(jnp.argsort(jnp.argsort(cdist)).astype(jnp.int32))


SETS = ["config3", "config4", "config6", "k5"]


@pytest.mark.parametrize("name", SETS)
def test_twin_ranks_match_jax_order(name):
    lo, hi, eye = _box_set(name)
    assert lo.shape[0] >= 1
    for o, n_batch, anchor in _anchors(lo, hi, eye):
        got_anchor, (rank,) = vk.visit_ranks(o, n_batch, [(lo, hi)])
        assert torch.equal(got_anchor, anchor)
        np.testing.assert_array_equal(rank.numpy(),
                                      _jax_rank(lo, hi, anchor))


@pytest.mark.parametrize("name", SETS)
def test_rewritten_distance_ranks_as_vector_norm(name):
    lo, hi, eye = _box_set(name)
    for o, n_batch, anchor in _anchors(lo, hi, eye, seed=1):
        gap = torch.clamp(torch.maximum(lo - anchor[None, :],
                                        anchor[None, :] - hi), min=0.0)
        old = torch.argsort(torch.linalg.vector_norm(gap, dim=1),
                            stable=True).to(torch.int32)
        new = kc.visit_order(lo, hi, o, n_batch, anchor)
        assert torch.equal(new, old)
        assert torch.equal(vk.visit_rank(o, n_batch, lo, hi),
                           kc.tree_rank(old))


def test_ties_keep_index_order():
    lo = torch.tensor([[0.0, 0.0, 0.0], [5.0, 0.0, 0.0], [-1.0, -1.0, -1.0],
                       [5.0, 0.0, 0.0], [2e38, 2e38, 2e38], [-2.0, -2.0, -2.0],
                       [2e38, 2e38, 2e38], [5.0, 0.0, 0.0]])
    hi = lo + torch.tensor([1.0, 1.0, 1.0])
    hi[4], hi[6] = lo[4], lo[6]
    hi[5] = torch.tensor([2.0, 2.0, 2.0])
    o = torch.full((3, 10), 0.5)
    # boxes 0 and 5 hold the anchor (distance 0), 1, 3 and 7 tie at 4.5,
    # the far boxes 4 and 6 tie at inf
    _, (rank,) = vk.visit_ranks(o, 10, [(lo, hi)])
    assert rank.tolist() == [0, 3, 2, 4, 6, 1, 7, 5]


def test_nan_anchor_and_nan_box():
    g = torch.Generator().manual_seed(3)
    lo = torch.randn((40, 3), generator=g)
    hi = lo + torch.rand((40, 3), generator=g)
    o = torch.randn((3, 100), generator=g)
    o[2, 7] = float("nan")
    anchor, (rank,) = vk.visit_ranks(o, 2048, [(lo, hi)])
    assert bool(torch.isnan(anchor[2]))
    cdist = kc.box_distance(lo, hi, anchor)
    assert bool(torch.isnan(cdist).all())
    assert torch.equal(rank, torch.arange(40, dtype=torch.int32))
    assert torch.equal(rank, kc.tree_rank(
        torch.argsort(cdist, stable=True).to(torch.int32)))
    # one NaN box sorts after every number, the rest by distance
    lo[3, 1] = float("nan")
    o[2, 7] = 0.0
    _, (rank,) = vk.visit_ranks(o, 2048, [(lo, hi)])
    assert int(rank[3]) == 39
    cdist = kc.box_distance(lo, hi, kc.batch_anchor(o, 2048))
    assert torch.equal(rank, kc.tree_rank(
        torch.argsort(cdist, stable=True).to(torch.int32)))


def test_negative_zero_distance_and_checks():
    lo = torch.tensor([[-0.0, 1.0, 1.0], [0.0, 1.0, 1.0], [0.0, 1.0, 1.0]])
    hi = lo + 1.0
    o = torch.zeros((3, 4))
    o[1:, :] = 1.5
    _, (rank,) = vk.visit_ranks(o, 4, [(lo, hi)])
    assert rank.tolist() == [0, 1, 2]
    state = torch.zeros((15, 6))
    _, (r2,) = vk.visit_ranks(state[0:3], 4, [(lo, hi)])
    assert r2.tolist() == [0, 1, 2]
    with pytest.raises(ValueError):
        vk.visit_ranks(o, 4, [(lo, hi)] * 3)
    with pytest.raises(ValueError):
        vk.visit_ranks(o.T.contiguous().T, 4, [(lo, hi)])
    with pytest.raises(ValueError):
        vk.visit_ranks(o, 0, [(lo, hi)])


def _cluster_rank(lo, hi, anchor):
    """The kernel's rank in plain Python: box j's 64-bit key (ordered
    distance bits << 32 | j); each of the `cluster_for` CTAs (one up to
    ONE_CTA_BOXES boxes, else CLUSTER) sorts its share of ceil(m / C) keys
    padded with ~0 to `share_keys(m, C)`, and a box's rank is the number of
    keys below its own in every share."""
    m = lo.shape[0]
    cdist = kc.box_distance(lo, hi, anchor).numpy()
    bits = cdist.view(np.uint32)
    bits = np.where(bits == 0x80000000, 0, bits)        # -0 as +0
    ordered = np.where(bits & 0x80000000, ~bits, bits | 0x80000000)
    ordered = np.where(np.isnan(cdist), 0xFFFFFFFF, ordered)
    keys = (ordered.astype(np.uint64) << np.uint64(32)
            | np.arange(m, dtype=np.uint64))
    c = vk.cluster_for([m])
    assert c == (1 if m <= vk.ONE_CTA_BOXES else vk.CLUSTER)
    share, size = -(-m // c), vk.share_keys(m, c)
    assert size >= max(share, 32) and size & (size - 1) == 0
    pad = np.uint64(2 ** 64 - 1)
    shares = []
    for k in range(c):
        own = keys[k * share:(k + 1) * share]
        shares.append(np.sort(np.concatenate(
            [own, np.full(size - len(own), pad, np.uint64)])))
    return np.array([sum(int(np.searchsorted(s, k)) for s in shares)
                     for k in keys], np.int32)


@pytest.mark.parametrize("m", [1, 2, 8, 9, 33, 257, 3340])
def test_twin_ranks_match_jax_order_synthetic(m):
    """V1's split sizes (one CTA's sort of 1 box, of a warp, past a warp;
    config 8's 3,340 superblocks over a cluster) on seeded boxes with
    duplicates, boxes that hold the anchor and NaN boxes: the twin's ranks
    equal the JAX package's `argsort(argsort(cdist))` and the kernel's
    rank (shares sorted, a rank the keys below in every share), every
    rank."""
    g = np.random.default_rng(m)
    o = g.normal(0.0, 2.0, (3, 500)).astype(np.float32)
    n_batch = kc.round_up(o.shape[1], 2048)
    anchor = kc.batch_anchor(torch.from_numpy(o), n_batch)
    c = anchor.numpy()[None, :] + g.normal(0.0, 6.0, (m, 3)).astype(
        np.float32)
    h = g.uniform(0.0, 2.0, (m, 3)).astype(np.float32)
    lo, hi = c - h, c + h
    if m >= 8:
        lo[m // 2:m // 2 + m // 4] = lo[:m // 4]         # duplicates
        hi[m // 2:m // 2 + m // 4] = hi[:m // 4]
        lo[1::7] = anchor.numpy() - 1.0                   # hold the anchor
        hi[1::7] = anchor.numpy() + 1.0
        lo[3::11, 1] = np.nan                             # NaN boxes
    lo, hi = torch.from_numpy(lo), torch.from_numpy(hi)
    got_anchor, (rank,) = vk.visit_ranks(torch.from_numpy(o), n_batch,
                                         [(lo, hi)])
    assert torch.equal(got_anchor, anchor)
    want = _jax_rank(lo, hi, anchor)
    np.testing.assert_array_equal(rank.numpy(), want)
    np.testing.assert_array_equal(_cluster_rank(lo, hi, anchor), want)
    if m >= 8:
        cdist = kc.box_distance(lo, hi, anchor)
        assert bool((cdist == 0).any())
        assert bool(torch.isnan(cdist).any())


# ---------------------------------------------------------------------------
# (d) folds
# ---------------------------------------------------------------------------

def _rays(n, seed, center, spread):
    g = np.random.default_rng(seed)
    o = (np.asarray(center, np.float32)[:, None]
         + g.normal(0, spread, (3, n)).astype(np.float32))
    tgt = g.normal(0, 1.5, (3, n)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    tmax = np.full((n,), 1e4, np.float32)
    tmax[::11] = 0.0                      # dead lanes
    tmax[5::13] = g.uniform(0.5, 8.0, (len(tmax[5::13]),))
    return (torch.from_numpy(np.ascontiguousarray(o)),
            torch.from_numpy(np.ascontiguousarray(d.astype(np.float32))),
            torch.from_numpy(tmax))


def _fold_scene():
    """Loose plane (S1), a clustered mirror torus mesh (K1; its bounces
    make more segments), a dozen tori (K2)."""
    s = procedural.scene_instanced_torus_grid(n=12)
    s.add_model(procedural.torus_mesh(1.0, 0.35, seg_major=24, seg_minor=12,
                                      material=procedural.mirror()),
                math3d.translation((0.0, 1.2, 0.0)))
    return build_scene(s)


def _kernel_call(kind, occlusion, rays):
    """(t, the wrapper's kwargs to fold, call(tmax_out, occ_out, occ_or))."""
    o, d, tm = rays
    if kind == "s1":
        scene = _scene("config3")
        tri = scene.triangles
        plan = tk._tri_plan(scene, geom_from_scene(scene))
        assert plan.L > 0

        def call(tmax_out, occ_out, occ_or, tm_in=tm):
            out = loose_hit(o, d, tm_in, tri.woop_o, tri.woop_d, plan.base,
                            plan.L, plan.base, occlusion, occ_out=occ_out)
            return out[0], out[5]
        return call
    if kind in ("k1", "k5"):
        scene = _scene("config6" if kind == "k1" else "k5")
        geom = geom_from_scene(scene)
        mesh = tk._tri_plan(scene, geom).mesh
        fn = tri_closest_hit if kind == "k1" else tri_closest_hit_stream

        def call(tmax_out, occ_out, occ_or, tm_in=tm):
            return fn(o, d, tm_in, mesh, occlusion=occlusion,
                      tmax_out=tmax_out, occ_out=occ_out,
                      occ_or=occ_or)[0], None
        return call
    scene = _scene("config4" if kind == "k2" else "config3")
    tb = tk._torus_tables(scene, geom_from_scene(scene))
    fn = (torus_closest_hit_chunked if kind == "k2"
          else torus_closest_hit_small)

    def call(tmax_out, occ_out, occ_or, tm_in=tm):
        return fn(o, d, tm_in, tb, occlusion=occlusion, occ_out=occ_out,
                  occ_or=occ_or)[0], None
    return call


FOLDS = [("s1", False), ("s1", True), ("k1", False), ("k1", True),
         ("k5", False), ("k5", True), ("k2", True), ("k3", True)]


@pytest.mark.parametrize("kind,occlusion", FOLDS,
                         ids=[f"{k}-{'any' if a else 'closest'}"
                              for k, a in FOLDS])
def test_fold_outputs_equal_torch_formulation(kind, occlusion):
    """(K2 and K3 end a query: in closest mode they fold nothing.) With
    occ_or the earlier kernels' byte is kept and the lanes it holds come
    in with tmax 0, as S1 leaves them."""
    center = {"k2": (0.0, 3.0, 0.0), "k5": (0.0, 2.5, 4.0)}.get(
        kind, (4.0, 3.0, 4.0))
    seed = {"s1": 1, "k1": 2, "k5": 3, "k2": 4, "k3": 5}[kind]
    rays = _rays(1536, seed=seed, center=center, spread=1.0)
    tm = rays[2]
    n = tm.shape[0]
    call = _kernel_call(kind, occlusion, rays)
    has_tmax = kind in ("k1", "k5")
    if not occlusion:
        nxt = torch.full((n,), -7.0) if has_tmax else None
        t, s1_tmax = call(nxt, None, False)
        assert bool((t < BIG).any()) and bool((t >= BIG).any())
        got = nxt if has_tmax else s1_tmax
        assert torch.equal(got, torch.minimum(tm, t))
        return
    g = torch.Generator().manual_seed(5)
    earlier = torch.rand((n,), generator=g) < 0.3
    for occ_or in ([False] if kind == "s1" else [False, True]):
        # as in a query: an earlier kernel that occluded a lane left its
        # tmax 0 (S1 writes it so)
        tm_in = torch.where(earlier, 0.0, tm) if occ_or else tm
        occ = earlier.clone()
        nxt = torch.full((n,), -7.0) if has_tmax else None
        t, s1_tmax = call(nxt, occ, occ_or, tm_in)
        want = (earlier | (t < BIG)) if occ_or else (t < BIG)
        assert torch.equal(occ, want)
        assert bool((t < BIG).any()) and bool((t >= BIG).any())
        if has_tmax:
            assert torch.equal(nxt, torch.where(want, 0.0, tm))
        if s1_tmax is not None:
            assert torch.equal(s1_tmax, torch.where(want, 0.0, tm))


def test_fold_checks():
    scene = _scene("config6")
    mesh = tk._tri_plan(scene, geom_from_scene(scene)).mesh
    o, d, tm = _rays(64, 0, (4.0, 3.0, 4.0), 1.0)
    with pytest.raises(ValueError):          # occlusion byte, closest query
        tri_closest_hit(o, d, tm, mesh, occ_out=torch.zeros(64, dtype=bool))
    with pytest.raises(ValueError):          # OR into nothing
        tri_closest_hit(o, d, tm, mesh, occlusion=True, occ_or=True)
    with pytest.raises(TypeError):
        tri_closest_hit(o, d, tm, mesh, occlusion=True,
                        occ_out=torch.zeros(64, dtype=torch.uint8))


# ---------------------------------------------------------------------------
# (e) one V1 a segment
# ---------------------------------------------------------------------------

def test_trace_state_ranks_once_a_segment(monkeypatch):
    scene = _fold_scene()
    geom = geom_from_scene(scene)
    assert tk._tri_plan(scene, geom).mesh.box_test
    calls = {"ranks": [], "per_call": 0, "segments": 0, "routes": 0}
    real_ranks = vk.visit_ranks
    real_route = tk.segment_routes
    real_finish = wf.shade_finish

    def ranks(origins, n_batch, sets, out=None):
        calls["ranks"].append(len(sets))
        return real_ranks(origins, n_batch, sets, out=out)

    def per_call(*a, **k):
        calls["per_call"] += 1
        return vk.visit_rank(*a, **k)

    def finish(*a, **k):
        calls["segments"] += 1
        return real_finish(*a, **k)

    def route(*a, **k):
        calls["routes"] += 1
        return real_route(*a, **k)

    monkeypatch.setattr(vk, "visit_ranks", ranks)
    monkeypatch.setattr(tk, "segment_routes", route)   # a query's own
    monkeypatch.setattr(sp, "segment_routes", route)   # the plan's
    monkeypatch.setattr(wf, "shade_finish", finish)
    for mod in ("tri_kernel", "torus_kernel", "tri_stream"):
        monkeypatch.setattr(sys.modules["toroidal_ray_tracing_tpu_torch.ops."
                                        + mod], "visit_rank", per_call)
    cam = PinholeCamera(eye=(7.0, 5.0, 7.0), center=(0.0, 0.5, 0.0))
    out = render(scene, cam, 40, 30, RenderSettings.default(max_depth=3),
                 backend="kernel", device="cpu")
    assert calls["segments"] >= 2
    # K1's clusters and K2's chunks, once a segment for both queries
    assert calls["ranks"] == [2] * calls["segments"]
    assert calls["per_call"] == 0
    # the route is decided once a loop (the segment plan's), and both
    # queries of every segment take it
    assert calls["routes"] == 1
    assert out["rays_traced"] > 0


def test_segment_ranks_sets():
    """Each route's box sets for V1 (`_Route.tri_set`, `.tor_set`) beside
    the route they were named
    for. Config 6: K1's clusters only; config 4 at 1080p lanes: K2's
    chunks; config 3 at 512x512 lanes (K3's route): no set, no launch."""
    def route(name, lanes):
        return tk.segment_routes(_scene(name), geom_from_scene(_scene(name)),
                                 (lanes,))[lanes]

    r6 = route("config6", 1920 * 1080)
    tri, tor = r6.tri_set, r6.tor_set
    assert tri[0].shape == tri[1].shape == (181, 3) and tor is None
    assert r6.tri.mesh.box_test and tri[0] is r6.tri.mesh.clo
    r4 = route("config4", 1920 * 1080)
    tri, tor = r4.tri_set, r4.tor_set
    assert tri is None and tor[0].shape == (64, 3)
    assert r4.tor is not None and not r4.small and tor[0] is r4.tor.clo
    r3 = route("config3", 512 * 512)
    assert r3.tri_set is None and r3.tor_set is None
    assert r3.small


# ---------------------------------------------------------------------------
# (f) the measurement scripts' builds of csrc/visit.cu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("build", ["limit", *v1_cluster_sweep.STOPS])
def test_v1_sweep_edits_match_the_source_once(build):
    """experiments/v1_cluster_sweep.py builds visit.cu with one line edited
    (the one-CTA limit, or an early exit); each edit must match the
    shipped source once, or the sweep raises on the card."""
    with open(os.path.join(kc.CSRC, "visit.cu")) as f:
        src = f.read()
    pattern, line = ((v1_cluster_sweep.LIMIT,
                      "constexpr int kOneCtaBoxes = {};")
                     if build == "limit" else v1_cluster_sweep.STOPS[build])
    assert len(pattern.findall(src)) == 1
    edited = pattern.sub(line.format(0), src)
    assert edited != src
    if build == "limit":
        assert f"constexpr int kOneCtaBoxes = {vk.ONE_CTA_BOXES};" in src
        assert f"constexpr int kCluster = {vk.CLUSTER};" in src
        assert f"constexpr int kSlabKeys = {vk.SLAB_KEYS};" in src
    else:
        assert edited.count("return;") == src.count("return;") + 1
