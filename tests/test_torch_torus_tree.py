"""K2's torus tree (`ops.torus_kernel.torus_tables`, over
`kernel_common.build_tree`) and a scalar Python reference of the CUDA
kernel's walk over it (`csrc/torus_hit.cu` torus_closest_hit): packets of
32 rays, one stack per packet, a node entered when any walking ray passes
it at the bound of its last round, the near child first by the packet's
majority direction sign; at a leaf (one torus, its box the leaf's) the
(ray, torus) pairs that passed join the packet's queue, and whenever
kFlushPairs are queued, and at the end, a round takes up to 32 of them
(one per lane) and folds each pair's root into its ray's minimum of (t,
chunk rank * chunk + torus % chunk).

The reference must return bit-identical t/idx (closest and attrs) to the
flat twin `torus_chunked_plain`, and equal any-hit masks, at K = 32, 128
and 1,024 (there with fewer box tests: below, the twin's chunks of 8 or 16
already cull as well as the tree), and on a constructed tie (the same
torus in two chunks) that only the chunk rank decides. The reference takes each
pair's root from a table computed chunk by chunk as the twin computes it
(`_quartic_t` on the chunk's rows against every ray), so the walk, not
the quartic, is what is compared. The orchestrator keeps the tables per
scene and device, and the wrappers take them prebuilt and build nothing
per call."""

import pathlib
import re

import numpy as np
import pytest
import torch

from test_torch_torus_kernel import _camera_rays, _torus_grid
from toroidal_ray_tracing_tpu.scene import build_scene as jax_build_scene
from toroidal_ray_tracing_tpu.scene import procedural as jax_procedural
from toroidal_ray_tracing_tpu_torch.ops import kernel_common as kc
from toroidal_ray_tracing_tpu_torch.ops import torus_kernel as tk
from toroidal_ray_tracing_tpu_torch.ops import trace_kernel as port_tk
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
    BIG, _inv_dir, slab, tree_rank, visit_order)
from toroidal_ray_tracing_tpu_torch.ops.shade_kernel import shade_attrs
from toroidal_ray_tracing_tpu_torch.scene import scene_from_numpy
from toroidal_ray_tracing_tpu_torch.trace.intersect import closest_hit

torch.set_num_threads(2)

# The torus sets, each with the eye of the pinhole camera its 64 x 32 rays
# come from (looking at the origin, every 7th ray dead, as
# test_torch_torus_kernel's): K = 32 and 128 are that file's seeded grids
# (chunks of 8 and of 16); K = 1,024 is config 4's instanced grid
# (experiments/configs.py SCENARIOS[4], procedural.scene_instanced_torus_grid
# with its camera).
SETS = {32: (6.0, 5.0, 6.0), 128: (12.0, 9.0, 12.0),
        1024: (25.0, 18.0, 25.0)}
# Dead and padded rows: a 29-torus grid (padded to 32) with these minor
# radii set to 0.
DEAD_K, DEAD_ROWS = 29, (3, 11, 20)
# The tie: a 15-torus grid plus a copy of torus TIE_SRC as torus 15, so
# chunk 0 and chunk 1 (8 tori each) hold the same torus; the camera is
# close enough for it to take ~95 of the rays.
TIE_K, TIE_SRC, TIE_EYE = 15, 7, (1.5, 1.5, 1.5)
PACKET = 32                 # rays per warp
ROUND = 32                  # pairs per round: one per lane
TORUS_CU = pathlib.Path(tk.__file__).parents[1] / "csrc" / "torus_hit.cu"
SOURCE = TORUS_CU.read_text()
FLUSH_PAIRS = int(re.search(r"constexpr int kFlushPairs = (\d+);",
                            SOURCE).group(1))
K_STACK = int(re.search(r"constexpr int kStack = (\d+);", (
    TORUS_CU.parent / "tree_walk.cuh").read_text()).group(1))
F32 = np.float32
TMIN = F32(1e-3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_scene(K):
    if K == 1024:
        return jax_build_scene(jax_procedural.scene_instanced_torus_grid(K))
    return _torus_grid(K)


def _set(K, eye=None, mat=True):
    """(tables, origins, dirs, tmax) of torus set K."""
    tor = _jax_scene(K).tori
    o, d, tmax = _camera_rays(eye or SETS[K])
    m = (torch.arange(K * 12, dtype=torch.float32).reshape(K, 12) * 0.25
         if mat else None)
    return (tk.torus_tables(_t(tor.world_to_obj), _t(tor.major_radius),
                            _t(tor.minor_radius), m), _t(o), _t(d), _t(tmax))


def _twin(tb, o, d, tmax, order, occl, counts=None):
    return tk.torus_chunked_plain(o, d, tmax, tb.w2o_rows, tb.rad, tb.tor_lo,
                                  tb.tor_hi, tb.clo, tb.chi, order, tb.chunk,
                                  None if occl else tb.mat, occl,
                                  counts=counts)


def _jmin(a, b):
    return a if (a < b or a != a) else b


class PairWalker:
    """Per-ray state of K2's walk: the (node, ray) slab entry/exit from the
    twin's `slab`, every (torus, ray) root from the twin's `_quartic_t`
    chunk by chunk, and each ray's best key, torus and root."""

    def __init__(self, o, d, tmax, tb, rank, occlusion):
        n = o.shape[1]
        ol, dl = [o[a] for a in range(3)], [d[a] for a in range(3)]
        inv = [_inv_dir(d[a]) for a in range(3)]
        tn, tf = slab(tb.tree_lo[:, None, :], tb.tree_hi[:, None, :], ol,
                      inv)
        self.node = (tn.numpy(), tf.numpy())
        ts, roots = [], []
        for c in range(tb.clo.shape[0]):
            ks = slice(c * tb.chunk, (c + 1) * tb.chunk)
            w = [tb.w2o_rows[ks, j:j + 1] for j in range(12)]
            t, troot, _ = tk._quartic_t(
                w, tb.rad[ks, 0:1], tb.rad[ks, 1:2], ol, dl, tmax,
                torch.ones((tb.chunk, n), dtype=torch.bool))
            ts.append(t)
            roots.append(troot)
        self.t_of = torch.cat(ts).numpy()
        self.root_of = torch.cat(roots).numpy()
        self.d, self.tmax = d, tmax.numpy()
        self.link, self.rank, self.chunk = (tb.tree_link.numpy(),
                                            rank.numpy(), tb.chunk)
        self.occl = occlusion
        self.t = np.full(n, F32(BIG))
        self.pos = np.full(n, 2 ** 32 - 1, np.int64)
        self.idx = np.zeros(n, np.int32)
        self.root = np.zeros(n, F32)
        self.done = ~(self.tmax > TMIN)
        self.box = self.prim = 0

    def passes(self, m, i):
        self.box += 1
        if self.occl:
            bound = F32(-1.0) if self.t[i] < F32(BIG) else self.tmax[i]
        else:
            bound = _jmin(self.t[i], self.tmax[i])
        tn, tf = self.node[0][m, i], self.node[1][m, i]
        return bool(tn <= _jmin(tf, bound) and tf >= TMIN
                    and self.tmax[i] > TMIN)

    def round(self, pairs):
        for i, k in pairs:
            self.prim += 1
            t = self.t_of[k, i]
            if not t < F32(BIG):
                continue
            pos = int(self.rank[k // self.chunk]) * self.chunk \
                + k % self.chunk
            if (t, pos) < (self.t[i], self.pos[i]):
                self.t[i], self.pos[i] = t, pos
                self.idx[i], self.root[i] = k, self.root_of[k, i]
        for i, _ in pairs:
            self.done[i] |= self.occl and self.t[i] < F32(BIG)


def walk_pair_queue(w):
    """Each packet of 32 consecutive rays walks the tree with one queue."""
    n = len(w.t)
    for c0 in range(0, n, PACKET):
        lanes = range(c0, min(c0 + PACKET, n))
        walking = [i for i in lanes if not w.done[i]]
        neg = [2 * sum(bool(w.d[a, i] < 0) for i in walking) > len(walking)
               for a in range(3)]
        m = 0 if len(w.link) and walking else -1
        stack, queue = [], []
        while m >= 0:
            passed = [i for i in lanes if not w.done[i] and w.passes(m, i)]
            if passed:
                left, right, axis = w.link[m]
                if left >= 0:
                    stack.append(left if neg[axis] else right)
                    m = right if neg[axis] else left
                    continue
                queue += [(i, -1 - left) for i in passed]
                if len(queue) >= FLUSH_PAIRS:
                    w.round(queue[:ROUND])
                    del queue[:ROUND]
            m = stack.pop() if stack else -1
        while queue:
            w.round(queue[:ROUND])
            del queue[:ROUND]
    return w


def _result(w, tb, o, d, occl):
    t, idx = torch.from_numpy(w.t.copy()), torch.from_numpy(w.idx.copy())
    if occl:
        return t, idx
    hit = t < BIG
    return t, idx, tk._winner_attrs(tb.w2o_rows, tb.rad, tb.mat, idx,
                                    torch.from_numpy(w.root.copy()),
                                    [o[a] for a in range(3)],
                                    [d[a] for a in range(3)], hit)


def _same(got, ref, occl):
    hit = ref[0] < BIG
    assert torch.equal(got[0] < BIG, hit)
    if not occl:
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    return int(hit.sum())


@pytest.mark.parametrize("K", [32, 128, 1024, DEAD_K])
def test_tree_invariants(K):
    if K == DEAD_K:
        tor = _torus_grid(K).tori
        minor = _t(tor.minor_radius).clone()
        minor[list(DEAD_ROWS)] = 0.0
        tb = tk.torus_tables(_t(tor.world_to_obj), _t(tor.major_radius),
                             minor)
    else:
        tb = _set(K)[0]
    Kp = tb.w2o_rows.shape[0]
    assert Kp % tb.chunk == 0 and tb.chunk == (16 if K > 64 else 8)
    live = tb.rad[:, 1] > 0.0
    assert int(live.sum()) == K - (len(DEAD_ROWS) if K == DEAD_K else 0)
    assert not live[K:].any()                      # padded rows are dead
    link, nlo, nhi = tb.tree_link, tb.tree_lo, tb.tree_hi
    leaf = link[:, 0] < 0
    ids = (-1 - link[leaf, 0]).long()
    assert torch.equal(ids.sort().values, torch.nonzero(live)[:, 0])
    assert link.shape[0] == 2 * int(live.sum()) - 1
    assert torch.equal(nlo[leaf], tb.tor_lo[ids])
    assert torch.equal(nhi[leaf], tb.tor_hi[ids])
    inner = torch.nonzero(~leaf)[:, 0]
    kids = link[inner, :2].long()
    assert torch.equal(kids[:, 0], inner + 1)
    assert torch.equal(nlo[inner], torch.minimum(nlo[kids[:, 0]],
                                                 nlo[kids[:, 1]]))
    assert torch.equal(nhi[inner], torch.maximum(nhi[kids[:, 0]],
                                                 nhi[kids[:, 1]]))
    depth = [0] * link.shape[0]
    for m in reversed(inner.tolist()):
        depth[m] = 1 + max(depth[int(k)] for k in link[m, :2])
    assert depth[0] == tb.depth <= K_STACK
    assert (tb.par is not None) == (K <= tk.TORUS_SMALL_MAX_K)


@pytest.mark.parametrize("K", sorted(SETS))
@pytest.mark.parametrize("mode", ["closest", "attrs", "occlusion"])
def test_pair_queue_walk_matches_flat_twin(K, mode):
    tb, o, d, tmax = _set(K)
    occl = mode == "occlusion"
    order = visit_order(tb.clo, tb.chi, o, o.shape[1])
    counts: dict = {}
    ref = _twin(tb, o, d, tmax, order, occl, counts)
    if mode == "closest":
        ref = ref[:2]
    w = walk_pair_queue(PairWalker(o, d, tmax, tb, tree_rank(order), occl))
    got = _result(w, tb, o, d, occl)[:len(ref)]
    assert _same(got, ref, occl) > 50
    if K == 1024:
        assert w.box < 0.7 * counts["box"]


def test_chunk_rank_decides_a_duplicated_torus():
    """Torus TIE_SRC of chunk 0 copied to row 15 of chunk 1: with either
    chunk ranked first, its copy of the torus must win every ray that hits
    it, in the twin (rank-order visiting) and in the pair-queue walk (the
    key's rank term)."""
    tor = _torus_grid(TIE_K).tori
    tb = tk.torus_tables(*(_t(np.concatenate([a, a[TIE_SRC:TIE_SRC + 1]]))
                           for a in (tor.world_to_obj, tor.major_radius,
                                     tor.minor_radius)))
    o, d, tmax = (_t(a) for a in _camera_rays(TIE_EYE))
    assert tb.clo.shape[0] == 2 and tb.chunk == 8
    hit_src = None
    for first, winner in ((0, TIE_SRC), (1, TIE_K)):
        order = torch.tensor([first, 1 - first], dtype=torch.int32)
        ref = _twin(tb, o, d, tmax, order, False)
        w = walk_pair_queue(PairWalker(o, d, tmax, tb, tree_rank(order),
                                       False))
        if hit_src is None:
            hit_src = (ref[0] < BIG) & ((ref[1] == TIE_SRC)
                                        | (ref[1] == TIE_K))
            assert int(hit_src.sum()) >= 50
            assert np.array_equal(w.t_of[TIE_SRC], w.t_of[TIE_K])
        assert (ref[1][hit_src] == winner).all()
        _same(_result(w, tb, o, d, True), ref, False)


@pytest.mark.parametrize("K", [4, 32])
def test_orchestrator_keeps_torus_tables_per_scene(K, monkeypatch):
    """The torus route (K3 at K = 4, K2 at K = 32 on these batches) builds
    its tables at a scene's first query on a device and keeps them in
    `Scene.kernel_tables` (material rows, padded tables, boxes, tree, K3's
    blocks): later queries and a copy made by `to` build nothing."""
    jscene = (jax_build_scene(jax_procedural.scene_multi_torus(True))
              if K == 4 else _torus_grid(K))
    scene = scene_from_numpy(jscene)
    o, d, tmax = (_t(a) for a in _camera_rays(SETS[32]))
    assert tk.use_small_kernel(2048, K) == (K == 4)
    first = closest_hit(scene, o, d, tmax, backend="kernel", want_attrs=True)
    assert ("torus", scene.device) in scene.kernel_tables

    def rebuilt(*_, **__):
        raise AssertionError("a scene-constant table rebuilt per query")

    for mod, name in ((port_tk, "torus_tables"), (port_tk, "_material_rows"),
                      (tk, "small_params"), (tk, "_torus_boxes"),
                      (tk, "_tables"), (tk, "tree_tensors"),
                      (kc, "build_tree")):
        monkeypatch.setattr(mod, name, rebuilt)
    again = closest_hit(scene, o, d, tmax, backend="kernel", want_attrs=True)
    moved = scene.to("cpu")
    occ = closest_hit(moved, o, d, tmax, backend="kernel", occlusion=True)
    assert moved.kernel_tables is scene.kernel_tables
    assert torch.equal(first.t, again.t) and torch.equal(first.prim,
                                                         again.prim)
    assert torch.equal(shade_attrs(first, first.attrs).nrm,
                       shade_attrs(again, again.attrs).nrm)
    assert torch.equal(occ.kind >= 0, first.kind >= 0)
    assert int((first.kind == 1).sum()) > 50


def test_wrappers_refuse_missing_tables():
    """K2 and K3 take the prebuilt TorusTables only; attrs need the
    material table, counters a CUDA tensor, and K3 at most 8 tori."""
    tb, o, d, tmax = _set(32, mat=False)
    for fn in (tk.torus_closest_hit_chunked, tk.torus_closest_hit_small):
        with pytest.raises(TypeError, match="TorusTables"):
            fn(o, d, tmax, None)
        with pytest.raises(ValueError, match="material"):
            fn(o, d, tmax, tb, want_attrs=True)
    with pytest.raises(ValueError, match="counters"):
        tk.torus_closest_hit_chunked(o, d, tmax, tb,
                                     counters=torch.zeros(2,
                                                          dtype=torch.int64))
    with pytest.raises(ValueError, match="K3 takes"):
        tk.torus_closest_hit_small(o, d, tmax, tb)
