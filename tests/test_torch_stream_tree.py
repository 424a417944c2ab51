"""The superblock tree of K5/K6 (`ops.kernel_common.build_tree`, built by
`stream_tables`) and scalar Python references of the CUDA kernels' two
walks over it. Both walk packets of rays: one stack per packet, a node
entered when any walking ray passes it at its own bound, near child first
by the packet's majority direction sign on the node's split axis, a leaf
walked by the rays that pass it. K5's packet is a warp of 32 rays, K6's a
CTA of 128. (How the kernels spread a leaf's rows over a warp's lanes
changes no ray's result, so the references test the rows per ray.)

Both references must return bit-identical t/idx/u/v to the flat twin
`tri_closest_hit_stream_plain` (closest and attrs) and equal any-hit
masks, with fewer box tests, on the 23k-triangle mesh at g = 4
(`STREAM_GATE_BOXES` = 32 in both packages: S = 46, the last superblock
padded) and at g = 1 (S = 181); and on a constructed tie, where only the
superblock rank can pick the winner. The twin still meets the JAX
streamed kernel (interpret mode) at test_torch_stream_kernel.py's
tolerances on the padded set-up."""

import pathlib
import re

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
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
    BIG, _inv_dir, slab, tree_rank, visit_order)
from toroidal_ray_tracing_tpu_torch.ops.tri_kernel import (
    winner_attrs, woop_block)
from toroidal_ray_tracing_tpu_torch.scene import scene_from_numpy
from toroidal_ray_tracing_tpu_torch.trace.intersect import closest_hit

torch.set_num_threads(2)

F32 = np.float32
TMIN = F32(1e-3)
# the kernels' stack entries: the one constant, in the CUDA source
K_STACK = int(re.search(r"constexpr int kStack = (\d+);", (
    pathlib.Path(port_ts.__file__).parents[1] / "csrc" / "tree_walk.cuh"
).read_text()).group(1))


@pytest.fixture(scope="module")
def mesh():
    scene = build_scene(procedural.scene_multi_torus(False))   # 23k tris
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    tri = scene.triangles
    return scene, (t(tri.woop_o), t(tri.woop_d), t(scene.cluster_lo),
                   t(scene.cluster_hi))


@pytest.fixture(params=[4, 1], ids=["g4", "g1"])
def g(request, monkeypatch):
    """Clusters per superblock: 4 with the gate target patched to 32 in
    both packages (S = 46, the last superblock padded), 1 as shipped."""
    if request.param == 4:
        for mod in (jax_ts, port_ts):
            monkeypatch.setattr(mod, "STREAM_GATE_BOXES", 32)
    return request.param


def _rays(width, height):
    cam = JaxPinhole(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0))
    o, d = cam.generate_rays(width, height, JaxSettings.default(), xp=np)
    o, d = np.ascontiguousarray(o.T), np.ascontiguousarray(d.T)
    tmax = np.full((o.shape[1],), 1e4, np.float32)
    tmax[::9] = 0.0                                   # dead rays stay misses
    tmax[1::9] = 3.0                                  # short segments
    return torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax)


def _jmin(a, b):
    """torch.minimum / the kernels' jmin on two float32 scalars."""
    return a if (a < b or a != a) else b


class Walker:
    """Per-ray state and the kernels' leaf walk, shared by both references
    (and K1's, tests/test_torch_tri_tree.py). Slab entry/exit of every
    (node, ray) and (cluster, ray) pair is precomputed with the twin's
    `slab`; the pass rule and the key update are the kernels'
    (csrc/common.cuh slab_pass, csrc/tree_walk.cuh). `leaf_box`: each
    cluster of a leaf is tested by its own box (K5/K6; K1's leaf box is its
    one cluster's)."""

    leaf_box = True

    def __init__(self, origins, dirs, tmax, tb, rank, occlusion):
        self.o, self.d, self.tmax = origins, dirs, tmax.numpy()
        inv = [_inv_dir(dirs[a]) for a in range(3)]
        o = [origins[a] for a in range(3)]

        def tn_tf(lo, hi):
            tn, tf = slab(lo[:, None, :], hi[:, None, :], o, inv)
            return tn.numpy(), tf.numpy()

        self.node = tn_tf(tb.tree_lo, tb.tree_hi)
        self.clus = tn_tf(tb.clo, tb.chi)
        self.link = tb.tree_link.numpy()
        self.tb, self.rank, self.occl = tb, rank.numpy(), occlusion
        n = origins.shape[1]
        self.t = np.full(n, F32(BIG))
        self.idx = np.zeros(n, np.int32)
        self.u = np.zeros(n, F32)
        self.v = np.zeros(n, F32)
        self.rk = np.full(n, -1)
        self.done = ~(self.tmax > TMIN)
        self.box = self.prim = 0

    def bound(self, i):
        if self.occl:
            return F32(-1.0) if self.t[i] < F32(BIG) else self.tmax[i]
        return _jmin(self.t[i], self.tmax[i])

    def passes(self, which, m, i):
        self.box += 1
        tn, tf = which[0][m, i], which[1][m, i]
        return bool(tn <= _jmin(tf, self.bound(i)) and tf >= TMIN
                    and self.tmax[i] > TMIN)

    def leaf(self, i, s):
        tb, cl = self.tb, self.tb.cluster
        T = tb.wrows.shape[0]
        rs = self.rank[s]
        for c in range(s * tb.g, (s + 1) * tb.g):
            base = c * cl
            if base >= T or self.done[i]:
                break
            if self.leaf_box and not self.passes(self.clus, c, i):
                continue
            end = min(base + cl, T)
            t, u, v = (x[:, 0].numpy() for x in woop_block(
                tb.wrows, base, end, [self.o[a, i:i + 1] for a in range(3)],
                [self.d[a, i:i + 1] for a in range(3)],
                torch.from_numpy(self.tmax[i:i + 1])))
            for j in range(end - base):
                self.prim += 1
                k, tk = base + j, t[j]
                if tk < F32(BIG) and (
                        tk < self.t[i] or (tk == self.t[i] and (
                            rs < self.rk[i] or (rs == self.rk[i]
                                                and k < self.idx[i])))):
                    self.t[i], self.idx[i], self.rk[i] = tk, k, rs
                    self.u[i], self.v[i] = u[j], v[j]
                    if self.occl:
                        self.done[i] = True
                        break

    def result(self):
        return tuple(torch.from_numpy(a.copy())
                     for a in (self.t, self.idx, self.u, self.v))


def walk_packets(w, group):
    """Each packet of `group` consecutive rays walks the tree together: K5
    with the 32 rays of a warp, K6 with the 128 rays of a CTA."""
    n = len(w.t)
    for c0 in range(0, n, group):
        lanes = range(c0, min(c0 + group, n))
        walking = [i for i in lanes if not w.done[i]]
        neg = [2 * sum(bool(w.d[a, i] < 0) for i in walking) > len(walking)
               for a in range(3)]
        m = 0 if len(w.link) and walking else -1
        stack = []
        while m >= 0:
            passed = {i: not w.done[i] and w.passes(w.node, m, i)
                      for i in lanes}
            if any(passed.values()):
                left, right, axis = w.link[m]
                if left >= 0:
                    flip = neg[axis]
                    stack.append(left if flip else right)
                    m = right if flip else left
                    continue
                for i in lanes:
                    if passed[i]:
                        w.leaf(i, -1 - left)
            m = stack.pop() if stack else -1
    return w.result()


def _setup(woop_o, woop_d, clo, chi, o, d, tmax):
    tb = port_ts.stream_tables(woop_o, woop_d, clo, chi, 128)
    order = visit_order(tb.sb_lo, tb.sb_hi, o, o.shape[1])
    return tb, order, tree_rank(order)


def _flat(tb, order, o, d, tmax, occl, tables=None, counts=None):
    return port_ts.tri_closest_hit_stream_plain(
        o, d, tmax, tb.wrows, tb.sb_lo, tb.sb_hi, order, tb.clo, tb.chi,
        tb.g, 128, tables, occl, counts=counts)


def _same(got, ref, occl):
    hit = ref[0] < BIG
    assert torch.equal(got[0] < BIG, hit)
    if not occl:
        for a, b in zip(got, ref[:4]):
            assert torch.equal(a, b)
    return int(hit.sum())


def test_tree_invariants(mesh, g):
    _, (woop_o, woop_d, clo, chi) = mesh
    far = clo.clone()
    far[:4] = 1e30                        # an all-empty superblock at g = 4
    for lo in (clo, far):
        tb = port_ts.stream_tables(woop_o, woop_d, lo, chi, 128)
        S = tb.sb_lo.shape[0]
        assert (tb.g, S) == ((4, 46) if g == 4 else (1, 181))
        live = ~(tb.clo[:, 0] > 1e29).reshape(S, tb.g).all(dim=1)
        link, nlo, nhi = tb.tree_link, tb.tree_lo, tb.tree_hi
        leaf = link[:, 0] < 0
        sb = (-1 - link[leaf, 0]).sort().values
        assert torch.equal(sb, torch.nonzero(live)[:, 0].to(torch.int32))
        assert link.shape[0] == 2 * int(live.sum()) - 1
        assert torch.equal(nlo[leaf], tb.sb_lo[(-1 - link[leaf, 0]).long()])
        assert torch.equal(nhi[leaf], tb.sb_hi[(-1 - link[leaf, 0]).long()])
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
    assert int(live.sum()) == S - (1 if g == 4 else 4)


@pytest.mark.parametrize("mode", ["closest", "attrs", "occlusion"])
def test_tree_walks_match_flat_twin(mesh, g, mode):
    scene, (woop_o, woop_d, clo, chi) = mesh
    o, d, tmax = _rays(32, 32)
    occl = mode == "occlusion"
    tb, order, rank = _setup(woop_o, woop_d, clo, chi, o, d, tmax)
    tables = None
    if mode == "attrs":
        geom = jax_isect.geom_from_scene(scene)
        tables = tuple(torch.from_numpy(np.array(a))
                       for a in jax_tk._tri_attr_tables(scene, geom))
    counts: dict = {}
    ref = _flat(tb, order, o, d, tmax, occl, tables, counts)
    for group in (32, 128):
        w = Walker(o, d, tmax, tb, rank, occl)
        got = walk_packets(w, group)
        assert _same(got, ref, occl) > o.shape[1] // 4
        if tables is not None:
            assert torch.equal(winner_attrs(tables, *got), ref[4])
        if group == 32:
            assert w.box < counts["box"] and w.prim <= counts["prim"]


def test_rank_decides_a_duplicated_triangle(mesh):
    """Cluster c's rows copied to a new last cluster whose box reaches
    toward the camera: the copy ranks first, so its (higher) rows must win
    every exact tie — in the twin (rank-order visiting) and in both tree
    walks (the key's rank term)."""
    _, (woop_o, woop_d, clo, chi) = mesh
    o, d, tmax = _rays(32, 32)
    tb0, order0, _ = _setup(woop_o, woop_d, clo, chi, o, d, tmax)
    t0, i0 = _flat(tb0, order0, o, d, tmax, False)[:2]
    c = int(torch.mode(i0[(t0 < BIG) & (i0 < 128 * 170)] // 128).values)
    T = woop_o.shape[2]
    woop_o2 = torch.cat([woop_o, woop_o[..., 128 * c:128 * (c + 1)]], dim=2)
    woop_d2 = torch.cat([woop_d, woop_d[..., 128 * c:128 * (c + 1)]], dim=2)
    eye = o.mean(dim=1)
    clo2 = torch.cat([clo, torch.minimum(clo[c], eye)[None]])
    chi2 = torch.cat([chi, torch.maximum(chi[c], eye)[None]])
    tb, order, rank = _setup(woop_o2, woop_d2, clo2, chi2, o, d, tmax)
    assert tb.g == 1 and rank[-1] < rank[c]
    ref = _flat(tb, order, o, d, tmax, False)
    was_c = (t0 < BIG) & (i0 // 128 == c)
    assert int(was_c.sum()) >= 3
    assert torch.equal((ref[0] < BIG) & (ref[1] >= T), was_c)
    assert torch.equal(ref[1][was_c], i0[was_c] - 128 * c + T)
    for group in (32, 128):
        _same(walk_packets(Walker(o, d, tmax, tb, rank, False), group), ref,
              False)


def test_twin_matches_pallas_at_g4_and_wrapper_checks(mesh, monkeypatch):
    """The twin meets the JAX streamed kernel on the padded set-up through
    the wrapper; the tables refuse clusters that are not whole multiples
    of 128 rows, and the wrapper refuses attribute tables of another
    triangle count and counters on CPU tensors."""
    scene, (woop_o, woop_d, clo, chi) = mesh
    for mod in (jax_ts, port_ts):
        monkeypatch.setattr(mod, "STREAM_GATE_BOXES", 32)
    o, d, tmax = _rays(24, 16)
    geom = jax_isect.geom_from_scene(scene)
    ref = [np.asarray(x) for x in jax_ts.tri_closest_hit_stream(
        jnp.asarray(o.numpy()), jnp.asarray(d.numpy()),
        jnp.asarray(tmax.numpy()), geom.woop_o, geom.woop_d,
        geom.cluster_lo, geom.cluster_hi, scene.cluster_size)]
    tb = port_ts.stream_tables(woop_o, woop_d, clo, chi, 128)
    got = [x.numpy() for x in port_ts.tri_closest_hit_stream(o, d, tmax, tb)]
    hit = ref[0] < 1e30
    np.testing.assert_array_equal(got[0] < 1e30, hit)
    np.testing.assert_allclose(got[0][hit], ref[0][hit], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got[1][hit], ref[1][hit])

    with pytest.raises(ValueError, match="128-multiple"):
        port_ts.stream_tables(woop_o[..., :-64], woop_d[..., :-64], clo, chi,
                              128)
    T = woop_o.shape[2]
    short = tuple(torch.zeros((k, T - 128)) for k in (21, 8, 8))
    with pytest.raises(ValueError, match="a0: shape"):
        port_ts.tri_closest_hit_stream(o, d, tmax, tb, attr_tables=short)
    with pytest.raises(ValueError, match="counters"):
        port_ts.tri_closest_hit_stream(
            o, d, tmax, tb, counters=torch.zeros(2, dtype=torch.int64))


def test_orchestrator_builds_stream_tables_once_per_scene(mesh,
                                                          monkeypatch):
    """The stream route keeps the scene-constant tables on the scene, per
    device: two queries build them once, a copy made by `to` shares them
    (as `render` makes one at every call), a new scene starts without
    them, and the hits do not change."""
    scene, _ = mesh
    monkeypatch.setattr(port_tk, "TRI_STREAM_MIN", 1024)
    built = []
    real = port_tk.stream_tables
    monkeypatch.setattr(port_tk, "stream_tables",
                        lambda *a: built.append(1) or real(*a))
    port = scene_from_numpy(scene)
    o, d, tmax = _rays(24, 16)
    first = closest_hit(port, o, d, tmax, backend="kernel", want_attrs=True)
    again = closest_hit(port, o, d, tmax, backend="kernel", want_attrs=True)
    assert len(built) == 1 and ("stream", port.device) in port.kernel_tables
    assert torch.equal(first.t, again.t) and torch.equal(first.prim,
                                                         again.prim)
    moved = port.to("cpu")
    copied = closest_hit(moved, o, d, tmax, backend="kernel",
                         want_attrs=True)
    assert len(built) == 1 and moved.kernel_tables is port.kernel_tables
    assert torch.equal(copied.t, first.t)
    fresh = scene_from_numpy(scene)
    assert fresh.kernel_tables == {}
    closest_hit(fresh, o, d, tmax, backend="kernel", occlusion=True)
    assert len(built) == 2
