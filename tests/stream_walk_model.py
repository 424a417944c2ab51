"""Scalar Python references of the CUDA tree walks (`csrc/tree_walk.cuh`):
the per-ray state and leaf walk of K1, K5 and K6 (`Walker`, each ray over
its rows; `WarpWalker`, with the kernels' cooperative branch and its Woop
tests), K5's leaf through its warp's ring of 32-row tiles (`TiledWalker`),
K1's walk (`K1Walker`) and its leaf behind 32-row group boxes
(`GroupedWalker`), and the packet walk over the tree (`walk_packets`).
They import the port alone, no JAX, so the card's tests share them with
the CPU's (tests/test_torch_stream_tree.py, test_torch_tri_tree.py,
test_torch_stream_card.py)."""

import pathlib
import re
import types

import numpy as np
import torch

from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
    BIG, _inv_dir, slab)
from toroidal_ray_tracing_tpu_torch.ops.tri_kernel import woop_block

F32 = np.float32
TMIN = F32(1e-3)
_WALK = (pathlib.Path(__file__).parents[1] / "toroidal_ray_tracing_tpu_torch"
         / "csrc" / "tree_walk.cuh").read_text()


def cuda_constant(name: str) -> int:
    """A `constexpr int` of csrc/tree_walk.cuh: the one value, in the CUDA
    source."""
    return int(re.search(rf"constexpr int {name} = (\d+);", _WALK).group(1))


K_STACK = cuda_constant("kStack")
K_COOP_LANES = cuda_constant("kCoopLanes")
K_TILE_ROWS = cuda_constant("kTileRows")
K_GROUP_ROWS = cuda_constant("kGroupRows")


def _jmin(a, b):
    """torch.minimum / the kernels' jmin on two float32 scalars."""
    return a if (a < b or a != a) else b


def _better(t, rs, k, bt, brank, bidx):
    """(t, rank, row) below the best's key (tree_walk.cuh `better`)."""
    return t < bt or (t == bt and (rs < brank or (rs == brank and k < bidx)))


class Walker:
    """Per-ray state and the kernels' leaf walk, shared by the references
    (K5's and K6's; K1's in tests/test_torch_tri_tree.py). Slab entry/exit
    of every (node, ray) and (cluster, ray) pair is precomputed with the
    twin's `slab`; the pass rule and the key update are the kernels'
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

    def rows(self, i, base, end):
        """Ray i against rows [base, end): (t, u, v), t BIG on a miss."""
        return (x[:, 0].numpy() for x in woop_block(
            self.tb.wrows, base, end,
            [self.o[a, i:i + 1] for a in range(3)],
            [self.d[a, i:i + 1] for a in range(3)],
            torch.from_numpy(self.tmax[i:i + 1])))

    def offer(self, i, tk, uk, vk, rs, k):
        """A hit of ray i at row k (rank rs) into its best; True where it
        took it."""
        if not _better(tk, rs, k, self.t[i], self.rk[i], self.idx[i]):
            return False
        self.t[i], self.idx[i], self.rk[i] = tk, k, rs
        self.u[i], self.v[i] = uk, vk
        return True

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
            self.rows_in_order(i, rs, base, min(base + cl, T))

    def rows_in_order(self, i, rs, base, end):
        """Ray i over rows [base, end) in order, any-hit stopping at its
        first hit."""
        t, u, v = self.rows(i, base, end)
        for j in range(end - base):
            self.prim += 1
            if t[j] < F32(BIG) and self.offer(i, t[j], u[j], v[j], rs,
                                              base + j) and self.occl:
                self.done[i] = True
                break

    def leaf_packet(self, lanes, s):
        """Leaf s for the packet's lanes that passed its box."""
        for i in lanes:
            self.leaf(i, s)

    def result(self):
        return tuple(torch.from_numpy(a.copy())
                     for a in (self.t, self.idx, self.u, self.v))


class WarpWalker(Walker):
    """The row-by-row leaf (tree_walk.cuh walk_superblock) for a warp of
    32 rays, as K1's warps and K6's (inside their CTA's packet) walk it:
    a cluster more than K_COOP_LANES of the warp's rays enter is walked
    by each ray over its rows in order (`Walker.leaf`'s tests); a cluster
    fewer enter is tested for each ray by lane l on rows l, l + 32, ...,
    a lane stopping at its first hit (any-hit), and the minimum (t, row)
    over the lanes (the lowest hit row for any-hit) is offered to the
    ray's best. The results are `Walker`'s; the Woop tests of any-hit are
    the kernel's, which test past a ray's first hit on the other lanes."""

    def leaf_packet(self, lanes, s):
        tb, cl = self.tb, self.tb.cluster
        T = tb.wrows.shape[0]
        rs = self.rank[s]
        for c in range(s * tb.g, (s + 1) * tb.g):
            base = c * cl
            if base >= T:
                break
            enter = [i for i in lanes
                     if not self.done[i] and (not self.leaf_box or
                                              self.passes(self.clus, c, i))]
            end = min(base + cl, T)
            if len(enter) > K_COOP_LANES:
                for i in enter:
                    self.rows_in_order(i, rs, base, end)
                continue
            for i in enter:
                t, u, v = self.rows(i, base, end)
                got = []
                for lane in range(32):
                    for j in range(lane, end - base, 32):
                        self.prim += 1
                        if t[j] < F32(BIG):
                            got.append((j, t[j]))
                            if self.occl:
                                break
                if got:
                    j = min(got)[0] if self.occl else min(
                        got, key=lambda h: (h[1], h[0]))[0]
                    if self.offer(i, t[j], u[j], v[j], rs, base + j):
                        self.done[i] = self.occl


class TiledWalker(Walker):
    """K5's leaf (tree_walk.cuh walk_superblock_tiled) for a warp of 32
    rays: an entered cluster's rows in tiles of K_TILE_ROWS rows, two
    copied at once and one more after each tile tested, none past the
    table's end; more than K_COOP_LANES entering lanes each test their ray
    over a tile's rows in order, else each cooperating ray is tested on
    row l of the tile by lane l, a lane stopping at its first hit of the
    ray (any-hit), and the tile's minimum (t, row) (lowest hit row for
    any-hit) is offered to the ray's best. Once no lane has a row left to
    test (any-hit), the warp copies no more and leaves the cluster.
    `entered` lists each (warp, cluster) entry as (cluster, cooperative,
    tiles copied); `tiles`, their sum, models K5's third counter."""

    def __init__(self, *args):
        super().__init__(*args)
        self.entered = []

    @property
    def tiles(self):
        return sum(e[2] for e in self.entered)

    def leaf_packet(self, lanes, s):
        tb, cl = self.tb, self.tb.cluster
        T = tb.wrows.shape[0]
        rs = self.rank[s]
        for c in range(s * tb.g, (s + 1) * tb.g):
            base = c * cl
            if base >= T:
                break
            enter = [i for i in lanes
                     if not self.done[i] and (not self.leaf_box or
                                              self.passes(self.clus, c, i))]
            if not enter:
                continue
            end = min(base + cl, T)
            n_tiles = -(-(end - base) // K_TILE_ROWS)
            hits = {i: tuple(self.rows(i, base, end)) for i in enter}
            coop = len(enter) <= K_COOP_LANES
            stopped = set()          # (ray, lane): the lane hit the ray
            copied = min(n_tiles, 2)
            for q in range(n_tiles):
                k0 = q * K_TILE_ROWS
                nr = min(K_TILE_ROWS, end - base - k0)
                if not coop:
                    for i in enter:
                        t, u, v = hits[i]
                        for j in range(k0, k0 + nr):
                            if self.done[i]:
                                break
                            self.prim += 1
                            if t[j] < F32(BIG) and self.offer(
                                    i, t[j], u[j], v[j], rs, base + j) \
                                    and self.occl:
                                self.done[i] = True
                    more = any(not self.done[i] for i in enter)
                else:
                    for i in enter:
                        t, u, v = hits[i]
                        got = []
                        for lane in range(nr):
                            if (i, lane) in stopped:
                                continue
                            self.prim += 1
                            j = k0 + lane
                            if t[j] < F32(BIG):
                                got.append((j, t[j]))
                                if self.occl:
                                    stopped.add((i, lane))
                        if not got:
                            continue
                        j = min(got)[0] if self.occl else min(
                            got, key=lambda h: (h[1], h[0]))[0]
                        if not self.done[i] and self.offer(
                                i, t[j], u[j], v[j], rs, base + j):
                            self.done[i] = self.occl
                    more = any((i, lane) not in stopped for i in enter
                               for lane in range(32))
                if q + 1 == n_tiles or not more:
                    break
                copied += q + 2 < n_tiles
            self.entered.append((c, coop, copied))


class K1Walker(Walker):
    """K1's walk over its `TriTables`: g = 1, the leaf's box is its
    cluster's, and a single uncullable block takes no box test; each ray
    over every row of the clusters it enters (`Walker.leaf`)."""

    leaf_box = False

    def __init__(self, origins, dirs, tmax, tb, rank, occlusion):
        view = types.SimpleNamespace(
            tree_lo=tb.tree_lo, tree_hi=tb.tree_hi, tree_link=tb.tree_link,
            clo=tb.clo, chi=tb.chi, g=1, cluster=tb.cluster, wrows=tb.wrows)
        super().__init__(origins, dirs, tmax, view, rank, occlusion)
        self.box_test = tb.box_test

    def passes(self, which, m, i):
        return super().passes(which, m, i) if self.box_test else True


class GroupedWalker(K1Walker):
    """K1's leaf (tree_walk.cuh walk_cluster_grouped) for a warp of 32
    rays: the cluster's rows in groups of K_GROUP_ROWS, each behind its
    group box where the tables have them (none for the single uncullable
    block). More than K_COOP_LANES entering lanes: the warp steps through
    each group some lane passes at its running bound (tested as the walk
    reaches the group, so an earlier group's hit culls it), each such lane
    testing its ray over the group's rows in order. Else each cooperating
    ray's groups (tested at its bound on entering the leaf) are tested on
    row l by lane l, a lane stopping at its first hit (any-hit), and one
    minimum (t, row) a ray and leaf (lowest hit row for any-hit) is
    offered to its best. `groups` models the kernel's third counter: the
    (warp, group) steps of the first branch and the (ray, group) pairs of
    the second."""

    def __init__(self, origins, dirs, tmax, tb, rank, occlusion):
        super().__init__(origins, dirs, tmax, tb, rank, occlusion)
        self.grp = None
        if tb.glo is not None:
            inv = [_inv_dir(dirs[a]) for a in range(3)]
            tn, tf = slab(tb.glo[:, None, :], tb.ghi[:, None, :],
                          [origins[a] for a in range(3)], inv)
            self.grp = tn.numpy(), tf.numpy()
        self.groups = 0

    def leaf_packet(self, lanes, s):
        cl = self.tb.cluster
        base = s * cl
        end = min(base + cl, self.tb.wrows.shape[0])
        rs = self.rank[s]
        enter = [i for i in lanes if not self.done[i]]
        if not enter:
            return
        n_groups = -(-(end - base) // K_GROUP_ROWS)
        g0 = s * (cl // K_GROUP_ROWS)

        def enters(q, i):
            return self.grp is None or self.passes(self.grp, g0 + q, i)

        if len(enter) > K_COOP_LANES:
            for q in range(n_groups):
                ins = [i for i in enter if not self.done[i] and enters(q, i)]
                if not ins:
                    continue
                self.groups += 1
                k0 = base + q * K_GROUP_ROWS
                for i in ins:
                    self.rows_in_order(i, rs, k0, min(k0 + K_GROUP_ROWS,
                                                      end))
            return
        mine = {i: [q for q in range(n_groups) if enters(q, i)]
                for i in enter}
        for i in enter:
            t, u, v = self.rows(i, base, end)
            self.groups += len(mine[i])
            got = []
            for lane in range(32):
                for q in mine[i]:
                    j = q * K_GROUP_ROWS + lane
                    if j >= end - base:
                        break
                    self.prim += 1
                    if t[j] < F32(BIG):
                        got.append((j, t[j]))
                        if self.occl:
                            break
            if got:
                j = min(got)[0] if self.occl else min(
                    got, key=lambda h: (h[1], h[0]))[0]
                if self.offer(i, t[j], u[j], v[j], rs, base + j):
                    self.done[i] = self.occl


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
                w.leaf_packet([i for i in lanes if passed[i]], -1 - left)
            m = stack.pop() if stack else -1
    return w.result()
