"""K1's cluster tree (`ops.tri_kernel.tri_tables`, over
`kernel_common.build_tree`) and scalar Python references of the CUDA
kernel's walk over it (`csrc/tri_hit.cu`, the warp-packet walk of
`csrc/tree_walk.cuh`): packets of 32 rays, one stack per packet, a node
entered when any walking ray passes it at its own bound, the near child
first by the packet's majority direction sign, and at a leaf (one cluster,
whose box the leaf's is) the rays that passed test its rows, keeping the
minimum of (t, rank, row). A single uncullable block is walked with no box
test. `K1Walker` (`stream_walk_model`, each ray over every row of its
entered clusters) is `Walker` with g = 1; `GroupedWalker` is the kernel's
leaf, each 32-row group behind its group box (`tri_kernel.group_boxes`),
with the kernel's cooperative branch and its group counter.

Both must return bit-identical t/idx/u/v (closest and attrs) to the flat
twin `tri_closest_hit_plain`, and equal any-hit masks, with fewer box
tests, on the 23,168-triangle mesh of config 6 (its raw cluster boxes, and
with the loose tail hoisted to far boxes as the orchestrator walks them)
and on a one-cluster mesh; the grouped leaf with at most 0.75x the Woop
tests of K1's previous leaf (`K1WarpWalker`) on config 6, and where a
triangle is duplicated across a group edge, so that only the row decides. The orchestrator keeps the tables per
scene and device (rebuilding the group boxes when a vertex changes in
place), and the wrapper builds no scene-constant table per call."""

import types

import pytest
import torch

from stream_walk_model import (K_GROUP_ROWS, GroupedWalker, K1Walker,
                               WarpWalker)
from test_torch_stream_tree import (K_STACK, _rays, _rays_onto, _same,
                                    walk_packets)
from toroidal_ray_tracing_tpu_torch.ops import kernel_common as kc
from toroidal_ray_tracing_tpu_torch.ops import trace_kernel as port_tk
from toroidal_ray_tracing_tpu_torch.ops import tri_kernel as trk
from toroidal_ray_tracing_tpu_torch.ops.shade_kernel import shade_attrs
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (tree_rank,
                                                              visit_order)
from toroidal_ray_tracing_tpu_torch.scene import (SceneDef, build_scene,
                                                  procedural)
from toroidal_ray_tracing_tpu_torch.trace.intersect import (closest_hit,
                                                            geom_from_scene)
from toroidal_ray_tracing_tpu_torch.utils import math3d

torch.set_num_threads(2)


def _one_cluster_mesh():
    """A 64-triangle torus mesh: one cluster of 64 rows."""
    sd = SceneDef()
    sd.add_model(procedural.torus_mesh(3.0, 1.2, seg_major=8, seg_minor=4),
                 math3d.translation((0.0, 0.5, 0.0)))
    return build_scene(sd)


@pytest.fixture(scope="module")
def scenes():
    return {"mesh": build_scene(procedural.scene_multi_torus(False)),
            "one_cluster": _one_cluster_mesh()}


def _verts(scene):
    t = scene.triangles
    return t.v0, t.e1, t.e2, t.valid


def _tables(scenes, setup):
    """K1's tables of each set-up: config 6's mesh with its raw cluster
    boxes, the same with the loose tail hoisted (far boxes), one cluster."""
    scene = scenes["one_cluster" if setup == "one_cluster" else "mesh"]
    geom = geom_from_scene(scene)
    cs = scene.cluster_size
    n_tail = -(-scene.loose_tris // cs) if setup == "hoisted" else 0
    clo, chi = port_tk._walked_boxes(geom, True, n_tail)
    return scene, trk.tri_tables(geom.woop_o, geom.woop_d, clo, chi, cs,
                                 _verts(scene))


class K1WarpWalker(K1Walker, WarpWalker):
    """K1's leaf before its group boxes (tree_walk.cuh walk_superblock with
    g = 1): every row of an entered cluster, with the cooperative branch's
    Woop tests."""


def _order(tb, o):
    if not tb.box_test:
        return torch.zeros((1,), dtype=torch.int32)
    return visit_order(tb.clo, tb.chi, o, o.shape[1])


SETUPS = ["mesh", "hoisted", "one_cluster"]


@pytest.mark.parametrize("setup", SETUPS)
def test_tree_invariants(scenes, setup):
    scene, tb = _tables(scenes, setup)
    C = tb.clo.shape[0]
    link, nlo, nhi = tb.tree_link, tb.tree_lo, tb.tree_hi
    leaf = link[:, 0] < 0
    ids = (-1 - link[leaf, 0]).long()
    if setup == "one_cluster":
        assert C == 1 and not tb.box_test and tb.cluster == 64
        assert link.tolist() == [[-1, -1, -1]] and tb.depth == 0
        return
    live = ~(tb.clo[:, 0] > 1e29)
    assert tb.box_test and int(live.sum()) == C - (
        -(-scene.loose_tris // tb.cluster) if setup == "hoisted" else 0)
    assert torch.equal(ids.sort().values, torch.nonzero(live)[:, 0])
    assert link.shape[0] == 2 * int(live.sum()) - 1
    assert torch.equal(nlo[leaf], tb.clo[ids])
    assert torch.equal(nhi[leaf], tb.chi[ids])
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


@pytest.mark.parametrize("setup", SETUPS)
@pytest.mark.parametrize("mode", ["closest", "attrs", "occlusion"])
def test_tree_walk_matches_flat_twin(scenes, setup, mode):
    scene, tb = _tables(scenes, setup)
    o, d, tmax = _rays(32, 32)
    occl = mode == "occlusion"
    tables = port_tk._tri_attr_tables(scene) if mode == "attrs" else None
    order = _order(tb, o)
    counts: dict = {}
    ref = trk.tri_closest_hit_plain(o, d, tmax, tb.wrows, tb.clo, tb.chi,
                                    order, tb.cluster, tb.box_test, tables,
                                    occl, counts=counts)
    w = K1Walker(o, d, tmax, tb, tree_rank(order), occl)
    got = walk_packets(w, 32)
    assert _same(got, ref, occl) >= 50
    if tables is not None:
        assert torch.equal(trk.winner_attrs(tables, *got), ref[4])
    if tb.box_test:
        assert w.box < counts["box"] / 3


@pytest.mark.parametrize("setup", SETUPS)
def test_group_box_invariants(scenes, setup):
    """Each group box is the min/max of its live rows' vertices, inside its
    cluster's box; far point boxes exactly for the groups with no live row
    and the hoisted tail's groups; a single block keeps none."""
    scene, tb = _tables(scenes, setup)
    if setup == "one_cluster":
        assert tb.glo is None and tb.ghi is None
        return
    C, G = tb.clo.shape[0], tb.cluster // K_GROUP_ROWS
    assert G == 4 and tb.glo.shape == tb.ghi.shape == (C * G, 3)
    v0, e1, e2, valid = _verts(scene)
    pts = torch.stack([v0, v0 + e1, v0 + e2])             # (3, T, 3)
    live = valid.reshape(C * G, K_GROUP_ROWS)
    tail = (tb.clo[:, 0] > 1e29).repeat_interleave(G)
    far = ~live.any(dim=1) | tail
    assert int((~live.any(dim=1)).sum()) > 0
    assert bool(tail.any()) == (setup == "hoisted")
    assert bool((tb.glo[far] == trk.FAR_BOX).all()
                and (tb.ghi[far] == trk.FAR_BOX).all())
    lo = torch.where(valid[:, None], pts.amin(0), float("inf"))
    hi = torch.where(valid[:, None], pts.amax(0), -float("inf"))
    keep = ~far
    assert torch.equal(tb.glo[keep], lo.reshape(C * G, K_GROUP_ROWS, 3)
                       .amin(1)[keep])
    assert torch.equal(tb.ghi[keep], hi.reshape(C * G, K_GROUP_ROWS, 3)
                       .amax(1)[keep])
    cl = torch.arange(C * G) // G
    assert bool((tb.glo[keep] >= tb.clo[cl[keep]]).all()
                and (tb.ghi[keep] <= tb.chi[cl[keep]]).all())
    # every live row's vertices lie in its group's box (the tail's aside)
    g_of = torch.arange(v0.shape[0]) // K_GROUP_ROWS
    for p in pts:
        assert bool(((p >= tb.glo[g_of]) & (p <= tb.ghi[g_of]))
                    .all(dim=1)[valid & ~tail[g_of]].all())


@pytest.mark.parametrize("setup", SETUPS)
@pytest.mark.parametrize("mode", ["closest", "attrs", "occlusion"])
def test_grouped_walk_matches_flat_twin(scenes, setup, mode):
    """The kernel's grouped leaf returns the twin's bits; on config 6 it
    tests at most 0.75x the Woop tests of the leaf that tests every row of
    an entered cluster (K1's leaf before its group boxes), with more box
    tests."""
    scene, tb = _tables(scenes, setup)
    o, d, tmax = _rays(32, 32)
    occl = mode == "occlusion"
    tables = port_tk._tri_attr_tables(scene) if mode == "attrs" else None
    order = _order(tb, o)
    ref = trk.tri_closest_hit_plain(o, d, tmax, tb.wrows, tb.clo, tb.chi,
                                    order, tb.cluster, tb.box_test, tables,
                                    occl)
    w = GroupedWalker(o, d, tmax, tb, tree_rank(order), occl)
    got = walk_packets(w, 32)
    assert _same(got, ref, occl) >= 50
    if tables is not None:
        assert torch.equal(trk.winner_attrs(tables, *got), ref[4])
    flat = K1WarpWalker(o, d, tmax, tb, tree_rank(order), occl)
    assert _same(walk_packets(flat, 32), ref, occl) >= 50
    assert w.groups > 0
    if tb.box_test:
        assert w.prim <= 0.75 * flat.prim
        assert w.box > flat.box


@pytest.mark.parametrize("lanes", ["many", "coop"])
def test_grouped_walk_duplicate_across_a_group_edge(scenes, lanes):
    """A triangle at the last row of one group and again at the first row
    of the next: the hits tie in t, so only the row decides, and the lower
    row wins in both branches of the leaf, as in the twin."""
    scene = scenes["mesh"]
    geom = geom_from_scene(scene)
    v0, e1, e2, valid = (x.clone() for x in _verts(scene))
    woop_o, woop_d = geom.woop_o.clone(), geom.woop_d.clone()
    cs, R = scene.cluster_size, K_GROUP_ROWS
    # a cluster whose rows R - 8 .. R + 7 are live
    c = next(c for c in range(geom.cluster_lo.shape[0])
             if bool(valid[c * cs + R - 8:c * cs + R + 8].all()))
    a, b = c * cs + R - 1, c * cs + R
    for x in (v0, e1, e2, valid):
        x[b] = x[a]
    woop_o[..., b], woop_d[..., b] = woop_o[..., a], woop_d[..., a]
    tb = trk.tri_tables(woop_o, woop_d, geom.cluster_lo, geom.cluster_hi, cs,
                        (v0, e1, e2, valid))
    assert torch.equal(tb.glo[b // R], torch.minimum(tb.glo[b // R],
                                                     tb.glo[a // R]))
    rows = [a, b, a - 1, b + 1] + list(range(a - 7, a - 1)) + \
        list(range(b + 2, b + 8))
    o, d, tmax = _rays_onto(types.SimpleNamespace(triangles=types.
                            SimpleNamespace(v0=v0, e1=e1, e2=e2)), rows, lanes)
    target = torch.tensor(rows * 2 if lanes == "many"
                          else rows[:4] + [rows[0]] * 28)
    order = _order(tb, o)
    ref = trk.tri_closest_hit_plain(o, d, tmax, tb.wrows, tb.clo, tb.chi,
                                    order, cs, True)
    w = GroupedWalker(o, d, tmax, tb, tree_rank(order), False)
    got = walk_packets(w, 32)
    _same(got, ref, False)
    on_dup = (tmax > 0) & ((target == a) | (target == b))
    assert int(on_dup.sum()) == (4 if lanes == "many" else 2)
    assert bool((got[1][on_dup] == a).all())
    # the tie is real: row b alone gives the same t
    t_b, _, _ = trk.woop_block(tb.wrows, b, b + 1, list(o), list(d), tmax)
    assert torch.equal(t_b[0][on_dup], got[0][on_dup])


def test_kept_tables_rebuild_group_boxes_after_an_inplace_change():
    """A vertex moved in place rebuilds K1's kept tables, with the group
    boxes of the new vertices."""
    scene = build_scene(procedural.scene_multi_torus(False))
    o, d, tmax = _rays(16, 8)
    closest_hit(scene, o, d, tmax, backend="kernel")
    key = ("tri", scene.device)
    first = scene.kernel_tables[key][2]
    tris = scene.triangles
    k = int(torch.nonzero(tris.valid)[0, 0])
    with torch.no_grad():
        tris.v0[k] += 0.25
    closest_hit(scene, o, d, tmax, backend="kernel")
    again = scene.kernel_tables[key][2]
    assert again is not first
    g = k // K_GROUP_ROWS
    want = trk.group_boxes(tris.v0, tris.e1, tris.e2, tris.valid, again.clo,
                           again.cluster)
    assert torch.equal(again.glo, want[0]) and torch.equal(again.ghi, want[1])
    assert not torch.equal(again.glo[g], first.glo[g]) or \
        not torch.equal(again.ghi[g], first.ghi[g])


def test_wrapper_takes_prebuilt_tables(scenes, monkeypatch):
    """The wrapper refuses anything but TriTables and counters on CPU
    tensors; with its tables built it builds nothing per call (the Woop
    rows and the tree are not rebuilt) and returns the twin's result."""
    _, tb = _tables(scenes, "hoisted")
    o, d, tmax = _rays(24, 16)
    with pytest.raises(TypeError, match="TriTables"):
        trk.tri_closest_hit(o, d, tmax, None)
    with pytest.raises(ValueError, match="counters"):
        trk.tri_closest_hit(o, d, tmax, tb,
                            counters=torch.zeros(3, dtype=torch.int64))

    def rebuilt(*_):
        raise AssertionError("a scene-constant table rebuilt per call")

    for mod, name in ((trk, "woop_rows"), (trk, "tree_tensors"),
                      (kc, "build_tree"), (kc, "tree_tensors")):
        monkeypatch.setattr(mod, name, rebuilt)
    got = trk.tri_closest_hit(o, d, tmax, tb)
    ref = trk.tri_closest_hit_plain(o, d, tmax, tb.wrows, tb.clo, tb.chi,
                                    _order(tb, o), tb.cluster, True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_orchestrator_keeps_k1_tables_per_scene(scenes, monkeypatch):
    """K1's route builds its tables at a scene's first query on a device
    and keeps them (with the attribute tables) in `Scene.kernel_tables`:
    a second query and a copy made by `to` build nothing, and the hits do
    not change."""
    scene = build_scene(procedural.scene_multi_torus(False))
    built = []
    real = port_tk.tri_tables
    monkeypatch.setattr(port_tk, "tri_tables",
                        lambda *a: built.append(1) or real(*a))
    o, d, tmax = _rays(24, 16)
    first = closest_hit(scene, o, d, tmax, backend="kernel", want_attrs=True)
    assert len(built) == 1 and ("tri", scene.device) in scene.kernel_tables

    def rebuilt(*_):
        raise AssertionError("a scene-constant table rebuilt per query")

    for name in ("tri_tables", "_tri_attr_tables", "_walked_boxes"):
        monkeypatch.setattr(port_tk, name, rebuilt)
    again = closest_hit(scene, o, d, tmax, backend="kernel", want_attrs=True)
    moved = scene.to("cpu")
    copied = closest_hit(moved, o, d, tmax, backend="kernel", occlusion=True)
    assert moved.kernel_tables is scene.kernel_tables
    for a, b in ((first.t, again.t), (first.prim, again.prim),
                 (shade_attrs(first, first.attrs).nrm,
                  shade_attrs(again, again.attrs).nrm)):
        assert torch.equal(a, b)
    assert torch.equal(copied.kind >= 0, first.kind >= 0)
