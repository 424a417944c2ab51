"""K1's cluster tree (`ops.tri_kernel.tri_tables`, over
`kernel_common.build_tree`) and a scalar Python reference of the CUDA
kernel's walk over it (`csrc/tri_hit.cu`, the warp-packet walk of
`csrc/tree_walk.cuh`): packets of 32 rays, one stack per packet, a node
entered when any walking ray passes it at its own bound, the near child
first by the packet's majority direction sign, and at a leaf (one cluster,
whose box the leaf's is) the rays that passed test its rows, keeping the
minimum of (t, rank, row). A single uncullable block is walked with no box
test. The reference reuses `test_torch_stream_tree.Walker` (K5's leaf
walk) with g = 1.

It must return bit-identical t/idx/u/v (closest and attrs) to the flat
twin `tri_closest_hit_plain`, and equal any-hit masks, with fewer box
tests, on the 23,168-triangle mesh of config 6 (its raw cluster boxes, and
with the loose tail hoisted to far boxes as the orchestrator walks them)
and on a one-cluster mesh. The orchestrator keeps the tables per scene and
device, and the wrapper builds no scene-constant table per call."""

import types

import pytest
import torch

from test_torch_stream_tree import K_STACK, Walker, _rays, _same, walk_packets
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


def _tables(scenes, setup):
    """K1's tables of each set-up: config 6's mesh with its raw cluster
    boxes, the same with the loose tail hoisted (far boxes), one cluster."""
    scene = scenes["one_cluster" if setup == "one_cluster" else "mesh"]
    geom = geom_from_scene(scene)
    cs = scene.cluster_size
    n_tail = -(-scene.loose_tris // cs) if setup == "hoisted" else 0
    clo, chi = port_tk._walked_boxes(geom, True, n_tail)
    return scene, trk.tri_tables(geom.woop_o, geom.woop_d, clo, chi, cs)


class K1Walker(Walker):
    """K1's walk: g = 1, the leaf's box is its cluster's, and a single
    uncullable block takes no box test."""

    leaf_box = False

    def __init__(self, o, d, tmax, tb, rank, occlusion):
        view = types.SimpleNamespace(
            tree_lo=tb.tree_lo, tree_hi=tb.tree_hi, tree_link=tb.tree_link,
            clo=tb.clo, chi=tb.chi, g=1, cluster=tb.cluster, wrows=tb.wrows)
        super().__init__(o, d, tmax, view, rank, occlusion)
        self.box_test = tb.box_test

    def passes(self, which, m, i):
        return super().passes(which, m, i) if self.box_test else True


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
                            counters=torch.zeros(2, dtype=torch.int64))

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
