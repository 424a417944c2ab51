"""The port's multi-device path (`parallel/`) on the CPU, mirroring
tests/test_sharding.py and tests/test_multiprocess.py.

Host-only cases hold `pad_scene_for_mesh` bit for bit to the JAX
package's and check the per-shard cluster bounds. The distributed cases
read the results of one launch of 8 gloo ranks
(`parallel.dryrun.launch`, each rank a process rendezvousing through a
FileStore) and of one launch of 4 ranks posed as 2 nodes x 2 ranks. Each
sharded frame is held to the port's single-process `render` of the same
scene (RMSE < 1e-6, tests/test_sharding.py's bound) with equal ray
counts. Every launch has a 300 s timeout, after which its children are
killed and the test fails with their output.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from toroidal_ray_tracing_tpu.cameras import PinholeCamera as JaxPinhole
from toroidal_ray_tracing_tpu.parallel import make_mesh as jax_mesh
from toroidal_ray_tracing_tpu.parallel import render_sharded as jax_sharded
from toroidal_ray_tracing_tpu.parallel.sharding import (
    pad_scene_for_mesh as jax_pad)
from toroidal_ray_tracing_tpu.scene import RenderSettings as JaxSettings
from toroidal_ray_tracing_tpu.scene import build_scene as jax_build
from toroidal_ray_tracing_tpu.scene import procedural as jax_proc
from toroidal_ray_tracing_tpu_torch.cameras import PinholeCamera, generate_rays
from toroidal_ray_tracing_tpu_torch.parallel import (dryrun, multihost,
                                                     pad_scene_for_mesh)
from toroidal_ray_tracing_tpu_torch.parallel.sharding import (padded_scene,
                                                             shard_geometry)
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings, build_scene,
                                                  procedural,
                                                  scene_from_numpy)
from toroidal_ray_tracing_tpu_torch.trace.wavefront import bucket_sizes

torch.set_num_threads(2)

RES = "16x16"
TIMEOUT = 300.0
MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]
# config 3's scene at depth 3 on the kernel twins, 4,608 rays a rays rank:
# big enough for the compaction buckets (4,608 and 2,304 lanes)
COMPACT_CASE = "flagship@2x4:kernel/96x96"
CASES = ([f"cornellish@{a}x{b}" for a, b in MESHES]
         + ["torus_grid16@2x4",
            "multi_torus@4x2:kernel", "multi_torus@1x8:kernel",
            "cornellish@2x4:kernel", "textured@1x8:kernel",
            "torus_plane@4x2", "torus_plane@1x8",
            "textured@4x2", "textured@1x8",
            "tie@1x8", "tie@2x4", COMPACT_CASE])
HYBRID = ["cornellish@hybrid1", "cornellish@hybrid2"]
# config 3's scene at 24x16, depth 3, 2 spp of seed 3 on two rays ranks
SPP_CASES = ["flagship@2x1/24x16+spp2+seed3",
             "flagship@2x1:kernel/24x16+spp2+seed3"]


# ---------------------------------------------------------------------------
# host-only
# ---------------------------------------------------------------------------

PAD_SCENES = {
    "cornellish": lambda p: p.scene_cornellish(),
    "mesh_grid64": lambda p: p.scene_instanced_torus_grid(n=64,
                                                          analytic=False),
    "torus_plane": lambda p: p.scene_torus_plane(analytic=True),
}


def _leaves(obj, prefix=""):
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            yield from _leaves(v, prefix + f.name + ".")
        elif isinstance(v, torch.Tensor):
            yield prefix + f.name, v


@pytest.mark.parametrize("n_prims", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(PAD_SCENES))
def test_pad_scene_matches_jax_bit_for_bit(name, n_prims):
    jscene = jax_build(PAD_SCENES[name](jax_proc))
    want = scene_from_numpy(jax_pad(jscene, n_prims))
    got = pad_scene_for_mesh(scene_from_numpy(jscene), n_prims)
    assert got.loose_tris == want.loose_tris
    assert got.cluster_size == want.cluster_size
    wanted = dict(_leaves(want))
    for key, a in _leaves(got):
        b = wanted.pop(key)
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.numpy().tobytes() == b.numpy().tobytes(), key
    assert not wanted
    assert got.triangles.count % (got.cluster_size * n_prims) == 0
    assert got.tori.count % n_prims == 0


def test_prim_shards_carry_tight_cluster_bounds():
    """Each prims shard culls against its own finite cluster boxes, equal
    to the boxes of its triangles, and rays from one side of the grid
    pass fewer than half of the (ray, cluster) slab tests."""
    n_prims = 4
    scene = pad_scene_for_mesh(build_scene(
        procedural.scene_instanced_torus_grid(n=64, analytic=False)),
        n_prims)
    cs = scene.cluster_size
    tri = scene.triangles
    for p in range(n_prims):
        g = shard_geometry(scene, n_prims, p)
        T = g.woop_o.shape[2]
        assert g.tri_offset == p * T and g.cluster_lo.shape[0] * cs == T
        lo, hi = g.cluster_lo.numpy(), g.cluster_hi.numpy()
        assert (np.abs(lo) < 1e31).all() and (np.abs(hi) < 1e31).all()
        sl = slice(p * T, (p + 1) * T)
        v0, e1, e2 = (a[sl].numpy() for a in (tri.v0, tri.e1, tri.e2))
        live = tri.valid[sl].numpy().reshape(-1, cs)
        tlo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2).reshape(-1, cs, 3)
        thi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2).reshape(-1, cs, 3)
        for c in range(lo.shape[0]):
            if live[c].any():
                np.testing.assert_allclose(lo[c], tlo[c][live[c]].min(0),
                                           atol=1e-5)
                np.testing.assert_allclose(hi[c], thi[c][live[c]].max(0),
                                           atol=1e-5)
    cam = PinholeCamera(eye=(20.0, 3.0, 0.0), center=(16.0, 0.0, 0.0))
    o, d = generate_rays(cam, 16, 16, RenderSettings.default(max_depth=1))
    o, d = o.numpy(), d.numpy()
    inv = np.where(np.abs(d) > 1e-30, 1.0 / np.where(d == 0, 1.0, d),
                   np.where(d >= 0, 3e38, -3e38))
    lo_all, hi_all = scene.cluster_lo.numpy(), scene.cluster_hi.numpy()
    t0 = (lo_all[:, None] - o[None]) * inv[None]
    t1 = (hi_all[:, None] - o[None]) * inv[None]
    tn = np.minimum(t0, t1).max(-1)
    tf = np.maximum(t0, t1).min(-1)
    hit_frac = ((tn <= tf) & (tf >= 1e-3)).mean()
    assert hit_frac < 0.5, f"culling ineffective: {hit_frac:.2f} pass"


def test_single_process_helpers():
    """Outside a process group: init_distributed is a no-op, the only node
    owns the whole frame, and the flagship mesh shapes of 8 are listed."""
    multihost.init_distributed()
    assert not torch.distributed.is_initialized()
    assert multihost.host_band(16, 16) == (0, 16)
    assert dryrun.mesh_shapes(8) == [(8, 1), (4, 2), (2, 4), (1, 8)]


def test_padded_scene_kept_per_scene():
    """render_sharded's padded scene is made once per scene object, so
    its slice tables persist across frames; an in-place change to the
    scene makes it again, and a scene that needs no padding is used as it
    is."""
    scene = build_scene(procedural.scene_cornellish())
    a = padded_scene(scene, 4)
    assert a is not scene and padded_scene(scene, 4) is a
    assert a.triangles.count % (4 * scene.cluster_size) == 0
    assert padded_scene(scene, 1) is scene
    a.kernel_tables["probe"] = 1
    assert padded_scene(scene, 4).kernel_tables == {"probe": 1}
    with torch.no_grad():
        scene.triangles.woop_o.add_(0.0)
    b = padded_scene(scene, 4)
    assert b is not a and b.kernel_tables == {}
    assert torch.equal(b.triangles.woop_o, a.triangles.woop_o)


# ---------------------------------------------------------------------------
# distributed: one launch of 8 ranks, one of 4 ranks as 2 nodes
# ---------------------------------------------------------------------------


def _by_case(ranks):
    out = {}
    for i, row in enumerate(ranks[0]["results"]):
        out[row["case"]] = [rk["results"][i] for rk in ranks]
    return out


@pytest.fixture(scope="module")
def world8():
    ranks = dryrun.launch(8, ",".join(CASES), device="cpu", res=RES,
                          timeout=TIMEOUT)
    return ranks, _by_case(ranks)


@pytest.fixture(scope="module")
def nodes2():
    ranks = dryrun.launch(4, ",".join(HYBRID), device="cpu", res=RES,
                          nodes=2, timeout=TIMEOUT)
    return ranks, _by_case(ranks)


@pytest.fixture(scope="module")
def spp2():
    ranks = dryrun.launch(2, ",".join(SPP_CASES), device="cpu",
                          timeout=TIMEOUT)
    return ranks, _by_case(ranks)


def _same_as_render(rows, spec):
    for r, row in enumerate(rows):
        assert row["finite"], (spec, r)
        assert row["rmse"] < 1e-6, (spec, r, row["rmse"])
        assert row["rays"] == row["ref_rays"], (spec, r)


@pytest.mark.parametrize("shape", MESHES)
def test_mesh_shapes_match_single_device(world8, shape):
    spec = "cornellish@%dx%d" % shape
    _same_as_render(world8[1][spec], spec)


def test_torus_scene_prim_sharded(world8):
    """Tori shard over "prims" too (16 tori, 4 a shard)."""
    _same_as_render(world8[1]["torus_grid16@2x4"], "torus_grid16@2x4")


def test_ray_count_independent_of_mesh(world8):
    counts = {row["rays"] for a, b in MESHES
              for row in world8[1][f"cornellish@{a}x{b}"]}
    assert len(counts) == 1 and counts.pop() > 256


@pytest.mark.parametrize("spec", ["multi_torus@4x2:kernel",
                                  "multi_torus@1x8:kernel",
                                  "cornellish@2x4:kernel",
                                  "textured@1x8:kernel"])
def test_kernel_backend_sharded(world8, spec):
    """backend="kernel" (the kernels' CPU twins) on per-shard slices:
    global ids, sliced attribute tables and torus materials, merged
    attrs."""
    _same_as_render(world8[1][spec], spec)


@pytest.mark.parametrize("shape", [(4, 2), (1, 8)])
def test_all_loose_scene_prim_sharded(world8, shape):
    """Torus + plane, every triangle in the loose tail: shards skip the
    hoist and test the tail's clusters as any others."""
    spec = "torus_plane@%dx%d" % shape
    _same_as_render(world8[1][spec], spec)


@pytest.mark.parametrize("shape", [(4, 2), (1, 8)])
def test_textured_scene_prim_sharded(world8, shape):
    """The atlas is replicated while the triangles shard: texture ids of
    other shards' triangles must survive the padding."""
    spec = "textured@%dx%d" % shape
    _same_as_render(world8[1][spec], spec)


@pytest.mark.parametrize("shape", [(1, 8), (2, 4)])
def test_tie_between_shards_goes_to_lowest_key(world8, shape):
    """Hits at equal t on several shards: every rank merges to the lowest
    prim*2+kind, with that hit's u, v and attrs."""
    rows = world8[1]["tie@%dx%d" % shape]
    assert all(row["tied_rays"] > 50 for row in rows)
    assert [row["mismatches"] for row in rows] == [0] * 8


def test_early_exit_reduced_across_ranks(world8):
    """On (4, 2) the first rays shard's rays all miss at the first segment
    while the others bounce off mirrors: every rank still traces the same
    segments (the stop test is reduced over both groups)."""
    rows = world8[1]["cornellish@4x2"]
    miss = rows[0]["rays_rank_all_miss"]
    assert miss[0] and not all(miss)
    assert {row["segments"] for row in rows} == {2}


def test_ranks_with_different_live_spans_pick_one_bucket(world8):
    """Live-ray compaction over a 2x4 mesh: the two rays ranks (the
    frame's upper and lower half) keep different live spans, so alone the
    upper one would trace a smaller bucket; every rank traces each
    segment on one prefix, the smallest bucket holding the larger rank's
    live spans. The frame equals the single-process render."""
    rows = world8[1][COMPACT_CASE]
    _same_as_render(rows, COMPACT_CASE)
    sizes = bucket_sizes(96 * 96 // 2)
    assert len(sizes) > 1
    prefixes = {tuple(row["prefixes"]) for row in rows}
    assert len(prefixes) == 1
    prefixes = prefixes.pop()
    live = [row["live_spans"] for row in rows]
    assert any(len({spans[s] for spans in live}) > 1
               for s in range(len(prefixes)))
    def bucket(spans):
        return min(b for b in sizes if b >= spans * 128)

    for s, lanes in enumerate(prefixes):
        assert lanes == bucket(max(spans[s] for spans in live)), (s, lanes)
    assert any(bucket(spans[s]) < lanes for spans in live
               for s, lanes in enumerate(prefixes)), (prefixes, live)


def test_every_rank_traced_the_same_segments(world8):
    ranks, by_case = world8
    assert dryrun.failures(ranks) == []
    for spec, rows in by_case.items():
        if "segments" in rows[0]:
            assert len({row["segments"] for row in rows}) == 1, spec


@pytest.mark.parametrize("n_prims", [1, 2])
def test_hybrid_multihost_mesh(nodes2, n_prims):
    """make_hybrid_mesh orders the ranks node-major (the launcher's
    variables interleave them: node r % 2) with "prims" inside a node,
    renders like `render`, and host_band gives each node's half (and
    raises on a height the nodes do not divide)."""
    rows = nodes2[1][f"cornellish@hybrid{n_prims}"]
    _same_as_render(rows, n_prims)
    assert [row["mesh"] for row in rows] == [[4 // n_prims, n_prims]] * 4
    for r, row in enumerate(rows):
        node = r % 2
        assert row["node"] == node and row["nodes"] == 2
        assert row["band"] == [node * 8, 8] and row["band_rejects_uneven"]
        assert row["coord"][0] // (2 // n_prims) == node
    assert dryrun.failures(nodes2[0]) == []


@pytest.mark.parametrize("spec", SPP_CASES)
def test_spp_sharded_matches_jax(spp2, spec):
    """render_sharded with spp = 2 on two gloo ranks draws the JAX
    package's `render_sharded` jitter (NumPy's default_rng(seed), one draw
    a sample): every rank's frame equals a single-process trace of the same
    rays (RMSE < 1e-6) and the JAX package's sharded frame on a 2x1 CPU
    mesh (jnp) within max |diff| 5e-4, ray counts exact."""
    rows = spp2[1][spec]
    _same_as_render(rows, spec)
    ref = jax_sharded(jax_build(jax_proc.scene_multi_torus(analytic=True)),
                      JaxPinhole(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0)),
                      24, 16, JaxSettings.default(max_depth=3),
                      mesh=jax_mesh(2, 1, devices=jax.devices()[:2]),
                      backend="jnp", spp=2, seed=3)
    want = np.asarray(ref["image"])
    for r, row in enumerate(rows):
        got = np.asarray(row["image"], np.float32).reshape(want.shape)
        err = float(np.abs(got - want).max())
        assert err < 5e-4, (spec, r, err)
        assert row["rays"] == int(float(ref["rays_traced"])), (spec, r)
    assert dryrun.failures(spp2[0]) == []


def test_dryrun_multichip():
    """The flagship scene on every mesh shape of 4 ranks, each frame held
    to a single-process render."""
    ranks = dryrun.dryrun_multichip(4, device="cpu", timeout=TIMEOUT)
    shapes = [row["mesh"] for row in ranks[0]["results"]]
    assert shapes == [[4, 1], [2, 2], [1, 4]]
