#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU: build, check, measure.

Usage (from the repository root, on a machine with a CUDA GPU):

    python3 chip_smoke.py [--only 16]

(`--only` runs phases 1, 2 and the listed ones; 6 and 8 also need 4, 14
needs 7.)

Phases, each printed on its own lines with its wall seconds:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: nvcc compiles the port's CUDA kernels from csrc/, one process
     per source, all started together;
  3. each kernel against its plain PyTorch twin on the card, same inputs,
     at the main path's shapes, with CUDA-event timings and the least time
     the card could take for the same work (bound_ms, from the bytes the
     call must move and the slab / Woop / quartic tests the twin counts):
     K1 on config 6's 1080p rays (a 262,144-ray subset and the full
     frame; any-hit on the subset's shadow rays), K2 on config 3 and
     config 4 (subset and full frame), K3 on
     config 3 at 512x512 (closest with attrs, and any-hit on its shadow
     rays) and on config 7's first 1080p closest+attrs and any-hit calls
     (K = 1) as render makes them, each with its work counters and its
     bare launch beside the wrapper, K4 on config 7's 1080p primary-hit and
     first-bounce texel indices (bit-equal; the bare launch, and beside it
     the one-call PyTorch gather, library_ms; the bound counts the atlas
     rows the call touches), K5 on
     a contiguous block-major patch of 32,768 of config 8's 1080p primary
     rays (closest with attrs, and any-hit on their shadow rays; the flat
     twin's slab / Woop tests per ray beside the tree walks' own counters),
     and K5 against K6 on the full 1080p frame (bit-equal, closest with
     attrs and any-hit; both also against the flat twin on every 63rd ray
     of the frame and as many rays near the mesh), each bound from the
     kernel's counters; K5's and K6's wrappers against their bare
     launches, beside the per-scene table preparation they no longer
     repeat, and a render of config 8 from its host scene; the threefry
     jitter kernel (csrc/threefry.cu) bit-equal to its twin
     `utils.prng.uniform` at config 5's (3840*2160, 2) and at n and (n, 2)
     for n in 1, 3, 4099, with its wrapper, bare-launch, device (in a CUDA
     graph) and twin times and its int32-operation bound;
  4. the main path, each path run with the launch counts set to 0 just
     before it and read just after: `render(..., backend="kernel",
     device="cuda")`, which compacts live rays (`trace.wavefront`), at
     1920x1080 for config 3 (K2 on its whole-frame segments and K3 on its
     compacted n/8 prefix), config 6, config 4, the
     toroidal capture, config 7 (textured: K1, K3, K4) and config 8 (1.18M
     triangles: K5), config 8 again with the group switch on (K6; the image
     must be bit-equal to K5's), plus config 3 at 512x512 (the K3 route);
     then `render_frames` over config 7's 4-camera orbit and
     `render_sequence` over config 8's 2-camera orbit at 1080p, each frame
     equal to a per-frame `render` with exact ray counts; config 5's frame
     0 at 3840x2160, 2 spp, through `render` and its banded path
     (tile_rows=540): one threefry launch each, K2 and K3, the image
     bit-equal to the same render with the twin's draw, and one profiled
     frame (device busy, idle share, the kernels' ms). Each scene also
     renders on both backends, which must agree (480x270; config 8 at
     128x72, where the torch backend's dense 1.18M-triangle query is
     affordable);
  5. the goldens of tests/golden on the card, on both backends;
  6. one profiled frame per cell (torch.profiler): device busy time,
     CUDA kernel launches, the port's kernels' share, idle share;
  7. the capture experiment through `experiments/`, each run with the
     launch counts set to 0 just before it and read just after: config
     6's scene written as OBJ + MTL files and loaded (native and Python
     parsers equal), config 8's 1.18M-triangle mesh loaded from OBJ and
     rendered at 1080p through K5 (kernel against torch backend at
     128x72); the 13-step rho sweep at 1920x1080, depth 10, on the OBJ
     scene (2 x 13 + 2 dump files), gTruth, and the reprojection of every
     step (finite RMSE, coverage in (0, 1]; one step splatted on the card
     and on the CPU alike); the capture's rho-4 step on both backends at
     480x270 (mirror paths may flip up to 0.1% of pixels); one step of 60
     frames; a 13-step sweep with the subject refit to a moving eye,
     whose last scene renders as a fresh build (RMSE < 1e-5). Text dumps
     are deleted at the end;
     smoke_out/experiment/experiment.json keeps the numbers;
  8. the measurement front doors, each path run with the launch counts set
     to 0 just before it and read just after: the bench headline (config
     3's 16-frame sequence, with mfu and cull_speedup), `run_scenario` of
     every ladder config in front-door mode (2 frames; config 5 its 8, its
     jitter drawn by the threefry kernel, one launch a frame of each of
     its 4 calls, launching K2 and K3; the ray
     counts of the cells phase 4 renders equal phase 4's),
     `raster_render` of configs 6 and 7 at 1920x1080 (timed) and at
     240x135 against the CPU, a 4-value light-intensity sweep of config 3
     at 1080p (each frame bit-equal to its own `render`), the microbench
     rows of configs 3 and 6 at 2M rays, and the roofline's post-cull
     count of config 6 on the card equal to the CPU's;
  9. gradients and multi-device, each path's launches added to the
     totals: `trace_rays_fixed` with `backend="kernel"` (the kernels for
     every segment's closest hit, the torch path's recompute backward)
     against `backend="torch"` (traced in tiles) on config 3 at 1920x1080
     (K2), config 3 at 512x512 (K3) and config 6 at 480x270 (K1): the
     image-mean loss within rtol 1e-5 and its gradients with respect to
     a minor-radius scale, the light's intensity and position and a
     diffuse scale within rtol 1e-3, with forward and forward+backward
     ms beside `render`'s and the peak memory; the light fit of
     tests/test_differentiable.py at 256x256 on the kernel backend (150
     Adam steps); `render_sharded` on a 1x1 mesh over a one-rank NCCL
     group (configs 3 and 6 at 1080p), and on two gloo ranks sharing the
     card (`parallel.dryrun`, meshes 1x2 and 2x1: configs 6, 4 and 8 at
     480x270), each frame equal to `render` (RMSE < 1e-6);
 10. the oracle on the card: each ladder scene, full scene at full
     ladder depth, through `render(..., backend="kernel")` (launch counts
     set to 0 just before it and read just after) and through the port's
     oracle `render_oracle(..., device="cuda")` (dense Möller–Trumbore
     over every triangle row, a float64 quartic per torus), held to
     tests/test_parity.py's `assert_parity` rule: image RMSE < bound,
     RMSE < 2e-4 after dropping the worst 0.1% of pixels (at least one),
     and the same on hit_position clipped to +-1e4 with the RMSE bound
     x50. Only the resolution is cut:
       config 1 (1 torus, depth 1), 256x256 (its ladder size): K3, 1e-3;
       config 2 (torus on a plane, depth 1), 512x512 (its ladder size):
         K3, 2e-2 (the contact circle);
       config 3 (4 tori + mirror, depth 3), 1920x1080 (full): K2, 2e-2
         (grazing mirror bounces); and at 512x512: K3, 2e-2;
       config 4 (1,024 tori + plane, depth 5), 480x270 (cut from 1080p):
         K2's tree, 1e-3;
       config 6 (23,168 triangles + mirror, depth 3), 480x270: K1, 1e-3;
       the capture (cornellish, toroidal rho 4, depth 10), 480x270: K1,
         1e-2 and the worst 1% dropped;
       config 7 (textured, depth 3), 480x270: K1, K3, K4, the image's
         plain RMSE < 1e-3 alone (as tests/test_mipmaps.py holds mip
         sampling);
       config 8 (1,179,648 triangles, depth 2), 128x72 (the dense oracle
         tests every row): K5, 1e-3; again with the group switch on: K6,
         1e-3, and bit-equal to K5's frame;
       config 5 (config 3's scene, fly-through frame 0, depth 3, 2 spp),
         960x540 (cut from 3840x2160): K3, 2e-2; the reference is the mean
         of two oracle passes, the centered rays and, through
         `JitteredCamera`, the rays of render's jittered sample (the same
         draw, key fold_in(PRNGKey(0), 1), by the twin `utils.prng.uniform`,
         so the reference does not rest on the kernel; the render's draw
         must launch the threefry kernel). Each cell
     prints the oracle's seconds, the render's ms, both RMSEs, the pixels
     off by > 1e-3 and its launches; between them the cells launch all
     seven kernels (config 3 at 1080p both K2 and K3, as in phase 4);
 11. compaction: the mirror cells (configs 3, 6, 7 and the capture at
     1920x1080, from phase 4's scenes), the experiment's depth-10
     capture frame (phase 7's OBJ scene, rho 4) and config 8, each
     rendered with `trace.wavefront.COMPACT_FACTORS` at its default and
     set to () in 8 alternating pairs: per segment the lanes traced and
     the live spans, ms/frame both ways (median and quartiles), the
     launches and one profiled frame's device busy time and idle share
     both ways. Held: ray counts equal, hit positions bit-equal, each
     segment on the smallest bucket holding its live spans, a late
     segment on a smaller prefix (config 8: every segment at n); images
     bit-equal, but config 3's (K3 on its prefix, K2 on the whole frame)
     by phase 4's backend rule, with K3 launched only compacted;
 12. random streams and the graft entry: config 5's jitter for sample 1
     of frames 0 and 7 (keys fold_in(PRNGKey(0), 1) and fold_in(PRNGKey(0),
     15), shape (3840*2160, 2)) drawn on the card by the threefry kernel
     (`ops.threefry_kernel.uniform`), bit-equal to its twin
     `utils.prng.uniform` on the card and on the CPU and to the
     fingerprints of `jax.random.uniform`'s draw pinned below
     (JITTER_PINS), with the kernel's and the twin's ms (CUDA events,
     median of 10); then `entry()`'s `fn(*args)`
     (config 3's scene, 64x64 rays, depth 3, K3) on the card, its launches
     counted (launch counts set to 0 just before it and read just after):
     finite, its ray count equal to the CPU twin's, its image within
     phase 4's backend rule of the CPU twin's;
 13. the segment kernels against their twins: S1 (`ops.loose_kernel`,
     csrc/loose_hit.cu: closest and any-hit), S2 and S3
     (`ops.shade_kernel`, csrc/shade.cu) on the arguments the main path
     gave them in the first whole-frame segment of config 6 (1920x1080,
     2,073,600 rays), config 5 (3840x2160, 8,294,400 rays) and config 7
     (textured), recorded from a `render`: the lanes whose every output
     is bit-equal, the lanes parted only where a libm function (powf,
     log2f, sqrtf) rounds otherwise, within 1e-6 of max(1, |value|), and
     no lane with a discrete output off; S3's ray count, live spans and
     their count equal. S2 takes the query's parts and is compared on
     the entries its contract defines (`shade_kernel.defined_entries`),
     also on the merged hit as its base (the route it replaces); S3 fed
     by S2 on parts, by S2 on the merged hit, and by S2 on parts with
     every undefined entry set to NaN, equals the twins end to end on
     every lane. Configs 6 and 5 also time each kernel: the wrapper, the
     bare launch, its device time (20 bare launches in a CUDA graph; S3,
     in place, less the restore of its state each run needs) and the
     twin, beside the byte bound (each input read once and each output
     written once, as this run's data needs them: a miss moves its flags
     and tmax, a lane its position rows only where it goes on); S2 also
     beside merge_parts + S2 on the merged hit, wrapper and CUDA-graph
     device time in the same process, which it must not exceed;
 14. the front-door kernels against their twins
     (`ops.front_kernel`): R1 (csrc/raygen.cu) into the bounce loop's
     state at config 5's jittered sample (3840x2160, block 24, the
     threefry draw), config 6's 1080p frame and the capture's toroidal
     1080p frame, and in both row layouts, and a toroidal eye at its
     center (NaN rays), its first-hit rows left as they were; G1
     (csrc/frame.cu span_gather) on the first bucket shrink of config 3's
     and config 5's frames and the second shrink of the experiment's
     depth-10 capture frame (spans past the old prefix, span maps composed,
     the first buffer as the spare), recorded from a `render`; F1
     (csrc/frame.cu frame_finish) on the traced states of config 5's two
     samples (the second adds and divides), config 6's and the capture's
     frames with dumps, row-major and channel-major, and an odd toroidal
     frame (1001x543, block 1: the last CTA short, the pixel count no
     multiple of 4) with dumps and then its second sample, its outputs
     16-B aligned and at a 4-B offset. Each kernel and its
     twin start from the same buffers and end bit-equal on every entry
     (NaN equal to NaN), those their contract leaves unwritten too, with the
     wrapper, the bare launch, its device time (20 bare launches in a
     CUDA graph), the twin, the byte bound, and for G1 and F1 the one
     PyTorch call for the same data movement (`index_select` of the
     prefix's rows; the permuted `.contiguous()` copy of the color rows);
 15. the visit-rank kernel V1 (`ops.visit_kernel`, csrc/visit.cu) against
     its twin (`batch_anchor`, `visit_order`, `tree_rank`) on every
     segment of a `render` of configs 3, 4, 6, 7, 8 (through K5, and
     through K6), 5 (3840x2160, 2 spp) and the capture at their main-path
     sizes, recorded as `segment_ranks` hands it the state's origin rows:
     the anchor and every rank bit-equal (an anchor that differs is
     printed); its per-call route (K1's and K2's wrappers given no rank
     launch V1 once, and hit as on the twin's rank); on the same renders
     the folds the query's kernels now write against the torch
     formulation they replace, on every lane: the torus query's tmax
     (`torch.minimum(tmax, t)`, `torch.where(occ, 0, tmax)`) and the
     occlusion byte (S1, K1, K5/K6, K2, K3; `t < BIG` ORed); synthetic
     sets on config 5's origins, two a launch (1 and 8, 9 and 257 boxes in
     one CTA; 513 and 3,340, 8,192 and 33 in a cluster, the sorted shares
     in shared memory; 9,000 and 16,385, 600 and 8,193 with shares in the
     global scratch), bit-equal to the twin; the same anchor bits
     from two launches on the same origins; V1's wrapper, bare,
     CUDA-graph device and twin times and byte bound on the 9,000- and
     16,385-box sets and on config 8's, config 6's and config 5's first
     segment, beside the eager route it replaces;
 16. the bounce loop's segment plan (`ops.segment_plan`): configs 3, 5
     (3840x2160, 2 spp), 6, 7 (textured) and 8 and the capture frame (config 6 in the
     toroidal camera, rho 4, depth 10) render through the plan and through
     the wrappers' default route, image, dumps and ray count bit-equal,
     `plan_segments` equal to the frame's segments; S1, K1, K5, K2, K3
     and S2 give the same bits with their rays' rows at another row
     stride; then each wrapper's first call of each route is replayed
     alone, the host microseconds a call takes with the plan's outputs
     and without (`host_us_plan`, `host_us`).

Phases 4 and 7-11 also check every kernel-backend segment that a counted
path traces on the card (`SegmentGuard`): from its visit ranks to its
S3, it launched V1 at most once, the shading kernels S2 and S3 once each
and the loose hoist S1 twice where it tests a scene's loose rows (its
closest and any-hit queries), and nothing called `trace.shade.shade`, a
segment kernel's twin or the eager visit order (`batch_anchor`,
`visit_order`, `tree_rank`) on card tensors; each phase traces at least
one. Phase 9's two gloo ranks report their segments and launches: S2 and
S3 once a segment, V1 at most once, S1 twice on a loose scene's whole
table (one prims shard), none on a prims slice. Every counted path's
front-door launches are checked too (`FrontGuard`, phases 4 and 7-11):
R1 once a frame of each batch a front door traces (once a sample) and
once a `device_rays` call on the card, F1 once a frame of each batch, G1
once a kernel-backend bucket shrink, no twin of the three on card
tensors; phase 4 also asserts R1 and F1 once a sample of every render it
counts.

Any failed check exits 1 without the result lines. On success the line
before the last is the per-kernel JSON summary and the last line is
{"ok": true, "device": {...}}. With no CUDA device it exits 1 at once.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "smoke_out")
DEVICE = "cuda"
FULL = (1920, 1080)       # the ladder's frame size
SUBSET = 262144           # rays compared against the dense plain twins
PATCH = 32768             # config 8's contiguous block-major K5 patch
FRAME_STRIDE = 63         # K5/K6 meet the twin on every 63rd 1080p ray
K3_RES = 512              # config 3 at this square size routes to K3
CHECK_RES = (480, 270)    # kernel-vs-torch backend agreement renders
CHECK_RES_C8 = (128, 72)  # the same for config 8 (1.18M triangles)
JITTER_CHECK_RES = (960, 540)   # config 5 against the oracle, 2 spp
FAILURES: list[str] = []
JITTER_PIXELS = 3840 * 2160   # config 5's frame
# Config 5's jitter, sample 1 of frames 0 and 7 (keys fold_in(PRNGKey(0),
# f * 2 + 1): 1 and 15) at (3840*2160, 2), as `jax.random.uniform` draws it
# (JAX 0.9.0, jax_threefry_partitionable on): the first and last four
# uint32 words and the uint64 sum of all words. tests/test_torch_prng.py
# derives them again from JAX.
JITTER_PINS = {
    1: ((0x3BEF0100, 0x3CAB2400, 0x3F14D85E, 0x3EB942D4),
        (0x3F17E40C, 0x3F05E218, 0x3F4D0364, 0x3EDBA328),
        17464193098880362),
    15: ((0x3F1D75FC, 0x3ED52B7C, 0x3F28B4EE, 0x3EE66B34),
         (0x3E552AF0, 0x3F102148, 0x3F20F3A2, 0x3F1D1970),
         17464176581738104),
}

# Operations per test, as the kernels' source notes count them.
SLAB_OPS = 26             # (ray, box) slab test, csrc/common.cuh
WOOP_OPS = 50             # (ray, triangle) Woop test, csrc/common.cuh
QUARTIC_OPS = 600         # (ray, torus) quartic test, csrc/torus_hit.cu
THREEFRY_INT_OPS = 75     # int32 operations a drawn float, csrc/threefry.cu
KERNEL_DIR = "toroidal_ray_tracing_tpu_torch/csrc"
JAX_OPS = "toroidal_ray_tracing_tpu/ops"


def jitter_fingerprint(words):
    """(first four, last four, uint64 sum) of a draw's uint32 words (a
    flat NumPy array)."""
    import numpy as np

    return (tuple(int(w) for w in words[:4]),
            tuple(int(w) for w in words[-4:]),
            int(words.astype(np.uint64).sum()))


def check(ok: bool, what: str) -> bool:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        FAILURES.append(what)
    return ok


def sync(torch):
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 5) -> float:
    """Median milliseconds of `fn` over `reps` runs after one warm-up,
    timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def once_ms(torch, fn):
    """(fn(), its milliseconds): one call, host clock, synchronized."""
    sync(torch)
    t0 = time.perf_counter()
    out = fn()
    sync(torch)
    return out, (time.perf_counter() - t0) * 1e3


def bound(nbytes: float, ops: float, int_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes / HBM rate and operations
    / their rate (f32 `ops`, int32 `int_ops`), the H100 SXM peaks at its
    700 W limit that `utils/roofline.py` keeps."""
    from toroidal_ray_tracing_tpu_torch.utils.roofline import (PEAK_BYTES,
                                                               PEAK_F32,
                                                               PEAK_INT32)

    tb = nbytes / PEAK_BYTES * 1e3
    to = (ops / PEAK_F32 + int_ops / PEAK_INT32) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def hit_bound(n, counts, prim_ops, table_bytes, out_rows):
    """bound_ms of a closest-hit call on n rays: rays in (3 + 3 + 1 f32),
    out_rows f32/i32 rows out, the table bytes the call needs; the counted
    slab tests and primitive tests."""
    nbytes = n * 4 * (7 + out_rows) + table_bytes
    ops = counts.get("box", 0) * SLAB_OPS + counts.get("prim", 0) * prim_ops
    print(f"  bound: {nbytes / 1e6:.1f} MB, {counts.get('box', 0)} slab "
          f"tests, {counts.get('prim', 0)} primitive tests", flush=True)
    return bound(nbytes, ops)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def tri_table_bytes(torch, counts, tri, boxes, tables, t, idx):
    """The table bytes a triangle hit call needs: the Woop inputs (12 + 9
    f32 per triangle) of the triangles some ray tested (the twin's "rows"),
    the cluster boxes in full, and the attribute columns (21 + 8 + 8 f32)
    of the distinct winning triangles."""
    woop = (tri.woop_o[..., 0].numel() + tri.woop_d[..., 0].numel()) * 4
    cols = sum(a.shape[0] * a.element_size() for a in tables)
    winners = int(torch.unique(idx[t < 1e30]).numel())
    print(f"  tables: {counts.get('rows', 0)} triangles tested, {winners} "
          "distinct winners", flush=True)
    return counts.get("rows", 0) * woop + nbytes(*boxes) + winners * cols


def compare_hits(name, got, ref, n, attr_rows=None, occlusion=False):
    """Print and check kernel-vs-twin agreement. got/ref: (t, idx[, ...]).
    Pass: t within rtol 1e-5 on common hits, mask and idx mismatches at
    most 1e-4 of the rays, attrs within 1e-4."""
    hit_g, hit_r = got[0] < 1e30, ref[0] < 1e30
    mask_bad = int((hit_g != hit_r).sum())
    line = f"  {name}: rays {n}, mask mismatches {mask_bad}"
    ok = mask_bad <= 1e-4 * n
    err = 0.0
    if not occlusion:
        both = hit_g & hit_r
        dt = (got[0][both] - ref[0][both]).abs()
        rel = dt / ref[0][both].abs().clamp(min=1e-30)
        err = float(dt.max()) if dt.numel() else 0.0
        idx_bad = int((got[1][both] != ref[1][both]).sum())
        line += (f", common hits {int(both.sum())}, max|dt| {err:.3e}, "
                 f"max rel dt {float(rel.max()) if rel.numel() else 0:.3e}, "
                 f"idx mismatches {idx_bad}")
        ok &= bool((rel <= 1e-5).all()) and idx_bad <= 1e-4 * n
        if attr_rows is not None:
            same = both & (got[1] == ref[1])
            da = (got[attr_rows][:, same] - ref[attr_rows][:, same]).abs()
            amax = float(da.max()) if da.numel() else 0.0
            line += f", attrs max diff {amax:.3e}"
            ok &= amax <= 1e-4
            ok &= bool((got[attr_rows][:, ~hit_g] == 0).all())
    print(line, flush=True)
    check(ok, f"{name} agrees with its plain twin")
    return err


def agree(torch, name, a, b, flips=False):
    """The kernel-vs-torch backend bound (phases 4 and 7): at most 0.1% of
    pixels off by > 1e-3 and RMSE < 1e-4, over every pixel or, with
    flips, over the pixels not off. flips is for mirror paths: the
    backends' shading arithmetic differs in the last ulp, a path that
    bounces between curved mirrors grows that until it crosses a mesh
    edge on the other side or takes another surface, and the pixel flips
    (the JAX package's two backends flip such pixels too)."""
    diff = (a - b).abs()
    off = diff.amax(dim=-1) > 1e-3
    bad = int(off.sum())
    rmse = float(diff.pow(2).mean().sqrt())
    n = a.shape[0] * a.shape[1]
    line = f"  {name}: rmse {rmse:.3e}, {bad} of {n} pixels off by > 1e-3"
    if flips:
        rmse = float(diff[~off].pow(2).mean().sqrt())
        line += f", rmse over the rest {rmse:.3e}"
    print(line, flush=True)
    return check(rmse < 1e-4 and bad <= 1e-3 * n, f"{name} agree")


def bit_equal(a, b) -> bool:
    import torch

    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


_SCENES: dict = {}
_HOST_SCENES: dict = {}


def scene_of(name, build):
    """Each scene is built once per run (config 8's 1.18M-triangle host
    build takes a while) and kept on the card, its host copy beside it."""
    if name not in _SCENES:
        t0 = time.perf_counter()
        _HOST_SCENES[name] = build()
        _SCENES[name] = _HOST_SCENES[name].to(DEVICE)
        print(f"  built {name} in {time.perf_counter() - t0:.1f} s",
              flush=True)
    return _SCENES[name]


def config(num):
    from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS

    sc = SCENARIOS[num]
    return sc, scene_of(sc.name, sc.build)


def shadow_rays(torch, o, d, t_hit, light):
    """Rays from the closest hits toward the point light (tmax 0 on a
    miss)."""
    hit = t_hit < 1e30
    p = o + torch.where(hit, t_hit, 0.0)[None, :] * d
    L = light.to(o.device)[:, None] - p
    dist = torch.linalg.vector_norm(L, dim=0)
    return (p.contiguous(), (L / dist.clamp(min=1e-20)).contiguous(),
            torch.where(hit, dist, 0.0))


def hoisted_tables(torch, scene):
    """The triangle tables as the main path passes them: loose tail
    clusters hoisted to far boxes, attr tables."""
    from toroidal_ray_tracing_tpu_torch.ops.trace_kernel import (
        _tri_attr_tables)

    cs, n_cl = scene.cluster_size, scene.cluster_lo.shape[0]
    n_tail = (scene.loose_tris + cs - 1) // cs
    far = torch.full((n_tail, 3), 2.0e38, device=DEVICE)
    clo = torch.cat([scene.cluster_lo[:n_cl - n_tail], far]).contiguous()
    chi = torch.cat([scene.cluster_hi[:n_cl - n_tail], far]).contiguous()
    return clo, chi, _tri_attr_tables(scene)


def equal_rays(got, ref) -> int:
    """Rays whose every output (t, idx[, u, v][, attr columns]) is
    bit-equal in got and ref."""
    import torch

    same = torch.ones_like(got[0], dtype=torch.bool)
    for a, b in zip(got, ref):
        eq = a == b
        same &= eq.all(dim=0) if eq.dim() == 2 else eq
    return int(same.sum())


def work_bound(torch, n, work, prim_ops, const_bytes, winner_bytes, t, idx,
               out_rows, prim_name):
    """bound_ms of a tree-walk call on n rays from the kernel's own
    counters: work = (slab tests, primitive tests). Bytes: rays in (7 f32)
    and out_rows f32/i32 rows out, the tables every call reads
    (const_bytes: tree, boxes, rank) and winner_bytes for each distinct
    winner (the primitives a ray tested but did not keep are not counted,
    so the bytes side is a lower bound)."""
    winners = int(torch.unique(idx[t < 1e30]).numel())
    nb = n * 4 * (7 + out_rows) + const_bytes + winners * winner_bytes
    box, prim = work
    print(f"  bound: {nb / 1e6:.1f} MB ({winners} distinct winners), {box} "
          f"slab tests ({box / n:.1f} per ray), {prim} {prim_name} "
          f"({prim / n:.2f} per ray)", flush=True)
    return bound(nb, box * SLAB_OPS + prim * prim_ops)


def refuses_deep_tree(launcher) -> bool:
    """The entry point returns an error for a tree deeper than kStack."""
    try:
        launcher(depth=1 << 20)
    except RuntimeError:
        return True
    return False


def phase_kernels(torch, results):
    from toroidal_ray_tracing_tpu_torch import render
    from toroidal_ray_tracing_tpu_torch.cameras import PinholeCamera
    from toroidal_ray_tracing_tpu_torch.cameras.pinhole import pick_block
    from toroidal_ray_tracing_tpu_torch.experiments.k3_turns import graph_ms
    from toroidal_ray_tracing_tpu_torch.ops import tex_kernel as txk
    from toroidal_ray_tracing_tpu_torch.ops import torus_kernel as tk
    from toroidal_ray_tracing_tpu_torch.ops import tri_kernel as trk
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
        launch, round_up, tree_rank, visit_order)
    from toroidal_ray_tracing_tpu_torch.ops.trace_kernel import _material_rows
    from toroidal_ray_tracing_tpu_torch.scene import RenderSettings
    from toroidal_ray_tracing_tpu_torch.trace import wavefront

    dev = torch.device(DEVICE)
    st = RenderSettings.default(max_depth=3)
    light = st.light.position
    gen = torch.Generator().manual_seed(0)

    def rays(cam, w, h):
        o, d = cam.device_rays(cam.ray_params(w, h, st), w, h, st,
                               block=pick_block(w, h), rows=True, device=dev)
        return o.contiguous(), d.contiguous()

    def subset(n, m=SUBSET):
        return torch.randperm(n, generator=gen)[:m].sort().values.to(dev)

    def counters():
        return torch.zeros(2, dtype=torch.int64, device=dev)

    cam36 = PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0))
    o, d = rays(cam36, *FULL)
    n_full = o.shape[1]
    sel = subset(n_full)
    os_, ds_ = o[:, sel].contiguous(), d[:, sel].contiguous()
    n_sub = os_.shape[1]
    tm_sub = torch.full((n_sub,), 1e4, device=dev)
    tm_full = torch.full((n_full,), 1e4, device=dev)

    # --- K1: config 6 mesh, the tables as the main path passes them -------
    _, scene = config(6)
    tri = scene.triangles
    cs = scene.cluster_size
    clo, chi, tables = hoisted_tables(torch, scene)
    tb, k1_build_ms = once_ms(torch, lambda: trk.tri_tables(
        tri.woop_o, tri.woop_d, clo, chi, cs))
    M1 = tb.tree_lo.shape[0]
    print(f"K1 tri_closest_hit (config 6: {tri.count} triangles, "
          f"{clo.shape[0]} clusters; tree of {M1} nodes, {(M1 + 1) // 2} "
          f"leaves, depth {tb.depth}, tables built in {k1_build_ms:.1f} ms)",
          flush=True)

    def k1(o_, d_, tm, attrs=True, occl=False, work=None):
        return trk.tri_closest_hit(o_, d_, tm, tb, attr_tables=tables
                                   if attrs else None, occlusion=occl,
                                   counters=work)

    def k1_plain(o_, d_, tm, attrs=True, occl=False, counts=None):
        order = visit_order(tb.clo, tb.chi, o_, o_.shape[1])
        return trk.tri_closest_hit_plain(o_, d_, tm, tb.wrows, tb.clo,
                                         tb.chi, order, cs, True,
                                         tables if attrs else None, occl,
                                         counts=counts)

    def k1_bare(o_, d_, tm, attrs=True, occl=False):
        """The kernel's launch alone: the rank and buffers made once."""
        n_ = o_.shape[1]
        rank = tree_rank(visit_order(tb.clo, tb.chi, o_, n_))
        outs = [torch.empty((n_,), device=dev) for _ in range(4)]
        outs[1] = outs[1].to(torch.int32)
        attr = torch.empty((21, n_), device=dev) if attrs else None

        def run(depth=tb.depth):
            launch("trt_tri_closest_hit", o_, d_, tm, n_, n_, tb.wrows,
                   tb.wrows.shape[0], tb.tree_lo, tb.tree_hi, tb.tree_link,
                   M1, depth, rank, cs, 1, *(tables if attrs else (None,) * 3),
                   int(occl), *outs, attr, None, None, None, 0)
        return run

    def k1_counted(*args, **kw):
        work = counters()
        out = k1(*args, work=work, **kw)
        return out, tuple(int(x) for x in work.tolist())

    k1_const = nbytes(tb.tree_lo, tb.tree_hi, tb.tree_link) + \
        tb.clo.shape[0] * 4
    k1_cols = 96 + sum(a.shape[0] * 4 for a in tables)
    check(refuses_deep_tree(k1_bare(os_, ds_, tm_sub)),
          "K1 refuses a tree deeper than its stack")

    counts: dict = {}
    got, w1s = k1_counted(os_, ds_, tm_sub)
    ref = k1_plain(os_, ds_, tm_sub, counts=counts)
    err = compare_hits("closest+attrs", got, ref, n_sub, attr_rows=4)
    print(f"  bit-equal rays: {equal_rays(got, ref)} of {n_sub}", flush=True)
    # u/v are the true barycentrics on both sides
    same = (got[0] < 1e30) & (ref[0] < 1e30) & (got[1] == ref[1])
    check(bool(((got[2] - ref[2])[same].abs() <= 1e-4).all()
               and ((got[3] - ref[3])[same].abs() <= 1e-4).all()),
          "K1 u/v within 1e-4 on common winners")
    ms = cuda_ms(lambda: k1(os_, ds_, tm_sub))
    bare_sub = cuda_ms(k1_bare(os_, ds_, tm_sub))
    plain_ms = cuda_ms(lambda: k1_plain(os_, ds_, tm_sub))
    b_ms, b_by = hit_bound(n_sub, counts, WOOP_OPS, tri_table_bytes(
        torch, counts, tri, (clo, chi), tables, ref[0], ref[1]), 4 + 21)
    bt_ms, bt_by = work_bound(torch, n_sub, w1s, WOOP_OPS, k1_const,
                              k1_cols, got[0], got[1], 4 + 21, "Woop tests")
    print(f"  subset closest+attrs: wrapper {ms:.3f} ms, bare launch "
          f"{bare_sub:.3f} ms vs plain {plain_ms:.3f} ms at {n_sub} rays; "
          f"bound {b_ms:.4f} ms ({b_by}) from the flat twin's work "
          f"({counts['box'] / n_sub:.1f} slab / {counts['prim'] / n_sub:.1f}"
          f" Woop tests per ray), {bt_ms:.4f} ms ({bt_by}) from the tree "
          f"walk's", flush=True)
    so, sd, stm = shadow_rays(torch, os_, ds_, got[0], light)
    counts = {}
    occ = k1_plain(so, sd, stm, False, True, counts=counts)
    got_occ, w1o = k1_counted(so, sd, stm, False, True)
    compare_hits("occlusion (shadow rays)", got_occ, occ, n_sub,
                 occlusion=True)
    occ_ms = cuda_ms(lambda: k1(so, sd, stm, False, True))
    occ_bare = cuda_ms(k1_bare(so, sd, stm, False, True))
    occ_plain = cuda_ms(lambda: k1_plain(so, sd, stm, False, True))
    bo, bo_by = hit_bound(n_sub, counts, WOOP_OPS, tri_table_bytes(
        torch, counts, tri, (clo, chi), (), occ[0], occ[1]), 4)
    bot, bot_by = work_bound(torch, n_sub, w1o, WOOP_OPS, k1_const, 96,
                             got_occ[0], got_occ[1], 4, "Woop tests")
    print(f"  occlusion: wrapper {occ_ms:.3f} ms, bare launch "
          f"{occ_bare:.3f} ms vs plain {occ_plain:.3f} ms (bound {bo:.4f} "
          f"ms ({bo_by}) from the flat twin's work, {bot:.4f} ms ({bot_by}) "
          f"from the tree walk's)", flush=True)
    # the full frame, as the main path launches K1 on its primary rays
    counts = {}
    got, w1f = k1_counted(o, d, tm_full)
    ref, plain_full = once_ms(torch, lambda: k1_plain(o, d, tm_full,
                                                      counts=counts))
    err_full = compare_hits("closest+attrs, full frame", got, ref, n_full,
                            attr_rows=4)
    print(f"  bit-equal rays: {equal_rays(got, ref)} of {n_full}",
          flush=True)
    bf, bf_by = hit_bound(n_full, counts, WOOP_OPS, tri_table_bytes(
        torch, counts, tri, (clo, chi), tables, ref[0], ref[1]), 4 + 21)
    bft, bft_by = work_bound(torch, n_full, w1f, WOOP_OPS, k1_const,
                             k1_cols, got[0], got[1], 4 + 21, "Woop tests")
    flat_work = (counts["box"], counts["prim"])
    del ref
    ms_full = cuda_ms(lambda: k1(o, d, tm_full))
    bare_full = cuda_ms(k1_bare(o, d, tm_full))
    wrows_ms = cuda_ms(lambda: trk.woop_rows(tri.woop_o, tri.woop_d))
    print(f"  full frame: wrapper {ms_full:.3f} ms, bare launch "
          f"{bare_full:.3f} ms vs plain {plain_full:.1f} ms (once) at "
          f"{n_full} rays; bound {bf:.4f} ms ({bf_by}) from the flat twin's "
          f"work ({flat_work[0] / n_full:.1f} slab / "
          f"{flat_work[1] / n_full:.1f} Woop tests per ray), {bft:.4f} ms "
          f"({bft_by}) from the tree walk's; per-call Woop rows the kept "
          f"tables save: {wrows_ms:.3f} ms", flush=True)
    results["tri_closest_hit"] = dict(
        source=f"{KERNEL_DIR}/tri_hit.cu",
        replaces=f"{JAX_OPS}/tri_kernel.py:77", max_abs_err=err_full,
        ms=ms_full, bare_ms=bare_full, plain_ms=plain_full, bound_ms=bft,
        bound_by=bft_by, flat_bound_ms=bf, flat_bound_by=bf_by,
        library_ms=None, rays=n_full, work=w1f, flat_work=flat_work,
        tree_nodes=M1, tree_depth=tb.depth, table_build_ms=k1_build_ms,
        woop_rows_ms=wrows_ms, subset_ms=ms, subset_bare_ms=bare_sub,
        subset_plain_ms=plain_ms, subset_bound_ms=bt_ms,
        subset_flat_bound_ms=b_ms, subset_rays=n_sub, occlusion_ms=occ_ms,
        occlusion_bare_ms=occ_bare, occlusion_plain_ms=occ_plain,
        occlusion_bound_ms=bot, occlusion_flat_bound_ms=bo)

    # --- K2: config 3 tori at 1080p, config 4 tori on a subset and 1080p --
    def torus_tables(sc):
        t = sc.tori
        return once_ms(torch, lambda: tk.torus_tables(
            t.world_to_obj, t.major_radius, t.minor_radius,
            _material_rows(sc, t.mat_id).contiguous()))

    def k2(tt, o_, d_, tm, attrs=True, occl=False, work=None):
        return tk.torus_closest_hit_chunked(o_, d_, tm, tt, want_attrs=attrs,
                                            occlusion=occl, counters=work)

    def k2_plain(tt, o_, d_, tm, attrs=True, occl=False, counts=None):
        order = visit_order(tt.clo, tt.chi, o_, o_.shape[1])
        return tk.torus_chunked_plain(
            o_, d_, tm, tt.w2o_rows, tt.rad, tt.tor_lo, tt.tor_hi, tt.clo,
            tt.chi, order, tt.chunk, tt.mat if attrs else None, occl,
            counts=counts)

    def k2_bare(tt, o_, d_, tm, attrs=True, occl=False):
        n_ = o_.shape[1]
        rank = tree_rank(visit_order(tt.clo, tt.chi, o_, n_))
        t_ = torch.empty((n_,), device=dev)
        i_ = torch.empty((n_,), dtype=torch.int32, device=dev)
        attr = torch.empty((15, n_), device=dev) if attrs else None

        def run(depth=tt.depth):
            launch("trt_torus_closest_hit", o_, d_, tm, n_, n_, tt.w2o_rows,
                   tt.rad, tt.tree_lo, tt.tree_hi, tt.tree_link,
                   tt.tree_lo.shape[0], depth, rank, tt.chunk,
                   tt.mat if attrs else None, int(occl), t_, i_, attr, None,
                   None, 0)
        return run

    def k2_counted(*args, **kw):
        work = counters()
        out = k2(*args, work=work, **kw)
        return out, tuple(int(x) for x in work.tolist())

    def k2_const(tt):
        return nbytes(tt.tree_lo, tt.tree_hi, tt.tree_link) + \
            tt.clo.shape[0] * 4

    k2_cols = (12 + 2 + 12) * 4   # a winner's transform, radii, material

    def k2_cell(label, tt, o_, d_, tm, plain_timed):
        """K2 closest+attrs on one ray set against the flat twin: the
        comparison, both bounds, wrapper / bare / plain times."""
        n_ = o_.shape[1]
        counts: dict = {}
        got, work = k2_counted(tt, o_, d_, tm)
        if plain_timed:
            ref = k2_plain(tt, o_, d_, tm, counts=counts)
            plain = cuda_ms(lambda: k2_plain(tt, o_, d_, tm))
            plain_note = f"{plain:.3f} ms"
        else:
            ref, plain = once_ms(torch, lambda: k2_plain(tt, o_, d_, tm,
                                                         counts=counts))
            plain_note = f"{plain:.1f} ms (once)"
        err = compare_hits(f"{label} closest+attrs", got, ref, n_,
                           attr_rows=2)
        print(f"  bit-equal rays: {equal_rays(got, ref)} of {n_}",
              flush=True)
        fb, fb_by = hit_bound(n_, counts, QUARTIC_OPS, 0, 2 + 15)
        tb_, tb_by = work_bound(torch, n_, work, QUARTIC_OPS, k2_const(tt),
                                k2_cols, got[0], got[1], 2 + 15, "quartics")
        del ref
        wrapped = cuda_ms(lambda: k2(tt, o_, d_, tm))
        bare = cuda_ms(k2_bare(tt, o_, d_, tm))
        print(f"  {label}: wrapper {wrapped:.3f} ms, bare launch "
              f"{bare:.3f} ms vs plain {plain_note} at {n_} rays; bound "
              f"{fb:.4f} ms ({fb_by}) from the flat twin's work "
              f"({counts['box'] / n_:.1f} slab tests, "
              f"{counts['prim'] / n_:.2f} quartics per ray), {tb_:.4f} ms "
              f"({tb_by}) from the tree walk's", flush=True)
        return dict(ms=wrapped, bare_ms=bare, plain_ms=plain, bound_ms=tb_,
                    bound_by=tb_by, flat_bound_ms=fb, flat_bound_by=fb_by,
                    max_abs_err=err, rays=n_, work=work,
                    flat_work=(counts["box"], counts["prim"]))

    _, s3 = config(3)
    tor = s3.tori
    tt3, tt3_ms = torus_tables(s3)
    print(f"K2 torus_closest_hit (config 3: 4 tori, tree of "
          f"{tt3.tree_lo.shape[0]} nodes, depth {tt3.depth}, tables built in "
          f"{tt3_ms:.1f} ms)", flush=True)
    check(refuses_deep_tree(k2_bare(tt3, os_, ds_, tm_sub)),
          "K2 refuses a tree deeper than its stack")
    c3 = k2_cell("config 3 (4 tori), 1080p", tt3, o, d, tm_full, True)
    _, s4 = config(4)
    tt4, tt4_ms = torus_tables(s4)
    print(f"  config 4: 1,024 tori in {tt4.clo.shape[0]} chunks of "
          f"{tt4.chunk}, tree of {tt4.tree_lo.shape[0]} nodes, depth "
          f"{tt4.depth}, tables built in {tt4_ms:.1f} ms", flush=True)
    cam4 = PinholeCamera(eye=(25.0, 18.0, 25.0), center=(0.0, 0.0, 0.0))
    o4, d4 = rays(cam4, *FULL)
    o4s, d4s = o4[:, sel].contiguous(), d4[:, sel].contiguous()
    c4s = k2_cell("config 4 (1,024 tori), subset", tt4, o4s, d4s, tm_sub,
                  True)
    c4 = k2_cell("config 4 (1,024 tori), 1080p", tt4, o4, d4, tm_full, False)
    # any-hit on config 4's shadow rays: the queue's early exit
    hits4 = k2(tt4, o4, d4, tm_full)[0]
    so4, sd4, stm4 = shadow_rays(torch, o4, d4, hits4, light)
    occ_ref, occ4_plain = once_ms(torch, lambda: k2_plain(
        tt4, so4, sd4, stm4, False, True))
    occ_got, w4o = k2_counted(tt4, so4, sd4, stm4, False, True)
    compare_hits("config 4 any-hit (1080p shadow rays)", occ_got, occ_ref,
                 n_full, occlusion=True)
    del occ_ref
    occ4 = cuda_ms(lambda: k2(tt4, so4, sd4, stm4, False, True))
    occ4_bare = cuda_ms(k2_bare(tt4, so4, sd4, stm4, False, True))
    bo4, bo4_by = work_bound(torch, n_full, w4o, QUARTIC_OPS, k2_const(tt4),
                             0, occ_got[0], occ_got[1], 2, "quartics")
    print(f"  config 4 any-hit: wrapper {occ4:.3f} ms, bare launch "
          f"{occ4_bare:.3f} ms vs plain {occ4_plain:.1f} ms (once); bound "
          f"{bo4:.4f} ms ({bo4_by}) from the tree walk's work", flush=True)
    results["torus_closest_hit"] = dict(
        source=f"{KERNEL_DIR}/torus_hit.cu",
        replaces=f"{JAX_OPS}/torus_kernel.py:136", library_ms=None,
        **c3, table_build_ms=tt3_ms, config4_subset=c4s, config4=c4,
        config4_table_build_ms=tt4_ms, config4_occlusion_ms=occ4,
        config4_occlusion_bare_ms=occ4_bare,
        config4_occlusion_plain_ms=occ4_plain,
        config4_occlusion_bound_ms=bo4, config4_occlusion_work=w4o)

    # --- K3: config 3 at 512x512, config 7's 1080p calls (K = 1) ----------
    def k3_bare(tt, o_, d_, tm, attrs, occl):
        """K3's launch alone, on outputs made once."""
        n_ = o_.shape[1]
        t_ = torch.empty((n_,), device=dev)
        i_ = torch.empty((n_,), dtype=torch.int32, device=dev)
        a_ = torch.empty((15, n_), device=dev) if attrs else None
        return lambda: launch("trt_torus_closest_hit_small", o_, d_, tm, n_,
                              n_, tt.par, tt.K, int(occl), t_, i_, a_, None,
                              None, 0)

    def k3_cell(label, tt, o_, d_, tm, attrs, occl):
        """K3 on one ray set against its twin (any-hit: masks, and idx 0 on
        every ray), its counters against the twin's counts (within K tests
        for each 1e-4 of the rays, as many as the hit masks may differ by),
        the bound from the kernel's counters, wrapper / bare / plain
        times."""
        n_ = o_.shape[1]
        work, counts = counters(), {}
        got = tk.torus_closest_hit_small(o_, d_, tm, tt, want_attrs=attrs,
                                         occlusion=occl, counters=work)
        ref = tk.torus_small_plain(o_, d_, tm, tt.par, attrs, occl,
                                   counts=counts)
        err = compare_hits(label, got, ref, n_,
                           attr_rows=2 if attrs else None, occlusion=occl)
        if occl:
            check(not bool(got[1].any()), f"K3 {label}: idx 0 on every ray")
        work = tuple(int(x) for x in work.tolist())
        twin = (int(counts["box"]), int(counts["prim"]))
        print(f"  {label}: counters (slab tests, quartics) {work}, the "
              f"twin's {twin}", flush=True)
        check(all(abs(a - b) <= tt.K * (1 + n_ // 10_000)
                  for a, b in zip(work, twin)),
              f"K3 {label}: counters agree with the twin's counts")
        b, by = work_bound(torch, n_, work, QUARTIC_OPS, nbytes(tt.par), 0,
                           got[0], got[1], 2 + (15 if attrs else 0),
                           "quartics")
        del got, ref
        wrapped = cuda_ms(lambda: tk.torus_closest_hit_small(
            o_, d_, tm, tt, want_attrs=attrs, occlusion=occl))
        bare = cuda_ms(k3_bare(tt, o_, d_, tm, attrs, occl))
        device = graph_ms(k3_bare(tt, o_, d_, tm, attrs, occl))
        plain = cuda_ms(lambda: tk.torus_small_plain(o_, d_, tm, tt.par,
                                                     attrs, occl))
        print(f"  {label}: wrapper {wrapped:.4f} ms, bare launch {bare:.4f} "
              f"ms ({device:.4f} ms on the device, in a graph) vs plain "
              f"{plain:.3f} ms at {n_} rays; bound {b:.4f} ms ({by}) from "
              "the kernel's work", flush=True)
        return dict(ms=wrapped, bare_ms=bare, device_ms=device,
                    plain_ms=plain, bound_ms=b, bound_by=by, max_abs_err=err,
                    rays=n_, work=work)

    print(f"K3 torus_closest_hit_small (config 3 at {K3_RES}x{K3_RES}: "
          f"{tt3.K} tori)", flush=True)
    o5, d5 = rays(cam36, K3_RES, K3_RES)
    n5 = o5.shape[1]
    tm5 = torch.full((n5,), 1e4, device=dev)
    check(tk.use_small_kernel(round_up(n5, 2048), tt3.K),
          f"{K3_RES}x{K3_RES} config 3 routes to K3")
    k3c = k3_cell("config 3 closest+attrs", tt3, o5, d5, tm5, True, False)
    so5, sd5, stm5 = shadow_rays(torch, o5, d5, tk.torus_closest_hit_small(
        o5, d5, tm5, tt3)[0], light)
    k3o = k3_cell("config 3 any-hit (shadow rays)", tt3, so5, sd5, stm5,
                  False, True)
    params_ms = cuda_ms(lambda: tk.small_params(
        tor.world_to_obj, tor.major_radius, tor.minor_radius,
        tt3.mat[:tt3.K]))
    print(f"  per-call parameter blocks the kept tables save: "
          f"{params_ms:.3f} ms", flush=True)

    # config 7 at 1080p through render: its K3 calls (the mirror torus,
    # K = 1) and its K4 calls (primary hits, then a bounce), as the main
    # path makes them
    sc7, s7 = config(7)
    k3_calls, k4_calls = [], []
    real_k3, real_k4 = tk.torus_closest_hit_small, wavefront.quad_gather

    def record_k3(o_, d_, tm, tables, want_attrs=False, occlusion=False,
                  **kw):
        k3_calls.append((tables, o_.clone(), d_.clone(), tm.clone(),
                         want_attrs, occlusion))
        return real_k3(o_, d_, tm, tables, want_attrs=want_attrs,
                       occlusion=occlusion, **kw)

    def record_k4(*args, **kw):
        k4_calls.append(tuple(a.clone() for a in args))
        return real_k4(*args, **kw)

    tk.torus_closest_hit_small, wavefront.quad_gather = (record_k3,
                                                         record_k4)
    try:
        render(s7, sc7.camera, *FULL, sc7.settings(), backend="kernel",
               device=DEVICE)
    finally:
        tk.torus_closest_hit_small, wavefront.quad_gather = real_k3, real_k4
    print(f"K3 on config 7's 1080p calls ({len(k3_calls)} per frame, K = "
          f"{k3_calls[0][0].K})", flush=True)
    k7 = {}
    for occl in (False, True):
        call = next(c for c in k3_calls if c[5] == occl)
        k7[occl] = k3_cell(f"config 7 {'any-hit' if occl else 'closest'}"
                           f"{'' if occl else '+attrs'} (first call)",
                           *call[:4], call[4], occl)
    results["torus_closest_hit_small"] = dict(
        source=f"{KERNEL_DIR}/torus_hit.cu",
        replaces=f"{JAX_OPS}/torus_kernel.py:530", library_ms=None, **k3c,
        config3_occlusion=k3o, config7=k7[False], config7_occlusion=k7[True],
        small_params_ms=params_ms)

    # --- K4: config 7's 1080p texel indices ---------------------------------
    def k4_cell(label, data4q, f0, f1, valid):
        """K4 against its twin and the library gather; wrapper, bare, plain
        and library times; the bound from the bytes the call moves: the
        indices and flags in, the words out, and the atlas rows its valid
        indices touch."""
        n_, T = f0.shape[0], data4q.shape[0]
        ref = txk.quad_gather_plain(data4q, f0, f1, valid)
        eq = bit_equal(txk.quad_gather(data4q, f0, f1, valid), ref)
        rows = int(torch.cat([f[valid & (f >= 0) & (f < T)]
                              for f in (f0, f1)]).unique().numel())
        print(f"  {label}: {n_} rays, {int(valid.sum())} valid, atlas {T} "
              f"texels ({rows} touched): words bit-equal {eq}", flush=True)
        check(eq, f"K4 {label} bit-equal to its plain twin")

        def library():
            # (S2 leaves an invalid lane's indices undefined: masked)
            return tuple(torch.where(valid[None, :],
                                     data4q[torch.where(valid, f, 0).long()].T,
                                     0) for f in (f0, f1))

        check(bit_equal(library(), ref),
              f"K4 {label}: library gather computes the same")
        q0, q1 = (torch.empty((3, n_), dtype=torch.int32, device=dev)
                  for _ in range(2))

        def run():
            launch("trt_quad_gather", data4q, T, f0, f1, valid, n_, q0, q1)

        wrapped = cuda_ms(lambda: txk.quad_gather(data4q, f0, f1, valid))
        bare = cuda_ms(run)
        device = graph_ms(run)
        plain = cuda_ms(lambda: txk.quad_gather_plain(data4q, f0, f1, valid))
        lib = cuda_ms(library)
        moved = nbytes(f0, f1, valid) + rows * 12 + 2 * 3 * 4 * n_
        b, by = bound(moved, 0)
        print(f"  {label}: wrapper {wrapped:.4f} ms, bare launch {bare:.4f} "
              f"ms ({device:.4f} ms on the device, in a graph) vs plain "
              f"{plain:.4f} ms vs library {lib:.4f} ms; bound {b:.4f} ms "
              f"({by}: {moved / 1e6:.2f} MB); device / bound "
              f"{device / b:.2f}", flush=True)
        return dict(ms=wrapped, bare_ms=bare, device_ms=device,
                    plain_ms=plain, library_ms=lib, bound_ms=b, bound_by=by,
                    bound_bytes=moved, atlas_rows_touched=rows, rays=n_)

    print(f"K4 quad_gather (config 7 at 1080p, {len(k4_calls)} calls per "
          "frame)", flush=True)
    k4p = k4_cell("primary hits", *k4_calls[0])
    k4b = k4_cell("first bounce", *k4_calls[1])
    results["quad_gather"] = dict(
        source=f"{KERNEL_DIR}/tex_gather.cu",
        replaces=f"{JAX_OPS}/tex_kernel.py:57", max_abs_err=0.0, **k4p,
        bounce=k4b)

    # --- K5 / K6: config 8, 1.18M triangles ---------------------------------
    phase_stream(torch, results, rays, light)

    # --- the jitter draw: config 5's shape ------------------------------
    threefry_row(torch, results)


def threefry_row(torch, results):
    """The threefry kernel against its twin `utils.prng.uniform`, bit for
    bit (float words as uint32), at config 5's (3840*2160, 2) and at (n,)
    and (n, 2) for n in 1, 3, 4099 (tails of 1-3 elements); times of the
    wrapper, the bare launch, its device time in a CUDA graph and the twin
    on the card; the bound from the 4 bytes written and THREEFRY_INT_OPS
    int32 operations (at the 128 lanes a clock the SM issues) plus one f32
    subtract a float. No PyTorch call computes threefry-2x32 (`torch.rand`
    is Philox), so library_ms is null."""
    from toroidal_ray_tracing_tpu_torch.experiments.k3_turns import graph_ms
    from toroidal_ray_tracing_tpu_torch.ops import threefry_kernel as tfk
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import launch
    from toroidal_ray_tracing_tpu_torch.utils import prng

    key = prng.fold_in(prng.prng_key(0), 1)
    shape = (JITTER_PIXELS, 2)
    worst = 0.0
    for shp in ((1,), (3,), (4099,), (1, 2), (3, 2), (4099, 2), shape):
        got = tfk.uniform(key, shp, DEVICE)
        ref = prng.uniform(key, shp, DEVICE)
        eq = torch.equal(got.view(torch.int32), ref.view(torch.int32))
        err = float((got - ref).abs().max())
        worst = max(worst, err)
        check(eq and got.shape == ref.shape,
              f"threefry_uniform {shp} bit-equal to its twin (max abs "
              f"diff {err:.1e})")
    n = JITTER_PIXELS * 2
    out = torch.empty(shape, device=DEVICE)

    def run():
        launch("trt_threefry_uniform", out, n, *key)

    wrapped = cuda_ms(lambda: tfk.uniform(key, shape, DEVICE), reps=10)
    bare = cuda_ms(run, reps=10)
    device = graph_ms(run)
    plain = cuda_ms(lambda: prng.uniform(key, shape, DEVICE), reps=10)
    b, by = bound(n * 4, n, n * THREEFRY_INT_OPS)
    print(f"threefry_uniform {shape}: wrapper {wrapped:.4f} ms, bare "
          f"launch {bare:.4f} ms ({device:.4f} ms on the device, in a "
          f"graph) vs plain {plain:.3f} ms; bound {b:.4f} ms ({by}: "
          f"{n * 4 / 1e6:.1f} MB, {n * THREEFRY_INT_OPS / 1e9:.3f}e9 int32 "
          f"operations); device / bound {device / b:.2f}", flush=True)
    results["threefry_uniform"] = dict(
        source=f"{KERNEL_DIR}/threefry.cu",
        replaces="toroidal_ray_tracing_tpu/render/renderer.py:53",
        max_abs_err=worst, ms=wrapped, bare_ms=bare, device_ms=device,
        plain_ms=plain, library_ms=None, bound_ms=b, bound_by=by,
        elements=n)


def stream_bound(torch, n, work, st, attr_tables, t, idx, out_rows):
    """bound_ms of a K5/K6 call on n rays from the kernel's own counters
    (work_bound): the tree's node boxes and links, the cluster boxes and
    the rank every call reads; the Woop row (96 B) and attribute columns of
    each distinct winner."""
    cols = 96 + (sum(a.shape[0] * 4 for a in attr_tables)
                 if attr_tables is not None else 0)
    const = nbytes(st.tree_lo, st.tree_hi, st.tree_link, st.clo, st.chi) \
        + st.sb_lo.shape[0] * 4
    return work_bound(torch, n, work, WOOP_OPS, const, cols, t, idx,
                      out_rows, "Woop tests")


def phase_stream(torch, results, rays, light):
    """K5 and K6 on config 8: the patch against the flat twin (its counts
    beside the tree walk's), then the full 1080p frame, closest+attrs and
    the shadow rays any-hit, with bounds from the kernels' counters; the
    per-call table preparation against the bare launch."""
    from toroidal_ray_tracing_tpu_torch.ops import tri_stream as tsk
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
        _inv_dir, box_pass, launch, tree_rank, visit_order)
    from toroidal_ray_tracing_tpu_torch.ops.tri_kernel import woop_rows

    dev = torch.device(DEVICE)
    sc8, s8 = config(8)
    tri8 = s8.triangles
    cs8 = s8.cluster_size
    clo8, chi8, tables8 = hoisted_tables(torch, s8)
    sync(torch)
    t0 = time.perf_counter()
    st = tsk.stream_tables(tri8.woop_o, tri8.woop_d, clo8, chi8, cs8)
    sync(torch)
    build_ms = (time.perf_counter() - t0) * 1e3
    S, M = st.sb_lo.shape[0], st.tree_lo.shape[0]
    print(f"K5 tri_closest_hit_stream (config 8: {tri8.count} triangles, "
          f"{st.clo.shape[0]} clusters, {S} superblocks of {st.g}; tree of "
          f"{M} nodes, {(M + 1) // 2} leaves, depth {st.depth}, built in "
          f"{build_ms:.1f} ms)", flush=True)
    o8, d8 = rays(sc8.camera, *FULL)
    n8 = o8.shape[1]
    start = (n8 // 2) // PATCH * PATCH
    op, dp = (a[:, start:start + PATCH].contiguous() for a in (o8, d8))
    tm_p = torch.full((PATCH,), 1e4, device=dev)

    def k5(o_, d_, tm, attrs=True, occl=False, group=0, work=None):
        return tsk.tri_closest_hit_stream(
            o_, d_, tm, st, attr_tables=tables8 if attrs else None,
            occlusion=occl, group=group, counters=work)

    def counted_call(*args, **kw):
        work = torch.zeros(2, dtype=torch.int64, device=dev)
        out = k5(*args, work=work, **kw)
        return out, tuple(int(x) for x in work.tolist())

    def k5_plain(counts=None):
        order = visit_order(st.sb_lo, st.sb_hi, op, PATCH)
        return tsk.tri_closest_hit_stream_plain(
            op, dp, tm_p, st.wrows, st.sb_lo, st.sb_hi, order, st.clo,
            st.chi, st.g, cs8, tables8, counts=counts)

    counts: dict = {}
    t0 = time.perf_counter()
    ref = k5_plain(counts)
    sync(torch)
    plain8 = (time.perf_counter() - t0) * 1e3
    got, w5p = counted_call(op, dp, tm_p)
    err8 = compare_hits(f"closest+attrs, patch of {PATCH} block-major rays",
                        got, ref, PATCH, attr_rows=4)
    print(f"  K5 bit-equal to its twin on the patch: {bit_equal(got, ref)}",
          flush=True)
    got6, w6p = counted_call(op, dp, tm_p, group=16)
    check(bit_equal(got6, got), "K6 bit-equal to K5 on the patch")
    so, sd, stm = shadow_rays(torch, op, dp, got[0], light)
    compare_hits("any-hit, the patch's shadow rays",
                 k5(so, sd, stm, False, True),
                 tsk.tri_closest_hit_stream_plain(
                     so, sd, stm, st.wrows, st.sb_lo, st.sb_hi,
                     visit_order(st.sb_lo, st.sb_hi, so, PATCH), st.clo,
                     st.chi, st.g, cs8, None, True), PATCH, occlusion=True)
    print(f"  per ray on the patch: flat twin {counts['box'] / PATCH:.1f} "
          f"slab / {counts['prim'] / PATCH:.1f} Woop tests; K5 tree "
          f"{w5p[0] / PATCH:.1f} / {w5p[1] / PATCH:.1f}; K6 packet "
          f"{w6p[0] / PATCH:.1f} / {w6p[1] / PATCH:.1f}", flush=True)
    ms8 = cuda_ms(lambda: k5(op, dp, tm_p))
    ms6 = cuda_ms(lambda: k5(op, dp, tm_p, group=16))
    b8, b8_by = hit_bound(PATCH, counts, WOOP_OPS, tri_table_bytes(
        torch, counts, tri8, (clo8, chi8), tables8, ref[0], ref[1]), 4 + 21)
    bt8, bt8_by = stream_bound(torch, PATCH, w5p, st, tables8, got[0],
                               got[1], 4 + 21)
    print(f"  patch: K5 {ms8:.3f} ms, K6 {ms6:.3f} ms vs plain {plain8:.1f} "
          f"ms (once); bound {b8:.4f} ms ({b8_by}) from the flat twin's "
          f"work, {bt8:.4f} ms ({bt8_by}) from the tree walk's", flush=True)

    print("K5 vs K6 on the full 1080p frame", flush=True)
    tm8 = torch.full((n8,), 1e4, device=dev)
    full5, w5 = counted_call(o8, d8, tm8)
    full6, w6 = counted_call(o8, d8, tm8, group=16)
    check(bit_equal(full5, full6), "K6 bit-equal to K5, closest+attrs, 1080p")
    so, sd, stm = shadow_rays(torch, o8, d8, full5[0], light)
    occ5, wo5 = counted_call(so, sd, stm, False, True)
    occ6, wo6 = counted_call(so, sd, stm, False, True, group=16)
    check(torch.equal(occ5[0] < 1e30, occ6[0] < 1e30),
          "K6 any-hit masks equal to K5's, 1080p shadow rays")
    # A ray's result does not depend on the other rays of its batch: hold
    # both kernels' full-frame outputs against the flat twin on a sample,
    # with the visit order of the whole frame. The sample: every
    # FRAME_STRIDE-th ray (all over the frame), and as many again spread
    # over the rays that enter the tree's root box (where every hit,
    # silhouette and incoherent warp lies).
    def sample(o_, d_, tm):
        every = torch.arange(0, n8, FRAME_STRIDE, device=dev)
        near = torch.nonzero(box_pass(st.tree_lo[0], st.tree_hi[0], o_,
                                      _inv_dir(d_), tm, tm))[:, 0]
        step = max(1, near.shape[0] // every.shape[0])
        return torch.unique(torch.cat([every, near[::step]]))

    def twin_at(pick, o_, d_, tm, attrs, occl):
        return tsk.tri_closest_hit_stream_plain(
            o_[:, pick].contiguous(), d_[:, pick].contiguous(),
            tm[pick].contiguous(), st.wrows, st.sb_lo, st.sb_hi,
            visit_order(st.sb_lo, st.sb_hi, o_, n8), st.clo, st.chi, st.g,
            cs8, attrs, occl)

    pick = sample(o8, d8, tm8)
    m8 = pick.shape[0]
    ref, twin_frame = once_ms(torch, lambda: twin_at(pick, o8, d8, tm8,
                                                     tables8, False))
    frame_err = {}
    for name, out in (("K5", full5), ("K6", full6)):
        got = tuple(x[..., pick] for x in out)
        frame_err[name] = compare_hits(
            f"{name} closest+attrs, {m8} sampled rays of the 1080p frame",
            got, ref, m8, attr_rows=4)
        print(f"  {name} bit-equal to its twin there: {bit_equal(got, ref)}",
              flush=True)
    pick = sample(so, sd, stm)
    m8o = pick.shape[0]
    ref, twin_occ = once_ms(torch, lambda: twin_at(pick, so, sd, stm, None,
                                                   True))
    for name, out in (("K5", occ5), ("K6", occ6)):
        compare_hits(f"{name} any-hit, {m8o} sampled shadow rays",
                     tuple(x[pick] for x in out), ref, m8o, occlusion=True)
    del ref
    print(f"  flat twin on the samples: {twin_frame:.0f} ms closest+attrs, "
          f"{twin_occ:.0f} ms any-hit (once)", flush=True)
    hits = int((full5[0] < 1e30).sum())
    live = int((stm > 1e-3).sum())
    f5 = cuda_ms(lambda: k5(o8, d8, tm8))
    f6 = cuda_ms(lambda: k5(o8, d8, tm8, group=16))
    fo5 = cuda_ms(lambda: k5(so, sd, stm, False, True))
    fo6 = cuda_ms(lambda: k5(so, sd, stm, False, True, group=16))
    print(f"  {n8} rays, {hits} hits, {live} live shadow rays: closest+attrs "
          f"K5 {f5:.3f} ms, K6 {f6:.3f} ms; any-hit K5 {fo5:.3f} ms, K6 "
          f"{fo6:.3f} ms", flush=True)
    bounds = {}
    for name, n_, work, out, tabs, rows in (
            ("K5 closest+attrs", n8, w5, full5, tables8, 4 + 21),
            ("K6 closest+attrs", n8, w6, full6, tables8, 4 + 21),
            ("K5 any-hit", n8, wo5, occ5, None, 4),
            ("K6 any-hit", n8, wo6, occ6, None, 4)):
        print(f" {name}:", flush=True)
        bounds[name] = stream_bound(torch, n_, work, st, tabs, out[0],
                                    out[1], rows)

    # the per-call table preparation the per-scene tables save, against
    # the wrapper (rank, checks, allocations) and the bare launch
    order8 = visit_order(st.sb_lo, st.sb_hi, o8, n8)
    rank8 = tree_rank(order8)
    outs = [torch.empty((n8,), device=dev) for _ in range(4)]
    outs[1] = outs[1].to(torch.int32)
    attrs8 = torch.empty((21, n8), device=dev)

    def bare(entry="", depth=st.depth):
        launch("trt_tri_closest_hit_stream" + entry, o8, d8, tm8, n8, n8,
               st.wrows, st.wrows.shape[0], st.tree_lo, st.tree_hi,
               st.tree_link, M, depth, rank8, st.clo, st.chi, st.g, cs8,
               *tables8, 0, *outs, attrs8, None, None, None, 0)

    refused = 0
    for entry in ("", "_grouped"):
        try:
            bare(entry, depth=1 << 20)
        except RuntimeError:
            refused += 1
    check(refused == 2, "K5 and K6 refuse a tree deeper than their stack")
    bare_ms = cuda_ms(bare)
    bare6_ms = cuda_ms(lambda: bare("_grouped"))
    wrows_ms = cuda_ms(lambda: woop_rows(tri8.woop_o, tri8.woop_d))
    sb_ms = cuda_ms(lambda: tsk.superblocks(clo8, chi8, cs8))
    cat_ms = cuda_ms(lambda: hoisted_tables(torch, s8)[:2])
    print(f"  full frame: K5 wrapper {f5:.3f} ms, bare launch {bare_ms:.3f} "
          f"ms; K6 wrapper {f6:.3f} ms, bare launch {bare6_ms:.3f} ms; "
          f"per-call preparation kept per scene: Woop rows "
          f"{wrows_ms:.3f} ms, superblocks {sb_ms:.3f} ms, tree "
          f"{build_ms:.1f} ms (stream_tables, host), hoisted cluster boxes "
          f"and attribute tables {cat_ms:.3f} ms", flush=True)
    # a host scene has one copy on the card (Scene.to, which render()
    # calls); the copy shares the scene's tables
    from toroidal_ray_tracing_tpu_torch import render
    from toroidal_ray_tracing_tpu_torch.render.renderer import check_device

    def render8(scene):
        return render(scene, sc8.camera, *FULL, sc8.settings(),
                      backend="kernel", device=DEVICE)

    host8 = _HOST_SCENES[sc8.name]
    first, host_first = once_ms(torch, lambda: render8(host8))
    _, host_again = once_ms(torch, lambda: render8(host8))
    again, card_ms = once_ms(torch, lambda: render8(s8))
    check(torch.equal(first["image"], again["image"]),
          "config 8 renders the same from the host scene")
    dev8 = check_device(DEVICE)
    check(host8.to(dev8) is host8.to(DEVICE) is s8,
          "a host scene's copy on the card is made once (one object on "
          "every call)")
    print(f"  render of config 8 from the host scene: {host_first:.1f} ms "
          f"(first call), {host_again:.1f} ms (second); from the scene "
          f"on the card {card_ms:.1f} ms (one call each; all three render "
          "the scene's one copy on the card)", flush=True)
    common = dict(plain_ms=plain8, plain_rays=PATCH, library_ms=None,
                  rays=n8, patch_bound_ms=b8, patch_bound_tree_ms=bt8,
                  patch_flat_work=(counts["box"], counts["prim"]),
                  tree_depth=st.depth, tree_nodes=M, table_build_ms=build_ms,
                  woop_rows_ms=wrows_ms, superblocks_ms=sb_ms,
                  boxes_tables_ms=cat_ms, frame_twin_rays=(m8, m8o),
                  frame_twin_ms=twin_frame,
                  frame_twin_occlusion_ms=twin_occ,
                  render_host_scene_ms=(host_first, host_again),
                  render_card_scene_ms=card_ms)
    results["tri_closest_hit_stream"] = dict(
        source=f"{KERNEL_DIR}/tri_stream.cu",
        replaces=f"{JAX_OPS}/tri_stream.py:202",
        max_abs_err=max(err8, frame_err["K5"]), ms=f5,
        bound_ms=bounds["K5 closest+attrs"][0],
        bound_by=bounds["K5 closest+attrs"][1], occlusion_ms=fo5,
        occlusion_bound_ms=bounds["K5 any-hit"][0], work=w5,
        occlusion_work=wo5, patch_ms=ms8, patch_work=w5p,
        bare_launch_ms=bare_ms, **common)
    results["tri_closest_hit_stream_grouped"] = dict(
        source=f"{KERNEL_DIR}/tri_stream.cu",
        replaces=f"{JAX_OPS}/tri_stream.py:303",
        max_abs_err=max(err8, frame_err["K6"]), ms=f6,
        bound_ms=bounds["K6 closest+attrs"][0],
        bound_by=bounds["K6 closest+attrs"][1], occlusion_ms=fo6,
        occlusion_bound_ms=bounds["K6 any-hit"][0], work=w6,
        occlusion_work=wo6, patch_ms=ms6, patch_work=w6p,
        bare_launch_ms=bare6_ms, **common)


def write_ppm(path, image):
    import numpy as np

    img = (np.clip(image, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img.tobytes())


def main_cells():
    """(name, scene key, build, camera, settings, width, height, kernels
    that must launch, stream group)."""
    from toroidal_ray_tracing_tpu_torch.cameras import ToroidalCamera
    from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
    from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings,
                                                      build_scene, procedural)

    W, H = FULL
    cells = []
    # config 3 at 1080p: K2 on its whole-frame segment, K3 on the
    # compacted prefixes (n/2 and below route to K3, as on the TPU)
    for num, needs in ((3, ["torus_closest_hit", "torus_closest_hit_small"]),
                       (6, ["tri_closest_hit"]),
                       (4, ["torus_closest_hit"]),
                       (7, ["tri_closest_hit", "torus_closest_hit_small",
                            "quad_gather"]),
                       (8, ["tri_closest_hit_stream"])):
        sc = SCENARIOS[num]
        cells.append((sc.name, sc.name, sc.build, sc.camera, sc.settings(),
                      W, H, needs, 0))
    sc3 = SCENARIOS[3]
    cells.insert(1, ("config3_multi_torus_k3", sc3.name, sc3.build,
                     sc3.camera, sc3.settings(), K3_RES, K3_RES,
                     ["torus_closest_hit_small"], 0))
    # the capture experiment's settings (reference default depth 10)
    cells.insert(4, ("cornellish_toroidal_rho4", "cornellish",
                     lambda: build_scene(procedural.scene_cornellish()),
                     ToroidalCamera(eye=(0.0, 1.0, 0.0),
                                    center=(8.0, 0.0, 0.0)),
                     RenderSettings.default(rho=4.0), W, H,
                     ["tri_closest_hit"], 0))
    sc8 = SCENARIOS[8]
    cells.append(("config8_streamed_mesh_k6", sc8.name, sc8.build,
                  sc8.camera, sc8.settings(), W, H,
                  ["tri_closest_hit_stream_grouped"], 16))
    return cells


def counted(LAUNCHES, reset, fn):
    """Run one path with the launch counts set to 0 just before it; return
    (its result, the counts read just after). Each kernel-backend segment
    it traces on the card is checked (`SegmentGuard`, tallied in
    `SEGMENTS`), and its front-door launches (`FrontGuard`: R1 and F1 once
    a sample, G1 once a shrink, tallied in `FRONT`)."""
    with SegmentGuard(LAUNCHES) as guard, FrontGuard(LAUNCHES) as front:
        reset()
        out = fn()
    SEGMENTS["checked"] += guard.segments
    SEGMENTS["bad"] += guard.bad
    FRONT["samples"] += front.samples
    FRONT["shrinks"] += front.shrinks
    FRONT["bad"] += front.bad
    return out, dict(LAUNCHES)


def phase_main_path(torch, totals):
    from toroidal_ray_tracing_tpu_torch import (render, render_frames,
                                                render_sequence, tonemap)
    from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
    from toroidal_ray_tracing_tpu_torch.ops import tri_stream
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
        LAUNCHES, reset_launches)

    cells = main_cells()
    os.makedirs(OUT_DIR, exist_ok=True)

    def add(launched):
        for k, v in launched.items():
            totals[k] = totals.get(k, 0) + v

    stats, images = [], {}
    for name, key, build, cam, st, w, h, needs, group in cells:
        scene = scene_of(key, build)
        tri_stream.STREAM_GROUP = group

        def run():
            out = render(scene, cam, w, h, st, backend="kernel",
                         device=DEVICE)
            sync(torch)
            return out

        def timed():
            out = run()                               # warm-up
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                out = run()
                times.append((time.perf_counter() - t0) * 1e3)
            return out, statistics.median(times)

        (out, ms), launched = counted(LAUNCHES, reset_launches, timed)
        tri_stream.STREAM_GROUP = 0
        add(launched)
        rays = out["rays_traced"]
        print(f"{name} {w}x{h}: {ms:.2f} ms/frame (median of 3), "
              f"{rays} rays/frame, {rays / ms / 1e3:.2f} Mrays/s, "
              f"launches {launched}", flush=True)
        img = out["image"]
        images[name] = img
        check(tuple(img.shape) == (h, w, 3)
              and bool(torch.isfinite(img).all()), f"{name}: image finite")
        for k in needs:
            check(launched[k] > 0, f"{name}: {k} launched")
        check(launched["raygen"] == launched["frame_finish"] == 4,
              f"{name}: R1 and F1 once a sample (4 frames: "
              f"{launched['raygen']}, {launched['frame_finish']}), G1 "
              f"{launched['span_gather']} times (once a shrink, FrontGuard)")
        stats.append(dict(cell=name, width=w, height=h, ms_per_frame=ms,
                          rays_per_frame=rays,
                          mrays_per_s=rays / ms / 1e3, launches=launched))
    check(torch.equal(images["config8_streamed_mesh_k6"],
                      images["config8_streamed_mesh"]),
          "config 8 frame through K6 bit-equal to the K5 frame")

    # render_frames over config 7's orbit, render_sequence over config 8's
    for num, front, n_frames, needs in (
            (7, "render_frames", 4,
             ["tri_closest_hit", "torus_closest_hit_small", "quad_gather"]),
            (8, "render_sequence", 2, ["tri_closest_hit_stream"])):
        sc, scene = config(num)
        cams = sc.cameras_seq(n_frames)
        st = sc.settings()
        fn = render_frames if front == "render_frames" else render_sequence

        def run():
            t0 = time.perf_counter()
            out = fn(scene, cams, *FULL, st, backend="kernel", device=DEVICE)
            sync(torch)
            return out, (time.perf_counter() - t0) * 1e3

        (out, ms), launched = counted(LAUNCHES, reset_launches, run)
        add(launched)
        print(f"{front} {sc.name} x{n_frames} at {FULL[0]}x{FULL[1]}: "
              f"{ms:.1f} ms, {out['rays_traced']} rays, launches "
              f"{launched}", flush=True)
        for k in needs:
            check(launched[k] > 0, f"{front} {sc.name}: {k} launched")
        check(launched["raygen"] == launched["frame_finish"] == n_frames,
              f"{front} {sc.name}: R1 and F1 once a frame "
              f"({launched['raygen']}, {launched['frame_finish']})")
        worst, total = 0.0, 0
        for f, cam in enumerate(cams):
            one = render(scene, cam, *FULL, st, backend="kernel",
                         device=DEVICE)
            got = out["images"][f]
            if front == "render_frames":
                got = got.permute(1, 2, 0)
            worst = max(worst, float((got - one["image"]).abs().max()))
            total += one["rays_traced"]
        check(worst <= 1e-6 and out["rays_traced"] == total,
              f"{front} {sc.name}: each frame equals render (max diff "
              f"{worst:.2e}), rays {out['rays_traced']} == {total}")
        stats.append(dict(cell=f"{front}_{sc.name}", frames=n_frames,
                          ms=ms, rays=out["rays_traced"], launches=launched))
    stats.extend(config5_renders(torch, counted, add))
    for k, v in totals.items():
        check(v > 0, f"main path launched {k} ({v} times)")

    # each scene on both backends: kernel against torch
    for name, key, _, cam, st, w, h, _, group in cells:
        if (w, h) != FULL or group:
            continue
        cw, ch = CHECK_RES_C8 if key == SCENARIOS[8].name else CHECK_RES
        a = render(_SCENES[key], cam, cw, ch, st, backend="kernel",
                   device=DEVICE)
        t0 = time.perf_counter()
        b = render(_SCENES[key], cam, cw, ch, st, backend="torch",
                   device=DEVICE)
        torch_s = time.perf_counter() - t0
        print(f"{name} {cw}x{ch} kernel vs torch: rays {a['rays_traced']} "
              f"vs {b['rays_traced']} (torch backend {torch_s:.1f} s)",
              flush=True)
        agree(torch, f"{name} {cw}x{ch} kernel vs torch", a["image"],
              b["image"])
        write_ppm(os.path.join(OUT_DIR, f"chip_smoke_{name}.ppm"),
                  tonemap(a["image"]).cpu().numpy())
    return stats, cells


def config5_renders(torch, counted, add):
    """Config 5's frame 0 at 3840x2160, 2 spp, through `render` and through
    its banded path (tile_rows=540), each counted: sample 1's jitter is one
    threefry kernel launch, and the image is bit-equal to the same render
    with the jitter drawn by the kernel's twin on the card. Then one
    `render` frame under torch.profiler: device busy, idle share, CUDA
    events and the kernels' ms."""
    from toroidal_ray_tracing_tpu_torch import render
    from toroidal_ray_tracing_tpu_torch.ops import threefry_kernel as tfk
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
        LAUNCHES, reset_launches)
    from toroidal_ray_tracing_tpu_torch.utils import prng

    sc, scene = config(5)
    cam, st = sc.camera_at(0), sc.settings()
    rows = []
    for tile_rows in (None, 540):
        def run():
            return once_ms(torch, lambda: render(
                scene, cam, sc.width, sc.height, st, backend="kernel",
                spp=sc.spp, tile_rows=tile_rows, device=DEVICE))

        run()                                          # warm-up
        (out, ms), launched = counted(LAUNCHES, reset_launches, run)
        add(launched)
        real = tfk.uniform
        tfk.uniform = prng.uniform
        try:
            twin, _ = run()
        finally:
            tfk.uniform = real
        name = f"render {sc.name}" + (f" tile_rows={tile_rows}"
                                      if tile_rows else "")
        print(f"{name} {sc.width}x{sc.height}, {sc.spp} spp: {ms:.1f} ms, "
              f"{out['rays_traced']} rays, launches {launched}", flush=True)
        check(launched["threefry_uniform"] == sc.spp - 1
              and all(launched[k] > 0 for k in ("torus_closest_hit",
                                                "torus_closest_hit_small")),
              f"{name}: {sc.spp - 1} threefry_uniform launch, K2 and K3 "
              "launched")
        check(launched["raygen"] == sc.spp and launched["frame_finish"] == (
            sc.spp if tile_rows is None else 0),
              f"{name}: R1 once a sample ({launched['raygen']}), F1 once a "
              f"sample unbanded ({launched['frame_finish']}; the banded "
              f"path accumulates its bands eagerly), G1 "
              f"{launched['span_gather']} times")
        check(bool(torch.isfinite(out["image"]).all())
              and torch.equal(out["image"], twin["image"])
              and out["rays_traced"] == twin["rays_traced"],
              f"{name}: finite, bit-equal to the twin-drawn render")
        rows.append(dict(cell=name.replace(" ", "_"), ms=ms, spp=sc.spp,
                         rays=out["rays_traced"], launches=launched))
    busy, events, mine = profile_frame(torch, lambda: render(
        scene, cam, sc.width, sc.height, st, backend="kernel", spp=sc.spp,
        device=DEVICE))
    ms = rows[0]["ms"]
    idle = None if busy is None else max(0.0, 1.0 - busy / ms)
    print(f"render {sc.name} profiled: device busy {busy} ms of {ms:.1f}, "
          f"idle share {idle}, {events} CUDA events, our kernels (ms, "
          f"calls) {mine}", flush=True)
    rows[0].update(busy_ms=busy, idle_share=idle, cuda_events=events,
                   kernels_ms=mine)
    return rows


def phase_goldens(torch):
    import numpy as np

    from toroidal_ray_tracing_tpu_torch import render
    from toroidal_ray_tracing_tpu_torch.cameras import (PinholeCamera,
                                                        ToroidalCamera)
    from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings,
                                                      build_scene, procedural)

    cases = {
        "multi_torus_pinhole": (
            procedural.scene_multi_torus(True),
            PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0)),
            RenderSettings.default(max_depth=3)),
        "cornellish_toroidal": (
            procedural.scene_cornellish(),
            ToroidalCamera(eye=(0.0, 1.0, 0.0), center=(8.0, 0.0, 0.0)),
            RenderSettings.default(max_depth=2, rho=5.0)),
        "torus_plane_shadow": (
            procedural.scene_torus_plane(True),
            PinholeCamera(eye=(7.0, 4.0, 7.0), center=(0.0, 0.5, 0.0)),
            RenderSettings.default(max_depth=1,
                                   light_position=(6.0, 10.0, 2.0))),
        "textured_mesh": (
            procedural.scene_textured_mesh(),
            PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0)),
            RenderSettings.default(max_depth=3)),
    }
    for name, (sd, cam, st) in cases.items():
        want = np.load(os.path.join(ROOT, "tests", "golden",
                                    f"{name}.npz"))["image"]
        scene = build_scene(sd).to(DEVICE)
        for backend in ("torch", "kernel"):
            got = render(scene, cam, 32, 32, st, backend=backend,
                         device=DEVICE)["image"].cpu().numpy()
            err = float(np.abs(got - want).max())
            check(err < 5e-4, f"golden {name} ({backend}): max diff {err:.2e}")


def profile_frame(torch, fn):
    """One call of fn under torch.profiler: (device busy ms, the sum of the
    CUDA events' device times, or None when the profiler saw none; the
    CUDA events; {our kernel: [ms, calls]})."""
    from torch.profiler import ProfilerActivity, profile

    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import LAUNCHES

    # the first name called: a kernel's, before its template and argument
    # lists (whose by-value structs, such as trt::Cam, hold `::` too)
    ours = re.compile(r"(\w+)(?:<[^>]*>)?\(")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync(torch)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    mine: dict = {}
    for e in dev:
        m = ours.search(e.name.replace("(anonymous namespace)", ""))
        if m and m.group(1) in LAUNCHES:
            row = mine.setdefault(m.group(1), [0.0, 0])
            row[0] += e.time_range.elapsed_us() / 1e3
            row[1] += 1
    busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    return (busy if dev else None), len(dev), mine


def phase_profile(torch, cells, stats):
    """One profiled frame per cell: device busy = the sum of the CUDA
    events' device times; the idle share is taken against the same run's
    unprofiled frame time (the profiler's overhead inflates its own)."""
    from toroidal_ray_tracing_tpu_torch import render
    from toroidal_ray_tracing_tpu_torch.ops import tri_stream

    frame_ms = {s["cell"]: s["ms_per_frame"] for s in stats
                if "ms_per_frame" in s}
    rows = []
    for name, key, _, cam, st, w, h, _, group in cells:
        tri_stream.STREAM_GROUP = group
        scene = _SCENES[key]
        busy, events, mine = profile_frame(torch, lambda: render(
            scene, cam, w, h, st, backend="kernel", device=DEVICE))
        tri_stream.STREAM_GROUP = 0
        row = dict(cell=name, frame_ms=frame_ms[name],
                   device_busy_ms=busy,
                   idle_share=(None if busy is None
                               else 1 - busy / frame_ms[name]),
                   cuda_events=events,
                   kernels={k: dict(ms=v[0], calls=v[1])
                            for k, v in mine.items()})
        rows.append(row)
        if busy is None:
            print(f"{name}: the profiler saw no device time (not measured)",
                  flush=True)
            continue
        print(f"{name}: frame {frame_ms[name]:.2f} ms, device busy "
              f"{busy:.2f} ms, idle {100 * row['idle_share']:.0f}%, "
              f"{events} CUDA events, ours "
              + ", ".join(f"{k} {v[0]:.2f} ms x{v[1]}"
                          for k, v in mine.items()), flush=True)
    return rows


def write_obj(base, mesh, xform):
    """Write one instance of a TriangleMesh as `base`.obj + `base`.mtl with
    its transform baked into the vertices (so it loads with the identity):
    positions and normals as %.9g (float32 round-trips exactly), uvs, one
    `usemtl` per material (mirrors keep `illum 3`). Returns the OBJ path."""
    import numpy as np

    from toroidal_ray_tracing_tpu_torch.utils import math3d

    name = os.path.basename(base)
    pos = math3d.transform_points(xform, mesh.positions)
    nrm = math3d.transform_normals(xform, mesh.normals)
    with open(base + ".mtl", "w") as f:
        for k, m in enumerate(mesh.materials):
            f.write(f"newmtl m{k}\n")
            for key, tag in (("ambient", "Ka"), ("diffuse", "Kd"),
                             ("specular", "Ks")):
                if key in m:
                    f.write(f"{tag} %.9g %.9g %.9g\n" % tuple(m[key]))
            f.write(f"Ns {m.get('shininess', 0.0):.9g}\n"
                    f"illum {int(m.get('illum', 0))}\n")
    lines = [f"mtllib {name}.mtl\n"]
    lines += ["v %.9g %.9g %.9g\n" % tuple(r) for r in pos.tolist()]
    lines += ["vn %.9g %.9g %.9g\n" % tuple(r) for r in nrm.tolist()]
    lines += ["vt %.9g %.9g\n" % tuple(r) for r in mesh.uvs.tolist()]
    idx = mesh.indices + 1
    for k in np.unique(mesh.mat_index):
        lines.append(f"usemtl m{k}\n")
        lines += ["f %d/%d/%d %d/%d/%d %d/%d/%d\n"
                  % (a, a, a, b, b, b, c, c, c)
                  for a, b, c in idx[mesh.mat_index == k].tolist()]
    with open(base + ".obj", "w") as f:
        f.writelines(lines)
    return base + ".obj"


def write_scene_objs(out_dir, scene_def):
    """One OBJ + MTL per instance of a triangle-mesh SceneDef (instance
    order kept, so the first file is instance 0); returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    return [write_obj(os.path.join(out_dir, f"model{i}"),
                      scene_def.models[inst.obj_index], inst.transform)
            for i, inst in enumerate(scene_def.instances)]


def same_mesh(a, b) -> bool:
    """Every array and material of two loaded meshes equal."""
    import numpy as np

    return (all(np.array_equal(getattr(a, f), getattr(b, f))
                for f in ("positions", "normals", "colors", "uvs",
                          "indices", "mat_index"))
            and a.materials == b.materials)


def subject_scene(procedural, SceneDef, eye):
    """tests/test_refit.py's scene: the subject cube at `eye` (instance
    0), a floor and an analytic torus."""
    import numpy as np

    from toroidal_ray_tracing_tpu_torch.utils import math3d

    sd = SceneDef()
    sd.add_model(procedural.cube(1.0, per_face_mats=True),
                 transform=math3d.translation(eye))
    sd.add_model(procedural.plane(8.0, y=-1.0))
    sd.models.append(procedural.Torus(1.5, 0.4,
                                      [procedural.matte((0.2, 0.4, 0.8))]))
    sd.add_instance(2, np.eye(4, dtype=np.float32))
    return sd


def phase_experiment(torch, totals, card):
    """The capture experiment through its entry points (the port's
    `experiments/`): OBJ scenes, the 13-step 1080p rho sweep, gTruth,
    reprojection of every step, one 60-frame step, and subject follow with
    a refit on the card."""
    import argparse
    import dataclasses
    import math
    import shutil

    import numpy as np

    from toroidal_ray_tracing_tpu_torch import render, tonemap
    from toroidal_ray_tracing_tpu_torch.cameras import (PinholeCamera,
                                                        ToroidalCamera)
    from toroidal_ray_tracing_tpu_torch.experiments import (gtruth,
                                                            reproject,
                                                            rho_sweep,
                                                            scene_args)
    from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
    from toroidal_ray_tracing_tpu_torch.io import dumps, native, png
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
        LAUNCHES, reset_launches)
    from toroidal_ray_tracing_tpu_torch.pointcloud import splat_points
    from toroidal_ray_tracing_tpu_torch.render.renderer import check_device
    from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings,
                                                      SceneDef, build_scene,
                                                      procedural)
    from toroidal_ray_tracing_tpu_torch.scene.obj_loader import load_obj

    W, H = FULL
    root = os.path.join(OUT_DIR, "experiment")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    summary: dict = {"card": card, "width": W, "height": H}
    print(f"  on {card}", flush=True)

    def run(fn):
        """(fn(), its seconds, the launches it made): counts set to 0
        just before, read just after, added to the main path's totals."""
        def timed():
            sync(torch)
            t0 = time.perf_counter()
            out = fn()
            sync(torch)
            return out, time.perf_counter() - t0
        (out, s), launched = counted(LAUNCHES, reset_launches, timed)
        for k, v in launched.items():
            totals[k] = totals.get(k, 0) + v
        return out, s, {k: v for k, v in launched.items() if v}

    def obj_scene(paths):
        return scene_args.scene_def_from_args(argparse.Namespace(obj=paths))

    # 1. OBJ load at real size: config 6's scene, then config 8's mesh
    check(native.available(), "native host library (OBJ parser, dump "
          "writer) available")
    t0 = time.perf_counter()
    objs6 = write_scene_objs(os.path.join(root, "config6"),
                             SCENARIOS[6].scene())
    write6 = time.perf_counter() - t0
    check(all(same_mesh(load_obj(p), load_obj(p, use_native=False))
              for p in objs6),
          f"config 6's {len(objs6)} OBJ files load equal through the native "
          "and the Python parser")
    t0 = time.perf_counter()
    sd6 = obj_scene(objs6)
    parse6 = time.perf_counter() - t0
    t0 = time.perf_counter()
    host6 = build_scene(sd6)
    build6 = time.perf_counter() - t0
    print(f"  config 6 as OBJ: {host6.num_triangles} triangle rows, written "
          f"in {write6:.2f} s, parsed (native) in {parse6:.3f} s, "
          f"build_scene {build6:.3f} s", flush=True)

    sc8 = SCENARIOS[8]
    t0 = time.perf_counter()
    objs8 = write_scene_objs(os.path.join(root, "config8"), sc8.scene())
    write8 = time.perf_counter() - t0
    t0 = time.perf_counter()
    sd8 = obj_scene(objs8)
    parse8 = time.perf_counter() - t0
    n8 = sum(m.num_triangles for m in sd8.models)
    t0 = time.perf_counter()
    host8 = build_scene(sd8)
    build8 = time.perf_counter() - t0
    print(f"  config 8 as OBJ: {n8} triangles, written in {write8:.1f} s, "
          f"parsed (native) in {parse8:.2f} s, build_scene {build8:.2f} s",
          flush=True)
    cam8, st8 = sc8.camera, sc8.settings()
    out8, s8, launched = run(lambda: render(host8, cam8, W, H, st8,
                                            backend="kernel", device=DEVICE))
    print(f"  config 8 from OBJ, one {W}x{H} frame: {1e3 * s8:.1f} ms (its "
          f"first: copies the scene, builds the tables), launches "
          f"{launched}", flush=True)
    check(launched.get("tri_closest_hit_stream", 0) > 0,
          "config 8 from OBJ: tri_closest_hit_stream launched")
    check(bool(torch.isfinite(out8["image"]).all()),
          "config 8 from OBJ: image finite")
    cw, ch = CHECK_RES_C8
    agree(torch, f"config 8 from OBJ {cw}x{ch} kernel vs torch",
          render(host8, cam8, cw, ch, st8, backend="kernel",
                 device=DEVICE)["image"],
          render(host8, cam8, cw, ch, st8, backend="torch",
                 device=DEVICE)["image"])
    del host8, out8, sd8
    shutil.rmtree(os.path.join(root, "config8"))
    summary["obj"] = dict(
        config6=dict(triangles=sum(m.num_triangles for m in sd6.models),
                     files=len(objs6), write_s=write6, parse_s=parse6,
                     build_s=build6),
        config8=dict(triangles=n8, write_s=write8, parse_s=parse8,
                     build_s=build8, first_frame_ms=1e3 * s8))

    # 2. the capture at 1080p on the OBJ config-6 scene: sweep, gTruth,
    # reprojection of every rho
    cap = os.path.join(root, "capture")
    cam_t = ToroidalCamera(eye=(0.0, 1.5, 0.0), center=(8.0, 0.0, 0.0))
    cam_p = PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0))
    st = RenderSettings.default(max_depth=10)
    rhos = rho_sweep.rho_values()
    files, cap_s, launched = run(lambda: rho_sweep.run_sweep(
        obj_scene(objs6), cap, cam_t, W, H, st, backend="kernel",
        save_rays=True, device=DEVICE))
    print(f"  capture: {len(rhos)} rhos at {W}x{H}, depth 10: {cap_s:.1f} s "
          f"({1e3 * cap_s / len(rhos):.0f} ms per step with its dumps), "
          f"{len(files)} files, launches {launched}", flush=True)
    check(len(files) == 2 * len(rhos) + 2
          and all(os.path.exists(f) for f in files),
          f"capture wrote 2 x {len(rhos)} + 2 files")
    check(launched.get("tri_closest_hit", 0) > 0,
          "capture: tri_closest_hit launched")
    gt_files, gt_s, launched = run(lambda: gtruth.run_gtruth(
        obj_scene(objs6), cap, "toroidal", cam_p, W, H, st,
        backend="kernel", device=DEVICE))
    print(f"  gTruth: {gt_s:.1f} s (OBJ load and build included), "
          f"launches {launched}", flush=True)
    rows, rep_s, _ = run(lambda: reproject.run_reproject_all(
        cap, "toroidal", cam_p, W, H, W, H, device=DEVICE))
    print(f"  reproject all: {rep_s:.1f} s", flush=True)
    print(f"  {'rho':>5} {'rmse':>9} {'covered':>9} {'holes':>9} "
          f"{'coverage':>8} {'points':>8}", flush=True)
    for r in rows:
        print(f"  {r['rho']:5.1f} {r['rmse']:9.6f} "
              f"{r.get('rmse_covered', math.nan):9.6f} "
              f"{r.get('rmse_holes', math.nan):9.6f} {r['coverage']:8.4f} "
              f"{r['n_points']:8d}", flush=True)
    check(len(rows) == len(rhos)
          and all(r["rmse"] is not None and math.isfinite(r["rmse"])
                  and 0.0 < r["coverage"] <= 1.0 for r in rows),
          "every rho's rmse finite and coverage in (0, 1]")
    # one step of the reprojection taken apart (rho 7.0), and its splat
    # on the CPU against the card's
    parts = {}

    def part(name, fn):
        sync(torch)
        t0 = time.perf_counter()
        out = fn()
        sync(torch)
        parts[name] = time.perf_counter() - t0
        return out

    pos, col = part("read the position and color dumps",
                    lambda: dumps.read_position_color(cap, 7.0, W, H))
    on_card, cov_card, _ = part("splat on the card", lambda: splat_points(
        pos, col, cam_p, W, H, return_cover=True, device=DEVICE))
    part("write the point-cloud dump", lambda: dumps.write_ptcloud_image(
        os.path.join(root, "part"), "part", on_card.cpu().numpy()))
    part("write its PNG", lambda: png.save_png(
        os.path.join(root, "part", "part.png"),
        tonemap(on_card).cpu().numpy()))
    part("read the gTruth dump", lambda: dumps.read_points(
        os.path.join(cap, "data", "toroidalgTruth.txt")))
    on_cpu, cov_cpu, _ = part("splat on the CPU", lambda: splat_points(
        pos, col, cam_p, W, H, return_cover=True, device="cpu"))
    print("  one reprojection step (rho 7.0): " + ", ".join(
        f"{k} {v:.2f} s" for k, v in parts.items()), flush=True)
    off = int((on_card.cpu() != on_cpu).any(dim=-1).sum())
    off_cover = int((cov_card.cpu() != cov_cpu).sum())
    print(f"  rho 7.0 splat, card vs CPU: {off} pixels differ, cover "
          f"masks differ at {off_cover}", flush=True)
    check(off <= 1e-3 * W * H and off_cover <= 1e-3 * W * H,
          "rho 7.0 splats alike on the card and the CPU")

    # the capture's frame alone (rho 4.0) and one profiled frame
    _SCENES["config6_obj"] = host6.to(DEVICE)
    st4 = dataclasses.replace(st, rho=rhos[0])
    times = []
    for k in range(4):
        sync(torch)
        t0 = time.perf_counter()
        render(_SCENES["config6_obj"], cam_t, W, H, st4, backend="kernel",
               device=DEVICE)
        sync(torch)
        times.append((time.perf_counter() - t0) * 1e3)
    frame_ms = statistics.median(times[1:])
    print(f"  capture frame, rho {rhos[0]}: {frame_ms:.2f} ms (median of 3 "
          f"after a warm-up)", flush=True)
    # the same step at CHECK_RES on both backends; its mirror paths flip
    # a few pixels (see agree)
    cw, ch = CHECK_RES
    kern, plain = (render(_SCENES["config6_obj"], cam_t, cw, ch, st4,
                          backend=b, device=DEVICE)["image"]
                   for b in ("kernel", "torch"))
    agree(torch, f"capture step rho {rhos[0]}, depth 10, {cw}x{ch} kernel "
          "vs torch", kern, plain, flips=True)
    prof = phase_profile(
        torch, [("capture_config6_obj", "config6_obj", None, cam_t, st4, W,
                 H, None, 0)],
        [dict(cell="capture_config6_obj", ms_per_frame=frame_ms)])
    summary["capture"] = dict(
        capture_s=cap_s, gtruth_s=gt_s, reproject_s=rep_s,
        reproject_step_parts_s=parts, frame_ms=frame_ms, profile=prof,
        splat_card_vs_cpu_pixels=off,
        by_rho={str(r["rho"]): {k: v for k, v in r.items()
                                if k not in ("rho", "files")}
                for r in rows})

    # 3. one rho step at the reference's cadence: 60 frames, the last
    # dumped (run_sweep with the sweep cut to its first rho)
    step = os.path.join(root, "step60")
    rho_end = rho_sweep.RHO_END
    rho_sweep.RHO_END = rho_sweep.RHO_START
    try:
        files60, s60, launched = run(lambda: rho_sweep.run_sweep(
            obj_scene(objs6), step, cam_t, W, H, st, backend="kernel",
            save_rays=False, frames_per_step=60, device=DEVICE))
    finally:
        rho_sweep.RHO_END = rho_end
    name = f"renderedPosition{dumps.rho_tag(rho_sweep.RHO_START)}.txt"
    a = dumps.read_points(os.path.join(step, "data", name))
    b = dumps.read_points(os.path.join(cap, "data", name))
    print(f"  one rho step of 60 frames at {W}x{H}: {s60:.2f} s, "
          f"{1e3 * s60 / 60:.2f} ms per frame (dumps of the last "
          f"included), launches {launched}", flush=True)
    check(len(files60) == 2 and a.shape == b.shape
          and bool(np.array_equal(a, b, equal_nan=True)),
          "the 60-frame step's dump equals the capture's first step")
    summary["step60"] = dict(seconds=s60, ms_per_frame=1e3 * s60 / 60)
    shutil.rmtree(cap)
    shutil.rmtree(step)

    # 4. subject follow: instance 0 refit to each eye on the card; the last
    # refit scene's frame against a fresh build of the moved scene
    def path(i):
        return ToroidalCamera(eye=(0.25 * i, 0.5, 0.1 * i),
                              center=(10.0, 0.0, 0.0))

    seen = {}
    real_render = rho_sweep.render

    def keep_last(scene, camera, *a, **k):
        out = real_render(scene, camera, *a, **k)
        seen.update(scene=scene, camera=camera, args=a, kw=k, out=out)
        return out

    rho_sweep.render = keep_last
    try:
        sd_f = subject_scene(procedural, SceneDef, (0.0, 0.0, 0.0))
        files_f, sf, launched = run(lambda: rho_sweep.run_sweep(
            sd_f, os.path.join(root, "follow"), path(0), W, H, st,
            backend="kernel", save_rays=False, subject_follow=True,
            camera_path=path, device=DEVICE))
    finally:
        rho_sweep.render = real_render
    shutil.rmtree(os.path.join(root, "follow"))
    last = path(len(rhos) - 1)
    fresh = build_scene(subject_scene(procedural, SceneDef, last.eye))
    first = build_scene(subject_scene(procedural, SceneDef, path(0).eye))
    check(seen["camera"] == last
          and seen["scene"].device == check_device(DEVICE),
          "subject follow rendered the last eye from a scene on the card")
    # the sweep's last frame, and a pinhole view of the subject
    pin = PinholeCamera(eye=(8.0, 5.0, 8.0), center=last.eye)
    pairs = {
        "last toroidal frame": (
            seen["out"]["image"],
            render(fresh, seen["camera"], *seen["args"],
                   **seen["kw"])["image"]),
        "pinhole view": tuple(
            render(sc, pin, W, H, st, backend="kernel",
                   device=DEVICE)["image"] for sc in (seen["scene"], fresh)),
    }
    moved = float((pairs["pinhole view"][0] - render(
        first, pin, W, H, st, backend="kernel",
        device=DEVICE)["image"]).abs().max())
    rmses = {k: float((a - b).pow(2).mean().sqrt())
             for k, (a, b) in pairs.items()}
    print(f"  subject follow: {len(rhos)} steps at {W}x{H} in {sf:.1f} s, "
          f"launches {launched}; the last refit scene against a fresh "
          f"build: rmse " + ", ".join(f"{v:.3e} ({k})"
                                      for k, v in rmses.items())
          + f"; max diff {moved:.3f} from the unmoved subject", flush=True)
    check(all(v < 1e-5 for v in rmses.values()) and moved > 0.01,
          "refit scene renders as a fresh build (rmse < 1e-5) on "
          "backend='kernel', and the subject moved")
    summary["subject_follow"] = dict(seconds=sf, rmse_vs_fresh=rmses)

    for d in ("config6", "part"):
        shutil.rmtree(os.path.join(root, d))
    with open(os.path.join(root, "experiment.json"), "w") as f:
        json.dump(summary, f, indent=1)
    return summary


RASTER_CHECK_RES = (240, 135)   # raster card-vs-CPU agreement size


def phase_front_doors(torch, totals, stats):
    """Phase 8: the measurement front doors (bench, run_scenario, raster,
    settings sweep, microbench, roofline) on the card."""
    import numpy as np

    from toroidal_ray_tracing_tpu_torch import bench, render
    from toroidal_ray_tracing_tpu_torch.cameras import generate_rays
    from toroidal_ray_tracing_tpu_torch.experiments import (configs,
                                                            microbench)
    from toroidal_ray_tracing_tpu_torch.experiments.settings_sweep import (
        _apply, sweep)
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
        LAUNCHES, reset_launches)
    from toroidal_ray_tracing_tpu_torch.render.raster import raster_render
    from toroidal_ray_tracing_tpu_torch.utils import roofline

    W, H = FULL
    summary: dict = {}

    def run(fn):
        """fn() with the launch counts set to 0 just before it and read
        just after (added to the main path's totals)."""
        out, launched = counted(LAUNCHES, reset_launches, fn)
        for k, v in launched.items():
            totals[k] = totals.get(k, 0) + v
        return out, {k: v for k, v in launched.items() if v}

    # the bench headline line
    head, launched = run(lambda: bench.headline(device=DEVICE))
    print("bench headline: " + json.dumps(head), flush=True)
    check(head["value"] > 0 and 0.0 <= head["mfu"] <= 1.0
          and head["cull_speedup"] >= 1.0,
          f"bench headline {head['value']:.1f} Mrays/s, mfu "
          f"{head['mfu']:.5f}, cull_speedup {head['cull_speedup']:.2f}")
    check(launched.get("torus_closest_hit", 0) > 0,
          f"bench headline launched K2 ({launched})")
    summary["headline"] = dict(head, launches=launched)

    # run_scenario's front door for every ladder config
    phase4 = {s["cell"]: s["rays_per_frame"] for s in stats
              if "ms_per_frame" in s and (s["width"], s["height"]) == FULL}
    rows = []
    for num, sc in sorted(configs.SCENARIOS.items()):
        frames = None if sc.animate_frames else 2
        (out, st), launched = run(lambda: configs.run_scenario(
            num, backend="kernel", frames=frames, device=DEVICE))
        lo, med, hi = st["window_ms"]
        print(f"run_scenario({num}) {sc.name} {sc.width}x{sc.height} "
              f"x{st['frames']}: {st['mrays_per_s']:.1f} Mrays/s, windows "
              f"{lo:.1f} / {med:.1f} / {hi:.1f} ms, "
              f"{st['rays_per_frame']:.0f} rays/frame, launches {launched}",
              flush=True)
        imgs = out["images"]
        check(tuple(imgs.shape) == (st["frames"], 3, sc.height, sc.width)
              and bool(torch.isfinite(imgs).all()) and launched,
              f"run_scenario({num}): frames finite, kernels launched")
        if sc.spp > 1:
            draws = (1 + configs.WINDOWS) * st["frames"] * (sc.spp - 1)
            check(all(launched.get(k, 0) > 0 for k in (
                "torus_closest_hit", "torus_closest_hit_small"))
                  and launched.get("threefry_uniform", 0) == draws,
                  f"run_scenario({num}), {sc.spp} spp: K2 and K3 launched, "
                  f"threefry_uniform {launched.get('threefry_uniform', 0)} "
                  f"times ({sc.spp - 1} a frame, {st['frames']} frames, "
                  f"{1 + configs.WINDOWS} calls)")
        if sc.name in phase4:
            check(st["rays_per_frame"] == phase4[sc.name],
                  f"run_scenario({num}): {st['rays_per_frame']:.0f} rays a "
                  f"frame, phase 4 {phase4[sc.name]}")
        rows.append(dict(st, launches=launched))
        del out, imgs
    summary["run_scenario"] = rows

    # the raster debug view: configs 6 and 7 at 1080p, and card vs CPU
    cw, ch = RASTER_CHECK_RES
    for num in (6, 7):
        sc, scene = config(num)
        st = sc.settings()
        raster_render(scene, sc.camera, W, H, st, device=DEVICE)  # warm-up
        out, ms = once_ms(torch, lambda: raster_render(
            scene, sc.camera, W, H, st, device=DEVICE))
        img = out["image"]
        clear = st.clear_color[:3].to(img.device)
        drawn = float((img != clear).any(dim=-1).float().mean())
        print(f"raster_render {sc.name} {W}x{H}: {ms:.1f} ms, {drawn:.3f} "
              "of pixels drawn", flush=True)
        check(bool(torch.isfinite(img).all()) and drawn > 0.1,
              f"raster {sc.name}: finite, drawn")
        a = raster_render(scene, sc.camera, cw, ch, st,
                          device=DEVICE)["image"].cpu().numpy()
        b = raster_render(_HOST_SCENES[sc.name], sc.camera, cw, ch, st,
                          device="cpu")["image"].numpy()
        c = st.clear_color[:3].numpy()
        ha, hb = (a != c).any(axis=-1), (b != c).any(axis=-1)
        off = float((ha != hb).mean())
        both = ha & hb
        err = float(np.abs(a - b).max(axis=-1)[both].max())
        check(off <= 0.002 and err < 1e-4,
              f"raster {sc.name} {cw}x{ch} card vs CPU: masks differ on "
              f"{off:.5f} of pixels, max diff {err:.2e} where both drew")
        summary[f"raster_{sc.name}_ms"] = ms

    # a settings sweep of config 3 at 1080p through the kernels
    sc, scene = config(3)
    values = [20.0, 60.0, 100.0, 180.0]
    out, launched = run(lambda: sweep(scene, sc.camera, W, H, sc.settings(),
                                      "light_intensity", values,
                                      backend="kernel", device=DEVICE))
    same = 0
    for i, v in enumerate(values):
        one = render(scene, sc.camera, W, H,
                     _apply(sc.settings(), "light_intensity", v),
                     backend="kernel", device=DEVICE)
        same += (torch.equal(out["images"][i], one["image"])
                 and int(out["rays_traced"][i]) == one["rays_traced"])
    print(f"sweep {sc.name} light_intensity {values}: launches {launched}",
          flush=True)
    check(same == len(values) and launched.get("torus_closest_hit", 0) > 0,
          f"sweep: {same} of {len(values)} frames bit-equal to render")

    # the microbench rows
    summary["microbench"] = {}
    for num in (3, 6):
        (rows, n), launched = run(lambda: microbench.run(
            num, 2 * 1024 * 1024, 8, DEVICE))
        print(f"microbench config {num}, {n} rays (ms a call): "
              + ", ".join(f"{name} {ms:.3f}" for name, ms in rows),
              flush=True)
        check(all(ms > 0 for _, ms in rows),
              f"microbench config {num}: every row timed")
        summary["microbench"][num] = dict(rows)

    # the roofline's post-cull count: card == CPU on config 6's rays
    sc, _ = config(6)
    host = _HOST_SCENES[sc.name]
    o, d = generate_rays(sc.camera_at(0), W, H, sc.settings(), device=DEVICE)
    on_card = roofline.measured_flops_per_ray(host, o, d)
    on_cpu = roofline.measured_flops_per_ray(host, o.cpu(), d.cpu())
    check(on_card == on_cpu, f"roofline {sc.name}: post-cull ops a ray "
          f"{on_card} on the card, {on_cpu} on the CPU")
    summary["roofline_config6_flops_per_ray"] = on_card
    return summary


GRAD_CELLS = ((3, FULL), (3, (K3_RES, K3_RES)), (6, CHECK_RES))
FIT_RES = 256              # the light fit's frame
SHARD_RES = "480x270"      # the two-rank cells' frame
def phase_gradients_multidevice(torch, totals):
    """Phase 9: the differentiable path (kernel against torch backend on
    the card, and the light fit) and multi-device rendering (a one-rank
    NCCL mesh in this process, two gloo ranks on the one card)."""
    import tempfile

    import numpy as np
    import torch.distributed as dist

    from toroidal_ray_tracing_tpu_torch import render
    from toroidal_ray_tracing_tpu_torch.cameras import (PinholeCamera,
                                                        generate_rays)
    from toroidal_ray_tracing_tpu_torch.experiments.grad_check import (
        PARAMS, RTOL, grad_loss, radius_check, torch_tile)
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
        LAUNCHES, reset_launches)
    from toroidal_ray_tracing_tpu_torch.parallel import (dryrun, make_mesh,
                                                         multihost,
                                                         render_sharded)
    from toroidal_ray_tracing_tpu_torch.render.renderer import (
        autofill_pixel_spread)
    from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings,
                                                      build_scene, procedural)
    from toroidal_ray_tracing_tpu_torch.trace.wavefront import (
        trace_rays_fixed)

    summary: dict = {"gradients": [], "sharded": []}

    def add(launched):
        for k, v in launched.items():
            totals[k] = totals.get(k, 0) + v
        return {k: v for k, v in launched.items() if v}

    # -- gradients: backend="kernel" against backend="torch" -------------
    for num, (w, h) in GRAD_CELLS:
        sc, scene = config(num)
        st = autofill_pixel_spread(sc.settings(), sc.camera, w, h).to(DEVICE)
        depth = int(st.max_depth)
        o, d = generate_rays(sc.camera, w, h, st, device=DEVICE)
        n = o.shape[0]
        label = f"{sc.name} {w}x{h} depth {depth}"

        def fwd():
            with torch.no_grad():
                out = trace_rays_fixed(scene, st, o, d, depth,
                                       backend="kernel")
            sync(torch)
            return out

        fwd()
        fwd_ms = statistics.median(once_ms(torch, fwd)[1] for _ in range(3))
        render(scene, sc.camera, w, h, sc.settings(), backend="kernel",
               device=DEVICE)
        render_ms = statistics.median(once_ms(torch, lambda: render(
            scene, sc.camera, w, h, sc.settings(), backend="kernel",
            device=DEVICE))[1] for _ in range(3))
        grad_loss(scene, st, o, d, depth, "kernel", n)   # warm-up
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        ((lk, gk), both_ms), launched = counted(
            LAUNCHES, reset_launches, lambda: once_ms(torch, lambda: (
                grad_loss(scene, st, o, d, depth, "kernel", n))))
        peak = (torch.cuda.max_memory_allocated() / 2**30
                if DEVICE == "cuda" else float("nan"))
        launched = add(launched)
        # the torch backend's dense graph, tile by tile
        tile = torch_tile(scene)
        (lt, gt), torch_ms = once_ms(torch, lambda: grad_loss(
            scene, st, o, d, depth, "torch", tile))
        # The radius's gradient of a frame of mirror tori is a sum with
        # heavy cancellation, carried by a few pixels that float32 fixes
        # only to a few percent: it is held to grad_check's rule (over the
        # pixels whose paths agree on both backends, the gap within the sum
        # of RTOL x each pixel's |contribution| and its one-ulp spread), the
        # others over the whole frame.
        (rad, rad_ms), launched_rule = counted(
            LAUNCHES, reset_launches, lambda: once_ms(torch, lambda: (
                radius_check(scene, st, o, d, depth, tile))))
        add(launched_rule)
        print(f"gradients {label}: forward {fwd_ms:.1f} ms, forward + "
              f"backward {both_ms:.1f} ms (render {render_ms:.1f} ms), peak "
              f"{peak:.2f} GiB; torch backend {torch_ms:.0f} ms in "
              f"{-(-n // tile)} tiles; launches {launched}", flush=True)
        print(f"  loss kernel {lk:.8g} torch {lt:.8g}; paths part on "
              f"{rad['parted']} of {n} pixels (first at (x, y) "
              + ", ".join(f"({i % w}, {i // w})"
                          for i in rad["parted_pixels"][:5])
              + f"); radius rule {rad_ms / 1e3:.1f} s", flush=True)
        check(abs(lk - lt) <= 1e-5 * abs(lt)
              and abs(rad["loss_kernel"] - rad["loss_torch"])
              <= 1e-5 * abs(rad["loss_torch"]),
              f"gradients {label}: loss within rtol 1e-5 (whole frame, and "
              "over the pixels whose paths agree)")
        rows = {}
        for k in PARAMS:
            rel = float(np.max(np.abs(gk[k] - gt[k])
                               / np.maximum(np.abs(gt[k]), 1e-30)))
            print(f"  d/d {k}: kernel {np.array2string(gk[k], precision=7)} "
                  f"torch {np.array2string(gt[k], precision=7)} (max rel "
                  f"{rel:.2e}, whole frame)", flush=True)
            finite = bool(np.isfinite(gk[k]).all() and np.isfinite(gt[k]).all())
            if k == "minor_radius_scale":
                check(finite, f"gradients {label}: d/d {k} finite")
                continue
            check(finite and bool(np.all(np.abs(gk[k] - gt[k])
                                         <= RTOL * np.abs(gt[k]))),
                  f"gradients {label}: d/d {k} finite, within rtol {RTOL} "
                  "(whole frame)")
            rows[k] = dict(kernel=gk[k].tolist(), torch=gt[k].tolist(),
                           max_rel=rel)
        print(f"  d/d minor_radius_scale over the {n - rad['parted']} pixels "
              f"whose paths agree: kernel {rad['kernel']:.9g} torch "
              f"{rad['torch']:.9g}, gap {rad['gap']:.3g} against "
              f"{rad['bound']:.3g} = {RTOL} x the sum of |per-pixel "
              f"contributions| {rad['bound_rtol']:.3g} (margin "
              f"{rad['bound_rtol'] / max(rad['gap'], 1e-30):.3g}x alone) + "
              f"their one-ulp spreads {rad['bound_spread']:.3g} (margin "
              f"{rad['margin']:.3g}x); the contributions sum to "
              f"{rad['contributions_sum']:.6g}, their absolute values to "
              f"{rad['contributions_abs']:.6g}; largest at (x, y) "
              + ", ".join(f"({i % w}, {i // w}) {c:.3g} (spread {sp:.2g})"
                          for i, c, sp in zip(rad["worst"],
                                              rad["worst_contributions"],
                                              rad["worst_spread"])),
              flush=True)
        check(rad["ok"], f"gradients {label}: d/d minor_radius_scale within "
              f"{RTOL} x the sum of |per-pixel contributions| plus their "
              "one-ulp spreads where the paths agree, paths parted on "
              f"{rad['parted']} pixels (at most 0.1%)")
        rows["minor_radius_scale"] = dict(
            kernel=gk[PARAMS[0]].tolist(), torch=gt[PARAMS[0]].tolist(),
            rule=rad, rule_ms=rad_ms)
        needs = "tri_closest_hit" if num == 6 else (
            "torus_closest_hit_small" if (w, h) != FULL
            else "torus_closest_hit")
        check(launched.get(needs, 0) > 0,
              f"gradients {label}: {needs} launched")
        summary["gradients"].append(dict(
            cell=label, rays=n, forward_ms=fwd_ms, forward_backward_ms=both_ms,
            render_ms=render_ms, peak_gib=peak, torch_backend_ms=torch_ms,
            torch_tile=tile, loss_kernel=lk, loss_torch=lt,
            pixels_parted=rad["parted"], grads=rows, launches=launched))

    # -- the light fit (tests/test_differentiable.py) at 256x256 ----------
    fit_scene = build_scene(procedural.scene_single_torus(True)).to(DEVICE)
    fit_cam = PinholeCamera(eye=(6.0, 3.0, 6.0))
    fit_st = RenderSettings.default(max_depth=1).to(DEVICE)
    fo, fd = generate_rays(fit_cam, FIT_RES, FIT_RES, fit_st, device=DEVICE)

    def fit_render(params):
        import dataclasses

        one = torch.ones((), device=DEVICE)
        pos = torch.tensor([10.0, 1.0, 8.0], device=DEVICE) * torch.stack(
            [one, params[1], one])
        stp = dataclasses.replace(fit_st, light=dataclasses.replace(
            fit_st.light, intensity=params[0], position=pos))
        return trace_rays_fixed(fit_scene, stp, fo, fd, 1,
                                backend="kernel")[0]

    def fit():
        with torch.no_grad():
            target = fit_render(torch.tensor([120.0, 12.0], device=DEVICE))
            theta = torch.log(torch.tensor([60.0, 6.0], device=DEVICE))
        theta.requires_grad_(True)
        opt = torch.optim.Adam([theta], lr=5e-2)

        def loss():
            return torch.mean((fit_render(torch.exp(theta)) - target) ** 2)

        with torch.no_grad():
            l0 = float(loss())
        for _ in range(150):
            opt.zero_grad()
            loss().backward()
            opt.step()
        with torch.no_grad():
            l1 = float(loss())
        return l0, l1, torch.exp(theta).detach().cpu().numpy()

    ((l0, l1, fitted), fit_ms), launched = counted(
        LAUNCHES, reset_launches, lambda: once_ms(torch, fit))
    launched = add(launched)
    print(f"light fit {FIT_RES}x{FIT_RES} (backend kernel, 150 Adam steps): "
          f"{fit_ms / 1e3:.2f} s, loss {l0:.4g} -> {l1:.4g}, intensity "
          f"{fitted[0]:.2f}, height {fitted[1]:.3f}; launches {launched}",
          flush=True)
    check(np.isfinite(l1) and l1 < 0.02 * l0 and abs(fitted[0] - 120) < 12,
          "light fit: loss under 2% of its start, intensity within 12 of "
          "120")
    summary["fit"] = dict(seconds=fit_ms / 1e3, l0=l0, l1=l1,
                          intensity=float(fitted[0]),
                          height=float(fitted[1]), launches=launched)

    # -- one rank: a 1x1 mesh over an NCCL group on this card -------------
    with tempfile.TemporaryDirectory(prefix="trt_nccl_") as tmp:
        multihost.init_distributed(
            f"file://{tmp}/store", 1, 0,
            "nccl" if DEVICE == "cuda" else "gloo")
        try:
            mesh = make_mesh(1, 1, torch.device(DEVICE).type)
            for num in (3, 6):
                sc, scene = config(num)
                ref = render(scene, sc.camera, *FULL, sc.settings(),
                             backend="kernel", device=DEVICE)
                _, first_ms = once_ms(torch, lambda: render_sharded(
                    scene, sc.camera, *FULL, sc.settings(), mesh=mesh,
                    backend="kernel", device=DEVICE))
                (out, ms), launched = counted(
                    LAUNCHES, reset_launches, lambda: once_ms(
                        torch, lambda: render_sharded(
                            scene, sc.camera, *FULL, sc.settings(),
                            mesh=mesh, backend="kernel", device=DEVICE)))
                launched = add(launched)
                diff = out["image"] - ref["image"]
                rmse = float(torch.sqrt(torch.mean(diff ** 2)))
                print(f"render_sharded 1x1 NCCL {sc.name} {FULL[0]}x"
                      f"{FULL[1]}: {ms:.1f} ms (first call {first_ms:.1f} "
                      f"ms), rmse {rmse:.3g}, max diff "
                      f"{float(diff.abs().max()):.3g}, rays "
                      f"{out['rays_traced']} (render {ref['rays_traced']}); "
                      f"launches {launched}", flush=True)
                check(rmse < 1e-6 and out["rays_traced"] == ref["rays_traced"]
                      and bool(torch.isfinite(out["image"]).all()),
                      f"render_sharded 1x1 NCCL {sc.name}: equals render")
                summary["sharded"].append(dict(
                    cell=sc.name, mesh=[1, 1], backend="nccl", ranks=1,
                    ms=ms, first_ms=first_ms, rmse=rmse,
                    max_diff=float(diff.abs().max()), launches=launched))
        finally:
            dist.destroy_process_group()

    # -- two gloo ranks on the one card -----------------------------------
    cases = ",".join(f"config{n}@{m}:kernel" for n in (6, 4, 8)
                     for m in ("1x2", "2x1"))
    try:
        ranks, ms = once_ms(torch, lambda: dryrun.launch(
            2, cases, device=DEVICE, res=SHARD_RES, timeout=600))
    except (RuntimeError, TimeoutError) as e:
        print(str(e), flush=True)
        check(False, "render_sharded on two gloo ranks: every rank ran")
        return summary
    print(f"render_sharded on two gloo ranks at {SHARD_RES}: {ms / 1e3:.1f} s "
          "for the launch (processes, scene builds, the cases and their "
          "references)", flush=True)
    for i, row in enumerate(ranks[0]["results"]):
        rows = [rk["results"][i] for rk in ranks]
        launched = {}
        for rw in rows:
            for k, v in rw["launches"].items():
                launched[k] = launched.get(k, 0) + v
        print(f"  {row['case']}: rmse "
              f"{max(rw['rmse'] for rw in rows):.3g}, max diff "
              f"{max(rw['max_diff'] for rw in rows):.3g}, rays "
              f"{row['rays']} (render {row['ref_rays']}), segments "
              f"{[rw['segments'] for rw in rows]}, ms "
              f"{[round(rw['ms'], 1) for rw in rows]} (again "
              f"{[round(rw['again_ms'], 1) for rw in rows]}, of which "
              f"collectives {[round(rw['merge_ms'], 1) for rw in rows]}), "
              f"launches {launched}", flush=True)
        want = {"config6": "tri_closest_hit", "config4": "torus_closest_hit",
                "config8": "tri_closest_hit_stream"}[row["case"][:7]]
        check(launched.get(want, 0) > 0, f"{row['case']}: {want} launched")
        # each rank's segments: S2 and S3 once, S1 twice where the rank
        # tests the whole triangle table of a scene with loose rows (one
        # prims shard); a prims slice tests them as K1 clusters
        loose = config(int(row["case"][6]))[1].loose_tris > 0
        for r, rw in enumerate(rows):
            segs, got = rw["segments"], rw["launches"]
            s1 = 2 * segs if loose and rw["mesh"][1] == 1 else 0
            check(segs > 0 and got.get("shade_hit", 0) == segs
                  and got.get("shade_finish", 0) == segs
                  and got.get("loose_hit", 0) == s1
                  and got.get("visit_rank", 0) <= segs,
                  f"{row['case']} rank {r}: {segs} segments, S2 "
                  f"x{got.get('shade_hit', 0)}, S3 "
                  f"x{got.get('shade_finish', 0)}, S1 "
                  f"x{got.get('loose_hit', 0)} (want {s1}), V1 "
                  f"x{got.get('visit_rank', 0)} (at most one a segment)")
        summary["sharded"].append(dict(
            cell=row["case"], mesh=row["mesh"], backend="gloo", ranks=2,
            ms=[rw["ms"] for rw in rows],
            again_ms=[rw["again_ms"] for rw in rows],
            merge_ms=[rw["merge_ms"] for rw in rows],
            rmse=max(rw["rmse"] for rw in rows),
            max_diff=max(rw["max_diff"] for rw in rows), launches=launched))
    for b in dryrun.failures(ranks):
        check(False, b)
    check(not dryrun.failures(ranks), "render_sharded on two gloo ranks: "
          "every frame equals render (RMSE < 1e-6), equal ray counts and "
          "segments")
    for rk in ranks:
        add(rk["launches"])
    print("NCCL across more than one card: unverified on GPU (one card "
          "here)", flush=True)
    return summary


def oracle_cells():
    """Phase 10's cells: (name, scene key, build, camera, settings, width,
    height, kernels that must launch, stream group, bounds, spp). Full
    scenes at full ladder depth; only the resolution is cut. Bounds are
    tests/test_parity.py's (rmse, robust, exclude); rmse_only gates the
    image's plain RMSE alone, as tests/test_mipmaps.py does."""
    from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS

    default = dict(rmse=1e-3, robust=2e-4, exclude=0.001)
    contact = dict(default, rmse=2e-2)
    by_key = {c[0]: c for c in main_cells()}
    cells = []
    for num, res, needs, bounds in (
            (1, (256, 256), ["torus_closest_hit_small"], default),
            (2, (512, 512), ["torus_closest_hit_small"], contact),
            (5, JITTER_CHECK_RES, ["torus_closest_hit_small",
                                   "threefry_uniform"], contact)):
        sc = SCENARIOS[num]
        cells.append((sc.name, sc.name, sc.build, sc.camera_at(0),
                      sc.settings(), *res, needs, 0, bounds, sc.spp))
    for name, res, bounds in (
            ("config3_multi_torus", FULL, contact),
            ("config3_multi_torus_k3", (K3_RES, K3_RES), contact),
            ("config4_instanced_grid", CHECK_RES, default),
            ("config6_mesh_torus", CHECK_RES, default),
            ("cornellish_toroidal_rho4", CHECK_RES,
             dict(rmse=1e-2, robust=2e-4, exclude=0.01)),
            ("config7_textured", CHECK_RES, dict(rmse=1e-3, rmse_only=True)),
            ("config8_streamed_mesh", CHECK_RES_C8, default),
            ("config8_streamed_mesh_k6", CHECK_RES_C8, default)):
        _, key, build, cam, st, _, _, needs, group = by_key[name]
        cells.append((name, key, build, cam, st, *res, needs, group, bounds,
                      1))
    return cells


class JitteredCamera:
    """`camera` with one jittered sample of `render`: `jitter[i]` moves the
    i-th ray in render's block-major trace order, as render applies it, so
    the oracle traces the rays of that sample (row-major, as the oracle
    takes them)."""

    def __init__(self, camera, jitter):
        self.camera, self.jitter = camera, jitter

    def pixel_spread(self, width, height):
        return self.camera.pixel_spread(width, height)

    def generate_rays(self, width, height, settings=None, device="cpu"):
        from toroidal_ray_tracing_tpu_torch.cameras.pinhole import (
            block_unswizzle, pick_block)

        block = pick_block(width, height)
        rays = self.camera.device_rays(
            self.camera.ray_params(width, height, settings), width, height,
            settings, jitter=self.jitter, block=block, device=device)
        return tuple(block_unswizzle(a, width, height, block).reshape(-1, 3)
                     for a in rays)


def oracle_mean(scene, cam, w, h, st, spp):
    """The oracle's image of `render(..., spp, seed=0)`: the mean of the
    centered pass and one pass a jittered sample, sample s through
    `JitteredCamera` with render's draw `uniform(fold_in(PRNGKey(0), s))`;
    the dumps are the centered pass's, as render's are."""
    from toroidal_ray_tracing_tpu_torch.oracle import render_oracle
    from toroidal_ray_tracing_tpu_torch.utils import prng

    out = render_oracle(scene, cam, w, h, st, device=DEVICE)
    acc = out["image"]
    for s in range(1, spp):
        jitter = prng.uniform(prng.fold_in(prng.prng_key(0), s), (w * h, 2),
                              DEVICE)
        acc = acc + render_oracle(scene, JitteredCamera(cam, jitter), w, h,
                                  st, device=DEVICE)["image"]
    return dict(out, image=acc / float(spp))


def parity(torch, a, b, exclude):
    """(plain RMSE, RMSE after dropping the worst `exclude` fraction of
    pixels (at least one), pixels off by > 1e-3) of two (H, W, 3)
    tensors: tests/test_parity.py's assert_parity measures."""
    err2 = (a - b).pow(2).mean(dim=-1).flatten().double()
    k = max(1, int(err2.numel() * exclude))
    rest = torch.sort(err2).values[:-k]
    off = int(((a - b).abs().amax(dim=-1) > 1e-3).sum())
    return (float(err2.mean().sqrt()), float(rest.mean().sqrt()), off)


def phase_oracle(torch, totals):
    """Phase 10: every ladder scene through `render(..., backend="kernel")`
    against the port's oracle (`oracle.render_oracle`), both on the card,
    at tests/test_parity.py's bounds."""
    from toroidal_ray_tracing_tpu_torch import render, tonemap
    from toroidal_ray_tracing_tpu_torch.ops import tri_stream
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
        LAUNCHES, reset_launches)

    rows, images, launched_all = [], {}, {}
    for (name, key, build, cam, st, w, h, needs, group, bnd,
         spp) in oracle_cells():
        scene = scene_of(key, build)
        tri_stream.STREAM_GROUP = group
        render(scene, cam, w, h, st, backend="kernel", spp=spp,
               device=DEVICE)

        def run():
            return once_ms(torch, lambda: render(
                scene, cam, w, h, st, backend="kernel", spp=spp,
                device=DEVICE))

        (out, ms), launched = counted(LAUNCHES, reset_launches, run)
        tri_stream.STREAM_GROUP = 0
        o, oracle_ms = once_ms(torch, lambda: oracle_mean(
            scene, cam, w, h, st, spp))
        for k, v in launched.items():
            totals[k] = totals.get(k, 0) + v
            launched_all[k] = launched_all.get(k, 0) + v
        images[name] = out["image"]
        exclude = bnd.get("exclude", 0.001)
        img = parity(torch, out["image"], o["image"], exclude)
        pos = parity(torch, out["hit_position"].clamp(-1e4, 1e4),
                     o["hit_position"].clamp(-1e4, 1e4), exclude)
        print(f"{name} {w}x{h}, {spp} spp: oracle {oracle_ms / 1e3:.2f} s, "
              f"render "
              f"{ms:.2f} ms; image rmse {img[0]:.3e}, robust {img[1]:.3e}, "
              f"{img[2]} of {w * h} pixels off by > 1e-3; hit_position "
              f"rmse {pos[0]:.3e}, robust {pos[1]:.3e}; launches "
              f"{launched}", flush=True)
        if bnd.get("rmse_only"):
            ok = img[0] < bnd["rmse"]
            what = f"image rmse < {bnd['rmse']:g}"
        else:
            ok = (img[0] < bnd["rmse"] and img[1] < bnd["robust"]
                  and pos[0] < 50 * bnd["rmse"] and pos[1] < bnd["robust"])
            what = (f"rmse < {bnd['rmse']:g} (hit_position "
                    f"{50 * bnd['rmse']:g}), robust < {bnd['robust']:g} "
                    f"without the worst {100 * exclude:g}%")
        check(ok and bool(torch.isfinite(o["image"]).all()),
              f"{name}: kernel render against the oracle, {what}")
        for k in needs:
            check(launched.get(k, 0) > 0, f"{name}: {k} launched")
        write_ppm(os.path.join(OUT_DIR, f"oracle_{name}.ppm"),
                  tonemap(o["image"]).cpu().numpy())
        rows.append(dict(cell=name, width=w, height=h, spp=spp,
                         oracle_s=oracle_ms / 1e3, render_ms=ms,
                         image_rmse=img[0], image_robust=img[1],
                         pixels_off=img[2], hit_position_rmse=pos[0],
                         hit_position_robust=pos[1], bounds=bnd,
                         launches=launched))
    check(torch.equal(images["config8_streamed_mesh_k6"],
                      images["config8_streamed_mesh"]),
          "config 8 at 128x72 through K6 bit-equal to the K5 frame")
    for k in ("tri_closest_hit", "torus_closest_hit",
              "torus_closest_hit_small", "quad_gather",
              "tri_closest_hit_stream", "tri_closest_hit_stream_grouped",
              "threefry_uniform"):
        check(launched_all.get(k, 0) > 0,
              f"phase 10 launched {k} ({launched_all.get(k, 0)} times)")
    return rows


COMPACT_PAIRS = 8         # phase 11: compacted / uncompacted frames in turns


def compaction_cells():
    """Phase 11's cells: (name, scene key, camera, settings, width, height,
    rule). rule "bit-equal": the prefixes route as the whole frame does;
    "route": a prefix changes a route (config 3: K2 on the whole frame,
    K3 below 2^20 rays), so the image meets phase 4's backend rule;
    "whole": no mirrors, every segment must trace all n rays."""
    from toroidal_ray_tracing_tpu_torch.cameras import ToroidalCamera
    from toroidal_ray_tracing_tpu_torch.experiments import rho_sweep
    from toroidal_ray_tracing_tpu_torch.scene import RenderSettings

    by_key = {c[0]: c for c in main_cells()}
    cells = []
    for name, rule in (("config3_multi_torus", "route"),
                       ("config6_mesh_torus", "bit-equal"),
                       ("config7_textured", "bit-equal"),
                       ("cornellish_toroidal_rho4", "bit-equal"),
                       ("config8_streamed_mesh", "whole")):
        _, key, _, cam, st, w, h, _, _ = by_key[name]
        cells.append((name, key, cam, st, w, h, rule))
    # the experiment's depth-10 capture frame (phase 7's OBJ scene)
    cells.insert(4, (
        "capture_config6_obj", "config6_obj",
        ToroidalCamera(eye=(0.0, 1.5, 0.0), center=(8.0, 0.0, 0.0)),
        RenderSettings.default(max_depth=10,
                               rho=rho_sweep.rho_values()[0]),
        *FULL, "bit-equal"))
    return cells


def phase_compaction(torch, totals):
    """Phase 11: live-ray compaction (`trace.wavefront`'s default
    COMPACT_FACTORS) against none (COMPACT_FACTORS = ()) on the mirror
    cells, the depth-10 frames and config 8: prefixes and live spans per
    segment, ms/frame in turns, launches, one profiled frame each way,
    and the outputs held to each cell's rule."""
    from toroidal_ray_tracing_tpu_torch import render
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
        LAUNCHES, reset_launches)
    from toroidal_ray_tracing_tpu_torch.trace import wavefront
    from toroidal_ray_tracing_tpu_torch.utils.profiling import record_segments

    factors = wavefront.COMPACT_FACTORS
    check(len(factors) > 0, f"compaction on by default: COMPACT_FACTORS "
          f"{factors}")
    ways = {"compacted": factors, "uncompacted": ()}
    rows = []
    try:
        for name, key, cam, st, w, h, rule in compaction_cells():
            scene = _SCENES[key]
            n = w * h
            sizes = wavefront.bucket_sizes(n)
            span = wavefront.COMPACT_SPAN
            n_spans = -(-n // span)

            def frame():
                out = render(scene, cam, w, h, st, backend="kernel",
                             device=DEVICE)
                sync(torch)
                return out

            row = dict(cell=name, width=w, height=h, rule=rule,
                       buckets=list(sizes))
            outs = {}
            for way, f in ways.items():
                wavefront.COMPACT_FACTORS = f
                segs = []
                with record_segments(segs):
                    out, launched = counted(LAUNCHES, reset_launches, frame)
                for k, v in launched.items():
                    totals[k] = totals.get(k, 0) + v
                outs[way] = out
                row[way] = dict(
                    lanes=[s[0] for s in segs],
                    live_spans=[s[1] for s in segs],
                    launches={k: v for k, v in launched.items() if v})
            # ms/frame in turns, the order alternating pair by pair
            times = {way: [] for way in ways}
            for i in range(COMPACT_PAIRS):
                for way in (ways if i % 2 == 0 else reversed(list(ways))):
                    wavefront.COMPACT_FACTORS = ways[way]
                    times[way].append(once_ms(torch, frame)[1])
            for way in ways:
                wavefront.COMPACT_FACTORS = ways[way]
                q1, med, q3 = statistics.quantiles(times[way], n=4)
                busy, events, mine = profile_frame(torch, frame)
                row[way].update(
                    ms=times[way], ms_median=statistics.median(times[way]),
                    ms_q1=q1, ms_q3=q3, device_busy_ms=busy,
                    idle_share=(None if busy is None else
                                1 - busy / statistics.median(times[way])),
                    cuda_events=events,
                    kernels={k: dict(ms=v[0], calls=v[1])
                             for k, v in mine.items()})
            wavefront.COMPACT_FACTORS = factors
            a, b = outs["compacted"], outs["uncompacted"]
            c, u = row["compacted"], row["uncompacted"]
            print(f"{name} {w}x{h}, buckets {list(sizes)}:", flush=True)
            for seg, (lanes, live) in enumerate(zip(c["lanes"],
                                                    c["live_spans"])):
                print(f"  segment {seg}: {lanes} lanes ({lanes / n:.3f} n), "
                      f"live spans {live} of {n_spans} "
                      f"({100 * live / n_spans:.1f}%)", flush=True)
            for way, r in (("compacted", c), ("uncompacted", u)):
                busy = ("not measured" if r["device_busy_ms"] is None else
                        f"device busy {r['device_busy_ms']:.2f} ms, idle "
                        f"{100 * r['idle_share']:.0f}%")
                print(f"  {way}: {r['ms_median']:.2f} ms/frame (median of "
                      f"{COMPACT_PAIRS}, quartiles {r['ms_q1']:.2f}-"
                      f"{r['ms_q3']:.2f}), {busy}, {r['cuda_events']} CUDA "
                      f"events, launches {r['launches']}; kernels "
                      + ", ".join(f"{k} {v['ms']:.2f} ms x{v['calls']}"
                                  for k, v in r["kernels"].items()),
                      flush=True)
            check(a["rays_traced"] == b["rays_traced"],
                  f"{name}: rays {a['rays_traced']} == {b['rays_traced']}")
            check(torch.equal(a["hit_position"], b["hit_position"]),
                  f"{name}: hit positions bit-equal (segment 0 traces the "
                  "whole frame)")
            check(c["lanes"][0] == sizes[0]
                  and set(u["lanes"]) == {sizes[0]},
                  f"{name}: segment 0 and every uncompacted segment trace "
                  f"{sizes[0]} lanes")
            check(all(lanes == min(z for z in sizes if z >= live * span)
                      for lanes, live in zip(c["lanes"], c["live_spans"])),
                  f"{name}: each segment traces the smallest bucket holding "
                  "its live spans")
            if rule == "whole":
                check(torch.equal(a["image"], b["image"])
                      and set(c["lanes"]) == {n},
                      f"{name}: bit-equal, every segment at n")
            else:
                check(min(c["lanes"]) < n,
                      f"{name}: a late segment traces a smaller prefix "
                      f"({c['lanes']})")
                if rule == "bit-equal":
                    check(torch.equal(a["image"], b["image"]),
                          f"{name}: image bit-equal")
                else:
                    agree(torch, f"{name} compacted vs uncompacted",
                          a["image"], b["image"])
                    check(c["launches"].get("torus_closest_hit_small", 0) > 0
                          and "torus_closest_hit_small" not in u["launches"],
                          f"{name}: the prefixes route to K3, the whole "
                          "frame to K2")
            rows.append(row)
    finally:
        wavefront.COMPACT_FACTORS = factors
    return rows


def phase_streams_entry(torch, totals):
    """Phase 12: config 5's jitter drawn on the card against the CPU and
    JAX's pinned fingerprints, with its ms; `entry()` on the card against
    its CPU twin."""
    import numpy as np

    from toroidal_ray_tracing_tpu_torch.entry import entry
    from toroidal_ray_tracing_tpu_torch.ops import threefry_kernel as tfk
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
        LAUNCHES, reset_launches)
    from toroidal_ray_tracing_tpu_torch.utils import prng

    def words(a):
        return a.cpu().numpy().view(np.uint32).ravel()

    summary: dict = {}
    shape = (JITTER_PIXELS, 2)
    for sample, pins in sorted(JITTER_PINS.items()):
        key = prng.fold_in(prng.prng_key(0), sample)
        ms = cuda_ms(lambda: tfk.uniform(key, shape, DEVICE), reps=10)
        twin_ms = cuda_ms(lambda: prng.uniform(key, shape, DEVICE), reps=10)
        kern = words(tfk.uniform(key, shape, DEVICE))
        twin = words(prng.uniform(key, shape, DEVICE))
        cpu = words(prng.uniform(key, shape, "cpu"))
        first, last, total = jitter_fingerprint(kern)
        print(f"config 5 jitter, key fold_in(PRNGKey(0), {sample}) = "
              f"({key[0]:#010x}, {key[1]:#010x}), {shape}: threefry kernel "
              f"{ms:.4f} ms, its twin {twin_ms:.3f} ms on the card; words "
              f"{[hex(w) for w in first]} ... {[hex(w) for w in last]}, sum "
              f"{total}", flush=True)
        check(np.array_equal(kern, twin) and np.array_equal(twin, cpu),
              f"jitter key {sample}: the kernel's draw bit-equal to the "
              "twin's on the card and on the CPU")
        check((first, last, total) == pins,
              f"jitter key {sample}: the kernel's draw has the fingerprint "
              "of jax.random.uniform")
        summary[f"jitter_{sample}_ms"] = ms
        summary[f"jitter_{sample}_twin_ms"] = twin_ms

    fn, args = entry(device=DEVICE)

    def run():
        out = fn(*args)
        sync(torch)
        return out

    (color, hitpos, rays), launched = counted(LAUNCHES, reset_launches, run)
    for k, v in launched.items():
        totals[k] = totals.get(k, 0) + v
    launched = {k: v for k, v in launched.items() if v}
    _, ms = once_ms(torch, lambda: fn(*args))
    cfn, cargs = entry(device="cpu")
    ccolor, _, crays = cfn(*cargs)
    print(f"entry(): fn(*args) on the card, {color.shape[1]} rays, "
          f"{rays} traced (CPU twin {crays}), {ms:.2f} ms, launches "
          f"{launched}", flush=True)
    check(tuple(color.shape) == (3, 64 * 64)
          and bool(torch.isfinite(color).all())
          and bool(torch.isfinite(hitpos).all()), "entry(): output finite")
    check(rays == crays, f"entry(): {rays} rays traced, the CPU twin's "
          f"{crays}")
    check(launched.get("torus_closest_hit_small", 0) > 0,
          "entry(): K3 launched")
    agree(torch, "entry() card vs CPU twin",
          color.T.reshape(64, 64, 3).cpu(), ccolor.T.reshape(64, 64, 3))
    summary["entry"] = dict(rays=rays, cpu_rays=crays, ms=ms,
                            launches=launched)
    return summary


SEGMENT_CELLS = ((6, FULL, True), (5, (3840, 2160), True), (7, FULL, False))
SEGMENT_TOL = 1e-6        # libm-parted values: |diff| <= tol * max(1, |ref|)


class SegmentGuard:
    """While entered, checks each kernel-backend segment that
    `trace.wavefront.trace_rays` traces on the card, from its visit ranks
    (`segment_ranks`, or a segment plan's `ranks`) to the return of its
    S3: V1 launched at most once,
    S2 and S3 once, S1 twice where the query tests the scene's loose rows
    (the closest and the any-hit query: a scene with loose rows, its whole
    triangle table), and no call of `trace.shade.shade` inside it, of a
    segment kernel's plain twin or of the eager visit order
    (`batch_anchor`, `visit_order`, `tree_rank`, V1's twin) on card
    tensors. `segments` counts them, `bad` describes the ones that were
    off."""

    def __init__(self, launches):
        from toroidal_ray_tracing_tpu_torch.ops import kernel_common as kc
        from toroidal_ray_tracing_tpu_torch.ops import loose_kernel as lk
        from toroidal_ray_tracing_tpu_torch.ops import segment_plan as sp
        from toroidal_ray_tracing_tpu_torch.ops import shade_kernel as sk
        from toroidal_ray_tracing_tpu_torch.ops import torus_kernel as tok
        from toroidal_ray_tracing_tpu_torch.ops import tri_kernel as trk
        from toroidal_ray_tracing_tpu_torch.ops import tri_stream as tsk
        from toroidal_ray_tracing_tpu_torch.ops import visit_kernel as vk
        from toroidal_ray_tracing_tpu_torch.trace import wavefront as wf

        self.launches = launches
        eager = [(m, n) for m in (kc, vk, trk, tok, tsk)
                 for n in ("batch_anchor", "visit_order", "tree_rank",
                           "visit_ranks_plain") if hasattr(m, n)]
        self.spots = [(wf, "segment_ranks", self._ranks),
                      (sp.SegmentPlan, "ranks", self._ranks),
                      (wf, "closest_hit", self._closest_hit),
                      (wf, "shade_finish", self._shade_finish),
                      (wf, "shade", self._stray(lambda a: self.open)),
                      *((m, n, self._stray(lambda a: a[0].is_cuda))
                        for m, n in ((lk, "loose_hit_plain"),
                                     (sk, "shade_hit_plain"),
                                     (sk, "shade_finish_plain"), *eager))]
        self.segments, self.bad = 0, []
        self.open = None      # (launches at its start, lanes, S1 to make)
        self.ranked = None    # launches before the segment's visit ranks
        self.stray = 0        # calls of shade() in a segment or of a twin
        self.seen = 0         # ... that a segment or the exit reported

    def _ranks(self, real):
        def call(*a, **k):
            self._close("did not reach S3")
            self.ranked = dict(self.launches)
            return real(*a, **k)
        return call

    def _closest_hit(self, real):
        def call(scene, o, *a, **k):
            self._close("did not reach S3")
            ranked, self.ranked = self.ranked, None
            if k.get("backend") == "kernel" and o.is_cuda:
                g = k.get("geom")
                T = g.woop_o.shape[2] if g is not None else None
                whole = g is None or (
                    T == scene.triangles.count
                    and g.cluster_lo.shape[0] * scene.cluster_size == T)
                n = o.shape[1]
                self.open = (ranked or dict(self.launches), n, 2 * (
                    n > 0 and scene.loose_tris > 0 and whole))
            return real(scene, o, *a, **k)
        return call

    def _shade_finish(self, real):
        def call(*a, **k):
            out = real(*a, **k)
            self._close(None)
            return out
        return call

    def _stray(self, on_card):
        def wrap(real):
            def call(*a, **k):
                self.stray += bool(on_card(a))
                return real(*a, **k)
            return call
        return wrap

    def _close(self, why):
        if self.open is None:
            return
        start, n, s1 = self.open
        self.open = None
        self.segments += 1
        got = {k: self.launches[k] - start[k]
               for k in ("loose_hit", "shade_hit", "shade_finish")}
        want = dict(loose_hit=s1, shade_hit=int(n > 0),
                    shade_finish=int(n > 0))
        v1 = self.launches["visit_rank"] - start["visit_rank"]
        stray, self.seen = self.stray - self.seen, self.stray
        if why or got != want or v1 > 1 or stray:
            self.bad.append(f"segment of {n} lanes: launched {got}, want "
                            f"{want}; V1 x{v1} (at most 1); {stray} calls "
                            "of shade(), a twin or the eager visit order"
                            f"{'; ' + why if why else ''}")

    def __enter__(self):
        self.real = [getattr(m, n) for m, n, _ in self.spots]
        for (m, n, wrap), fn in zip(self.spots, self.real):
            setattr(m, n, wrap(fn))
        return self

    def __exit__(self, *exc):
        for (m, n, _), fn in zip(self.spots, self.real):
            setattr(m, n, fn)
        self._close("did not reach S3")
        if self.stray > self.seen:
            self.bad.append(f"{self.stray - self.seen} calls of a segment "
                            "kernel's twin on card tensors")


SEGMENTS = {"checked": 0, "bad": []}   # a phase's segments, `counted`'s


def segments_checked(name):
    """The phase's kernel-backend segments on the card (every `counted`
    path's): at least one, and none off (`SegmentGuard`). Resets the
    tally."""
    n, bad = SEGMENTS["checked"], SEGMENTS["bad"]
    for b in bad[:5]:
        print(f"  {name}: {b}", flush=True)
    check(n > 0 and not bad,
          f"{name}: {n} kernel-backend segments on the card, {len(bad)} "
          "off: each launched V1 at most once, S2 and S3 once, S1 twice "
          "where it tests the scene's loose rows, and reached neither "
          "shade(), a twin nor the eager visit order")
    SEGMENTS.update(checked=0, bad=[])


def _cloned(x):
    import dataclasses

    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_cloned(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _cloned(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


def segment_calls(torch, num, w, h):
    """The first whole-frame segment's S1 (closest and any-hit), S2 and S3
    calls of config `num`'s `render` at w x h, their arguments cloned as
    the main path passes them."""
    from toroidal_ray_tracing_tpu_torch import render
    from toroidal_ray_tracing_tpu_torch.ops import trace_kernel as tk
    from toroidal_ray_tracing_tpu_torch.trace import wavefront as wf

    sc, scene = config(num)
    cam = sc.camera_at(0) if num == 5 else sc.camera
    calls: dict = {}
    spots = [(tk, "loose_hit"), (wf, "shade_hit"), (wf, "shade_finish")]
    real = [getattr(m, n) for m, n in spots]

    def spy(key_of, fn):
        def call(*a, **k):
            calls.setdefault(key_of(a), _cloned(a))
            return fn(*a, **k)
        return call

    tk.loose_hit = spy(lambda a: "s1_any" if a[8] else "s1", real[0])
    wf.shade_hit = spy(lambda a: "s2", real[1])
    wf.shade_finish = spy(lambda a: "s3", real[2])
    try:
        render(scene, cam, w, h, sc.settings(), backend="kernel",
               device=DEVICE)
        sync(torch)
    finally:
        for (m, n), fn in zip(spots, real):
            setattr(m, n, fn)
    return calls


def outputs_agree(torch, got, ref):
    """(lanes, bit-equal lanes, lanes parted only within SEGMENT_TOL, worst
    |diff| / max(1, |ref|), lanes whose discrete outputs differ) over
    outputs laid out (rows, n) or (n,): floats may part by the tolerance,
    ints and bools must be equal."""
    n = ref[0].shape[-1]
    same = torch.ones(n, dtype=torch.bool, device=ref[0].device)
    near = torch.ones_like(same)
    discrete = torch.zeros_like(same)
    worst = 0.0
    for a, b in zip(got, ref):
        a2, b2 = a.reshape(-1, n), b.reshape(-1, n)
        eq = (a2 == b2) | (torch.isnan(a2) & torch.isnan(b2)
                           if a2.is_floating_point() else False)
        same &= eq.all(dim=0)
        if a2.is_floating_point():
            rel = (a2 - b2).abs() / b2.abs().clamp(min=1.0)
            rel = torch.where(eq, 0.0, rel)
            worst = max(worst, float(rel.max()))
            near &= (rel <= SEGMENT_TOL).all(dim=0)
        else:
            discrete |= ~eq.all(dim=0)
    return (n, int(same.sum()), int((near & ~same & ~discrete).sum()),
            worst, int(discrete.sum()))


def segment_row(results, key, name, src, agree_out, times, nbytes_,
                extra):
    """Print and check one kernel's agreement, keep its row."""
    n, same, parted, worst, discrete = agree_out
    ok = discrete == 0 and same + parted == n
    print(f"{name}: {n} lanes, {same} bit-equal, {parted} parted only by "
          f"libm (max |diff| {worst:.2e} of max(1, |ref|)), {discrete} with "
          f"discrete outputs off" + extra, flush=True)
    check(ok, f"{name} agrees with its twin (bit-equal, or within "
          f"{SEGMENT_TOL:g} where libm parts them)")
    row = results.setdefault(key, dict(
        source=f"{KERNEL_DIR}/{src[0]}", replaces=src[1], library_ms=None,
        max_abs_err=0.0, shapes={}))
    row["max_abs_err"] = max(row["max_abs_err"], worst)
    if times is None:
        return
    wrapped, bare, device, plain = times
    b, by = bound(nbytes_, 0.0)
    print(f"  {name}: wrapper {wrapped:.4f} ms, bare {bare:.4f} ms "
          f"({device:.4f} ms on the device, 20 launches in a CUDA graph), "
          f"twin {plain:.3f} ms; bound {b:.4f} ms ({by}: "
          f"{nbytes_ / 1e6:.1f} MB); device / bound {device / b:.2f}",
          flush=True)
    row["shapes"][str(n)] = dict(ms=wrapped, bare_ms=bare,
                                 device_ms=device, plain_ms=plain,
                                 bound_ms=b, bound_by=by, bytes=nbytes_,
                                 bit_equal_lanes=same, parted_lanes=parted)
    # the line's numbers: the largest shape's (config 5's segment)
    row.update(ms=wrapped, bare_ms=bare, device_ms=device, plain_ms=plain,
               bound_ms=b, bound_by=by)


def bare_launch(fn):
    """(name, args) of the one `launch` that the wrapper call fn() makes
    (S1, S2, S3 or V1)."""
    from toroidal_ray_tracing_tpu_torch.ops import kernel_common as kc
    from toroidal_ray_tracing_tpu_torch.ops import loose_kernel as lk
    from toroidal_ray_tracing_tpu_torch.ops import shade_kernel as sk
    from toroidal_ray_tracing_tpu_torch.ops import visit_kernel as vk

    seen = []
    real = kc.launch

    def rec(name, *args, **kw):
        seen.append((name, args))
        return real(name, *args, **kw)

    lk.launch = sk.launch = vk.launch = rec
    try:
        fn()
    finally:
        lk.launch = sk.launch = vk.launch = real
    return seen[0]


def s2_bytes(rows, flags, params) -> int:
    """The bytes S2 must move for this segment's data under its contract
    (`ops.shade_kernel`'s docstring): every lane reads each part's t (and
    the base's kind) and writes its flags and shadow tmax (and K4's valid
    flag); a hit reads its ray and writes its first-hit point, diffuse and
    specular colors and light intensity; a lit hit writes the shadow
    direction, one with Phong or a reflection its normal, a reflection its
    position, one with Phong its shininess, a textured hit the five texel
    rows and K4's two indices; a hit reads of its winner's rows the normal,
    illum, diffuse and specular colors, the ambient where illum >= 1, the
    shininess with Phong, and a triangle its texture id, its position for
    a point light or a reflection, its uv and texel density where
    textured; with loose rows a triangle hit reads its prim, a loose one
    its u and v and the tail's table columns once (in L2)."""
    from toroidal_ray_tracing_tpu_torch.ops import shade_kernel as sk
    from toroidal_ray_tracing_tpu_torch.ops.trace_kernel import merge_parts
    from toroidal_ray_tracing_tpu_torch.scene.types import LIGHT_POINT

    def count(m):
        return int(m.sum())

    n = flags.shape[0]
    hit = merge_parts(rows, n, flags.device)
    illum = sk.shade_attrs(hit, hit.attrs).illum
    tor, tri = hit.kind == 1, hit.kind == 0
    hits = tor | tri
    loose = tri & False
    if rows.loose is not None:
        loose = tri & (hit.prim >= rows.loose_base) & (
            hit.prim < rows.loose_base + rows.n_loose)

    def bit(b):
        return hits & ((flags & b) > 0)

    spec = bit(sk.SPEC_ON) & bit(sk.FACING)
    refl, tex = bit(sk.REFLECT), bit(sk.TEXTURED)
    textured = params.atlas is not None
    b = n * (8 * (rows.base is not None) + 4 * (rows.tri_hit is not None)
             + 4 * (rows.tor_hit is not None) + 4 + 1 + int(textured))
    b += count(hits) * (24 + 40) + count(bit(sk.NEED_SHADOW)) * 12
    b += count(spec | refl) * 12 + count(refl) * 12 + count(spec) * 4
    if textured:
        b += count(tex) * 28
    own = hits & ~loose                   # rows from the kernels' outputs
    b += count(own) * (12 + 4 + 12 + 12) + count(own & (illum >= 1)) * 12
    b += count(own & spec) * 4 + count(tri & ~loose) * 4
    pos = tri & ~loose & (refl | (params.light_type == LIGHT_POINT))
    b += count(pos) * 12 + count(tex & ~loose) * 12
    if rows.loose is not None:
        b += count(tri) * 4 + count(loose) * 8
        b += rows.n_loose * (21 + 8 + 8) * 4
    return b


def s3_bytes(active, nb, flags, occluded, going_on, textured, depth) -> int:
    """The bytes S3 must move for this segment's data: every lane reads its
    active flag and each 128-lane span writes its live flag; a live lane
    reads its flags, color and attenuation and writes its color, active
    flag and, at depth 0, its first hit (a miss 0, a hit the shadow
    origin it reads); a hit also reads its diffuse color and light
    intensity, its occluded flag where it cast a shadow ray, its
    direction, normal and specular color where the specular term or a
    reflection needs them, the light direction and shininess where the
    specular term does, writes its attenuation where it reflects, reads
    its position and writes its next ray where it goes on, and reads the
    texel fractions and K4's words where it is textured."""
    from toroidal_ray_tracing_tpu_torch.ops import shade_kernel as sk

    def count(m):
        return int(m.sum())

    act, fl = active[:nb], flags

    def has(bit):
        return act & ((fl & bit) > 0)

    missed = has(sk.MISSED)
    hit = act & ~missed
    shadowed = has(sk.NEED_SHADOW) & occluded
    spec = has(sk.SPEC_ON) & has(sk.FACING) & ~missed & ~shadowed
    refl = has(sk.REFLECT)
    first = 12 if depth == 0 else 0
    b = nb + -(-nb // sk.SPAN)
    b += count(missed) * (1 + 24 + 12 + 1 + first)
    b += count(hit) * (1 + 12 + 4 + 24 + 12 + 1 + 2 * first)
    b += count(has(sk.NEED_SHADOW)) + count(spec | refl) * 36
    b += count(spec) * 16 + count(refl) * 12 + count(going_on) * 36
    return b + (count(hit & has(sk.TEXTURED)) * 44 if textured else 0)


def phase_segment_kernels(torch, results):
    """Phase 13: S1, S2 and S3 against their twins on the card, on the
    inputs of the first whole-frame segment of config 6 and config 5
    (2,073,600 and 8,294,400 rays) and config 7 (textured), with their
    times (wrapper, bare launch, device time of 20 bare launches in a CUDA
    graph, the twin) and byte bounds."""
    import dataclasses

    from toroidal_ray_tracing_tpu_torch.experiments.k3_turns import graph_ms
    from toroidal_ray_tracing_tpu_torch.ops import loose_kernel as lk
    from toroidal_ray_tracing_tpu_torch.ops import shade_kernel as sk
    from toroidal_ray_tracing_tpu_torch.ops import trace_kernel as tk
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import launch

    S1 = ("loose_hit.cu", "toroidal_ray_tracing_tpu/ops/trace_kernel.py:207")
    S2 = ("shade.cu", "toroidal_ray_tracing_tpu/trace/shade.py:226")
    S3 = ("shade.cu", "toroidal_ray_tracing_tpu/trace/wavefront.py:167")
    for num, (w, h), timed in SEGMENT_CELLS:
        calls = segment_calls(torch, num, w, h)
        tag = f"config {num} {w}x{h} segment 0"

        # --- S1, both queries
        for key in ("s1", "s1_any"):
            if not config(num)[1].loose_tris:
                continue                          # no loose rows: no S1
            if not check(key in calls, f"{tag}: S1 ran ({key})"):
                continue
            a = calls[key]
            got = lk.loose_hit(*a)
            ref = lk.loose_hit_plain(*a)
            n, L = a[0].shape[1], a[6]
            nb = n * (28 + 24) + L * 84
            times = None
            if timed and key == "s1":
                name, args = bare_launch(lambda: lk.loose_hit(*a))
                times = (cuda_ms(lambda: lk.loose_hit(*a), reps=10),
                         cuda_ms(lambda: launch(name, *args), reps=10),
                         graph_ms(lambda: launch(name, *args)),
                         cuda_ms(lambda: lk.loose_hit_plain(*a), reps=3))
            segment_row(results, "loose_hit", f"S1 loose_hit {tag} "
                        f"({'any-hit' if a[8] else 'closest'}, L = {L})",
                        S1, outputs_agree(torch, got, ref), times, nb, "")

        # --- S2 on the query's parts, and on the merged hit as its base
        # (the route it replaces, which a primitive-sharded query keeps)
        o, d, rows, params = calls["s2"]
        n = o.shape[1]

        def merged():
            return sk.base_rows(tk.merge_parts(rows, n, o.device))

        got = sk.shade_hit(o, d, rows, params)
        got_m = sk.shade_hit(o, d, merged(), params)
        ref = sk.shade_hit_plain(o, d, rows, params)
        textured = params.atlas is not None

        def s2_out(r):
            # each output on the lanes the contract defines it (the twin's
            # flags; every entry else is left undefined)
            return [torch.where(lanes, x, torch.zeros_like(x))
                    for _, x, lanes in sk.defined_entries(
                        dataclasses.replace(r, flags=ref.flags), textured)]

        nb = s2_bytes(rows, ref.flags, params)
        times = None
        if timed:
            name, args = bare_launch(lambda: sk.shade_hit(o, d, rows, params))
            times = (cuda_ms(lambda: sk.shade_hit(o, d, rows, params),
                             reps=10),
                     cuda_ms(lambda: launch(name, *args), reps=10),
                     graph_ms(lambda: launch(name, *args)),
                     cuda_ms(lambda: sk.shade_hit_plain(o, d, rows, params),
                             reps=3))
            old = dict(
                ms=cuda_ms(lambda: sk.shade_hit(o, d, merged(), params),
                           reps=10),
                device_ms=graph_ms(lambda: sk.shade_hit(o, d, merged(),
                                                        params)),
                parts_device_ms=graph_ms(lambda: sk.shade_hit(o, d, rows,
                                                              params)))
            print(f"  S2 {tag}: on parts, wrapper and outputs in a CUDA graph "
                  f"{old['parts_device_ms']:.4f} ms on the device; the route "
                  f"it replaces, merge_parts + S2 on the merged hit: wrapper "
                  f"{old['ms']:.4f} ms, {old['device_ms']:.4f} ms on the "
                  f"device", flush=True)
            check(old["parts_device_ms"] <= old["device_ms"] * 1.02,
                  f"S2 {tag}: on parts no slower than merge_parts + S2 on "
                  "the merged hit (device, 2% for noise)")
        segment_row(results, "shade_hit", f"S2 shade_hit {tag}"
                    + (" (textured)" if textured else ""), S2,
                    outputs_agree(torch, s2_out(got), s2_out(ref)), times,
                    nb, "")
        segment_row(results, "shade_hit_merged", f"S2 shade_hit on the "
                    f"merged hit {tag}", S2,
                    outputs_agree(torch, s2_out(got_m), s2_out(ref)), None,
                    nb, "")
        if times is not None:
            results["shade_hit"]["shapes"][str(n)].update(
                merged_route=old)

        # --- S3, in place: each run starts from the recorded state
        a3 = calls["s3"]
        state0, active0, nb_, sr, occ, quads, prm, depth, mx = a3[:9]

        def fresh():
            return _cloned(a3)

        ka, ta = fresh(), fresh()
        sk.shade_finish(*ka)
        sk.shade_finish_plain(*ta)

        def s3_out(x):
            return [x[0], x[1][None, :].to(torch.uint8)]

        n3 = nb_
        agree_s3 = outputs_agree(torch, s3_out(ka), s3_out(ta))
        counts_eq = (int(ka[9]) == int(ta[9]) and int(ka[11]) == int(ta[11])
                     and torch.equal(ka[10][:-(-n3 // 128)],
                                     ta[10][:-(-n3 // 128)]))
        n_live = int(active0[:n3].sum())
        n_next = int(ka[1][:n3].sum())
        nb = s3_bytes(active0, n3, sr.flags, occ, ka[1][:n3], textured,
                      depth)
        times = None
        if timed:
            st_run = fresh()
            saved = (st_run[0].clone(), st_run[1].clone())

            def restore():
                st_run[0].copy_(saved[0])
                st_run[1].copy_(saved[1])
                st_run[11].zero_()

            name, args = bare_launch(lambda: (
                restore(), sk.shade_finish(*st_run)))

            def wrapped():
                restore()
                sk.shade_finish(*st_run)

            def plain():
                restore()
                sk.shade_finish_plain(*st_run)

            def bare():
                restore()
                launch(name, *args)

            base_ms = cuda_ms(restore, reps=10)
            base_dev = graph_ms(restore)
            times = (cuda_ms(wrapped, reps=10) - base_ms,
                     cuda_ms(bare, reps=10) - base_ms,
                     graph_ms(bare) - base_dev,
                     cuda_ms(plain, reps=3) - base_ms)
        segment_row(results, "shade_finish", f"S3 shade_finish {tag}"
                    + (" (textured)" if textured else ""), S3, agree_s3,
                    times, nb, f"; ray count, live spans and their count "
                    f"{'equal' if counts_eq else 'DIFFER'} ({n_live} live "
                    f"lanes in, {n_next} out)")
        check(counts_eq, f"S3 {tag}: ray count and live spans equal the "
              "twin's")
        # S3 fed by each S2 output, with S2's undefined entries poisoned in
        # one, against the twins end to end: every lane bit-equal
        tw = list(fresh())
        tw[3] = ref
        sk.shade_finish_plain(*tw)
        for what, sr_v in (("S2 on parts", got), ("S2 on the merged hit",
                                                  got_m),
                           ("S2 on parts, undefined entries poisoned",
                            poisoned(got, textured))):
            kv = list(fresh())
            kv[3] = sr_v
            sk.shade_finish(*kv)
            same = (torch.equal(kv[0], tw[0]) and torch.equal(kv[1], tw[1])
                    and int(kv[9]) == int(tw[9])
                    and int(kv[11]) == int(tw[11])
                    and torch.equal(kv[10][:-(-n3 // 128)],
                                    tw[10][:-(-n3 // 128)]))
            check(same, f"S3 {tag} fed by {what}: state, active, ray count, "
                  "spans and count bit-equal to the twins' on every lane")
    for k in ("loose_hit", "shade_hit", "shade_finish"):
        check(k in results and "ms" in results[k], f"{k}: timed")
    # the merged route's agreement, kept in the shade_hit row
    results["shade_hit"]["merged_route_max_abs_err"] = results.pop(
        "shade_hit_merged")["max_abs_err"]


class FrontGuard:
    """While entered, counts what the front doors must launch on the card
    and checks it against the launch counts at exit: R1 once a frame of
    each batch `render.renderer._trace_frames` fills and once a
    `front_kernel.raygen` call on a CUDA device (the cameras'
    `device_rays`), F1 once a frame of each such batch (once a sample),
    G1 once a bucket shrink of a kernel-backend bounce loop on the card
    (`trace.wavefront.trace_state`: its segments' lanes fall); and no twin
    of the three called on card tensors. `samples`, `shrinks` and `bad`
    report it."""

    def __init__(self, launches):
        from toroidal_ray_tracing_tpu_torch.ops import front_kernel as fk
        from toroidal_ray_tracing_tpu_torch.render import renderer as rd
        from toroidal_ray_tracing_tpu_torch.trace import wavefront as wf

        self.launches = launches
        self.want = dict(raygen=0, frame_finish=0, span_gather=0)
        self.samples = self.shrinks = self.stray = 0
        self.loop = None          # the open bounce loop's segment lanes
        self.bad = []
        self.spots = [
            (rd, "_trace_frames", self._frames),
            (fk, "raygen", self._raygen),
            (wf, "trace_state", self._trace_state),
            (rd, "trace_state", self._trace_state),
            (wf, "closest_hit", self._closest_hit),
            (fk, "raygen_plain", self._stray(
                lambda a: torch_device(a[7] if len(a) > 7 else "cpu"))),
            (fk, "raygen_state_plain", self._stray(lambda a: a[6].is_cuda)),
            (fk, "span_gather_plain", self._stray(lambda a: a[0].is_cuda)),
            (fk, "frame_finish_plain", self._stray(lambda a: a[5].is_cuda))]

    def _frames(self, real):
        def call(scene, settings, cams, *a, **k):
            if torch_device(a[-1]):
                self.samples += len(cams)
                self.want["raygen"] += len(cams)
                self.want["frame_finish"] += len(cams)
            return real(scene, settings, cams, *a, **k)
        return call

    def _raygen(self, real):
        def call(*a, **k):
            if torch_device(k.get("device", a[7] if len(a) > 7 else "cpu")):
                self.want["raygen"] += 1
            return real(*a, **k)
        return call

    def _trace_state(self, real):
        def call(scene, settings, state, *a, **k):
            outer, self.loop = self.loop, []
            try:
                return real(scene, settings, state, *a, **k)
            finally:
                lanes, self.loop = self.loop, outer
                backend = k.get("backend", a[2] if len(a) > 2 else "torch")
                if state.is_cuda and backend == "kernel":
                    n = sum(b < a_ for a_, b in zip(lanes, lanes[1:]))
                    self.shrinks += n
                    self.want["span_gather"] += n
        return call

    def _closest_hit(self, real):
        def call(scene, o, *a, **k):
            if self.loop is not None:
                self.loop.append(o.shape[1])
            return real(scene, o, *a, **k)
        return call

    def _stray(self, on_card):
        def wrap(real):
            def call(*a, **k):
                self.stray += bool(on_card(a))
                return real(*a, **k)
            return call
        return wrap

    def __enter__(self):
        self.real = [getattr(m, n) for m, n, _ in self.spots]
        for (m, n, wrap), fn in zip(self.spots, self.real):
            setattr(m, n, wrap(fn))
        return self

    def __exit__(self, *exc):
        for (m, n, _), fn in reversed(list(zip(self.spots, self.real))):
            setattr(m, n, fn)
        got = {k: self.launches[k] for k in self.want}
        if got != self.want or self.stray:
            self.bad.append(f"launched {got}, want {self.want}; "
                            f"{self.stray} twin calls on card tensors")


def torch_device(device) -> bool:
    """Whether `device` (a torch.device or a string) is a CUDA device."""
    import torch

    return torch.device(device).type == "cuda"


FRONT = {"samples": 0, "shrinks": 0, "bad": []}   # a phase's, `counted`'s


def front_checked(name, need_shrink: bool, need_samples: bool = True):
    """The phase's front-door launches on the card (every `counted` path's,
    `FrontGuard`): R1 and F1 once a sample, G1 once a shrink, no twin on
    the card; at least one sample (and shrink) where asked. Resets the
    tally."""
    n, shrinks, bad = FRONT["samples"], FRONT["shrinks"], FRONT["bad"]
    for b in bad[:5]:
        print(f"  {name}: {b}", flush=True)
    check((n > 0 or not need_samples) and not bad
          and (shrinks > 0 or not need_shrink),
          f"{name}: {n} front-door samples and {shrinks} bucket shrinks on "
          f"the card, {len(bad)} paths off: R1 and F1 launched once a "
          "sample (and R1 once a device_rays call), G1 once a shrink, no "
          "twin on card tensors")
    FRONT.update(samples=0, shrinks=0, bad=[])


def front_bare(fn):
    """(name, args) of the one `launch` that the front_kernel wrapper call
    fn() makes."""
    from toroidal_ray_tracing_tpu_torch.ops import front_kernel as fk

    seen = []
    real = fk.launch

    def rec(name, *args, **kw):
        seen.append((name, args))
        return real(name, *args, **kw)

    fk.launch = rec
    try:
        fn()
    finally:
        fk.launch = real
    return seen[0]


def nan_equal(torch, a, b) -> bool:
    """Equal on every entry, NaN equal to NaN, the same dtype and shape."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return bool(torch.equal(a, b))
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def front_row(results, key, src, name, same, timing, nbytes_, library):
    """Print and check one kernel's agreement; keep its times (the last
    timed shape's, the main path's largest, in the line)."""
    from toroidal_ray_tracing_tpu_torch.experiments.k3_turns import graph_ms

    check(same, f"{name}: bit-equal to its twin on every lane (NaN equal "
          "to NaN)")
    row = results.setdefault(key, dict(
        source=f"{KERNEL_DIR}/{src[0]}", replaces=src[1], library_ms=None,
        max_abs_err=0.0, shapes={}))
    if not same:
        row["max_abs_err"] = float("nan")
    if timing is None:
        return
    wrapper, bare_call, twin = timing
    times = (cuda_ms(wrapper, reps=10), cuda_ms(bare_call, reps=10),
             graph_ms(bare_call), cuda_ms(twin, reps=3))
    lib = cuda_ms(library, reps=10) if library is not None else None
    b, by = bound(nbytes_, 0.0)
    print(f"  {name}: wrapper {times[0]:.4f} ms, bare {times[1]:.4f} ms "
          f"({times[2]:.4f} ms on the device, 20 launches in a CUDA graph), "
          f"twin {times[3]:.3f} ms, library call "
          + (f"{lib:.4f} ms" if lib is not None else "none")
          + f"; bound {b:.4f} ms ({by}: {nbytes_ / 1e6:.1f} MB); device / "
          f"bound {times[2] / b:.2f}", flush=True)
    shape = dict(ms=times[0], bare_ms=times[1], device_ms=times[2],
                 plain_ms=times[3], library_ms=lib, bound_ms=b, bound_by=by,
                 bytes=nbytes_)
    row["shapes"][name] = shape
    row.update(shape)


def phase_front_kernels(torch, results):
    """Phase 14: R1, G1 and F1 against their twins on the card, bit-equal
    on every lane (NaN equal to NaN), at the main path's shapes: R1 into
    the state at config 5's jittered sample (3840x2160, block 24), config
    6's 1080p frame and the capture's toroidal 1080p frame (and in both
    row layouts, and a toroidal eye at its center: NaN rays); G1 on the
    first bucket shrink of config 5's and config 3's frames and the second
    of the experiment's depth-10 capture frame, recorded from a `render`;
    F1 on the traced states of config 5's two samples (the
    second adds and divides), config 6's frame with its dumps, the
    capture's, and channel-major (`render_frames`). Times: the wrapper, the
    bare launch, its device time (20 bare launches in a CUDA graph), the
    twin, the byte bound, and for G1 and F1 the one PyTorch call for the
    same data movement (`index_select` of the prefix's rows; the permuted
    `.contiguous()` copy of the color rows)."""
    from toroidal_ray_tracing_tpu_torch.cameras import ToroidalCamera
    from toroidal_ray_tracing_tpu_torch.cameras.pinhole import pick_block
    from toroidal_ray_tracing_tpu_torch.ops import front_kernel as fk
    from toroidal_ray_tracing_tpu_torch.ops import threefry_kernel as tfk
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import launch
    from toroidal_ray_tracing_tpu_torch.render import renderer as rd
    from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings,
                                                      build_scene, procedural)
    from toroidal_ray_tracing_tpu_torch.trace import wavefront as wf
    from toroidal_ray_tracing_tpu_torch.utils import prng

    R1 = ("raygen.cu", "toroidal_ray_tracing_tpu/cameras/pinhole.py:107")
    G1 = ("frame.cu", "toroidal_ray_tracing_tpu/trace/wavefront.py:218")
    F1 = ("frame.cu", "toroidal_ray_tracing_tpu/trace/wavefront.py:250")
    dev = rd.check_device(DEVICE)
    W, H = FULL
    sc5, scene5 = config(5)
    sc6, scene6 = config(6)
    sc3, scene3 = config(3)
    cap_cam = ToroidalCamera(eye=(0.0, 1.0, 0.0), center=(8.0, 0.0, 0.0))
    cap_st = RenderSettings.default(rho=4.0)
    cap_scene = scene_of("cornellish",
                         lambda: build_scene(procedural.scene_cornellish()))
    key5 = prng.fold_in(prng.prng_key(0), 1)
    jitter5 = tfk.uniform(key5, (sc5.width * sc5.height, 2), DEVICE)
    # (name, camera, settings, width, height, jitter, timed)
    frames = [
        (f"config 6 {W}x{H}", sc6.camera, sc6.settings(), W, H, None, True),
        (f"capture {W}x{H} (toroidal)", cap_cam, cap_st, W, H, None, True),
        (f"config 5 {sc5.width}x{sc5.height} sample 1 (jittered)",
         sc5.camera_at(0), sc5.settings(), sc5.width, sc5.height, jitter5,
         True)]

    # --- R1 into the state, and in both row layouts
    for name, cam, st, w, h, jit, timed in frames:
        params = cam.ray_params(w, h, st)
        n, block = w * h, pick_block(w, h)
        lanes = wf.lane_count(n, "kernel")
        args = (cam.KIND, params, w, h, jit, block)
        ks, ka = wf.new_state(lanes, dev)
        ks.fill_(float("nan"))              # the first hit stays NaN
        ts, ta = ks.clone(), ka.clone()
        fk.raygen_state(*args, ks, ka, 0, lanes - n)
        fk.raygen_state_plain(*args, ts, ta, 0, lanes - n)
        same = nan_equal(torch, ks, ts) and nan_equal(torch, ka, ta)
        timing = None
        if timed:
            lname, largs = front_bare(
                lambda: fk.raygen_state(*args, ks, ka, 0, lanes - n))
            timing = (lambda: fk.raygen_state(*args, ks, ka, 0, lanes - n),
                      lambda: launch(lname, *largs),
                      lambda: fk.raygen_state_plain(*args, ts, ta, 0,
                                                    lanes - n))
        # origin, direction, color, attenuation and active written (the
        # first hit is segment 0's), the jitter read
        nb_ = n * (49 + (8 if jit is not None else 0)) + (lanes - n) * 49
        front_row(results, "raygen", R1, f"R1 raygen into the state, {name}",
                  same, timing, nb_, None)
        for rows in (True, False):
            got = fk.raygen(cam.KIND, params, w, h, jit, block, rows, dev)
            ref = fk.raygen_plain(cam.KIND, params, w, h, jit, block, rows,
                                  dev)
            front_row(results, "raygen", R1, f"R1 raygen {name}, "
                      f"{'(3, N)' if rows else '(N, 3)'}",
                      all(nan_equal(torch, a, b) for a, b in zip(got, ref)),
                      None, 0, None)
    nan_cam = ToroidalCamera(eye=(0.0, 1.0, 0.0), center=(0.0, 1.0, 0.0))
    params = nan_cam.ray_params(64, 32, cap_st)
    got = fk.raygen(nan_cam.KIND, params, 64, 32, None, 32, True, dev)
    ref = fk.raygen_plain(nan_cam.KIND, params, 64, 32, None, 32, True, dev)
    front_row(results, "raygen", R1, "R1 raygen, toroidal eye at its center "
              f"({int(torch.isnan(got[1]).sum())} NaN direction entries)",
              all(nan_equal(torch, a, b) for a, b in zip(got, ref))
              and bool(torch.isnan(got[1]).any()), None, 0, None)

    # --- G1 on the second shrink of the experiment's depth-10 capture
    # frame (a suffix, composed span maps, the first buffer as the spare)
    # and the first shrink of config 3's and config 5's frames
    exp = next(c for c in compaction_cells() if c[0] == "capture_config6_obj")
    g1_cases = [
        ("the experiment's depth-10 capture frame, second shrink",
         _SCENES[exp[1]], exp[2], exp[3], exp[4], exp[5], 1),
        (f"config 3 {W}x{H}, first shrink", scene3, sc3.camera_at(0),
         sc3.settings(), W, H, 0),
        (f"config 5 {sc5.width}x{sc5.height}, first shrink", scene5,
         sc5.camera_at(0), sc5.settings(), sc5.width, sc5.height, 0)]
    for label, scene, cam, st, w, h, want in g1_cases:
        calls = []
        real = wf.span_gather

        def spy(*a, want=want):
            if len(calls) == want:
                calls.append(_cloned(a))
            elif len(calls) < want:
                calls.append(None)
            return real(*a)

        wf.span_gather = spy
        try:
            rd.render(scene, cam, w, h, st, backend="kernel", device=DEVICE)
            sync(torch)
        finally:
            wf.span_gather = real
        if not check(len(calls) > want, f"{label}: G1 ran on shrink "
                     f"{want + 1}"):
            continue
        a = calls[want]
        cur, _, act_in, _, spans, count, orig_in, _, _, nb, fit = a[:11]
        tmax_row = a[11] if len(a) > 11 else None   # a segment plan's
        lanes = cur.shape[1]
        # both start from the same buffers: every entry equal, those the
        # contract leaves unwritten too
        kern, twin = list(_cloned(a)), list(_cloned(a))
        fk.span_gather(*kern)
        fk.span_gather_plain(*twin)
        same = all(nan_equal(torch, kern[i], twin[i]) for i in (
            1, 3, 7, 8, *((11,) if tmax_row is not None else ())))
        live = int(count)
        s_old, s_total = nb // 128, lanes // 128
        name = (f"G1 span_gather {label}: the {nb}-lane prefix of {lanes} "
                f"lanes into {fit}, {live} of its {s_old} spans live"
                + (", spans moved before" if orig_in is not None else ""))
        lname, largs = front_bare(lambda: fk.span_gather(*kern))
        perm = torch.cat([fk.span_order(spans[:s_old]),
                          torch.arange(s_old, s_total, device=dev)])
        idx = fk.span_lanes(perm[:s_old])
        # 12 rows and the active byte of a lane landing in the new prefix,
        # read and written; origin and color of every other lane; the live
        # flags; the span maps
        nb_ = (fit * (98 if tmax_row is None else 102) + (lanes - fit) * 48
               + s_old + s_total * (12 if orig_in is not None else 8))
        front_row(results, "span_gather", G1, name, same,
                  (lambda: fk.span_gather(*kern),
                   lambda: launch(lname, *largs),
                   lambda: fk.span_gather_plain(*twin)),
                  nb_, lambda: cur[:12].index_select(1, idx))

    # --- F1 on traced states
    def traced_of(cam, st, w, h, jit, scene):
        # (the loop's R1 draws the jitter from its key: jitter5's)
        st = rd.autofill_pixel_spread(st, cam, w, h)
        return rd._trace_frames(scene, st.to(dev),
                                [(cam, cam.ray_params(w, h, st))], w, h,
                                "kernel", None if jit is None else key5, dev)

    f1_cases = []
    for name, cam, st, w, h, jit, _ in frames:
        scene = (scene6 if name.startswith("config 6") else cap_scene
                 if name.startswith("capture") else scene5)
        tr = traced_of(cam, st, w, h, None, scene)
        params = cam.ray_params(w, h, st)
        if jit is None:
            f1_cases.append((f"{name}, dumps", cam, params, w, h, tr, 0, 1,
                             True, False))
            f1_cases.append((f"{name}, channel-major with dumps "
                             "(render_frames)", cam, params, w, h, tr, 0, 1,
                             True, True))
        else:
            tr1 = traced_of(cam, st, w, h, jit, scene)
            f1_cases.append((f"config 5 sample 0 of 2, dumps", cam, params,
                             w, h, tr, 0, 2, True, False))
            f1_cases.append((f"config 5 sample 1 of 2 (adds, divides)", cam,
                             params, w, h, tr1, 1, 2, False, False))
    for name, cam, params, w, h, tr, s, spp, dumps, chw in f1_cases:
        n, block = w * h, pick_block(w, h)
        shape = (3, h, w) if chw else (h, w, 3)
        seed_img = torch.rand(shape, device=dev)
        outs = {side: [seed_img.clone()] + (
            [torch.empty(shape, device=dev) for _ in range(3)] if dumps
            else []) for side in ("kernel", "twin")}
        args = (cam.KIND, params, w, h, block, tr.state, tr.first, tr.slot,
                0)
        fk.frame_finish(*args, outs["kernel"][0], s, spp,
                        tuple(outs["kernel"][1:]) or None, chw)
        fk.frame_finish_plain(*args, outs["twin"][0], s, spp,
                              tuple(outs["twin"][1:]) or None, chw)
        same = all(nan_equal(torch, a, b)
                   for a, b in zip(outs["kernel"], outs["twin"]))
        ko, to = outs["kernel"], outs["twin"]
        call = (lambda ko=ko: fk.frame_finish(*args, ko[0], s, spp,
                                              tuple(ko[1:]) or None, chw))
        lname, largs = front_bare(call)
        hv = fk.unpermute_rows(tr.state[6:9], tr.slot)[:, :n]
        nb_ = n * (24 + (12 if s > 0 else 0) + (48 if dumps else 0))
        label = (f"F1 frame_finish {name} "
                 f"({'compacted' if tr.slot is not None else 'no shrink'})")
        front_row(results, "frame_finish", F1, label, same,
                  (call, lambda: launch(lname, *largs),
                   lambda to=to: fk.frame_finish_plain(
                       *args, to[0], s, spp, tuple(to[1:]) or None, chw)),
                  nb_,
                  lambda: fk.block_unswizzle(hv.T, w, h, block).contiguous())
        if dumps:
            # the library yardstick moves the color only; the PyTorch route
            # that does the most of F1's work also lays out the first hit
            # (the ray dumps have no library call)
            def lay(rows):
                a = fk.block_unswizzle(rows.T, w, h, block)
                return (a.permute(2, 0, 1) if chw else a).contiguous()

            hp_rows = tr.first[12:15, :n]
            route = cuda_ms(lambda: (lay(hv), lay(hp_rows)), reps=10)
            results["frame_finish"]["shapes"][label]["library_route_ms"] = \
                route
            print(f"  {label}: the color's and the first hit's permuted "
                  f"`.contiguous()` {route:.4f} ms", flush=True)
    # an odd frame on the toroidal camera (block 1; its pixel count no
    # multiple of 4, the last CTA short of 256 pixels), HWC with dumps, then
    # its second sample adding on the same image; the outputs 16-B aligned
    # (whole CTAs store float4 runs) and at a 4-B offset (every CTA stores
    # scalars)
    w, h = F1_ODD_RES
    n = w * h
    tr = traced_of(cap_cam, cap_st, w, h, None, cap_scene)
    args = (cap_cam.KIND, cap_cam.ray_params(w, h, cap_st), w, h,
            pick_block(w, h), tr.state, tr.first, tr.slot, 0)
    seed_img = torch.rand((h, w, 3), device=dev)
    for shift in (0, 1):
        outs = {side: [torch.empty(n * 3 + shift, device=dev)[shift:].view(
            h, w, 3) for _ in range(4)] for side in ("kernel", "twin")}
        for side in outs:
            outs[side][0].copy_(seed_img)
        fk.frame_finish(*args, outs["kernel"][0], 0, 2,
                        tuple(outs["kernel"][1:]))
        fk.frame_finish_plain(*args, outs["twin"][0], 0, 2,
                              tuple(outs["twin"][1:]))
        same = all(nan_equal(torch, a, b)
                   for a, b in zip(outs["kernel"], outs["twin"]))
        fk.frame_finish(*args, outs["kernel"][0], 1, 2)
        fk.frame_finish_plain(*args, outs["twin"][0], 1, 2)
        same = same and nan_equal(torch, outs["kernel"][0], outs["twin"][0])
        front_row(results, "frame_finish", F1, f"F1 frame_finish {w}x{h} "
                  f"capture (toroidal, block {args[4]}, {n} pixels: the last "
                  f"CTA {n % 256}), HWC with dumps, then its second sample "
                  f"(adds, divides); outputs "
                  + ("16-B aligned" if shift == 0 else "at a 4-B offset")
                  + (" (compacted)" if tr.slot is not None
                     else " (no shrink)"), same, None, 0, None)
    for k in ("raygen", "span_gather", "frame_finish"):
        check(k in results and "ms" in results[k], f"{k}: timed")


def poisoned(sr, textured):
    """A copy of S2's outputs with every entry its contract leaves
    undefined set to NaN (floats) or -7 (K4's indices)."""
    from toroidal_ray_tracing_tpu_torch.ops import shade_kernel as sk

    out = _cloned(sr)
    for _, x, lanes in sk.defined_entries(out, textured):
        x[..., ~lanes] = float("nan") if x.is_floating_point() else -7
    return out


V1_CELLS = (3, 4, 6, 7, 8, "8k6", 5, "capture")
F1_ODD_RES = (1001, 543)      # phase 14's odd frame: 543,543 pixels


def v1_cell(num):
    """(label, scene, camera, settings, width, height, spp, stream group)
    of a phase 15 cell at its main-path size."""
    from toroidal_ray_tracing_tpu_torch.cameras import ToroidalCamera
    from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings,
                                                      build_scene, procedural)

    if num == "capture":
        scene = scene_of("cornellish",
                         lambda: build_scene(procedural.scene_cornellish()))
        return ("capture", scene, ToroidalCamera(eye=(0.0, 1.0, 0.0),
                                                 center=(8.0, 0.0, 0.0)),
                RenderSettings.default(rho=4.0), *FULL, 1, 0)
    group = 16 if num == "8k6" else 0
    sc, scene = config(8 if group else num)
    w, h = (sc.width, sc.height) if sc.spp > 1 else FULL
    return (f"config {num}", scene, sc.camera_at(0), sc.settings(), w, h,
            sc.spp, group)


def phase_visit_ranks(torch, results):
    """Phase 15: the visit-rank kernel V1 (`ops.visit_kernel`,
    csrc/visit.cu) against its twin on every segment of a `render` of
    configs 3, 4, 6, 7, 8 (K5, and K6 with the group switch on), 5 (4K, 2
    spp) and the capture at their main-path sizes: the anchor and every
    rank bit-equal (an anchor that differs is printed); its per-call route
    (a tree kernel's wrapper given no rank launches V1 once, and its hits
    equal those on the twin's rank); synthetic sets on config 5's origins
    (ties, boxes at distance 0 and NaN boxes among them; shares in shared
    memory and in the global scratch) bit-equal to the twin; two launches'
    anchor bits equal; the query folds the kernels write on
    the same renders against the torch formulation they replace, on every
    lane: the torus query's tmax (`torch.minimum`, `torch.where(occ, 0,
    tmax)`) and the occlusion byte (`t < BIG` ORed over the query's
    kernels). Times on the 9,000- and 16,385-box sets and on config 8's,
    config 6's and config 5's first segment: the wrapper, the bare
    launch, its device time (20 bare launches in a CUDA graph), the twin,
    the byte bound (12 B a lane of origins, 28 B a box),
    and the eager route it replaces (`batch_anchor` + `visit_order` +
    `tree_rank`, the twin on the card) as the library yardstick."""
    from toroidal_ray_tracing_tpu_torch import render
    from toroidal_ray_tracing_tpu_torch.ops import kernel_common as kc
    from toroidal_ray_tracing_tpu_torch.ops import trace_kernel as tk
    from toroidal_ray_tracing_tpu_torch.ops import tri_stream
    from toroidal_ray_tracing_tpu_torch.ops import visit_kernel as vk
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
        LAUNCHES, launch)
    from toroidal_ray_tracing_tpu_torch.ops.torus_kernel import (
        torus_closest_hit_chunked)
    from toroidal_ray_tracing_tpu_torch.ops.tri_kernel import tri_closest_hit
    from toroidal_ray_tracing_tpu_torch.trace.intersect import (
        geom_from_scene)

    V1 = ("visit.cu", f"{JAX_OPS}/tri_kernel.py:398")
    checked = dict(segments=0, sets=0, anchors_off=0, tmax=0, occ=0,
                   tmax_lanes=0, occ_lanes=0)
    timed = {}
    for num in V1_CELLS:
        label, scene, cam, st, w, h, spp, group = v1_cell(num)
        calls, folds_off, seen = [], [], {}
        real_ranks, real_query = tk.visit_ranks, tk._query
        real_hit = {k: getattr(tk, k) for k in (
            "tri_closest_hit", "tri_closest_hit_stream", "torus_closest_hit")}

        def ranks(origins, n_batch, sets, out=None):
            out = real_ranks(origins, n_batch, sets, out=out)
            calls.append((origins.clone(), n_batch, sets,
                          out[0].clone(), [r.clone() for r in out[1]]))
            return out

        def rec(name):
            def call(o, d, tm, *a, **k):
                seen[name] = tm.clone()
                return real_hit[name](o, d, tm, *a, **k)
            return call

        def query(scene_, geom, o, d, tmax, want_attrs, occlusion, r):
            seen.clear()
            rows, occ = real_query(scene_, geom, o, d, tmax, want_attrs,
                                   occlusion, r)
            tri_in = (seen.get("tri_closest_hit")
                      if "tri_closest_hit" in seen
                      else seen.get("tri_closest_hit_stream"))
            if tri_in is not None and "torus_closest_hit" in seen:
                t_occ = rows.tri_hit[0] < kc.BIG
                if rows.base is not None:
                    t_occ = t_occ | (rows.base[1] >= 0)
                want = (torch.where(t_occ, 0.0, tmax) if occlusion
                        else torch.minimum(tri_in, rows.tri_hit[0]))
                checked["tmax"] += 1
                checked["tmax_lanes"] += want.numel()
                if not torch.equal(want, seen["torus_closest_hit"]):
                    folds_off.append("any-hit tmax" if occlusion
                                     else "closest tmax")
            if occlusion:
                ref = torch.zeros_like(tmax, dtype=torch.bool)
                for part, hit in ((rows.base, lambda p: p[1] >= 0),
                                  (rows.tri_hit, lambda p: p[0] < kc.BIG),
                                  (rows.tor_hit, lambda p: p[0] < kc.BIG)):
                    if part is not None:
                        ref |= hit(part)
                checked["occ"] += 1
                checked["occ_lanes"] += ref.numel()
                if not torch.equal(ref, occ):
                    folds_off.append("occlusion byte")
            return rows, occ

        tk.visit_ranks, tk._query = ranks, query
        vk.visit_ranks = ranks     # the segment plan's V1 call
        for k in real_hit:
            setattr(tk, k, rec(k))
        tri_stream.STREAM_GROUP = group
        try:
            render(scene, cam, w, h, st, backend="kernel", spp=spp,
                   device=DEVICE)
            sync(torch)
        finally:
            tk.visit_ranks, tk._query = real_ranks, real_query
            vk.visit_ranks = real_ranks
            for k, fn in real_hit.items():
                setattr(tk, k, fn)
            tri_stream.STREAM_GROUP = 0
        same_anchor = same_ranks = 0
        for origins, n_batch, sets, anchor, got in calls:
            ref_anchor, ref = vk.visit_ranks_plain(origins, n_batch, sets)
            if torch.equal(anchor, ref_anchor):
                same_anchor += 1
            else:
                print(f"  {label}: V1 anchor {anchor.tolist()} against the "
                      f"twin's {ref_anchor.tolist()}", flush=True)
                checked["anchors_off"] += 1
            same_ranks += all(torch.equal(a, b) for a, b in zip(got, ref))
            checked["sets"] += len(sets)
        checked["segments"] += len(calls)
        print(f"  {label} {w}x{h}: {len(calls)} segments ranked by V1 "
              f"(sets {[len(c[2]) for c in calls]}, boxes "
              f"{[[int(lo.shape[0]) for lo, _ in c[2]] for c in calls]}); "
              f"anchor bit-equal {same_anchor}, every rank bit-equal "
              f"{same_ranks}; folds off: {folds_off[:4] or 'none'}",
              flush=True)
        check(calls and same_anchor == len(calls)
              and same_ranks == len(calls),
              f"{label}: V1 ranked its segments, anchor and ranks "
              f"bit-equal to the twin's on all {len(calls)}")
        check(not folds_off, f"{label}: the kernels' tmax folds and "
              "occlusion bytes equal the torch formulation on every lane")
        if num in (8, 6, 5) and calls:
            timed[num] = calls[0]
    check(checked["segments"] > 0 and checked["tmax"] > 0
          and checked["occ"] > 0,
          f"phase 15 checked {checked['segments']} segments' ranks "
          f"({checked['sets']} sets), {checked['tmax']} torus tmax folds "
          f"({checked['tmax_lanes']} lanes) and {checked['occ']} occlusion "
          f"bytes ({checked['occ_lanes']} lanes)")

    # the per-call route: a wrapper given no rank launches V1 once
    sc6, scene6 = config(6)
    geom6 = geom_from_scene(scene6)
    mesh6 = tk._tri_plan(scene6, geom6).mesh
    cam6 = sc6.camera
    o, d = cam6.device_rays(cam6.ray_params(*FULL, sc6.settings()), *FULL,
                            sc6.settings(), rows=True, device=DEVICE)
    o, d = o.contiguous(), d.contiguous()
    tm = torch.full((o.shape[1],), 1e4, device=DEVICE)
    sc4, scene4 = config(4)
    tor4 = tk._torus_tables(scene4, geom_from_scene(scene4))
    for name, fn, lo, hi in (
            ("K1", lambda r: tri_closest_hit(o, d, tm, mesh6, rank=r),
             mesh6.clo, mesh6.chi),
            ("K2", lambda r: torus_closest_hit_chunked(o, d, tm, tor4, rank=r),
             tor4.clo, tor4.chi)):
        before = LAUNCHES["visit_rank"]
        got = fn(None)
        sync(torch)
        launched = LAUNCHES["visit_rank"] - before
        _, (rank,) = vk.visit_ranks_plain(o, o.shape[1], [(lo, hi)])
        before = LAUNCHES["visit_rank"]
        ref = fn(rank)
        sync(torch)
        check(launched == 1 and LAUNCHES["visit_rank"] == before
              and all(torch.equal(a, b) for a, b in zip(got, ref)),
              f"{name}'s wrapper with no rank launches V1 once ({launched}) "
              "and none with one; its hits bit-equal to those on the twin's "
              "rank")

    # synthetic sets on config 5's first-segment origins (the most lanes),
    # with duplicate boxes, boxes that hold the anchor (distance 0) and NaN
    # boxes, in launches of two sets, against the twin bit for bit: ranked
    # in one CTA (1 and 8, 9 and 257 boxes), in a cluster with the sorted
    # shares in shared memory (513 and 3,340, 8,192 and 33) and in the
    # global scratch (9,000 and 16,385; 600 and 8,193, one of each)
    origins, n_batch, _, anchor, _ = timed[5]
    gen = torch.Generator().manual_seed(16)

    def box_set(m):
        c = anchor.cpu() + 6.0 * torch.randn((m, 3), generator=gen)
        h = 2.0 * torch.rand((m, 3), generator=gen)
        lo, hi = c - h, c + h
        q = m // 4
        lo[m // 2:m // 2 + q], hi[m // 2:m // 2 + q] = lo[:q], hi[:q]
        lo[2::7], hi[2::7] = anchor.cpu() - 1.0, anchor.cpu() + 1.0
        lo[5::97, 1] = float("nan")
        return lo.to(DEVICE), hi.to(DEVICE)

    pairs = [(1, 8), (9, 257), (513, 3340), (vk.SLAB_KEYS, 33),
             (9000, 16385), (600, vk.SLAB_KEYS + 1)]
    checked["synthetic_sets"] = []
    for ms in pairs:
        sets = [box_set(m) for m in ms]
        before = LAUNCHES["visit_rank"]
        got_anchor, got = vk.visit_ranks(origins, n_batch, sets)
        sync(torch)
        launched = LAUNCHES["visit_rank"] - before
        ref_anchor, ref = vk.visit_ranks_plain(origins, n_batch, sets)
        zero = [int((kc.box_distance(lo, hi, ref_anchor) == 0).sum())
                for lo, hi in sets]
        nan = [int(torch.isnan(kc.box_distance(lo, hi, ref_anchor)).sum())
               for lo, hi in sets]
        c = vk.cluster_for(ms)
        where = ["the scratch" if c * vk.share_keys(m, c) > vk.SLAB_KEYS
                 else "shared memory" for m in ms]
        check(launched == 1 and torch.equal(got_anchor, ref_anchor)
              and all(torch.equal(a, b) for a, b in zip(got, ref)),
              f"V1 on synthetic sets of {list(ms)} boxes (ranked by "
              f"{c} CTA{'s' if c > 1 else ''}, the sorted shares in "
              f"{where}; {zero} at distance 0, {nan} NaN, on "
              f"{origins.shape[1]} lanes): one launch, anchor and every rank "
              "bit-equal to the twin's")
        checked["synthetic_sets"].append(list(ms))
        if ms[0] == 9000:
            nb = (origins.shape[1] * 12 + sum(m * 28 for m in ms) + 12)
            name, args = bare_launch(
                lambda: vk.visit_ranks(origins, n_batch, sets))
            front_row(results, "visit_rank", V1, "V1 visit_rank on config "
                      f"5's segment 0 origins, synthetic sets of {list(ms)} "
                      "boxes", True,
                      (lambda: vk.visit_ranks(origins, n_batch, sets),
                       lambda: launch(name, *args),
                       lambda: vk.visit_ranks_plain(origins, n_batch, sets)),
                      nb, lambda: vk.visit_ranks_plain(origins, n_batch,
                                                        sets))

    # two launches on the same origins give the same anchor bits (and
    # ranks): config 5's and config 6's first segment
    for num in (5, 6):
        origins, n_batch, sets, _, _ = timed[num]
        a1, r1 = vk.visit_ranks(origins, n_batch, sets)
        a2, r2 = vk.visit_ranks(origins, n_batch, sets)
        sync(torch)
        check(torch.equal(a1.view(torch.int32), a2.view(torch.int32))
              and all(torch.equal(x, y) for x, y in zip(r1, r2)),
              f"V1 twice on config {num}'s segment 0 origins: the same "
              f"anchor bits ({[hex(v) for v in a1.view(torch.int32).tolist()]}"
              ") and ranks")

    # times on the first segment of config 8 (3,340 superblocks: the
    # largest sort), config 6 and config 5 (the most lanes: the line's)
    for num in (8, 6, 5):
        origins, n_batch, sets, _, _ = timed[num]
        lanes = origins.shape[1]
        nb = lanes * 12 + sum(lo.shape[0] * 28 for lo, _ in sets) + 12
        name, args = bare_launch(
            lambda: vk.visit_ranks(origins, n_batch, sets))
        front_row(results, "visit_rank", V1, f"V1 visit_rank config {num} "
                  f"segment 0 ({lanes} lanes, boxes "
                  f"{[int(lo.shape[0]) for lo, _ in sets]})", True,
                  (lambda: vk.visit_ranks(origins, n_batch, sets),
                   lambda: launch(name, *args),
                   lambda: vk.visit_ranks_plain(origins, n_batch, sets)),
                  nb, lambda: vk.visit_ranks_plain(origins, n_batch, sets))
    results["visit_rank"].update(checked)



PLAN_REPS = 40            # phase 16: timed replays of a wrapper call


def plan_cells():
    """Phase 16's cells: (name, scenario number, camera, settings, width,
    height, spp) at the ladder's shapes (config 7: K4 and K3 with K = 1),
    and the capture frame (config 6's scene in the toroidal camera, rho 4,
    depth 10, as the benchmark's capture cell)."""
    from toroidal_ray_tracing_tpu_torch.cameras import ToroidalCamera
    from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
    from toroidal_ray_tracing_tpu_torch.scene import RenderSettings

    cells = []
    for num in (3, 5, 6, 7, 8):
        sc = SCENARIOS[num]
        cells.append((sc.name, num, sc.camera_at(0), sc.settings(), sc.width,
                      sc.height, sc.spp))
    cells.append(("capture_config6_rho4", 6,
                  ToroidalCamera(eye=(0.0, 1.5, 0.0), center=(8.0, 0.0, 0.0)),
                  RenderSettings.default(max_depth=10, rho=4.0), *FULL, 1))
    return cells


class CallRecorder:
    """The first call of each segment wrapper (V1, S1, K1, K5, K2, K3, S2,
    K4, S3), recorded as (fn, args, kwargs) while a frame renders, for
    replaying it alone."""

    def __init__(self):
        from toroidal_ray_tracing_tpu_torch.ops import torus_kernel as tok
        from toroidal_ray_tracing_tpu_torch.ops import trace_kernel as tk
        from toroidal_ray_tracing_tpu_torch.ops import visit_kernel as vk
        from toroidal_ray_tracing_tpu_torch.trace import wavefront as wf

        self.spots = [(vk, "visit_ranks", "V1 visit_rank"),
                      (tk, "visit_ranks", "V1 visit_rank"),
                      (tk, "loose_hit", "S1 loose_hit"),
                      (tk, "tri_closest_hit", "K1 tri_closest_hit"),
                      (tk, "tri_closest_hit_stream",
                       "K5 tri_closest_hit_stream"),
                      (tok, "torus_closest_hit_chunked",
                       "K2 torus_closest_hit"),
                      (tok, "torus_closest_hit_small",
                       "K3 torus_closest_hit_small"),
                      (wf, "shade_hit", "S2 shade_hit"),
                      (wf, "quad_gather", "K4 quad_gather"),
                      (wf, "shade_finish", "S3 shade_finish")]
        self.calls: dict = {}

    def __enter__(self):
        self.real = [getattr(m, a) for m, a, _ in self.spots]
        for (mod, attr, name), fn in zip(self.spots, self.real):
            def rec(*a, _fn=fn, _name=name, **k):
                self.calls.setdefault(_name, (_fn, a, k))
                return _fn(*a, **k)
            setattr(mod, attr, rec)
        return self

    def __exit__(self, *exc):
        for (mod, attr, _), fn in zip(self.spots, self.real):
            setattr(mod, attr, fn)


def host_us(torch, fn, reps: int = PLAN_REPS) -> float:
    """Host microseconds a call of fn() takes to return (its launch
    queued, not run): the median of 5 rounds of `reps` calls."""
    fn()
    torch.cuda.synchronize()
    rounds = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        rounds.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return statistics.median(rounds)


def same_outputs(torch, a, b) -> bool:
    """A wrapper's outputs equal bit for bit: tuples entry by entry, S2's
    `ShadeRays` on the lanes its contract defines."""
    from toroidal_ray_tracing_tpu_torch.ops import shade_kernel as sk

    if isinstance(a, sk.ShadeRays):
        return all(nan_equal(torch, x[..., m], y[..., m])
                   for (_, x, m), (_, y, _) in zip(
                       sk.defined_entries(a, a.tex is not None),
                       sk.defined_entries(b, b.tex is not None)))
    if isinstance(a, torch.Tensor):
        return nan_equal(torch, a, b)
    return len(a) == len(b) and all(same_outputs(torch, x, y)
                                    for x, y in zip(a, b))


def strided_twin(torch, fn, a, k):
    """Whether the wrapper call fn(*a, **k), whose first two arguments are
    the rays' (3, N) rows, gives the same bits on the rows at another row
    stride (contiguous rows when they were a state's prefix, else rows
    inside a wider buffer)."""
    o, d = a[0], a[1]
    n = o.shape[1]
    if o.is_contiguous():
        wide = torch.empty((6, n + 4096), device=o.device)
        wide[0:3, :n], wide[3:6, :n] = o, d
        o2, d2 = wide[0:3, :n], wide[3:6, :n]
    else:
        o2, d2 = o.contiguous(), d.contiguous()
    k = {key: v for key, v in k.items() if key != "out"}
    return same_outputs(torch, fn(*a, **k), fn(o2, d2, *a[2:], **k))


def phase_segment_plan(torch, results):
    """Phase 16: the bounce loop's segment plan (`ops.segment_plan`) on the
    card. Each cell's frame renders through the plan and through the
    wrappers' default route (`wavefront.segment_plan` giving none): image,
    dumps and ray count bit-equal, `plan_segments` equal to the planned
    frame's S3 launches (its segments) and none on the default route. The
    first call of each ray-reading wrapper (S1, K1, K5, K2, K3, S2) gives
    the same bits with its rays' rows at another row stride. Then each
    wrapper's first call of each route is replayed alone: the host
    microseconds a call takes with the plan's outputs (`out=`) and without
    (its checks, allocations and route), into the kernels' results as
    `host_us` / `host_us_plan`."""
    from toroidal_ray_tracing_tpu_torch import render
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
        LAUNCHES, reset_launches)
    from toroidal_ray_tracing_tpu_torch.trace import wavefront as wf
    from toroidal_ray_tracing_tpu_torch.utils.profiling import COUNTERS

    timing: dict = {}
    for name, num, cam, st, w, h, spp in plan_cells():
        _, scene = config(num)
        outs, calls, segs = {}, {}, {}
        for route in ("default", "plan"):
            real = wf.segment_plan
            if route == "default":
                wf.segment_plan = lambda *a, **k: None
            before = COUNTERS["plan_segments"]
            try:
                with CallRecorder() as rec:
                    reset_launches()
                    outs[route] = render(scene, cam, w, h, st,
                                         backend="kernel", spp=spp,
                                         device=DEVICE)
                    sync(torch)
                    segs[route] = (LAUNCHES["shade_finish"],
                                   COUNTERS["plan_segments"] - before)
            finally:
                wf.segment_plan = real
            calls[route] = rec.calls
        same = all(bit_equal(outs["plan"][k], outs["default"][k])
                   for k in ("image", "hit_position", "ray_origin",
                             "ray_dir"))
        check(same and outs["plan"]["rays_traced"]
              == outs["default"]["rays_traced"],
              f"{name}: the plan's frame bit-equal to the default route's "
              f"(image, dumps), rays {outs['plan']['rays_traced']} / "
              f"{outs['default']['rays_traced']}")
        check(segs["plan"][1] == segs["plan"][0] > 0
              and segs["default"][1] == 0,
              f"{name}: plan_segments {segs['plan'][1]} = the planned "
              f"frame's {segs['plan'][0]} segments; default route "
              f"{segs['default'][1]}")
        strided = [kernel for kernel, (fn, a, k) in calls["default"].items()
                   if kernel.split()[0] in ("S1", "K1", "K5", "K2", "K3",
                                            "S2")
                   and not strided_twin(torch, fn, a, k)]
        check(not strided, f"{name}: S1, K1, K5, K2, K3, S2 give the same "
              f"bits at another row stride ({len(calls['default'])} "
              f"wrappers called; off: {strided or 'none'})")
        for kernel, (fn, a, k) in calls["plan"].items():
            d = calls["default"].get(kernel)
            if d is None or k.get("out") is None:
                continue
            plain = host_us(torch, lambda: d[0](*d[1], **d[2]))
            planned = host_us(torch, lambda: fn(*a, **k))
            timing.setdefault(kernel, {})[name] = (plain, planned)
    print("host us a wrapper call, segment 0, default route -> plan:",
          flush=True)
    for kernel, by_cell in timing.items():
        cells = "; ".join(f"{c} {p:.1f} -> {q:.1f}"
                          for c, (p, q) in by_cell.items())
        print(f"  {kernel}: {cells}", flush=True)
        key = kernel.split(" ", 1)[1]
        row = results.setdefault(key, {})
        row["host_us"] = {c: p for c, (p, _) in by_cell.items()}
        row["host_us_plan"] = {c: q for c, (_, q) in by_cell.items()}


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=None,
                    help="comma-separated phases to run after 1 and 2 (6 "
                         "and 8 also need 4, 14 needs 7); default: every "
                         "phase")
    args = ap.parse_args(argv)
    only = (None if args.only is None
            else {int(x) for x in args.only.split(",") if x})

    def want(n: int) -> bool:
        return only is None or n in only

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import toroidal_ray_tracing_tpu_torch  # noqa: F401  (sets TF32 off)
    from toroidal_ray_tracing_tpu_torch.ops import kernel_common

    phase_s = {}

    def phase(title):
        phase_s[title] = time.perf_counter()
        print(f"== {title}", flush=True)

    def done(title):
        phase_s[title] = time.perf_counter() - phase_s[title]
        print(f"-- {title}: {phase_s[title]:.1f} s", flush=True)

    phase("1. device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    for line in smi.stdout.strip().splitlines():
        print(line, flush=True)
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}",
          flush=True)
    done("1. device")

    phase("2. build")
    path = kernel_common.build_library()
    kernel_common.library()
    print(f"built {os.path.relpath(path)} in "
          f"{kernel_common.BUILD_LOG['seconds']} s", flush=True)
    for line in kernel_common.BUILD_LOG["ptxas"].splitlines():
        if ("registers" in line or "Compiling entry" in line
                or "smem" in line):
            print("  " + line.strip(), flush=True)
    done("2. build")

    results: dict = {}
    launches: dict = {}
    stats = cells = profile_rows = experiment = front_doors = phase9 = None
    oracle_rows = compaction_rows = streams = None
    if want(3):
        phase("3. kernels against their plain twins")
        phase_kernels(torch, results)
        done("3. kernels against their plain twins")

    if want(4):
        phase("4. main path: render / render_frames / render_sequence "
              "(backend='kernel', device='cuda')")
        SEGMENTS.update(checked=0, bad=[])
        FRONT.update(samples=0, shrinks=0, bad=[])
        stats, cells = phase_main_path(torch, launches)
        segments_checked("phase 4")
        front_checked("phase 4", need_shrink=True)
        done("4. main path: render / render_frames / render_sequence "
             "(backend='kernel', device='cuda')")

    if want(5):
        phase("5. goldens on the card")
        phase_goldens(torch)
        done("5. goldens on the card")

    if want(6) and stats is not None:
        phase("6. profile: one frame per cell")
        profile_rows = phase_profile(torch, cells, stats)
        done("6. profile: one frame per cell")

    if want(7):
        phase("7. experiment: OBJ scenes, rho sweep, gTruth, reprojection")
        before = dict(launches)
        SEGMENTS.update(checked=0, bad=[])
        FRONT.update(samples=0, shrinks=0, bad=[])
        experiment = phase_experiment(torch, launches, smi.stdout.strip())
        segments_checked("phase 7")
        front_checked("phase 7", need_shrink=False)
        done("7. experiment: OBJ scenes, rho sweep, gTruth, reprojection")

    if want(8) and stats is not None:
        phase("8. measurement front doors")
        before = dict(launches)
        front_doors = phase_front_doors(torch, launches, stats)
        print("launches, phases 4 and 7: " + json.dumps(before)
              + "; phase 8: " + json.dumps({k: launches[k] - before.get(k, 0)
                                            for k in launches}), flush=True)
        segments_checked("phase 8")
        front_checked("phase 8", need_shrink=False)
        done("8. measurement front doors")

    if want(9):
        phase("9. gradients and multi-device")
        before = dict(launches)
        phase9 = phase_gradients_multidevice(torch, launches)
        print("launches, phase 9: " + json.dumps(
            {k: launches[k] - before.get(k, 0) for k in launches}), flush=True)
        segments_checked("phase 9")
        front_checked("phase 9", need_shrink=False, need_samples=False)
        done("9. gradients and multi-device")

    if want(10):
        phase("10. oracle on the card")
        before = dict(launches)
        oracle_rows = phase_oracle(torch, launches)
        print("launches, phase 10: " + json.dumps(
            {k: launches[k] - before.get(k, 0) for k in launches}), flush=True)
        segments_checked("phase 10")
        front_checked("phase 10", need_shrink=False)
        done("10. oracle on the card")

    if want(11):
        phase("11. compaction")
        before = dict(launches)
        compaction_rows = phase_compaction(torch, launches)
        print("launches, phase 11: " + json.dumps(
            {k: launches[k] - before.get(k, 0) for k in launches}), flush=True)
        segments_checked("phase 11")
        front_checked("phase 11", need_shrink=True)
        done("11. compaction")

    if want(12):
        phase("12. random streams and the graft entry")
        before = dict(launches)
        streams = phase_streams_entry(torch, launches)
        print("launches, phase 12: " + json.dumps(
            {k: launches[k] - before.get(k, 0) for k in launches}), flush=True)
        done("12. random streams and the graft entry")

    if want(13):
        phase("13. segment kernels S1-S3 against their twins")
        phase_segment_kernels(torch, results)
        done("13. segment kernels S1-S3 against their twins")

    if want(14):
        phase("14. front-door kernels R1, G1, F1 against their twins")
        phase_front_kernels(torch, results)
        done("14. front-door kernels R1, G1, F1 against their twins")

    if want(15):
        phase("15. visit ranks V1 and the query folds against their twins")
        phase_visit_ranks(torch, results)
        done("15. visit ranks V1 and the query folds against their twins")

    if want(16):
        phase("16. the segment plan against the default route")
        phase_segment_plan(torch, results)
        done("16. the segment plan against the default route")

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:", file=sys.stderr)
        for f in FAILURES:
            print("  " + f, file=sys.stderr)
        return 1
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": smi.stdout.strip(), "kernels": results,
                   "cells": stats, "profile": profile_rows,
                   "experiment": experiment, "front_doors": front_doors,
                   "gradients_multidevice": phase9,
                   "oracle": oracle_rows, "compaction": compaction_rows,
                   "streams_entry": streams,
                   "phase_seconds": phase_s},
                  f, indent=1)
    keys = ("route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = []
    for k, v in results.items():
        row = dict(v, name=k, route="cuda", launches=launches.get(k))
        kernels.append({"name": k, **{key: row.get(key) for key in keys},
                        **{key: row[key] for key in ("host_us",
                                                     "host_us_plan")
                           if key in row}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
