"""Shared pieces of the trace kernels: constants, the slab-test reciprocal
and pass rule, front-to-back visit order, the plain twins' work counts,
input checks, the outputs a segment plan hands a wrapper (`Planned`),
launch counters, and the nvcc build + ctypes loader of the hand-written
CUDA kernels in `csrc/`.

Build: every `csrc/*.cu` compiles with its own nvcc process (all started
together) and the objects link into ONE shared library with a plain C
interface, `build/libtrt_kernels_<hash>.so`, where the hash covers the
sources and the flags. It happens at the first CUDA call (or
`build_library()`), never at import, so the package imports on a machine
with no CUDA at all. `--fmad=false` keeps the kernels' rounding equal to
their plain PyTorch twins (no fused multiply-add contraction).

Dispatch rule for every kernel wrapper: a CUDA tensor launches the kernel
(or raises); a CPU tensor runs the kernel's plain PyTorch twin. There is
no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

BIG = 3.0e38          # "no hit" t (float32 value)
TMIN = 1.0e-3         # raytrace.rgen:61
SEG_TMAX = 10000.0    # raytrace.rgen:62: a live ray's tmax in a segment
SAH_BINS = 16         # build_tree's centroid bins per split

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")

# Kernel launches per kernel name. Each wrapper adds one exactly where it
# launches its CUDA kernel (never on the CPU twin path), so a run can show
# which kernels the main path went through. Reset with `reset_launches`.
LAUNCHES = {"tri_closest_hit": 0, "torus_closest_hit": 0,
            "torus_closest_hit_small": 0, "quad_gather": 0,
            "tri_closest_hit_stream": 0,
            "tri_closest_hit_stream_grouped": 0, "threefry_uniform": 0,
            "loose_hit": 0, "shade_hit": 0, "shade_finish": 0,
            "raygen": 0, "span_gather": 0, "frame_finish": 0,
            "visit_rank": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _inv_dir(dc):
    """Slab-test reciprocal: components with |d| <= 1e-30 become +/-3e38
    (by sign), so the slab arithmetic never sees inf * 0."""
    ok = dc.abs() > 1e-30
    r = torch.where(ok, 1.0, 0.0) / torch.where(ok, dc, 1.0)
    return torch.where(ok, r, torch.where(dc >= 0, 3e38, -3e38))


def slab(lo, hi, o, inv):
    """AABB slab entry/exit. lo/hi: (..., 3) boxes broadcast against the
    (3, ...) ray rows o/inv. Returns (tn, tf)."""
    t0 = [(lo[..., a] - o[a]) * inv[a] for a in range(3)]
    t1 = [(hi[..., a] - o[a]) * inv[a] for a in range(3)]
    tn = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]),
                                     torch.minimum(t0[1], t1[1])),
                       torch.minimum(t0[2], t1[2]))
    tf = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]),
                                     torch.maximum(t0[1], t1[1])),
                       torch.maximum(t0[2], t1[2]))
    return tn, tf


def walk_bound(best, tmax, occlusion: bool):
    """The slab bound of the next box: min(best, tmax), or -1 once an
    any-hit ray has its hit."""
    if occlusion:
        return torch.where(best < BIG, -1.0, tmax)
    return torch.minimum(best, tmax)


def box_pass(lo, hi, o, inv, bound, tmax):
    """The walks' slab rule: tn <= min(tf, bound), tf >= TMIN and
    tmax > TMIN."""
    tn, tf = slab(lo, hi, o, inv)
    return (tn <= torch.minimum(tf, bound)) & (tf >= TMIN) & (tmax > TMIN)


def count(counts, key: str, k) -> None:
    """Add k (int or 0-d tensor) to counts[key] when counting is on."""
    if counts is not None:
        counts[key] = counts.get(key, 0) + int(k)


def fold_outputs(t, tmax, occlusion: bool, tmax_out=None, occ_out=None,
                 occ_or: bool = False) -> None:
    """The folds a query's kernel writes beside its hit, for the kernel
    after it (the plain twins' form of csrc/common.cuh write_folds), in
    place: occ_out (N,) bool, the occlusion byte t < BIG, ORed into its
    own lanes where occ_or; tmax_out (N,), the next kernel's tmax: in
    occlusion mode 0 where t < BIG and tmax elsewhere, else min(tmax, t).
    In a query an earlier kernel that occluded a lane left its tmax 0, so
    tmax_out is 0 wherever occ_out holds."""
    hit = t < BIG
    if occ_out is not None:
        occ_out.copy_(occ_out | hit if occ_or else hit)
    if tmax_out is not None:
        tmax_out.copy_(torch.where(hit, 0.0, tmax) if occlusion
                       else torch.minimum(tmax, t))


def check_folds(device, n: int, occlusion: bool, tmax_out=None,
                occ_out=None, occ_or: bool = False) -> None:
    """Validate a kernel's fold outputs: (N,) float32 tmax_out, (N,) bool
    occ_out (occlusion mode only)."""
    check_args(device, tmax_out=(tmax_out, (n,), F32),
               occ_out=(occ_out, (n,), torch.bool))
    if occ_out is not None and not occlusion:
        raise ValueError("occ_out: the occlusion byte of an any-hit query")
    if occ_or and occ_out is None:
        raise ValueError("occ_or ORs into occ_out")


def batch_anchor(origins, n_batch: int):
    """The point a batch's visit order starts from: its mean origin. The
    JAX kernels average over their padded batch (pad rays have zero
    origins), so the sum is divided by that padded size `n_batch`. The sum
    runs in float64, so the anchor does not depend on the rays' order."""
    return (origins.sum(dim=1, dtype=torch.float64) / n_batch).float()


def box_distance(lo, hi, anchor):
    """Each (M, 3) box's clamped distance from the (3,) anchor, as
    elementwise ops in a fixed order (`(gx*gx + gy*gy) + gz*gz`, then the
    root), the order and rounding the visit-rank kernel V1 reproduces."""
    a = anchor[None, :]
    gap = torch.clamp(torch.maximum(lo - a, a - hi), min=0.0)
    gx, gy, gz = gap[:, 0], gap[:, 1], gap[:, 2]
    return torch.sqrt((gx * gx + gy * gy) + gz * gz)


def visit_order(lo, hi, origins, n_batch: int, anchor=None):
    """Front-to-back block order: argsort (stable) of each box's clamped
    distance from `anchor` (default: `batch_anchor(origins, n_batch)`)."""
    mean_o = batch_anchor(origins, n_batch) if anchor is None else anchor
    cdist = box_distance(lo, hi, mean_o)
    return torch.argsort(cdist, stable=True).to(torch.int32)


def tree_rank(order):
    """rank[s]: the position of box s in the visit order."""
    rank = torch.empty_like(order)
    rank[order.long()] = torch.arange(order.shape[0], dtype=order.dtype,
                                      device=order.device)
    return rank


def build_tree(box_lo, box_hi, leaves):
    """Binary tree over the boxes `leaves` (ids into box_lo/hi: K1's
    clusters, K2's tori, K5/K6's superblocks), top-down binned SAH on the
    box centroids along the widest centroid axis (object median where
    binning cannot split). Nodes in depth-first preorder, root 0, left
    child m + 1. Returns numpy (lo (M, 3) f32, hi (M, 3) f32, link (M, 3)
    i32, depth): link is (left, right, split axis) for an inner node (left
    holds the lower centroids) and (-1 - s, -1 - s, -1) for the leaf of box
    s, whose box is box s; depth counts the inner nodes on the longest
    root-to-leaf path. Two-wide: config 8's 3,339 superblocks make a tree
    16 deep, which the kernels' 64-entry stack (`kStack`,
    csrc/tree_walk.cuh) holds (their entry points refuse a deeper one); a
    binary node needs no ordering of its children beyond one direction
    sign, and a packet pushes at most one far child per level."""
    slo, shi = (np.asarray(a, np.float32) for a in (box_lo, box_hi))
    cent = (slo.astype(np.float64) + shi) * 0.5
    lo, hi, link = [], [], []

    def area(l, h):
        e = np.maximum(h - l, 0.0)
        return e[..., 0] * e[..., 1] + e[..., 1] * e[..., 2] \
            + e[..., 2] * e[..., 0]

    def split(ids):
        c = cent[ids]
        cmin, cmax = c.min(axis=0), c.max(axis=0)
        axis = int(np.argmax(cmax - cmin))
        ext = cmax[axis] - cmin[axis]
        if ext > 0:
            b = np.minimum(((c[:, axis] - cmin[axis]) / ext
                            * SAH_BINS).astype(np.int64), SAH_BINS - 1)
            blo = np.full((SAH_BINS, 3), np.inf)
            bhi = np.full((SAH_BINS, 3), -np.inf)
            np.minimum.at(blo, b, slo[ids])
            np.maximum.at(bhi, b, shi[ids])
            cnt = np.bincount(b, minlength=SAH_BINS)
            llo = np.minimum.accumulate(blo)
            lhi = np.maximum.accumulate(bhi)
            rlo = np.minimum.accumulate(blo[::-1])[::-1]
            rhi = np.maximum.accumulate(bhi[::-1])[::-1]
            nl = np.cumsum(cnt)
            cost = area(llo[:-1], lhi[:-1]) * nl[:-1] \
                + area(rlo[1:], rhi[1:]) * (len(ids) - nl[:-1])
            cost[(nl[:-1] == 0) | (nl[:-1] == len(ids))] = np.inf
            k = int(np.argmin(cost))
            if np.isfinite(cost[k]):
                return axis, ids[b <= k], ids[b > k]
        ids = ids[np.argsort(c[:, axis], kind="stable")]
        return axis, ids[:len(ids) // 2], ids[len(ids) // 2:]

    def node(ids):
        m = len(lo)
        lo.append(None)
        hi.append(None)
        link.append(None)
        if len(ids) == 1:
            s = int(ids[0])
            lo[m], hi[m], link[m] = slo[s], shi[s], (-1 - s, -1 - s, -1)
            return 0
        axis, left, right = split(ids)
        dl = node(left)
        r = len(lo)
        dr = node(right)
        lo[m] = np.minimum(lo[m + 1], lo[r])
        hi[m] = np.maximum(hi[m + 1], hi[r])
        link[m] = (m + 1, r, axis)
        return 1 + max(dl, dr)

    leaves = np.asarray(leaves, np.int64)
    depth = node(leaves) if len(leaves) else 0
    return (np.array(lo, np.float32).reshape(-1, 3),
            np.array(hi, np.float32).reshape(-1, 3),
            np.array(link, np.int32).reshape(-1, 3), depth)


def tree_tensors(box_lo, box_hi, live):
    """`build_tree` over the boxes where the (S,) bool tensor `live` holds,
    as tensors on the boxes' device: (tree_lo (M, 3), tree_hi (M, 3),
    tree_link (M, 3) int32, depth). A host build: one sync."""
    lo, hi, link, depth = build_tree(box_lo.cpu().numpy(),
                                     box_hi.cpu().numpy(),
                                     np.nonzero(live.cpu().numpy())[0])
    dev = box_lo.device
    return (torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev),
            torch.from_numpy(link).to(dev), depth)


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


F32 = torch.float32
I32 = torch.int32


def check_args(device, **args):
    """Each argument is (tensor or None, shape, dtype): it must lie on
    `device`, have that shape and dtype, and be contiguous — or raise."""
    for name, (a, shape, dtype) in args.items():
        if a is None:
            continue
        if a.device != device:
            raise ValueError(f"{name} on {a.device}, rays on {device}")
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(a.shape)}, want {shape}")
        if a.dtype != dtype:
            raise TypeError(f"{name}: dtype {a.dtype}, want {dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def check_rays(origins, dirs, tmax) -> int:
    """Validate the (3, N) float32 ray rows + (N,) tmax every kernel takes
    (tmax None: the rays alone) and return the rows' stride. origins and
    dirs may be row views of a larger buffer (a prefix of the bounce loop's
    (15, lanes) state): each row contiguous, both at one row stride, which
    the kernels take."""
    n = origins.shape[-1]
    dev = origins.device
    rs = origins.stride(0) if origins.dim() == 2 else 0
    for name, a in (("origins", origins), ("dirs", dirs)):
        if a.device != dev:
            raise ValueError(f"{name} on {a.device}, rays on {dev}")
        if tuple(a.shape) != (3, n):
            raise ValueError(f"{name}: shape {tuple(a.shape)}, want (3, {n})")
        if a.dtype != F32:
            raise TypeError(f"{name}: dtype {a.dtype}, want {F32}")
        if (n > 1 and a.stride(1) != 1) or a.stride(0) != rs:
            raise ValueError(f"{name}: each row contiguous, origins and "
                             "dirs at one row stride")
    check_args(dev, tmax=(tmax, (n,), F32))
    return rs


def ray_rows(origins, dirs):
    """(origins, dirs) as the kernels take them: as they are when each row
    is contiguous and both share a row stride (a prefix of the bounce
    loop's state), else contiguous copies (the transposed (N, 3) rays of
    `trace_rays_fixed`)."""
    ok = all(a.dim() == 2 and (a.shape[1] <= 1 or a.stride(1) == 1)
             and a.stride(0) == origins.stride(0) for a in (origins, dirs))
    return (origins, dirs) if ok else (origins.contiguous(),
                                       dirs.contiguous())


class Planned(tuple):
    """A wrapper's outputs from a segment plan (`ops.segment_plan`), passed
    as `out=`: views of the plan's workspace, in the order the wrapper
    returns them (None for an output the call does not write), and the raw
    CUDA stream its launch goes on (None on the CPU); keyword extras are a
    kernel's scratch buffers. The plan ran the wrapper's checks on these
    arguments once, when it was built, so a wrapper handed one checks
    nothing and allocates nothing. On CPU tensors the twin runs and its
    results are copied into the views (`fill`)."""

    def __new__(cls, views, stream=None, **extra):
        out = super().__new__(cls, views)
        out.stream = stream
        out.__dict__.update(extra)
        return out


def fill(out: Planned, results) -> Planned:
    """A twin's results copied into a plan's views; returns the views."""
    for view, r in zip(out, results):
        if view is not None:
            view.copy_(r)
    return out


# ---------------------------------------------------------------------------
# nvcc build + ctypes loader
# ---------------------------------------------------------------------------

_lock = threading.Lock()
_lib = None
BUILD_LOG = {"seconds": None, "path": None, "ptxas": ""}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
_SIGNATURES = {
    # origins, dirs, tmax, n, ray row stride, wrows, n_tris, tree_lo,
    # tree_hi, tree_link, n_nodes, depth, rank, cluster, box_test, a0, a1,
    # a2, occlusion, t, idx, u, v, attrs, counters, tmax_out, occ_out,
    # occ_or, stream
    "trt_tri_closest_hit": [_P, _P, _P, _I, _L, _P, _I, _P, _P, _P, _I, _I,
                            _P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P,
                            _P, _P, _P, _I, _P],
    # origins, dirs, tmax, n, ray row stride, w2o, rad, tree_lo, tree_hi,
    # tree_link, n_nodes, depth, rank, chunk, mat, occlusion, t, idx,
    # attrs, counters, occ_out, occ_or, stream
    "trt_torus_closest_hit": [_P, _P, _P, _I, _L, _P, _P, _P, _P, _P, _I,
                              _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _I,
                              _P],
    # origins, dirs, tmax, n, ray row stride, par, K, occlusion, t, idx,
    # attrs, counters, occ_out, occ_or, stream
    "trt_torus_closest_hit_small": [_P, _P, _P, _I, _L, _P, _I, _I, _P, _P,
                                    _P, _P, _P, _I, _P],
    # data4q, n_texels, f0, f1, valid, n, q0, q1, stream
    "trt_quad_gather": [_P, _I, _P, _P, _P, _I, _P, _P, _P],
    # origins, dirs, tmax, n, ray row stride, wrows, n_tris, tree_lo,
    # tree_hi, tree_link, n_nodes, depth, rank, clo, chi, g, cluster, a0,
    # a1, a2, occlusion, t, idx, u, v, attrs, counters, tmax_out, occ_out,
    # occ_or, stream
    "trt_tri_closest_hit_stream": [_P, _P, _P, _I, _L, _P, _I, _P, _P, _P,
                                   _I, _I, _P, _P, _P, _I, _I, _P, _P, _P,
                                   _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                   _P],
    "trt_tri_closest_hit_stream_grouped": [_P, _P, _P, _I, _L, _P, _I, _P,
                                           _P, _P, _I, _I, _P, _P, _P, _I,
                                           _I, _P, _P, _P, _I, _P, _P, _P,
                                           _P, _P, _P, _P, _P, _I, _P],
    # out, n, k1, k2, stream
    "trt_threefry_uniform": [_P, ctypes.c_int64, ctypes.c_uint32,
                             ctypes.c_uint32, _P],
    # origins, dirs, tmax, n, ray row stride, woop_o, woop_d, n_tris, base,
    # n_rows, prim_base, occlusion, t, kind, prim, u, v, tri_tmax, occ_out,
    # stream
    "trt_loose_hit": [_P, _P, _P, _I, _L, _P, _P, _I, _I, _I, _I, _I, _P,
                      _P, _P, _P, _P, _P, _P, _P],
    # origins, dirs, n, ray row stride, base t, kind, prim, u, v, tri t,
    # idx, u, v, tri_off, tor t, tri, tor, la0, la1, la2, n_cols,
    # loose_base, n_loose, consts, light_point, intensity, pixel_spread,
    # tex_off, tex_sizes, tex_levels, n_lv, shadow_o, shadow_d, shadow_tmax,
    # block, flags, tex_i0, tex_i1, tex_valid, stream
    "trt_shade_hit": [_P, _P, _I, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _I, _F,
                      _F, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                      _P],
    # state, lanes, active, nb, block, flags, shadow_o, shadow_d, occluded,
    # q0, q1, srgb, consts, first, more, rays, spans, count, tmax_next,
    # seg_tmax, stream
    "trt_shade_finish": [_P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _I, _I, _P, _P, _P, _P, _F, _P],
    # cam, kind, width, height, block, jitter, n, tail, o, d, row_stride,
    # elem_stride, rest, lanes, active, stream
    "trt_raygen": [_P, _I, _I, _I, _I, _P, _I, _I, _P, _P, _L, _I, _P, _L,
                   _P, _P],
    # cur, spare, act_in, act_out, live, count, orig_in, orig_out, slot,
    # s_old, s_fit, s_total, lanes, tmax_out, seg_tmax, stream
    "trt_span_gather": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L,
                        _P, _F, _P],
    # cam, kind, width, height, block, hv, slot, lanes, off, hp, img, s,
    # spp, hp_out, o_out, d_out, chw, stream
    "trt_frame_finish": [_P, _I, _I, _I, _I, _P, _P, _L, _L, _P, _P, _I, _I,
                         _P, _P, _P, _I, _P],
    # origins, row_stride, lanes, n_batch, lo0, hi0, m0, rank0, lo1, hi1,
    # m1, rank1, anchor, partial, ticket, scratch, stream
    "trt_visit_rank": [_P, _L, _I, _I, _P, _P, _I, _P, _P, _P, _I, _P, _P,
                       _P, _P, _P, _P],
}


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _run(procs):
    """Wait for each (name, Popen); raise with the first failure's stderr.
    Returns the stderr texts."""
    errs = []
    for name, proc in procs:
        _, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            for _, other in procs:
                other.kill()
                other.wait()
            raise RuntimeError(f"nvcc failed on {name} "
                               f"({proc.returncode}):\n{err}")
        errs.append(err)
    return errs


def build_library() -> str:
    """Compile csrc/*.cu into the shared library (once per source hash) and
    return its path: one nvcc per source in parallel, then one link. Raises
    with nvcc's stderr if a step fails."""
    digest = _digest()
    out = os.path.join(BUILD_DIR, f"libtrt_kernels_{digest}.so")
    if os.path.exists(out):
        BUILD_LOG["path"] = out
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{digest}.{os.getpid()}"
    srcs = [s for s in _sources() if s.endswith(".cu")]
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o")
            for s in srcs]
    popen = dict(stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    ptxas = _run([(os.path.basename(s), subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-c", s, "-o", o], **popen))
        for s, o in zip(srcs, objs)])
    tmp = f"{out}.{os.getpid()}.tmp"
    _run([("link", subprocess.Popen([_nvcc(), "-shared", "-o", tmp, *objs],
                                    **popen))])
    for o in objs:
        os.remove(o)
    os.replace(tmp, out)
    BUILD_LOG.update(seconds=time.perf_counter() - t0, path=out,
                     ptxas="".join(ptxas))
    return out


def library():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


_entries: dict = {}   # C entry point name -> its ctypes function


def entry(name: str):
    """The ctypes function of C entry point `name`, resolved once (the
    library is built and loaded at the first)."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(library(), name)
    return fn


def launch(name: str, *args, stream=None) -> None:
    """Call C entry point `name` on `stream` (a raw CUDA stream handle, a
    segment plan's; default the current stream); raise if the launch
    reports an error (cudaGetLastError != 0). Tensor arguments pass as
    device pointers (None -> NULL)."""
    fn = _entries.get(name) or entry(name)
    if stream is None:
        stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a
              for a in args], stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    LAUNCHES[name[4:]] += 1
