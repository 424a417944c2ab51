"""V1: the visit ranks of the tree kernels K1, K2 and K5/K6, with their
anchor, in one launch.

`visit_ranks` is the wrapper: on CUDA tensors it launches the hand-written
kernel `csrc/visit.cu::visit_rank`; on CPU tensors it runs
`visit_ranks_plain`, the plain PyTorch twin with the same inputs and
outputs (`kernel_common.batch_anchor`, `visit_order`, `tree_rank`). It is
the port's counterpart of what XLA fuses of the JAX package's visit orders
beside its Pallas calls (`ops/tri_kernel.py:398-409`,
`ops/torus_kernel.py:438-450`, `ops/tri_stream.py:534-538`); no Pallas
kernel.

Contract: the anchor is `batch_anchor(origins, n_batch)`, the rows' float64
sum over n_batch cast to float32 (the kernel sums in a fixed order, so two
launches on the same origins give the same bits); for each (lo, hi) box
set, rank[s] is box s's position in the stable ascending order of its
clamped distance from the anchor (`kernel_common.box_distance`, NaN after
every number). The tree kernels take only the rank.

The bounce loop ranks a segment's sets once (its segment plan's V1 call,
over the sets `ops.trace_kernel.segment_routes` names) and hands them to
both of its queries; a kernel wrapper that gets no rank launches V1 for
its one set.
"""

from __future__ import annotations

import torch

from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
    F32, I32, Planned, batch_anchor, check_args, launch, tree_rank,
    visit_order)

CLUSTER = 8               # csrc/visit.cu kCluster: the CTAs that rank a
                          # set above ONE_CTA_BOXES
ONE_CTA_BOXES = 512       # csrc/visit.cu kOneCtaBoxes
SLAB_KEYS = 8192          # csrc/visit.cu kSlabKeys: a set's sorted shares
                          # above this many keys go to a global scratch
_PARTIALS = 512 * 3       # csrc/visit.cu: one float64 triple a CTA
_scratch: dict = {}       # (device, stream) -> (partial, ticket)


def visit_ranks_plain(origins, n_batch: int, sets):
    """Plain PyTorch twin: (anchor (3,), [rank (M,) int32 per set])."""
    anchor = batch_anchor(origins, n_batch)
    return anchor, [tree_rank(visit_order(lo, hi, origins, n_batch, anchor))
                    for lo, hi in sets]


def cluster_for(ms) -> int:
    """csrc/visit.cu cluster_for: the CTAs that rank box sets of these
    sizes (one while every set fits ONE_CTA_BOXES)."""
    return CLUSTER if max(ms, default=0) > ONE_CTA_BOXES else 1


def share_keys(m: int, c: int) -> int:
    """csrc/visit.cu share_keys: the keys each of c CTAs sorts for an m-box
    set (its share ceil(m / c) padded to a power of two, at least 32; 0
    for no set)."""
    if m <= 0:
        return 0
    share, p = -(-m // c), 32
    while p < share:
        p *= 2
    return p


def _rows(origins):
    """The (3, lanes) float32 origin rows, each row contiguous (a view of
    the bounce loop's state is fine): (lanes, row stride)."""
    if (origins.dim() != 2 or origins.shape[0] != 3
            or origins.dtype != F32):
        raise ValueError(f"origins: {tuple(origins.shape)} {origins.dtype}, "
                         "want (3, lanes) float32")
    lanes = origins.shape[1]
    if lanes > 1 and origins.stride(1) != 1:
        raise ValueError("origins: each row must be contiguous")
    return lanes, origins.stride(0)


def _buffers(dev, stream=None):
    """The kernel's per-(device, stream) partial sums and ticket counter
    (zero once; every launch leaves it zero); stream: a raw handle, default
    the current stream."""
    if stream is None:
        stream = torch.cuda.current_stream(dev).cuda_stream
    key = (dev, stream)
    buf = _scratch.get(key)
    if buf is None:
        buf = (torch.empty((_PARTIALS,), dtype=torch.float64, device=dev),
               torch.zeros((1,), dtype=I32, device=dev))
        _scratch[key] = buf
    return buf


def check_visit_ranks(origins, n_batch: int, sets) -> tuple:
    """`visit_ranks`' argument checks (a segment plan runs them once on its
    own arguments); returns (lanes, the rows' stride)."""
    if len(sets) > 2:
        raise ValueError(f"V1 ranks at most two box sets, got {len(sets)}")
    lanes, row_stride = _rows(origins)
    if n_batch < 1:
        raise ValueError(f"n_batch {n_batch} < 1")
    for k, (lo, hi) in enumerate(sets):
        m = lo.shape[0]
        check_args(origins.device, **{f"lo{k}": (lo, (m, 3), F32),
                                      f"hi{k}": (hi, (m, 3), F32)})
    return lanes, row_stride


def slab_keys(sets) -> int:
    """The int64 words of global scratch V1 needs for these box sets (0:
    every set's shares fit shared memory)."""
    m = [lo.shape[0] for lo, _ in sets] + [0, 0]
    c = cluster_for(m)
    return sum(c * share_keys(k, c) for k in m[:2]
               if c * share_keys(k, c) > SLAB_KEYS)


def planned_outputs(sets, device, stream, views=None) -> Planned:
    """V1's outputs for these box sets, as a segment plan hands them
    (`out=`): the anchor (3,) and a rank (M,) int32 a set, from `views`
    where given (the plan's workspace) else new; the stream's partial sums
    and ticket and the slab scratch as extras."""
    if views is None:
        views = (torch.empty((3,), dtype=F32, device=device),
                 *(torch.empty((lo.shape[0],), dtype=I32, device=device)
                   for lo, _ in sets))
    slab = slab_keys(sets)
    partial, ticket = (_buffers(device, stream) if device.type == "cuda"
                       else (None, None))
    return Planned(views, stream, partial=partial, ticket=ticket,
                   scratch=(torch.empty((slab,), dtype=torch.int64,
                                        device=device) if slab else None))


def visit_ranks(origins, n_batch: int, sets, out=None):
    """V1 wrapper. origins: (3, lanes) float32 rows (each row contiguous);
    n_batch: the anchor's divisor (the caller's padded batch); sets: up to
    two (lo (M, 3), hi (M, 3)) float32 box sets on the origins' device.
    out: `planned_outputs` of these sets, from a segment plan (no check,
    no allocation). Returns (anchor (3,) float32, [rank (M,) int32 per
    set])."""
    if out is None:
        sets = list(sets)
        lanes, row_stride = check_visit_ranks(origins, n_batch, sets)
    else:
        lanes, row_stride = origins.shape[1], origins.stride(0)
    if not origins.is_cuda:
        anchor, ranks = visit_ranks_plain(origins, n_batch, sets)
        if out is None:
            return anchor, ranks
        out[0].copy_(anchor)
        for view, r in zip(out[1:], ranks):
            view.copy_(r)
        return out[0], list(out[1:])

    if out is None:
        out = planned_outputs(sets, origins.device, None)
    anchor, ranks = out[0], list(out[1:])
    m = [r.shape[0] for r in ranks] + [0, 0]
    args = [a for k in range(2) for a in (
        (*sets[k], m[k], ranks[k]) if k < len(sets) else (None, None, 0,
                                                          None))]
    launch("trt_visit_rank", origins, row_stride, lanes, int(n_batch), *args,
           anchor, out.partial, out.ticket, out.scratch, stream=out.stream)
    return anchor, ranks


def visit_rank(origins, n_batch: int, lo, hi):
    """One set's rank (V1 on CUDA tensors, the twin on CPU tensors)."""
    return visit_ranks(origins, n_batch, [(lo, hi)])[1][0]
