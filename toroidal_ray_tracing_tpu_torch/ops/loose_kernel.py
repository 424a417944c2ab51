"""S1: the loose-triangle hoist.

`loose_hit` is the wrapper: on CUDA tensors it launches the hand-written
kernel `csrc/loose_hit.cu::loose_hit` (one thread per ray, the rows in
shared memory); on CPU tensors it runs `loose_hit_plain`, the plain PyTorch
twin with the same inputs and outputs. It is the port's counterpart of
what XLA fuses of the JAX package's `ops/trace_kernel.py:207`
(`_loose_tri_hit`) and the merge after it (:325-333); no Pallas kernel.

Contract: per ray, the Woop unit-triangle test (K1's arithmetic,
`geom.triangle.woop_dots` / `woop_hit`) against the scene's L <= 16 loose
tail rows [base, base + L) of its Woop tables, the lowest row winning
ties; the winner comes out merged, as the triangle kernels' starting
point: t (BIG on a miss), kind (0 / -1), prim (prim_base + row, 0 on a
miss), u, v (0 on a miss), and the triangle kernels' tmax, min(tmax, t)
or, in occlusion mode, 0 where the ray hit; in occlusion mode, optionally,
the query's occlusion byte (t < BIG), which the later kernels OR into. The
kernel reads the rows from
the scene's (3, 4, T) / (3, 3, T) tables as they are, so nothing is kept
per scene for it.
"""

from __future__ import annotations

import torch

from toroidal_ray_tracing_tpu_torch.geom.triangle import woop_dots, woop_hit
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
    BIG, F32, I32, TMIN, check_args, check_folds, check_rays, fill,
    fold_outputs, launch)

LOOSE_MAX = 16      # scene/build.py LOOSE_TOTAL_MAX, the kernel's row cap


def loose_hit_plain(origins, dirs, tmax, woop_o, woop_d, base: int, L: int,
                    prim_base: int, occlusion: bool = False, occ_out=None):
    """Plain PyTorch twin: (t, kind, prim, u, v, tri_tmax), each (N,);
    occ_out as the wrapper's."""
    rows = slice(base, base + L)
    comps = woop_dots(woop_o[:, :, rows, None], woop_d[:, :, rows, None],
                      *origins, *dirs)                     # each (L, N)
    t, u, v, _ = woop_hit(*comps, TMIN, tmax)
    best, row = torch.min(t, dim=0)
    hit = best < BIG
    r = row[None, :]
    tri_tmax = (torch.where(hit, 0.0, tmax) if occlusion
                else torch.minimum(tmax, best))
    fold_outputs(best, tmax, occlusion, occ_out=occ_out)
    return (best, torch.where(hit, 0, -1).to(I32),
            torch.where(hit, prim_base + row, 0).to(I32),
            torch.where(hit, u.gather(0, r)[0], 0.0),
            torch.where(hit, v.gather(0, r)[0], 0.0), tri_tmax)


def check_loose_hit(origins, dirs, tmax, woop_o, woop_d, base: int, L: int,
                    occlusion: bool = False, occ_out=None, out=None) -> int:
    """`loose_hit`'s argument checks (a segment plan runs them once on its
    own arguments and outputs); returns the rays' row stride."""
    rs = check_rays(origins, dirs, tmax)
    n, T = origins.shape[1], woop_o.shape[2]
    check_args(origins.device, woop_o=(woop_o, (3, 4, T), F32),
               woop_d=(woop_d, (3, 3, T), F32))
    check_folds(origins.device, n, occlusion, occ_out=occ_out)
    if not (1 <= L <= LOOSE_MAX and 0 <= base and base + L <= T):
        raise ValueError(f"loose rows [{base}, {base + L}) of {T}: the "
                         f"kernel takes 1 to {LOOSE_MAX} rows of the table")
    if out is not None:
        check_args(origins.device, **{
            f"out{k}": (a, (n,), I32 if k in (1, 2) else F32)
            for k, a in enumerate(out)})
    return rs


def loose_hit(origins, dirs, tmax, woop_o, woop_d, base: int, L: int,
              prim_base: int, occlusion: bool = False, occ_out=None,
              out=None):
    """S1 wrapper. origins/dirs: (3, N) rows, each row contiguous, at one
    row stride (a prefix of the bounce loop's state is fine); tmax (N,);
    woop_o (3, 4, T) and woop_d (3, 3, T): the Woop tables, whose rows
    [base, base + L) are the loose tail, 1 <= L <= 16; prim_base: the
    global index of row base. occ_out: in occlusion mode, an optional (N,)
    bool tensor the kernel writes the query's occlusion byte (t < BIG)
    into. out: the six outputs from a segment plan
    (`kernel_common.Planned`; no check, no allocation). Returns (t, kind,
    prim, u, v, tri_tmax), each (N,): kind and prim int32."""
    n, T = origins.shape[1], woop_o.shape[2]
    if out is None:
        rs = check_loose_hit(origins, dirs, tmax, woop_o, woop_d, base, L,
                             occlusion, occ_out)
    else:
        rs = origins.stride(0)
    if not origins.is_cuda:
        got = loose_hit_plain(origins, dirs, tmax, woop_o, woop_d, base, L,
                              prim_base, occlusion, occ_out)
        return got if out is None else fill(out, got)
    if out is None:
        f32 = dict(dtype=F32, device=origins.device)
        i32 = dict(dtype=I32, device=origins.device)
        out = (torch.empty((n,), **f32), torch.empty((n,), **i32),
               torch.empty((n,), **i32), torch.empty((n,), **f32),
               torch.empty((n,), **f32), torch.empty((n,), **f32))
    if n:
        launch("trt_loose_hit", origins, dirs, tmax, n, rs, woop_o, woop_d,
               T, int(base), L, int(prim_base), int(occlusion), *out,
               occ_out, stream=getattr(out, "stream", None))
    return out
