"""K2 and K3: analytic torus closest-hit / any-hit.

* K2 `torus_closest_hit_chunked` (CUDA `csrc/torus_hit.cu::torus_closest_hit`)
  replaces the JAX package's TPU kernel `ops/torus_kernel.py:136`
  (`_torus_kernel`). Contract: tori in chunks of 8 (16 above 64 tori),
  chunks ranked front to back, each torus culled by its world box; the
  winner is the minimum of (t, chunk rank, torus index). The twin walks
  the chunks in rank order with the per-torus slab against the bound at
  the chunk's start; the kernel walks a binary tree over the live tori's
  boxes (`kernel_common.build_tree`, one torus per leaf) as warp packets,
  each box at the ray's running bound, and spreads the quartics of the
  passing (ray, torus) pairs over the warp's lanes.
* K3 `torus_closest_hit_small` (CUDA `torus_closest_hit_small`) replaces
  `torus_kernel.py:530` (`_torus_small_kernel`): K <= 8 tori, a union-box
  gate, then every torus with the per-torus slab against the running best,
  one thread per ray in the kernel; any-hit writes idx 0, as the TPU
  kernel does.

`torus_closest_hit` routes between them with the TPU launcher's rule
(`torus_kernel.py:392-394`) on the batch size the caller pads to. Each
wrapper launches its CUDA kernel on CUDA tensors and runs its plain PyTorch
twin (same inputs, same outputs) on CPU tensors. Both take the scene's
tables prebuilt (`torus_tables`: padded transforms and radii, torus and
chunk boxes, the tree, the material rows and K3's parameter blocks) and
never build them; the orchestrator keeps them per scene and device. Only
K2's chunk rank is per call: the caller's (the bounce loop ranks a
segment's sets once with the visit-rank kernel V1, `ops.visit_kernel`), or
V1 on the call's own rays. In any-hit mode both kernels can also write the
query's occlusion byte, or OR their hits into the earlier kernels'
(`kernel_common.fold_outputs`).

Outputs: t (N,) f32 (BIG on a miss), idx (N,) i32, and with want_attrs the
(15, N) attrs: the winner's unnormalized world normal (rows 0-2) and its
12 material values, zero on a miss.
"""

from __future__ import annotations

import dataclasses

import torch

from toroidal_ray_tracing_tpu_torch.geom.torus import quartic_min_positive
from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
    BIG, F32, I32, TMIN, _inv_dir, box_pass, check_args, check_folds,
    check_rays, count, fill, fold_outputs, launch, round_up, slab, tree_rank,
    tree_tensors)
from toroidal_ray_tracing_tpu_torch.ops.visit_kernel import visit_rank
from toroidal_ray_tracing_tpu_torch.utils import profiling

TORUS_CHUNK = 8           # tori per chunk, K <= 64
GATED_TORUS_CHUNK = 16    # tori per chunk, K > 64
TORUS_SMALL_MAX_K = 8
TORUS_SMALL_TILE = 2048
TORUS_SMALL_MAX_RAYS = 1 << 20
TORUS_SMALL_WORK_MAX = 4 << 20
N_ATTR = 15


def _w2o_rays(w, ox, oy, oz, dx, dy, dz):
    """Affine object-frame ray transform (t-preserving), component-wise.
    w: 12-sequence of row-major world-to-object entries."""
    oxo = w[0] * ox + w[1] * oy + w[2] * oz + w[3]
    oyo = w[4] * ox + w[5] * oy + w[6] * oz + w[7]
    ozo = w[8] * ox + w[9] * oy + w[10] * oz + w[11]
    dxo = w[0] * dx + w[1] * dy + w[2] * dz
    dyo = w[4] * dx + w[5] * dy + w[6] * dz
    dzo = w[8] * dx + w[9] * dy + w[10] * dz
    return oxo, oyo, ozo, dxo, dyo, dzo


def _torus_quartic_coeffs(oxo, oyo, ozo, dxo, dyo, dzo, Rmaj, rmin):
    """Monic quartic coefficients in the closest-approach frame. Returns
    (b3, b2, b1, b0, tshift, px, py, pz)."""
    m = torch.clamp(dxo * dxo + dyo * dyo + dzo * dzo, min=1e-30)
    tshift = -(oxo * dxo + oyo * dyo + ozo * dzo) / m
    px = oxo + tshift * dxo
    py = oyo + tshift * dyo
    pz = ozo + tshift * dzo
    od = px * dxo + py * dyo + pz * dzo
    oo = px * px + py * py + pz * pz
    R2 = Rmaj * Rmaj
    k = oo + R2 - rmin * rmin
    dxz2 = dxo * dxo + dzo * dzo
    oxz_dxz = px * dxo + pz * dzo
    oxz2 = px * px + pz * pz
    inv4 = 1.0 / (m * m)
    b3 = 4.0 * m * od * inv4
    b2 = (2.0 * m * k + 4.0 * od * od - 4.0 * R2 * dxz2) * inv4
    b1 = (4.0 * od * k - 8.0 * R2 * oxz_dxz) * inv4
    b0 = (k * k - 4.0 * R2 * oxz2) * inv4
    return b3, b2, b1, b0, tshift, px, py, pz


def _torus_obj_normal(px, py, pz, dxo, dyo, dzo, troot, Rmaj, hitm):
    """Object-space normal at p* + troot*d: p - R * normalize((x, 0, z)).
    Misses are sanitized (BIG roots would make 0*inf NaNs)."""
    ts = torch.where(hitm, troot, 0.0)
    pxh = px + ts * dxo
    pyh = py + ts * dyo
    pzh = pz + ts * dzo
    xz = torch.sqrt(torch.clamp(pxh * pxh + pzh * pzh, min=1e-30))
    scale = 1.0 - Rmaj / xz
    return pxh * scale, pyh, pzh * scale


def _obj_normal_to_world(w, nx, ny, nz):
    """World normal via the inverse-transpose: w2o's rotation rows applied
    as columns."""
    return (nx * w[0] + ny * w[4] + nz * w[8],
            nx * w[1] + ny * w[5] + nz * w[9],
            nx * w[2] + ny * w[6] + nz * w[10])


def _torus_boxes(w2o_rows, rad, chunk: int):
    """Per-torus world AABBs + `chunk`-torus chunk AABBs.

    The object-space box (R+r, r, R+r) mapped through the o2w rotation (the
    adjugate inverse of w2o's rotation rows) with the |M| h trick. Dead rows
    (minor radius <= 0) get far point boxes and drop out of the chunk
    reduction; a fully dead chunk keeps a far point box.
    w2o_rows: (Kp, 12); rad: (Kp, 2) [major, minor]; Kp % chunk == 0.
    Returns (tor_lo, tor_hi, chunk_lo, chunk_hi)."""
    r0 = w2o_rows[:, 0:3]
    r1 = w2o_rows[:, 4:7]
    r2 = w2o_rows[:, 8:11]
    tv = torch.stack([w2o_rows[:, 3], w2o_rows[:, 7], w2o_rows[:, 11]], dim=1)
    c0 = torch.linalg.cross(r1, r2, dim=1)
    c1 = torch.linalg.cross(r2, r0, dim=1)
    c2 = torch.linalg.cross(r0, r1, dim=1)
    det = (r0 * c0).sum(dim=1, keepdim=True)
    ok = det.abs() > 1e-30
    inv_det = torch.where(ok, 1.0, 0.0) / torch.where(ok, det, 1.0)
    rot = torch.stack([c0, c1, c2], dim=2) * inv_det[:, :, None]  # o2w (K,3,3)
    wc = -(rot[:, :, 0] * tv[:, 0:1] + rot[:, :, 1] * tv[:, 1:2]
           + rot[:, :, 2] * tv[:, 2:3])
    rmin_abs = rad[:, 1].abs()
    h_obj = torch.stack([rad[:, 0] + rmin_abs, rmin_abs,
                         rad[:, 0] + rmin_abs], dim=1)
    arot = rot.abs()
    h_w = (arot[:, :, 0] * h_obj[:, 0:1] + arot[:, :, 1] * h_obj[:, 1:2]
           + arot[:, :, 2] * h_obj[:, 2:3])
    alive = (rad[:, 1] > 0.0)[:, None]
    tor_lo = torch.where(alive, wc - h_w, 2.0e38)
    tor_hi = torch.where(alive, wc + h_w, 2.0e38)

    C = w2o_rows.shape[0] // chunk
    any_alive = alive.reshape(C, chunk).any(dim=1)[:, None]
    clo = tor_lo.reshape(C, chunk, 3).amin(dim=1)
    chi = torch.where(alive, wc + h_w, -2.0e38).reshape(C, chunk, 3).amax(dim=1)
    chi = torch.where(any_alive, chi, 2.0e38)
    return tor_lo, tor_hi, clo, chi


def _quartic_t(w, Rmaj, rmin, o, d, tmax, cand):
    """Closest root of each (torus, ray) pair: t (BIG where none or where
    `cand` is False) plus what the normal needs."""
    oxo, oyo, ozo, dxo, dyo, dzo = _w2o_rays(w, *o, *d)
    b3, b2, b1, b0, tshift, px, py, pz = _torus_quartic_coeffs(
        oxo, oyo, ozo, dxo, dyo, dzo, Rmaj, rmin)
    troot = quartic_min_positive(b3, b2, b1, b0, TMIN - tshift, tmax - tshift,
                                 newton_iters=3, extra_valid=cand,
                                 cubic="newton")
    t = torch.where(troot < BIG, troot + tshift, BIG)
    return t, troot, (px, py, pz, dxo, dyo, dzo)


def _winner_attrs(w2o_rows, rad, mat, idx, troot, o, d, hit):
    """(15, N) attrs of each ray's winning torus (zero on a miss),
    recomputed from the winner's index and shifted-frame root — the same
    arithmetic the kernels run after their walks."""
    k = idx.long()
    w = [w2o_rows[k, i] for i in range(12)]
    Rmaj = rad[k, 0]
    oxo, oyo, ozo, dxo, dyo, dzo = _w2o_rays(w, *o, *d)
    _, _, _, _, _, px, py, pz = _torus_quartic_coeffs(
        oxo, oyo, ozo, dxo, dyo, dzo, Rmaj, rad[k, 1])
    nx, ny, nz = _torus_obj_normal(px, py, pz, dxo, dyo, dzo, troot, Rmaj,
                                   hit)
    nrm = torch.stack(_obj_normal_to_world(w, nx, ny, nz), dim=0)
    attrs = torch.cat([nrm, mat[k].T], dim=0)
    return torch.where(hit, attrs, 0.0)


def torus_chunked_plain(origins, dirs, tmax, w2o_rows, rad, tor_lo, tor_hi,
                        clo, chi, order, chunk: int, mat=None,
                        occlusion: bool = False, counts=None, occ_out=None,
                        occ_or: bool = False):
    """Plain PyTorch twin of K2: vectorized over rays, one loop step per
    chunk in `order`. Returns (t, idx[, attrs]). counts: optional dict of
    the kernel's (ray, box) slab tests ("box": chunk and torus boxes) and
    (ray, torus) quartic tests ("prim"). occ_out, occ_or: the occlusion
    byte, as the wrapper's."""
    n = origins.shape[1]
    o = [origins[a] for a in range(3)]
    d = [dirs[a] for a in range(3)]
    inv = [_inv_dir(d[a]) for a in range(3)]
    best = torch.full((n,), BIG, dtype=torch.float32, device=origins.device)
    bidx = torch.zeros((n,), dtype=torch.int32, device=origins.device)
    broot = torch.zeros_like(best)
    for c in order.tolist():
        if occlusion:
            bound = torch.where(best < BIG, -1.0, tmax)
        else:
            bound = torch.minimum(tmax, best)
        ks = slice(c * chunk, (c + 1) * chunk)
        tn, tf = slab(tor_lo[ks, None, :], tor_hi[ks, None, :], o, inv)
        cand = (tn <= torch.minimum(tf, bound)) & (tf >= TMIN) \
            & (tmax > TMIN) & (rad[ks, 1:2] > 0.0)               # (chunk, N)
        if counts is not None:
            chunk_pass = box_pass(clo[c], chi[c], o, inv, bound, tmax)
            count(counts, "box", (best >= BIG).sum() if occlusion else n)
            count(counts, "box", chunk * chunk_pass.sum())
            count(counts, "prim", (cand & chunk_pass).sum())
        if not bool(cand.any()):
            continue
        w = [w2o_rows[ks, i:i + 1] for i in range(12)]
        t, troot, _ = _quartic_t(w, rad[ks, 0:1], rad[ks, 1:2], o, d, tmax,
                                 cand)
        ct, arg = torch.min(t, dim=0)
        better = ct < best
        best = torch.where(better, ct, best)
        bidx = torch.where(better, (c * chunk + arg).to(torch.int32), bidx)
        broot = torch.where(better, troot.gather(0, arg[None, :])[0], broot)
    fold_outputs(best, tmax, occlusion, occ_out=occ_out, occ_or=occ_or)
    if mat is None:
        return best, bidx
    hit = best < BIG
    return best, bidx, _winner_attrs(w2o_rows, rad, mat, bidx, broot, o, d,
                                     hit)


def torus_small_plain(origins, dirs, tmax, par, emit_attrs: bool,
                      occlusion: bool = False, counts=None, occ_out=None,
                      occ_or: bool = False):
    """Plain PyTorch twin of K3. par: (K, 32) per-torus blocks [w2o (12),
    Rmaj, rmin, box lo (3), box hi (3), mat (12)]. Returns (t, idx[,
    attrs]). counts: as `torus_chunked_plain`'s (union and torus boxes).
    occ_out, occ_or: the occlusion byte, as K2's."""
    n = origins.shape[1]
    K = par.shape[0]
    o = [origins[a] for a in range(3)]
    d = [dirs[a] for a in range(3)]
    inv = [_inv_dir(d[a]) for a in range(3)]
    ulo, uhi = par[0, 14:17], par[0, 17:20]
    for k in range(1, K):
        ulo = torch.minimum(ulo, par[k, 14:17])
        uhi = torch.maximum(uhi, par[k, 17:20])
    tn, tf = slab(ulo, uhi, o, inv)
    any_cand = (tn <= torch.minimum(tf, tmax)) & (tf >= TMIN) & (tmax > TMIN)
    count(counts, "box", n)

    best = torch.full((n,), BIG, dtype=torch.float32, device=origins.device)
    barg = torch.zeros((n,), dtype=torch.int32, device=origins.device)
    broot = torch.zeros_like(best)
    for k in range(K):
        if occlusion:
            bound = torch.where(best < BIG, -1.0, tmax)
        else:
            bound = torch.minimum(tmax, best)
        tn, tf = slab(par[k, 14:17], par[k, 17:20], o, inv)
        cand = any_cand & (tn <= torch.minimum(tf, bound)) & (tf >= TMIN) \
            & (tmax > TMIN) & (par[k, 13] > 0.0)
        if occlusion:   # no quartic after a ray's first hit, as in the CUDA
            cand &= best >= BIG   # kernel (a bound of -1 still passes a
                                  # box that holds the ray's origin)
        count(counts, "box", (any_cand & (best >= BIG)).sum() if occlusion
              else any_cand.sum())
        count(counts, "prim", cand.sum())
        w = [par[k, i] for i in range(12)]
        t, troot, _ = _quartic_t(w, par[k, 12], par[k, 13], o, d, tmax, cand)
        if occlusion:
            best = torch.minimum(best, t)
            continue
        better = t < best
        best = torch.where(better, t, best)
        barg = torch.where(better, k, barg)
        broot = torch.where(better, troot, broot)
    fold_outputs(best, tmax, occlusion, occ_out=occ_out, occ_or=occ_or)
    if not emit_attrs:
        return best, barg
    hit = best < BIG
    return best, barg, _winner_attrs(par[:, :12], par[:, 12:14], par[:, 20:],
                                     barg, broot, o, d, hit)


def _tables(w2o, major, minor, chunk: int):
    K = major.shape[0]
    Kp = round_up(K, chunk)
    w2o_rows = w2o.reshape(K, 12)
    rad = torch.stack([major, minor], dim=1)
    if Kp != K:
        pad = Kp - K
        eye = torch.eye(3, 4, dtype=torch.float32, device=w2o.device)
        w2o_rows = torch.cat([w2o_rows, eye.reshape(1, 12).expand(pad, 12)])
        pad_rad = torch.tensor([[0.0, -1.0]], dtype=torch.float32,
                               device=w2o.device)
        rad = torch.cat([rad, pad_rad.expand(pad, 2)])
    return w2o_rows.contiguous(), rad.contiguous()


def small_params(w2o, major, minor, mat_table=None):
    """K3's (K, 32) per-torus parameter blocks [w2o (12), Rmaj, rmin, box lo
    (3), box hi (3), mat (12)]."""
    K = major.shape[0]
    w2o_rows, rad = _tables(w2o, major, minor, 1)
    tor_lo, tor_hi, _, _ = _torus_boxes(w2o_rows, rad, 1)
    mat = mat_table if mat_table is not None else w2o_rows.new_zeros((K, 12))
    return torch.cat([w2o_rows, rad, tor_lo, tor_hi, mat], dim=1).contiguous()


@dataclasses.dataclass
class TorusTables:
    """The scene-constant inputs of K2, K3 and their twins."""

    K: int                   # tori
    chunk: int               # tori per chunk: 8, 16 above 64 tori
    w2o_rows: torch.Tensor   # (Kp, 12) world-to-object rows, padded
    rad: torch.Tensor        # (Kp, 2) [major, minor], pad rows minor -1
    tor_lo: torch.Tensor     # (Kp, 3) torus boxes (far points when dead)
    tor_hi: torch.Tensor
    clo: torch.Tensor        # (Kp / chunk, 3) chunk boxes
    chi: torch.Tensor
    tree_lo: torch.Tensor    # (M, 3) node boxes
    tree_hi: torch.Tensor
    tree_link: torch.Tensor  # (M, 3) int32, see kernel_common.build_tree
    depth: int
    mat: torch.Tensor | None    # (Kp, 12) material rows
    par: torch.Tensor | None    # (K, 32) K3's blocks, K <= 8


def torus_tables(w2o, major, minor, mat_table=None) -> TorusTables:
    """Build the scene-constant tables of K tori: w2o (K, 3, 4);
    major/minor (K,); mat_table optional (K, 12). K2's tables are padded to
    whole chunks; its tree's leaves are the live tori (minor radius > 0).
    K3's blocks are built too when K <= TORUS_SMALL_MAX_K. One host sync:
    the tree is built on the host."""
    K = major.shape[0]
    chunk = GATED_TORUS_CHUNK if K > 64 else TORUS_CHUNK
    w2o_rows, rad = _tables(w2o, major, minor, chunk)
    tor_lo, tor_hi, clo, chi = (a.contiguous() for a in
                                _torus_boxes(w2o_rows, rad, chunk))
    tree_lo, tree_hi, tree_link, depth = tree_tensors(tor_lo, tor_hi,
                                                      rad[:, 1] > 0.0)
    mat = None
    if mat_table is not None:
        mat = torch.cat([mat_table, mat_table.new_zeros(
            (w2o_rows.shape[0] - K, 12))]).contiguous()
    par = (small_params(w2o, major, minor, mat_table)
           if 1 <= K <= TORUS_SMALL_MAX_K else None)
    return TorusTables(K=K, chunk=chunk, w2o_rows=w2o_rows, rad=rad,
                       tor_lo=tor_lo, tor_hi=tor_hi, clo=clo, chi=chi,
                       tree_lo=tree_lo, tree_hi=tree_hi,
                       tree_link=tree_link, depth=depth, mat=mat, par=par)


def _check_tables(name: str, tables, want_attrs: bool) -> None:
    if not isinstance(tables, TorusTables):
        raise TypeError(f"{name} takes the scene's prebuilt TorusTables "
                        "(torus_tables)")
    if want_attrs and tables.mat is None:
        raise ValueError(f"{name}: want_attrs needs tables with a material "
                         "table")


def _hit_outputs(out, n: int, attrs: bool, device) -> None:
    """Check a torus kernel's planned outputs: (t, idx) (N,) and, with
    attrs, the (15, N) rows."""
    shapes = [((n,), F32), ((n,), I32)] + ([((N_ATTR, n), F32)] if attrs
                                           else [])
    if len(out) != len(shapes):
        raise ValueError(f"out: {len(out)} outputs, want {len(shapes)}")
    check_args(device, **{f"out{k}": (a, *shape)
                          for k, (a, shape) in enumerate(zip(out, shapes))})


def check_torus_closest_hit_chunked(origins, dirs, tmax, tables: TorusTables,
                                    want_attrs: bool = False,
                                    occlusion: bool = False, counters=None,
                                    rank=None, occ_out=None,
                                    occ_or: bool = False, out=None) -> int:
    """`torus_closest_hit_chunked`'s argument checks (a segment plan runs
    them once on its own arguments and outputs; rank None: V1 makes it);
    returns the rays' row stride."""
    _check_tables("torus_closest_hit_chunked", tables, want_attrs)
    rs = check_rays(origins, dirs, tmax)
    n = origins.shape[1]
    tb = tables
    Kp, C, M = tb.w2o_rows.shape[0], tb.clo.shape[0], tb.tree_lo.shape[0]
    mat = tb.mat if want_attrs else None
    check_args(origins.device, w2o=(tb.w2o_rows, (Kp, 12), F32),
               rad=(tb.rad, (Kp, 2), F32), tor_lo=(tb.tor_lo, (Kp, 3), F32),
               tor_hi=(tb.tor_hi, (Kp, 3), F32), clo=(tb.clo, (C, 3), F32),
               chi=(tb.chi, (C, 3), F32), tree_lo=(tb.tree_lo, (M, 3), F32),
               tree_hi=(tb.tree_hi, (M, 3), F32),
               tree_link=(tb.tree_link, (M, 3), I32),
               rank=(rank, (C,), I32), mat=(mat, (Kp, 12), F32),
               counters=(counters, (2,), torch.int64))
    check_folds(origins.device, n, occlusion, occ_out=occ_out, occ_or=occ_or)
    if out is not None:
        _hit_outputs(out, n, want_attrs, origins.device)
    return rs


def _torus_out(n: int, want_attrs: bool, device):
    out = (torch.empty((n,), dtype=torch.float32, device=device),
           torch.empty((n,), dtype=torch.int32, device=device))
    if want_attrs:
        out += (torch.empty((N_ATTR, n), dtype=torch.float32,
                            device=device),)
    return out


def torus_closest_hit_chunked(origins, dirs, tmax, tables: TorusTables,
                              want_attrs: bool = False,
                              occlusion: bool = False,
                              n_batch: int | None = None, counters=None,
                              rank=None, occ_out=None,
                              occ_or: bool = False, out=None):
    """K2 wrapper. origins/dirs (3, N), each row contiguous, at one row
    stride (a prefix of the bounce loop's state is fine); tmax (N,);
    tables: the scene's `torus_tables`. n_batch: batch size the chunk
    visit order averages origins over (default N). counters: optional (2,)
    int64 CUDA tensor the kernel adds its (ray, box) slab tests and (ray,
    torus) quartics to (inside `utils.profiling.record_segments`, a
    counters tensor of the record's where none is given). rank: the (C,)
    int32 visit rank of the chunks
    (default: V1 on these rays). occ_out: in occlusion mode, an optional
    (N,) bool occlusion byte the kernel writes (or, with occ_or, ORs its
    hits into). out: (t, idx[, attrs]) from a segment plan
    (`kernel_common.Planned`; no check, no allocation)."""
    n = origins.shape[1]
    tb = tables
    if out is None:
        rs = check_torus_closest_hit_chunked(origins, dirs, tmax, tb,
                                             want_attrs, occlusion, counters,
                                             rank, occ_out, occ_or)
    else:
        rs = origins.stride(0)
    if rank is None:
        rank = visit_rank(origins, n_batch or n, tb.clo, tb.chi)
    mat = tb.mat if want_attrs else None
    if profiling.HIT_CALLS is not None and n:
        call = profiling.HitCall(
            "torus_closest_hit", n, bool(want_attrs), False,
            occ_out is not None, bool(occ_or), tb.tree_lo.shape[0],
            tb.clo.shape[0], 0, tb.w2o_rows.shape[0])
        if counters is None:     # the card counts the call's work
            counters = profiling.record_call(call, origins.device)
        else:
            profiling.record_call(call)

    if not origins.is_cuda:
        if counters is not None:
            raise ValueError("counters count the CUDA kernel's work")
        got = torus_chunked_plain(origins, dirs, tmax, tb.w2o_rows, tb.rad,
                                  tb.tor_lo, tb.tor_hi, tb.clo, tb.chi,
                                  tree_rank(rank), tb.chunk, mat, occlusion,
                                  occ_out=occ_out, occ_or=occ_or)
        return got if out is None else fill(out, got)

    # the entry point refuses a tree deeper than the kernel's stack, with an
    # error that `launch` raises
    if out is None:
        out = _torus_out(n, want_attrs, origins.device)
    if n:
        launch("trt_torus_closest_hit", origins, dirs, tmax, n, rs,
               tb.w2o_rows, tb.rad, tb.tree_lo, tb.tree_hi, tb.tree_link,
               tb.tree_lo.shape[0], tb.depth, rank, tb.chunk, mat,
               int(occlusion), out[0], out[1],
               out[2] if want_attrs else None, counters, occ_out,
               int(occ_or), stream=getattr(out, "stream", None))
    return out


def check_torus_closest_hit_small(origins, dirs, tmax, tables: TorusTables,
                                  want_attrs: bool = False,
                                  occlusion: bool = False, counters=None,
                                  occ_out=None, occ_or: bool = False,
                                  out=None) -> int:
    """`torus_closest_hit_small`'s argument checks (a segment plan runs
    them once on its own arguments and outputs); returns the rays' row
    stride."""
    _check_tables("torus_closest_hit_small", tables, want_attrs)
    rs = check_rays(origins, dirs, tmax)
    n = origins.shape[1]
    K = tables.K
    if tables.par is None:
        raise ValueError(f"K3 takes 1..{TORUS_SMALL_MAX_K} tori, got {K}")
    check_args(origins.device, par=(tables.par, (K, 32), F32),
               counters=(counters, (2,), torch.int64))
    check_folds(origins.device, n, occlusion, occ_out=occ_out, occ_or=occ_or)
    if out is not None:
        _hit_outputs(out, n, want_attrs, origins.device)
    return rs


def torus_closest_hit_small(origins, dirs, tmax, tables: TorusTables,
                            want_attrs: bool = False,
                            occlusion: bool = False, counters=None,
                            occ_out=None, occ_or: bool = False, out=None):
    """K3 wrapper (K <= TORUS_SMALL_MAX_K tori); same contract as K2.
    counters: optional (2,) int64 CUDA tensor the kernel adds its (ray,
    box) slab tests and (ray, torus) quartics to, as the twin's `counts`
    counts them. occ_out, occ_or, out: as K2's."""
    n = origins.shape[1]
    if out is None:
        rs = check_torus_closest_hit_small(origins, dirs, tmax, tables,
                                           want_attrs, occlusion, counters,
                                           occ_out, occ_or)
    else:
        rs = origins.stride(0)
    K, par = tables.K, tables.par
    if profiling.HIT_CALLS is not None and n:
        profiling.HIT_CALLS.append(profiling.HitCall(
            "torus_closest_hit_small", n, bool(want_attrs), False,
            occ_out is not None, bool(occ_or), 0, 0, 0, K))

    if not origins.is_cuda:
        if counters is not None:
            raise ValueError("counters count the CUDA kernel's work")
        got = torus_small_plain(origins, dirs, tmax, par, want_attrs,
                                occlusion, occ_out=occ_out, occ_or=occ_or)
        return got if out is None else fill(out, got)

    if out is None:
        out = _torus_out(n, want_attrs, origins.device)
    if n:
        launch("trt_torus_closest_hit_small", origins, dirs, tmax, n, rs,
               par, K, int(occlusion), out[0], out[1],
               out[2] if want_attrs else None, counters, occ_out,
               int(occ_or), stream=getattr(out, "stream", None))
    return out


def use_small_kernel(n_batch: int, K: int) -> bool:
    """The TPU launcher's K3 route (torus_kernel.py:392-394) on a batch of
    `n_batch` rays (the caller's padded batch)."""
    return (K <= TORUS_SMALL_MAX_K
            and n_batch <= max(TORUS_SMALL_MAX_RAYS, TORUS_SMALL_WORK_MAX // K)
            and n_batch % TORUS_SMALL_TILE == 0)


def torus_closest_hit(origins, dirs, tmax, tables: TorusTables,
                      want_attrs: bool = False, occlusion: bool = False,
                      n_batch: int | None = None, rank=None, occ_out=None,
                      occ_or: bool = False, small: bool | None = None,
                      out=None):
    """Route to K3 or K2 as the TPU launcher does, then run it (rank: K2's
    visit rank, K3 has none; occ_out, occ_or: the occlusion byte; small:
    the route where the caller decided it, default
    `use_small_kernel(n_batch, K)`; out: the kernel's planned outputs)."""
    n_batch = n_batch or origins.shape[1]
    if small is None:
        small = use_small_kernel(n_batch, tables.K)
    if small:
        return torus_closest_hit_small(origins, dirs, tmax, tables,
                                       want_attrs=want_attrs,
                                       occlusion=occlusion, occ_out=occ_out,
                                       occ_or=occ_or, out=out)
    return torus_closest_hit_chunked(origins, dirs, tmax, tables,
                                     want_attrs=want_attrs,
                                     occlusion=occlusion, n_batch=n_batch,
                                     rank=rank, occ_out=occ_out,
                                     occ_or=occ_or, out=out)
