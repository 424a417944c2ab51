"""Closest-hit / any-hit queries — the `traceRayEXT` replacement.

Two backends:

* `backend="torch"` (this module, `_closest_hit_torch`): the Woop test and
  the Ferrari quartic as plain tensor ops over (rays x prims) blocks,
  chunked over rays, the lowest index winning ties. Any device.
* `backend="kernel"` (`ops/trace_kernel.closest_hit_kernel`): the same
  query through the hand-written kernels (K1 triangles, K2/K3 tori) with
  kernel-emitted shading attributes. On CUDA tensors the kernels launch; on
  CPU tensors their plain twins run.

Multi-device: a query can test a slice of the primitives (`GeomSlice`,
offsets mapping local indices back to global ids); with `prim_group` the
per-rank winners then merge with a lexicographic min over that
`torch.distributed` group (`combine_hits_over_axis`).

Gradients: `closest_hit_diff` runs the kernels for the forward pass and
recomputes the backward pass through the dense torch path
(`ClosestHitDiff`).

Hit kinds: 0 = triangle, 1 = torus, -1 = miss (raytrace.rmiss).
Per-ray vectors are (3, N) rows throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from toroidal_ray_tracing_tpu_torch.geom import torus as torus_geom
from toroidal_ray_tracing_tpu_torch.geom.triangle import intersect_woop
from toroidal_ray_tracing_tpu_torch.scene.types import Scene, derived
from toroidal_ray_tracing_tpu_torch.utils.collectives import (MAX, MIN, SUM,
                                                              all_reduce)

BIG = 3.0e38
TMIN = 1.0e-3      # raytrace.rgen:61
TMAX = 10000.0     # raytrace.rgen:62
_INT_MAX = 2147483647


@dataclasses.dataclass
class ShadeAttrs:
    """Interpolated shading attributes of the winning primitive, emitted by
    the kernel backend. Vector fields are rows ((C, N))."""

    pos: torch.Tensor          # (3, N) barycentric-exact position (triangles)
    nrm: torch.Tensor          # (3, N) unnormalized shading normal (world)
    uv: torch.Tensor           # (2, N)
    ambient: torch.Tensor      # (3, N)
    diffuse: torch.Tensor      # (3, N)
    specular: torch.Tensor     # (3, N)
    shininess: torch.Tensor    # (N,)
    illum: torch.Tensor        # (N,) i32
    texture_id: torch.Tensor   # (N,) i32
    tex_density: torch.Tensor  # (N,) uv-texel density for mip LOD (tris only)


@dataclasses.dataclass
class AttrRows:
    """A kernel-backend closest-hit query's raw attribute rows and hit
    parts, what the shading kernel S2 (`ops.shade_kernel.shade_hit`) reads
    in place of `ShadeAttrs` and a merged `Hit`: the triangle kernels' 21
    rows (pos, nrm, uv, the 12 material values, the uv texel density) and
    the torus kernels' 15 rows (nrm, material) of each ray's winner of that
    kind, None where the query ran no such kernel; and where the
    loose-triangle hoist ran (only on the whole table, never on a slice of
    the primitives), the triangle interpolation tables (a0 (21, T), a1 (8,
    T), a2 (8, T)) and the index of the first of the n_loose tail rows:
    where the triangle side's winner is a tail row, the triangle rows come
    from the tables at (prim, u, v).

    The hit parts, each (N,) per ray, merged in this order with strict
    comparisons (`ops.trace_kernel.merge_parts`): `base`, the (t, kind,
    prim, u, v) the query starts from (the hoist's hit, or a hit merged
    already), None for no hit (t BIG, kind -1, prim 0, u = v = 0);
    `tri_hit`, the triangle kernel's (t, idx, u, v), idx local to the
    slice starting at `tri_offset`; `tor_hit`, the torus kernel's (t, idx)
    from `tor_offset`. tri_kind / tri_prim: the triangle side's winner
    (kind 0 / -1, prim) before the tori merged, which `merge_parts` sets
    where the loose tables are (`shade_attrs` reads it)."""

    tri: Optional[torch.Tensor] = None
    tor: Optional[torch.Tensor] = None
    loose: Optional[tuple] = None
    loose_base: int = 0
    n_loose: int = 0
    tri_kind: Optional[torch.Tensor] = None
    tri_prim: Optional[torch.Tensor] = None
    base: Optional[tuple] = None
    tri_hit: Optional[tuple] = None
    tri_offset: int = 0
    tor_hit: Optional[tuple] = None
    tor_offset: int = 0


@dataclasses.dataclass
class Hit:
    t: torch.Tensor      # (N,) f32, BIG on miss
    kind: torch.Tensor   # (N,) i32: 0 tri, 1 torus, -1 miss
    prim: torch.Tensor   # (N,) i32 index into triangles or tori
    u: torch.Tensor      # (N,) f32 triangle barycentric
    v: torch.Tensor      # (N,) f32
    attrs: Optional[ShadeAttrs | AttrRows] = None


@dataclasses.dataclass
class GeomSlice:
    """The intersection-only geometry a query tests: the whole scene, or
    one rank's slice of its primitives (`parallel.sharding`). The offsets
    map local indices back to global ids; the cluster boxes are the
    slice's own, so each slice culls against its clusters."""

    woop_o: torch.Tensor      # (3, 4, Tl)
    woop_d: torch.Tensor      # (3, 3, Tl)
    cluster_lo: torch.Tensor  # (Cl, 3)
    cluster_hi: torch.Tensor  # (Cl, 3)
    tor_w2o: torch.Tensor     # (Kl, 3, 4)
    tor_major: torch.Tensor   # (Kl,)
    tor_minor: torch.Tensor   # (Kl,)
    tri_offset: int = 0       # global index of the slice's first triangle
    tor_offset: int = 0       # ... and of its first torus


def geom_from_scene(scene: Scene) -> GeomSlice:
    return GeomSlice(
        woop_o=scene.triangles.woop_o,
        woop_d=scene.triangles.woop_d,
        cluster_lo=scene.cluster_lo,
        cluster_hi=scene.cluster_hi,
        tor_w2o=scene.tori.world_to_obj,
        tor_major=scene.tori.major_radius,
        tor_minor=scene.tori.minor_radius,
    )


def has_prims(scene: Scene):
    """(has_tris, has_tori): static skips — a scene with no real triangles
    or tori still carries one padded row. Kept per primitive soup: each
    check reads its valid mask back from the device (a host sync)."""
    return tuple(derived(soup, "has_prims", lambda s=soup: bool(s.valid.any()))
                 for soup in (scene.triangles, scene.tori))


def _ray_chunk(n_prims: int, budget: int = 1 << 24) -> int:
    """Rays per chunk so chunk x prims intermediates stay ~64 MB."""
    c = max(256, budget // max(n_prims, 1))
    return 1 << (c.bit_length() - 1)


def _tmax(tmax, origins):
    """The (N,) float32 tmax of a query: TMAX by default, else tmax
    broadcast over the rays."""
    n = origins.shape[1]
    if tmax is None:
        return torch.full((n,), TMAX, dtype=torch.float32,
                          device=origins.device)
    if (isinstance(tmax, torch.Tensor) and tmax.dtype == torch.float32
            and tmax.shape == (n,) and tmax.device == origins.device
            and tmax.is_contiguous()):
        return tmax       # a bounce segment's row, as it is
    return torch.broadcast_to(torch.as_tensor(
        tmax, dtype=torch.float32, device=origins.device), (n,)).contiguous()


def combine_hits_over_axis(hit: Hit, group) -> Hit:
    """Merge the per-rank winners of `group` into the global nearest hit:
    the min of t, then among the ranks on that t the min of the key
    prim*2+kind (so ties resolve alike on every rank), then the winner's
    u and v. Exactly one rank holds the winner's `AttrRows`: the others'
    kernel rows are zeroed and the rows summed over the group (the loose
    tables are every rank's own)."""
    t = all_reduce(hit.t, MIN, group)
    on_min = (hit.t == t) & (hit.kind >= 0)
    own = hit.prim * 2 + hit.kind
    key = all_reduce(torch.where(on_min, own, _INT_MAX), MIN, group)
    pick = on_min & (own == key)
    uv = all_reduce(torch.where(pick[None, :], torch.stack([hit.u, hit.v]),
                                -BIG), MAX, group)
    missed = key == _INT_MAX
    attrs = hit.attrs
    if attrs is not None:
        blocks = [b for b in (attrs.tri, attrs.tor) if b is not None]
        if blocks:
            summed = all_reduce(torch.where(pick[None, :], torch.cat(blocks),
                                            0.0), SUM, group)
            blocks = list(summed.split([b.shape[0] for b in blocks]))
        attrs = dataclasses.replace(
            attrs, tri=blocks.pop(0) if attrs.tri is not None else None,
            tor=blocks.pop(0) if attrs.tor is not None else None)
    return Hit(
        t=t,
        kind=torch.where(missed, -1, key & 1).to(torch.int32),
        prim=torch.where(missed, 0, key >> 1).to(torch.int32),
        u=torch.where(missed, 0.0, uv[0]),
        v=torch.where(missed, 0.0, uv[1]),
        attrs=attrs,
    )


def closest_hit(scene: Scene, origins, dirs, tmax=None,
                backend: str = "torch", geom: Optional[GeomSlice] = None,
                want_attrs: bool = False, occlusion: bool = False,
                prim_group=None, ranks=None, merge: bool = True) -> Hit:
    """Nearest hit for every ray. origins/dirs: (3, N) f32 rows.

    geom: the geometry to test (default: the whole scene). prim_group: the
    `torch.distributed` group whose ranks hold the other slices; their
    winners merge (`combine_hits_over_axis`). want_attrs: emit the
    kernels' raw `AttrRows`, which the shading kernel S2 reads and
    `ops.shade_kernel.shade_attrs` assembles into ShadeAttrs (kernel
    backend only; the torch path shades via gathers). occlusion: any-hit
    semantics — only Hit.kind >= 0 is meaningful then. ranks: kernel
    backend, the tree kernels' visit ranks (`ops.trace_kernel.Ranks`),
    which decide exact ties between boxes (default: each kernel ranks its
    boxes from the batch's mean origin; the bounce loop passes its planned
    segment's, from the whole wavefront's). merge=False (kernel
    backend, want_attrs, no prim_group): Hit.attrs holds the query's hit
    parts unmerged, what S2 merges, and Hit's own fields are None."""
    if not merge and (backend != "kernel" or prim_group is not None):
        raise ValueError("merge=False: the kernel backend's unsharded "
                         "query (the ranks' merge needs the merged hit)")
    tmax = _tmax(tmax, origins)
    if geom is None:
        geom = geom_from_scene(scene)

    if backend == "kernel":
        from toroidal_ray_tracing_tpu_torch.ops.trace_kernel import (
            closest_hit_kernel)

        hit = closest_hit_kernel(scene, geom, origins, dirs, tmax,
                                 want_attrs=want_attrs, occlusion=occlusion,
                                 ranks=ranks, merge=merge)
    elif backend == "torch":
        hit = _closest_hit_torch(scene, geom, origins, dirs, tmax)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    if prim_group is not None:
        hit = combine_hits_over_axis(hit, prim_group)
    return hit


def _closest_hit_torch(scene: Scene, geom: GeomSlice, origins, dirs,
                       tmax) -> Hit:
    """Dense path: per ray chunk, the Woop test against every triangle and
    the quartic against every torus, argmin with the lowest index winning.

    Unlike the JAX package's jnp path (`_closest_hit_jnp`, exact trig
    resolvent cubic) the tori use the kernels' Newton resolvent solver, so
    the two backends of this package compute one quartic function: with
    the trig solver a few grazing rays per frame flip between hit and miss
    across backends (6 of 129,600 pixels on config 3 at 480x270)."""
    n = origins.shape[1]
    n_tris = int(geom.woop_o.shape[2])
    n_tori = int(geom.tor_major.shape[0])
    has_tris, has_tori = has_prims(scene)
    o_all, d_all = origins.T, dirs.T

    dev = origins.device
    t_best = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    kind = torch.full((n,), -1, dtype=torch.int32, device=dev)
    prim = torch.zeros((n,), dtype=torch.int32, device=dev)
    u = torch.zeros((n,), dtype=torch.float32, device=dev)
    v = torch.zeros((n,), dtype=torch.float32, device=dev)
    W = geom.tor_w2o
    chunk = _ray_chunk(max(n_tris, n_tori * 8))
    for s in range(0, n, chunk):
        sl = slice(s, min(s + chunk, n))
        o, d, tm = o_all[sl], d_all[sl], tmax[sl]
        tb = torch.full((o.shape[0],), BIG, dtype=torch.float32, device=dev)
        if has_tris:
            tt, tu, tv, _ = intersect_woop(o, d, geom.woop_o, geom.woop_d,
                                           TMIN, tm[:, None])
            p = torch.argmin(tt, dim=1, keepdim=True)
            tt = tt.gather(1, p)[:, 0]
            better = tt < tb
            tb = torch.where(better, tt, tb)
            kind[sl] = torch.where(better, 0, kind[sl])
            prim[sl] = torch.where(better, p[:, 0].to(torch.int32)
                                   + geom.tri_offset, prim[sl])
            u[sl] = torch.where(better, tu.gather(1, p)[:, 0], u[sl])
            v[sl] = torch.where(better, tv.gather(1, p)[:, 0], v[sl])
        if has_tori:
            # rays into every torus's object frame (t-preserving affine map)
            oo = torch.stack(
                [((o[:, None, 0] * W[None, :, i, 0]
                   + o[:, None, 1] * W[None, :, i, 1])
                  + o[:, None, 2] * W[None, :, i, 2]) + W[None, :, i, 3]
                 for i in range(3)], dim=-1)
            dd = torch.stack(
                [(d[:, None, 0] * W[None, :, i, 0]
                  + d[:, None, 1] * W[None, :, i, 1])
                 + d[:, None, 2] * W[None, :, i, 2] for i in range(3)],
                dim=-1)
            # the kernels' resolvent solver (the JAX jnp path uses the
            # exact trig one): both backends then decide grazing hits alike
            kt, _ = torus_geom.torus_intersect(
                oo, dd, geom.tor_major[None, :], geom.tor_minor[None, :],
                TMIN, tm[:, None], newton_iters=3, cubic="newton")
            p = torch.argmin(kt, dim=1, keepdim=True)
            kt = kt.gather(1, p)[:, 0]
            better = kt < tb
            tb = torch.where(better, kt, tb)
            kind[sl] = torch.where(better, 1, kind[sl])
            prim[sl] = torch.where(better, p[:, 0].to(torch.int32)
                                   + geom.tor_offset, prim[sl])
        t_best[sl] = tb
    return Hit(t=t_best, kind=kind, prim=prim, u=u, v=v)


class ClosestHitDiff(torch.autograd.Function):
    """Closest hit through the kernels with a backward pass (the JAX
    package's `_closest_hit_pallas_diff` custom VJP).

    Forward: `closest_hit_kernel` (no attrs) on detached tensors. Backward:
    recompute (t, u, v) on the dense torch path and pull the cotangents
    through it with `torch.autograd.grad`, one ray chunk at a time, each
    chunk's graph freed before the next: the dense path holds (chunk x
    prims) tensors for every saved op. kind and prim get no gradient.

    Inputs: scene (kept on ctx), origins, dirs (3, N), tmax (N,), then the
    geometry tensors woop_o, woop_d, tor_w2o, tor_major, tor_minor.
    Returns (t, kind, prim, u, v)."""

    @staticmethod
    def forward(ctx, scene, origins, dirs, tmax, *geo):
        from toroidal_ray_tracing_tpu_torch.ops.trace_kernel import (
            closest_hit_kernel)

        hit = closest_hit_kernel(scene, _geom_of(scene, *(g.detach()
                                                          for g in geo)),
                                 origins.detach(), dirs.detach(),
                                 tmax.detach())
        ctx.scene = scene
        ctx.save_for_backward(origins, dirs, tmax, *geo)
        ctx.mark_non_differentiable(hit.kind, hit.prim)
        return hit.t, hit.kind, hit.prim, hit.u, hit.v

    @staticmethod
    def backward(ctx, gt, _gkind, _gprim, gu, gv):
        origins, dirs, tmax, *geo = ctx.saved_tensors
        scene = ctx.scene
        need = ctx.needs_input_grad[1:]
        leaves = [g.detach().requires_grad_(w) for g, w in zip(geo, need[3:])]
        geom = _geom_of(scene, *leaves)
        grads = [torch.zeros_like(a) if w else None
                 for a, w in zip((origins, dirs, tmax, *geo), need)]
        n = origins.shape[1]
        chunk = _ray_chunk(max(int(geo[0].shape[2]), int(geo[4].shape[0]) * 8))
        for s in range(0, n, chunk):
            sl = slice(s, min(s + chunk, n))
            cts = (gt[sl], gu[sl], gv[sl])
            if not any(bool(c.any()) for c in cts):
                continue            # no cotangent reaches these rays
            with torch.enable_grad():
                rays = [a[..., sl].detach().requires_grad_(w)
                        for a, w in zip((origins, dirs, tmax), need)]
                h = _closest_hit_torch(scene, geom, *rays)
                pairs = [(o, c) for o, c in zip((h.t, h.u, h.v), cts)
                         if o.requires_grad]
                wrt = [(i, x) for i, x in enumerate(rays + leaves)
                       if x.requires_grad]
                if not pairs or not wrt:
                    continue
                got = torch.autograd.grad([o for o, _ in pairs],
                                          [x for _, x in wrt],
                                          [c for _, c in pairs],
                                          allow_unused=True)
            for (i, _), g in zip(wrt, got):
                if g is None:
                    continue
                if i < 3:
                    grads[i][..., sl] += g
                else:
                    grads[i] += g
        return (None, *grads)


def _geom_of(scene: Scene, woop_o, woop_d, tor_w2o, tor_major, tor_minor):
    return GeomSlice(woop_o=woop_o, woop_d=woop_d,
                     cluster_lo=scene.cluster_lo,
                     cluster_hi=scene.cluster_hi, tor_w2o=tor_w2o,
                     tor_major=tor_major, tor_minor=tor_minor)


def closest_hit_diff(scene: Scene, origins, dirs, tmax=None) -> Hit:
    """Differentiable closest hit on the kernel backend: the kernels run
    the primal, the dense torch path the backward pass (`ClosestHitDiff`)
    — inverse rendering at kernel speed (`trace_rays_fixed(...,
    backend="kernel")`). origins/dirs: (3, N) rows."""
    g = geom_from_scene(scene)
    t, kind, prim, u, v = ClosestHitDiff.apply(
        scene, origins, dirs, _tmax(tmax, origins), g.woop_o, g.woop_d,
        g.tor_w2o, g.tor_major, g.tor_minor)
    return Hit(t=t, kind=kind, prim=prim, u=u, v=v)


def any_hit(scene: Scene, origins, dirs, tmax, backend: str = "torch",
            geom: Optional[GeomSlice] = None, prim_group=None, ranks=None):
    """Occlusion query (shadow rays: TerminateOnFirstHit | SkipClosestHit,
    raytrace.rchit:96-109). The kernel backend runs its kernels in any-hit
    mode and returns the occlusion byte they write (`ops.trace_kernel.
    occluded_kernel`; ranks: their visit ranks, as in `closest_hit`).
    Returns a bool mask; with prim_group, a ray is
    occluded when any rank's slice occludes it (a MAX over the group: a
    hit is t < BIG on every path, so this equals the full combine's
    kind >= 0)."""
    if backend == "kernel":
        from toroidal_ray_tracing_tpu_torch.ops.trace_kernel import (
            occluded_kernel)

        mask = occluded_kernel(scene, geom or geom_from_scene(scene),
                               origins, dirs, _tmax(tmax, origins),
                               ranks=ranks)
    else:
        mask = closest_hit(scene, origins, dirs, tmax=tmax, backend=backend,
                           geom=geom).kind >= 0
    if prim_group is not None:
        mask = all_reduce(mask, MAX, prim_group)
    return mask
