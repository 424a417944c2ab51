"""Closest-hit / any-hit queries — the `traceRayEXT` replacement.

Two backends:

* `backend="torch"` (this module, `_closest_hit_torch`): the Woop test and
  the Ferrari quartic as plain tensor ops over (rays x prims) blocks,
  chunked over rays, the lowest index winning ties. Any device.
* `backend="kernel"` (`ops/trace_kernel.closest_hit_kernel`): the same
  query through the hand-written kernels (K1 triangles, K2/K3 tori) with
  kernel-emitted shading attributes. On CUDA tensors the kernels launch; on
  CPU tensors their plain twins run.

Hit kinds: 0 = triangle, 1 = torus, -1 = miss (raytrace.rmiss).
Per-ray vectors are (3, N) rows throughout.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from toroidal_ray_tracing_tpu_torch.geom import torus as torus_geom
from toroidal_ray_tracing_tpu_torch.geom.triangle import intersect_woop
from toroidal_ray_tracing_tpu_torch.scene.types import Scene

BIG = 3.0e38
TMIN = 1.0e-3      # raytrace.rgen:61
TMAX = 10000.0     # raytrace.rgen:62


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
class Hit:
    t: torch.Tensor      # (N,) f32, BIG on miss
    kind: torch.Tensor   # (N,) i32: 0 tri, 1 torus, -1 miss
    prim: torch.Tensor   # (N,) i32 index into triangles or tori
    u: torch.Tensor      # (N,) f32 triangle barycentric
    v: torch.Tensor      # (N,) f32
    attrs: Optional[ShadeAttrs] = None


@dataclasses.dataclass
class GeomSlice:
    """The intersection-only geometry a query tests (the whole scene here;
    prims-axis sharding waits for the multi-device port)."""

    woop_o: torch.Tensor      # (3, 4, T)
    woop_d: torch.Tensor      # (3, 3, T)
    cluster_lo: torch.Tensor  # (C, 3)
    cluster_hi: torch.Tensor  # (C, 3)
    tor_w2o: torch.Tensor     # (K, 3, 4)
    tor_major: torch.Tensor   # (K,)
    tor_minor: torch.Tensor   # (K,)


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
    or tori still carries one padded row."""
    return (bool(scene.triangles.valid.any()), bool(scene.tori.valid.any()))


def _ray_chunk(n_prims: int, budget: int = 1 << 24) -> int:
    """Rays per chunk so chunk x prims intermediates stay ~64 MB."""
    c = max(256, budget // max(n_prims, 1))
    return 1 << (c.bit_length() - 1)


def closest_hit(scene: Scene, origins, dirs, tmax=None,
                backend: str = "torch", geom: Optional[GeomSlice] = None,
                want_attrs: bool = False, occlusion: bool = False) -> Hit:
    """Nearest hit for every ray. origins/dirs: (3, N) f32 rows.

    want_attrs: emit interpolated ShadeAttrs (kernel backend only; the
    torch path shades via gathers). occlusion: any-hit semantics — only
    Hit.kind >= 0 is meaningful then."""
    n = origins.shape[1]
    if tmax is None:
        tmax = torch.full((n,), TMAX, dtype=torch.float32,
                          device=origins.device)
    else:
        tmax = torch.broadcast_to(torch.as_tensor(
            tmax, dtype=torch.float32, device=origins.device), (n,))
    tmax = tmax.contiguous()
    if geom is None:
        geom = geom_from_scene(scene)

    if backend == "kernel":
        from toroidal_ray_tracing_tpu_torch.ops.trace_kernel import (
            closest_hit_kernel)

        return closest_hit_kernel(scene, geom, origins, dirs, tmax,
                                  want_attrs=want_attrs, occlusion=occlusion)
    if backend != "torch":
        raise ValueError(f"unknown backend {backend!r}")
    return _closest_hit_torch(scene, geom, origins, dirs, tmax)


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
            prim[sl] = torch.where(better, p[:, 0].to(torch.int32), prim[sl])
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
            prim[sl] = torch.where(better, p[:, 0].to(torch.int32), prim[sl])
        t_best[sl] = tb
    return Hit(t=t_best, kind=kind, prim=prim, u=u, v=v)


def any_hit(scene: Scene, origins, dirs, tmax, backend: str = "torch",
            geom: Optional[GeomSlice] = None):
    """Occlusion query (shadow rays: TerminateOnFirstHit | SkipClosestHit,
    raytrace.rchit:96-109). The kernel backend runs its kernels in any-hit
    mode. Returns a bool mask."""
    hit = closest_hit(scene, origins, dirs, tmax=tmax, backend=backend,
                      geom=geom, occlusion=backend == "kernel")
    return hit.kind >= 0
