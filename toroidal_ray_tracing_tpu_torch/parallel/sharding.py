"""Multi-device rendering over a ("rays", "prims") mesh of
`torch.distributed` ranks (the JAX package's `parallel/sharding.py`).

* "rays": data parallelism. Each rays rank traces an even share of the
  frame's flat pixel batch; nothing is exchanged while tracing.
* "prims": primitive parallelism. Each prims rank tests one slice of the
  triangles and tori (`GeomSlice`, cut on cluster boundaries), and the
  per-ray winners merge with a lexicographic min over the prims group
  (`trace.intersect.combine_hits_over_axis`) at every closest-hit and
  shadow query.

Every rank runs the same program on its share (`render_sharded`); the
bounce loop's stop test is reduced over both groups, and the finished
frame is all-gathered over "rays", so every rank returns the full frame.
Gloo groups stage each collective through host memory
(`utils.collectives`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from toroidal_ray_tracing_tpu_torch.cameras import generate_rays
from toroidal_ray_tracing_tpu_torch.render.renderer import (
    autofill_pixel_spread, check_device)
from toroidal_ray_tracing_tpu_torch.scene.types import (RenderSettings, Scene,
                                                        TorusSoup,
                                                        TriangleSoup, derived)
from toroidal_ray_tracing_tpu_torch.trace.intersect import (GeomSlice,
                                                            geom_from_scene)
from toroidal_ray_tracing_tpu_torch.trace.wavefront import trace_rays
from toroidal_ray_tracing_tpu_torch.utils.collectives import (SUM,
                                                              all_gather_cols,
                                                              all_reduce)

AXES = ("rays", "prims")
FAR = 1.0e30          # padding clusters' point boxes and tori's centres


def make_mesh(n_ray_shards: Optional[int] = None, n_prim_shards: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("rays", "prims") mesh over the current world, ranks in order
    (row r holds ranks r * n_prim_shards ...). Default: every rank on
    "rays". device_type: "cuda" or "cpu", the mesh's device kind; its
    groups use the world's backend."""
    world = dist.get_world_size()
    if n_ray_shards is None:
        n_ray_shards = world // n_prim_shards
    if n_ray_shards * n_prim_shards != world:
        raise ValueError(f"mesh {n_ray_shards}x{n_prim_shards} != "
                         f"{world} ranks")
    return init_device_mesh(device_type, (n_ray_shards, n_prim_shards),
                            mesh_dim_names=AXES)


def pad_scene_for_mesh(scene: Scene, n_prim_shards: int) -> Scene:
    """Pad the triangle clusters and the torus batch so both divide evenly
    over the "prims" axis, with the triangle cuts on cluster boundaries
    (each shard culls against whole clusters of its own). The tensors
    equal the JAX package's bit for bit: degenerate Woop rows and far
    point boxes for the padding triangles (and `loose_tris` dropped when
    they are added: the loose tail then keeps its real boxes and the
    owning shard tests it like any cluster), tori of minor radius -1 with
    far centres. A scene that needs no padding is returned as it is."""
    scene = _pad_triangles(scene, n_prim_shards)
    return _pad_tori(scene, n_prim_shards)


def padded_scene(scene: Scene, n_prim_shards: int) -> Scene:
    """`pad_scene_for_mesh`, kept per scene object (`derived`: made again
    only after a tensor of the scene changed), so the padded scene's
    slice tables are built once, not at every frame."""
    return derived(scene, ("padded", n_prim_shards),
                   lambda: pad_scene_for_mesh(scene, n_prim_shards))


def _cat(a: torch.Tensor, fill, rows: int) -> torch.Tensor:
    return torch.cat([a, a.new_full((rows, *a.shape[1:]), fill)])


def _pad_triangles(scene: Scene, n_prim_shards: int) -> Scene:
    cs = scene.cluster_size
    T = scene.triangles.count
    step = cs * n_prim_shards
    pad = (T + step - 1) // step * step - T
    if pad == 0:
        return scene
    tri = scene.triangles
    # degenerate Woop rows (build's convention): W = 0, c = (0, 0, 1), so
    # d'z = 0 and the row never hits
    woop_o = tri.woop_o.new_zeros((3, 4, pad))
    woop_o[2, 3, :] = 1.0
    fills = {"mat_id": 0, "instance_id": -1, "valid": False}
    triangles = TriangleSoup(**{
        f.name: _cat(getattr(tri, f.name), fills.get(f.name, 0.0), pad)
        for f in dataclasses.fields(TriangleSoup)
        if f.name not in ("woop_o", "woop_d")},
        woop_o=torch.cat([tri.woop_o, woop_o], dim=2),
        woop_d=torch.cat([tri.woop_d, tri.woop_d.new_zeros((3, 3, pad))],
                         dim=2))
    # far POINT boxes: every ray culls them (an inverted lo > hi box would
    # pass the slab test)
    return dataclasses.replace(
        scene, triangles=triangles, loose_tris=0,
        cluster_lo=_cat(scene.cluster_lo, FAR, pad // cs),
        cluster_hi=_cat(scene.cluster_hi, FAR, pad // cs))


def _pad_tori(scene: Scene, n_prim_shards: int) -> Scene:
    tor = scene.tori
    K = tor.count
    pad = (K + n_prim_shards - 1) // n_prim_shards * n_prim_shards - K
    if pad == 0:
        return scene
    eye = torch.eye(3, 4, dtype=torch.float32, device=scene.device)
    eye = eye.expand(pad, 3, 4)
    tori = TorusSoup(
        world_to_obj=torch.cat([tor.world_to_obj, eye]),
        obj_to_world=torch.cat([tor.obj_to_world, eye]),
        major_radius=_cat(tor.major_radius, 0.0, pad),
        minor_radius=_cat(tor.minor_radius, -1.0, pad),
        mat_id=_cat(tor.mat_id, 0, pad),
        instance_id=_cat(tor.instance_id, -1, pad),
        valid=_cat(tor.valid, False, pad),
        center=_cat(tor.center, FAR, pad),
        bound_radius=_cat(tor.bound_radius, 0.0, pad),
    )
    return dataclasses.replace(scene, tori=tori)


def shard_geometry(scene: Scene, n_prims: int, p: int) -> GeomSlice:
    """Prims rank p's slice of a scene padded for n_prims shards."""
    if n_prims == 1:
        return geom_from_scene(scene)
    T = scene.triangles.count // n_prims
    C = scene.cluster_lo.shape[0] // n_prims
    K = scene.tori.count // n_prims
    tri, tor = scene.triangles, scene.tori
    return GeomSlice(
        woop_o=tri.woop_o[:, :, p * T:(p + 1) * T],
        woop_d=tri.woop_d[:, :, p * T:(p + 1) * T],
        cluster_lo=scene.cluster_lo[p * C:(p + 1) * C],
        cluster_hi=scene.cluster_hi[p * C:(p + 1) * C],
        tor_w2o=tor.world_to_obj[p * K:(p + 1) * K],
        tor_major=tor.major_radius[p * K:(p + 1) * K],
        tor_minor=tor.minor_radius[p * K:(p + 1) * K],
        tri_offset=p * T, tor_offset=p * K)


def render_sharded(scene: Scene, camera, width: int, height: int,
                   settings: RenderSettings | None = None,
                   mesh: Optional[DeviceMesh] = None,
                   backend: str = "torch", spp: int = 1, seed: int = 0,
                   device="cuda"):
    """Render one frame over a ("rays", "prims") mesh; every rank of the
    mesh calls it with the same arguments.

    The flat pixel batch splits evenly over the "rays" ranks (padded with
    zero-origin, unit-direction rays that are dropped at the end); each
    "prims" rank tests its slice of the padded scene. spp > 1 adds
    jittered samples, each drawn on the host as the JAX package's
    `render_sharded` draws it, `np.random.default_rng(seed).random((W*H,
    2), float32)` (one generator, one draw a sample), and copied to the
    device; the pad rays take none. device: as `render` (the CUDA device
    unless device="cpu"). mesh: default, every rank on "rays"
    (`make_mesh`).

    Returns `render`'s dict — image, hit_position, ray_origin, ray_dir,
    each (H, W, 3), the full frame on every rank — and rays_traced, the
    frame's total over the "rays" ranks (int)."""
    device = check_device(device)
    if settings is None:
        settings = RenderSettings.default()
    settings = autofill_pixel_spread(settings, camera, width, height)
    settings = settings.to(device)
    if mesh is None:
        mesh = make_mesh(device_type=device.type)
    rays_mesh, prims_mesh = mesh["rays"], mesh["prims"]
    n_rays, n_prims = rays_mesh.size(), prims_mesh.size()
    ray_group, prim_group = rays_mesh.get_group(), prims_mesh.get_group()
    r, p = rays_mesh.get_local_rank(), prims_mesh.get_local_rank()

    scene = padded_scene(scene.to(device), n_prims)
    geom = shard_geometry(scene, n_prims, p)

    n = width * height
    n_local = -(-n // n_rays)
    pad = n_local * n_rays - n
    mine = slice(r * n_local, (r + 1) * n_local)
    unit = 1.0 / math.sqrt(3.0)
    rng = np.random.default_rng(seed)
    acc = first = None
    nrays = 0
    for s in range(max(spp, 1)):
        jitter = (None if s == 0 else torch.from_numpy(
            rng.random((n, 2), dtype=np.float32)).to(device))
        o, d = generate_rays(camera, width, height, settings, jitter=jitter,
                             device=device)
        if s == 0:
            origins0, dirs0 = o, d
        if pad:
            o = torch.cat([o, o.new_zeros((pad, 3))])
            d = torch.cat([d, d.new_full((pad, 3), unit)])
        color, hitpos, nr = trace_rays(
            scene, settings, o[mine].T.contiguous(), d[mine].T.contiguous(),
            backend=backend, geom=geom,
            prim_group=prim_group if n_prims > 1 else None,
            ray_group=ray_group if n_rays > 1 else None)
        acc = color if acc is None else acc + color
        nrays += nr
        if s == 0:
            first = hitpos
    color = acc / float(max(spp, 1))

    frame = all_gather_cols(torch.cat([color, first]), ray_group)[:, :n]
    total = all_reduce(torch.tensor(nrays, dtype=torch.int64, device=device),
                       SUM, ray_group)
    shape = (height, width, 3)
    return {
        "image": frame[:3].T.reshape(shape),
        "hit_position": frame[3:].T.reshape(shape),
        "ray_origin": origins0.reshape(shape),
        "ray_dir": dirs0.reshape(shape),
        "rays_traced": int(total),
    }
