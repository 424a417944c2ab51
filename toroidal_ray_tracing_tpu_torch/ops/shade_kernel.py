"""S2 and S3: a bounce segment's shading and state update on the kernel
backend.

The JAX package runs this work between its Pallas kernels inside one
jitted `lax.while_loop` body, and XLA fuses it (`trace/shade.py:226-414`,
`trace/wavefront.py:167-195`); no Pallas kernel. Here it is two
hand-written CUDA kernels, `csrc/shade.cu`:

* S2 `shade_hit`: from a closest-hit query's parts and its kernels' raw
  attribute rows (`intersect.AttrRows`) to the shadow query: the merges of
  `ops.trace_kernel.merge_parts` (strict t comparisons, in registers), the
  `ShadeAttrs` assembly (`shade_attrs`), the hit point, the normal, the
  point or infinite light, Lambert plus ambient, the mip LOD and K4's two
  quad indices and fractions, and the shadow ray. Its outputs
  (`ShadeRays`) carry what S3 needs: a (19, N) block of per-ray values and
  one flag byte a ray.
* S3 `shade_finish`: after the shadow query (and K4's fetch on textured
  scenes): the texel blend, Phong with its energy factor, the 0.3 shadow
  attenuation, the miss color, the reflection request, the next ray, and
  the bounce loop's update of the (15, lanes) state in place
  (`trace/wavefront.py`'s rows), the active mask, the int64 ray counter,
  and each 128-ray span's live flag with their count, which the host reads
  once a segment.

S2 writes each output only on the lanes where a reader reads it, as masks
over its flag bits (`defined_entries`; hit = not MISSED):

  every lane:     flags (a missed lane: MISSED alone), shadow_tmax (0 where
                  not NEED_SHADOW), K4's valid flag (textured scenes)
  hit:            shadow_o (the first-hit position), block DIFF, SPEC, LINT
  NEED_SHADOW:    shadow_d
  SPEC_ON & FACING, or REFLECT:  block NRM
  REFLECT:        block POS
  SPEC_ON & FACING:  block SHIN
  hit & TEXTURED: block FX0-FLOD and K4's two indices (textured scenes)

Everything else is left as `torch.empty` made it. S3 reads only these
entries; the shadow query reads every lane's rays but tests none where
shadow_tmax is 0; K4 loads every lane's indices and uses them only where
valid. S2 reads a winner's attribute rows only for what these outputs
need (a triangle's pos only for a point light or a reflection; ambient
only where illum >= 1; uv and texel density only where textured).

Each wrapper launches its kernel on CUDA tensors and runs its plain
PyTorch twin (`shade_hit_plain`, `shade_finish_plain`) on CPU tensors;
there is no fallback from one to the other. The twins are `trace/shade.py`
`shade()`'s arithmetic (which stays the `backend="torch"` and gradient
path) and the loop update, split where the kernels split, so on the CPU
they give shade()'s bits; S2's twin writes every entry.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F_

from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
    F32, I32, SEG_TMAX, check_args, check_rays, launch)
from toroidal_ray_tracing_tpu_torch.ops.trace_kernel import _kept, merge_parts
from toroidal_ray_tracing_tpu_torch.scene.types import (LIGHT_POINT,
                                                        RenderSettings, Scene,
                                                        srgb_table)
from toroidal_ray_tracing_tpu_torch.trace.intersect import (AttrRows, Hit,
                                                            ShadeAttrs)
from toroidal_ray_tracing_tpu_torch.trace.shade import (TWO_PI, _blend_quad,
                                                        _normalize,
                                                        _quad_index, _reflect,
                                                        mip_lod)

SPAN = 128          # S3's block: one compaction span (wavefront.COMPACT_SPAN)
N_BLOCK = 19        # rows of S2's per-ray block, below
# rows of the block S2 writes and S3 reads
NRM, POS, DIFF, SPEC = (slice(0, 3), slice(3, 6), slice(6, 9), slice(9, 12))
SHIN, LINT, FX0, FY0, FX1, FY1, FLOD = 12, 13, 14, 15, 16, 17, 18
# bits of S2's flag byte
MISSED, NEED_SHADOW, FACING, SPEC_ON, REFLECT, TEXTURED = (1, 2, 4, 8, 16,
                                                           32)
# rows of the bounce loop's stacked state (trace/wavefront.py)
_O, _D, _HV, _AT, _HP = (slice(0, 3), slice(3, 6), slice(6, 9),
                         slice(9, 12), slice(12, 15))


@dataclasses.dataclass
class ShadeParams:
    """A frame's shading constants on the render's device, made once per
    `trace_rays` (`shade_params`)."""

    consts: torch.Tensor        # (9,) f32: light position, the infinite
    #                             light's unit direction, the miss color
    light_type: int
    intensity: float
    pixel_spread: float
    atlas: Optional[object]     # TextureAtlas of a textured scene, or None
    srgb: Optional[torch.Tensor]  # (256,) f32 sRGB decode table, or None


def shade_params(scene: Scene, settings: RenderSettings) -> ShadeParams:
    """The frame's constants, with shade()'s own ops (so the twins and the
    kernels see its bits): the infinite light's direction
    lpos / max(|lpos|, 1e-30) and the miss color clear_color[:3] * 0.8."""
    lpos = settings.light.position
    l_inf = lpos / torch.clamp(torch.linalg.vector_norm(lpos), min=1e-30)
    clear = settings.clear_color[:3] * 0.8
    atlas = scene.textures if scene.textures.data4q.shape[0] > 1 else None
    return ShadeParams(
        consts=torch.cat([lpos, l_inf, clear]).to(F32).contiguous(),
        light_type=int(settings.light.type),
        intensity=float(settings.light.intensity),
        pixel_spread=float(settings.pixel_spread), atlas=atlas,
        srgb=srgb_table(lpos.device) if atlas is not None else None)


def kept_shade_params(scene: Scene, settings: RenderSettings) -> ShadeParams:
    """`shade_params`, kept on the scene (`ops.trace_kernel._kept`) for the
    settings' tensors and numbers: made again only when a light position or
    clear color tensor was replaced or changed in place, or a number
    changed. The front doors hand equal settings the same device tensors
    (`render.renderer`), so a closed-loop client's frames compute it
    once."""
    return _kept(scene, "shade_params", (),
                 (settings.light.position, settings.clear_color,
                  scene.textures.data4q),
                 lambda: shade_params(scene, settings),
                 numbers=(int(settings.light.type),
                          float(settings.light.intensity).hex(),
                          float(settings.pixel_spread).hex()))


@dataclasses.dataclass
class ShadeRays:
    """S2's outputs: the shadow query's rays and what S3 reads (each
    defined on the lanes of `defined_entries`)."""

    shadow_o: torch.Tensor      # (3, N) the hit point o + min(t, 1e8) d
    shadow_d: torch.Tensor      # (3, N) toward the light
    shadow_tmax: torch.Tensor   # (N,) the light's distance, 0: no query
    block: torch.Tensor         # (N_BLOCK, N) f32, rows above
    flags: torch.Tensor         # (N,) uint8, bits above
    tex: Optional[tuple]        # K4's (i0, i1, valid), textured scenes


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------


def shade_attrs(hit: Hit, rows: AttrRows) -> ShadeAttrs:
    """Each ray's winner's shading attributes from the query's raw rows:
    the triangle rows from the loose tail's tables at (prim, u, v) (A0 +
    u*A1 + v*A2 for rows 0-7, A0 for rows 8-20) where the triangle side's
    winner is a loose row, else the triangle kernels' 21 rows; the torus
    rows from the torus kernels' 15 (a query that ran no such kernel reads
    zeros). A torus winner's pos and uv rows are the triangle side's."""
    n = hit.t.shape[0]
    dev = hit.t.device
    tri = (rows.tri if rows.tri is not None
           else torch.zeros((21, n), dtype=F32, device=dev))
    tor = (rows.tor if rows.tor is not None
           else torch.zeros((15, n), dtype=F32, device=dev))
    if rows.loose is not None:
        a0, a1, a2 = rows.loose
        b, L = rows.loose_base, rows.n_loose
        c = rows.tri_prim.long()
        loose = (rows.tri_kind == 0) & (c >= b) & (c < b + L)
        c = torch.clamp(c, b, b + L - 1)
        top = (a0[:8, c] + hit.u * a1[:, c]) + hit.v * a2[:, c]
        tri = torch.where(loose[None, :], torch.cat([top, a0[8:, c]]), tri)
    is_tor = hit.kind == 1
    # torus world positions are o + t d (shading computes them); the pos
    # rows carry the triangle's barycentric-exact position only
    nrm = torch.where(is_tor, tor[0:3], tri[3:6])
    mat = torch.where(is_tor, tor[3:15], tri[8:20])
    return ShadeAttrs(
        pos=tri[0:3], nrm=nrm, uv=tri[6:8], ambient=mat[0:3],
        diffuse=mat[3:6], specular=mat[6:9], shininess=mat[9],
        illum=torch.round(mat[10]).to(I32),
        texture_id=torch.round(mat[11]).to(I32),
        tex_density=torch.where(is_tor, 0.0, tri[20]))


def base_rows(hit: Hit) -> AttrRows:
    """S2's input for a hit merged already (a primitive-sharded query's,
    `intersect.combine_hits_over_axis`): its rows with the hit as the base
    and no other part."""
    return dataclasses.replace(
        hit.attrs if hit.attrs is not None else AttrRows(),
        base=(hit.t, hit.kind, hit.prim, hit.u, hit.v), tri_hit=None,
        tor_hit=None)


def defined_entries(s2: ShadeRays, textured: bool):
    """[(name, values (rows, N) or (N,), lanes)]: each of S2's outputs with
    the (N,) bool lanes on which the contract defines it, from s2's own
    flags (the module's docstring; views, so a caller may overwrite the
    undefined entries in place)."""
    fl, b = s2.flags, s2.block
    hit = (fl & MISSED) == 0
    every = torch.ones_like(hit)

    def bit(x):
        return (fl & x) > 0

    spec = bit(SPEC_ON) & bit(FACING)
    out = [("flags", fl, every), ("shadow_tmax", s2.shadow_tmax, every),
           ("shadow_o", s2.shadow_o, hit),
           ("shadow_d", s2.shadow_d, bit(NEED_SHADOW)),
           ("nrm", b[NRM], spec | bit(REFLECT)), ("pos", b[POS], bit(REFLECT)),
           ("diff", b[DIFF], hit), ("spec", b[SPEC], hit),
           ("shin", b[SHIN], spec), ("lint", b[LINT], hit)]
    if textured:
        tex = hit & bit(TEXTURED)
        out += [("tex_rows", b[FX0:], tex), ("tex_i0", s2.tex[0], tex),
                ("tex_i1", s2.tex[1], tex), ("tex_valid", s2.tex[2], every)]
    return out


def shade_hit_plain(origins, dirs, rows: AttrRows,
                    params: ShadeParams) -> ShadeRays:
    """Plain PyTorch twin of S2: `merge_parts`, then shade()'s arithmetic
    up to its shadow query (`trace/shade.py:127-144, 203-248`)."""
    n = origins.shape[1]
    hit = merge_parts(rows, n, origins.device)
    rows = hit.attrs
    missed = hit.kind < 0
    is_tor = hit.kind == 1
    ray_hit_pos = origins + torch.clamp(hit.t, max=1.0e8)[None, :] * dirs
    a = shade_attrs(hit, rows)
    world_pos = torch.where(is_tor[None, :], ray_hit_pos, a.pos)
    tex_id = torch.where(is_tor, -1, a.texture_id)
    nrm = _normalize(a.nrm)

    lpos, l_inf = params.consts[0:3], params.consts[3:6]
    if params.light_type == LIGHT_POINT:
        ldir = lpos[:, None] - world_pos
        ldist_pt = torch.linalg.vector_norm(ldir, dim=0)
        L = ldir / torch.clamp(ldist_pt[None, :], min=1e-20)
        ldist = ldist_pt
        lint = params.intensity / torch.clamp(ldist_pt * ldist_pt, min=1e-20)
    else:
        L = torch.broadcast_to(l_inf[:, None], world_pos.shape)
        ldist = torch.full_like(world_pos[0], 100000.0)
        lint = torch.full_like(world_pos[0], params.intensity)

    ndotl = (nrm * L).sum(dim=0)
    diffuse = a.diffuse * torch.clamp(ndotl, min=0.0)[None, :]
    diffuse = torch.where((a.illum >= 1)[None, :], diffuse + a.ambient,
                          diffuse)

    block = torch.zeros((N_BLOCK, n), dtype=F32, device=origins.device)
    tex = None
    if params.atlas is not None:
        atlas = params.atlas
        tid = torch.clamp(tex_id, min=0).long()
        sizes0 = atlas.sizes[:, 0]
        dim0 = torch.maximum(sizes0[tid, 0], sizes0[tid, 1]).float()
        lod = mip_lod(hit.t, params.pixel_spread, a.tex_density, dim0)
        nl = atlas.n_levels[tid]
        lvl = torch.minimum(torch.clamp(lod, min=0.0), (nl - 1).float())
        l0 = torch.floor(lvl).to(I32)
        l1 = torch.minimum(l0 + 1, nl - 1)
        i0, fx0, fy0 = _quad_index(atlas, tid, l0, a.uv)
        i1, fx1, fy1 = _quad_index(atlas, tid, l1, a.uv)
        tex = (i0, i1, (tex_id >= 0) & ~missed)
        block[FX0], block[FY0], block[FX1], block[FY1] = fx0, fy0, fx1, fy1
        block[FLOD] = lvl - l0.float()

    facing = ndotl > 0.0
    need_shadow = facing & ~missed
    block[NRM], block[POS], block[DIFF] = nrm, world_pos, diffuse
    block[SPEC], block[SHIN], block[LINT] = a.specular, a.shininess, lint
    # a missed lane's flags are MISSED alone (S2 reads no rows for it)
    flags = torch.where(missed, MISSED, need_shadow * NEED_SHADOW
                        + facing * FACING + (a.illum >= 2) * SPEC_ON
                        + (a.illum == 3) * REFLECT
                        + (tex_id >= 0) * TEXTURED).to(torch.uint8)
    return ShadeRays(shadow_o=ray_hit_pos.contiguous(),
                     shadow_d=L.contiguous(),
                     shadow_tmax=torch.where(need_shadow, ldist, 0.0),
                     block=block, flags=flags, tex=tex)


def live_spans(active):
    """(S,) bool: the 128-lane spans of `active` that hold a live ray (a
    batch that is no whole number of spans has a short last one)."""
    pad = (-active.shape[0]) % SPAN
    return F_.pad(active, (0, pad)).view(-1, SPAN).any(dim=1)


def shade_finish_plain(state, active, nb: int, s2: ShadeRays, occluded,
                       quads, params: ShadeParams, depth: int,
                       max_depth: int, rays, spans, count,
                       tmax_next=None) -> None:
    """Plain PyTorch twin of S3: shade()'s arithmetic after its shadow
    query (`trace/shade.py:252-284`) and the bounce loop's update
    (`trace/wavefront.py`), in place; with tmax_next, the next segment's
    tmax row on the prefix (SEG_TMAX where a ray goes on, else 0)."""
    s = state[:, :nb]
    act = active[:nb]
    o, d, att, hv = s[_O], s[_D], s[_AT], s[_HV]
    b, fl = s2.block, s2.flags
    missed, need_shadow = (fl & MISSED) > 0, (fl & NEED_SHADOW) > 0
    facing, reflective = (fl & FACING) > 0, (fl & REFLECT) > 0
    nrm, world_pos, diffuse, specular_c = b[NRM], b[POS], b[DIFF], b[SPEC]
    L, ray_hit_pos = s2.shadow_d, s2.shadow_o

    if quads is not None:
        c0 = _blend_quad(quads[0], b[FX0][None, :], b[FY0][None, :])
        c1 = _blend_quad(quads[1], b[FX1][None, :], b[FY1][None, :])
        f = b[FLOD][None, :]
        texel = c0 * (1 - f) + c1 * f
        diffuse = torch.where(((fl & TEXTURED) > 0)[None, :],
                              diffuse * texel, diffuse)

    shadowed = occluded & need_shadow
    attenuation_local = torch.where(shadowed, 0.3, 1.0)
    kshine = torch.clamp(b[SHIN], min=4.0)
    energy = (2.0 + kshine) / TWO_PI
    V = _normalize(-d)
    Rv = _reflect(-L, nrm)
    spec = energy * torch.pow(torch.clamp((V * Rv).sum(dim=0), min=0.0),
                              kshine)
    spec = torch.where(((fl & SPEC_ON) > 0) & facing & ~shadowed, spec, 0.0)
    specular = specular_c * spec[None, :]
    hit_value = (attenuation_local * b[LINT])[None, :] * (diffuse + specular)
    hit_value = torch.where(missed[None, :], params.consts[6:9, None],
                            hit_value)
    hit_position = torch.where(missed[None, :], 0.0, ray_hit_pos)
    atten_factor = torch.where(reflective[None, :], specular_c, 1.0)
    next_dir = _reflect(d, nrm)

    live = act[None, :]
    torch.where(live, att * atten_factor, att, out=att)
    torch.where(live, hv + hit_value * att, hv, out=hv)
    if depth == 0:
        torch.where(live, hit_position, s[_HP], out=s[_HP])
    rays += act.sum() + (act & need_shadow).sum()
    act = act & reflective & (depth + 1 < max_depth)
    active[:nb] = act
    if tmax_next is not None:
        tmax_next[:nb] = torch.where(act, SEG_TMAX, 0.0)
    torch.where(act[None, :], world_pos, o, out=o)
    torch.where(act[None, :], next_dir, d, out=d)
    live = live_spans(act)
    spans[:live.shape[0]] = live
    count.copy_(live.sum())


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def check_shade_hit(origins, dirs, rows: AttrRows, params: ShadeParams,
                    out=None) -> int:
    """`shade_hit`'s argument checks (a segment plan runs them once on its
    own arguments and outputs); returns the rays' row stride."""
    n, dev = origins.shape[1], origins.device
    base, tri_hit, tor_hit = rows.base, rows.tri_hit, rows.tor_hit
    b = base if base is not None else (None,) * 5
    k = tri_hit if tri_hit is not None else (None,) * 4
    q = tor_hit if tor_hit is not None else (None,) * 2
    T = rows.loose[0].shape[1] if rows.loose is not None else 0
    la = rows.loose if rows.loose is not None else (None,) * 3
    rs = check_rays(origins, dirs, None)
    check_args(dev, t=(b[0], (n,), F32),
               kind=(b[1], (n,), I32), prim=(b[2], (n,), I32),
               u=(b[3], (n,), F32), v=(b[4], (n,), F32),
               tri_t=(k[0], (n,), F32),
               tri_idx=(k[1], (n,), I32), tri_u=(k[2], (n,), F32),
               tri_v=(k[3], (n,), F32), tor_t=(q[0], (n,), F32),
               tor_idx=(q[1], (n,), I32),
               tri=(rows.tri, (21, n), F32), tor=(rows.tor, (15, n), F32),
               a0=(la[0], (21, T), F32), a1=(la[1], (8, T), F32),
               a2=(la[2], (8, T), F32), consts=(params.consts, (9,), F32))
    if rows.loose is not None and not (
            0 <= rows.loose_base <= T - rows.n_loose):
        raise ValueError("loose rows lie outside the tables")
    at = params.atlas
    if at is not None:
        n_tex, n_lv = at.offsets.shape
        check_args(dev, offsets=(at.offsets, (n_tex, n_lv), I32),
                   sizes=(at.sizes, (n_tex, n_lv, 2), I32),
                   n_levels=(at.n_levels, (n_tex,), I32))
    if out is not None:
        shapes = [((3, n), F32), ((3, n), F32), ((n,), F32),
                  ((N_BLOCK, n), F32), ((n,), torch.uint8)]
        if at is not None:
            shapes += [((n,), I32), ((n,), I32), ((n,), torch.bool)]
        if len(out) != len(shapes):
            raise ValueError(f"out: {len(out)} outputs, want {len(shapes)}")
        check_args(dev, **{f"out{j}": (a, *shape)
                           for j, (a, shape) in enumerate(zip(out, shapes))})
    return rs


def _shade_rays(views) -> ShadeRays:
    return ShadeRays(shadow_o=views[0], shadow_d=views[1],
                     shadow_tmax=views[2], block=views[3], flags=views[4],
                     tex=tuple(views[5:8]) if len(views) > 5 else None)


def shade_hit(origins, dirs, rows: AttrRows, params: ShadeParams,
              out=None) -> ShadeRays:
    """S2 wrapper. origins/dirs: (3, N) rows, each row contiguous, at one
    row stride (a prefix of the bounce loop's state is fine); rows: a
    closest-hit query's `AttrRows` with its hit parts (`closest_hit(...,
    merge=False)`, or `base_rows` of a merged hit); params:
    `shade_params`. out: the outputs from a segment plan
    (`kernel_common.Planned`: shadow_o, shadow_d, shadow_tmax, block,
    flags, and K4's three on textured scenes; no check, no allocation).
    The outputs are defined on the lanes the module's contract gives
    (`defined_entries`)."""
    n, dev = origins.shape[1], origins.device
    if out is None:
        rs = check_shade_hit(origins, dirs, rows, params)
    else:
        rs = origins.stride(0)
    if not origins.is_cuda:
        got = shade_hit_plain(origins, dirs, rows, params)
        if out is None:
            return got
        sr = _shade_rays(out)
        for view, full in zip(out, (got.shadow_o, got.shadow_d,
                                    got.shadow_tmax, got.block, got.flags,
                                    *(got.tex or ()))):
            view.copy_(full)
        return sr
    at = params.atlas
    if out is None:
        f32 = dict(dtype=F32, device=dev)
        out = (torch.empty((3, n), **f32), torch.empty((3, n), **f32),
               torch.empty((n,), **f32), torch.empty((N_BLOCK, n), **f32),
               torch.empty((n,), dtype=torch.uint8, device=dev))
        if at is not None:
            out += (torch.empty((n,), dtype=I32, device=dev),
                    torch.empty((n,), dtype=I32, device=dev),
                    torch.empty((n,), dtype=torch.bool, device=dev))
    sr = _shade_rays(out)
    base, tri_hit, tor_hit = rows.base, rows.tri_hit, rows.tor_hit
    b = base if base is not None else (None,) * 5
    k = tri_hit if tri_hit is not None else (None,) * 4
    la = rows.loose if rows.loose is not None else (None,) * 3
    if n:
        launch("trt_shade_hit", origins, dirs, n, rs, *b, *k,
               int(rows.tri_offset),
               tor_hit[0] if tor_hit is not None else None, rows.tri,
               rows.tor, *la,
               rows.loose[0].shape[1] if rows.loose is not None else 0,
               int(rows.loose_base), int(rows.n_loose), params.consts,
               int(params.light_type == LIGHT_POINT), params.intensity,
               params.pixel_spread,
               *((at.offsets, at.sizes, at.n_levels, at.offsets.shape[1])
                 if at is not None else (None, None, None, 0)),
               *out[:5], *(out[5:8] if at is not None else (None,) * 3),
               stream=getattr(out, "stream", None))
    return sr


def check_shade_finish(state, active, nb: int, s2: ShadeRays, occluded,
                       quads, params: ShadeParams, rays, spans, count,
                       out=None) -> None:
    """`shade_finish`'s argument checks (a segment plan runs them once on
    its own arguments and outputs)."""
    lanes = state.shape[1]
    dev = state.device
    check_args(dev, state=(state, (15, lanes), F32),
               active=(active, (lanes,), torch.bool),
               occluded=(occluded, (nb,), torch.bool),
               block=(s2.block, (N_BLOCK, nb), F32),
               flags=(s2.flags, (nb,), torch.uint8),
               shadow_o=(s2.shadow_o, (3, nb), F32),
               shadow_d=(s2.shadow_d, (3, nb), F32),
               rays=(rays, (), torch.int64), count=(count, (), I32))
    n_spans = -(-nb // SPAN)
    if spans.shape[0] < n_spans or spans.dtype != torch.bool:
        raise ValueError(f"spans: want >= {n_spans} bools")
    if (quads is None) != (params.atlas is None):
        raise ValueError("quads go with a textured scene's params")
    if quads is not None:
        check_args(dev, q0=(quads[0], (3, nb), I32),
                   q1=(quads[1], (3, nb), I32),
                   srgb=(params.srgb, (256,), F32))
    if out is not None:
        check_args(dev, tmax_next=(out[0], (lanes,), F32))


def shade_finish(state, active, nb: int, s2: ShadeRays, occluded, quads,
                 params: ShadeParams, depth: int, max_depth: int, rays,
                 spans, count, out=None) -> None:
    """S3 wrapper, in place. state: the (15, lanes) bounce state (rows
    origin, direction, color, attenuation, first hit); active: (lanes,)
    bool; nb: the lanes this segment traced (its prefix); s2: S2's
    outputs; occluded: (nb,) bool, the shadow query; quads: K4's (q0, q1)
    on textured scenes, else None; depth, max_depth: the segment and the
    cap; rays: the int64 0-d ray counter; spans: (>= ceil(nb / 128),)
    bool, count: int32 0-d holding 0, the live spans this writes. out:
    from a segment plan (`kernel_common.Planned`; no check), the (lanes,)
    float32 tmax row of the next segment, which S3 writes on the lanes it
    updates: `kernel_common.SEG_TMAX` where the ray goes on, else 0."""
    if out is None:
        check_shade_finish(state, active, nb, s2, occluded, quads, params,
                           rays, spans, count)
    tmax_next = out[0] if out is not None else None
    if not state.is_cuda:
        shade_finish_plain(state, active, nb, s2, occluded, quads, params,
                           depth, max_depth, rays, spans, count, tmax_next)
        return
    if nb:
        launch("trt_shade_finish", state, state.shape[1], active, nb,
               s2.block, s2.flags, s2.shadow_o, s2.shadow_d, occluded,
               *(quads if quads is not None else (None, None)), params.srgb,
               params.consts, int(depth == 0),
               int(depth + 1 < max_depth), rays, spans, count, tmax_next,
               SEG_TMAX, stream=getattr(out, "stream", None))
