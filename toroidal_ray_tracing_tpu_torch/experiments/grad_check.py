"""Gradients of a ladder frame on both backends, and the rule that holds
the minor radius's.

The loss is the image mean of `trace_rays_fixed` at the scenario's depth;
the parameters (`PARAMS`) are a scale on every torus's minor radius, the
light's intensity and position, and a per-channel scale on every
material's diffuse colour. `backend="kernel"` runs the kernels forward and
recomputes the backward pass on the dense torch path; `backend="torch"`
differentiates the dense path itself, traced in tiles whose graphs are
freed one by one.

The radius's gradient of a frame of mirror tori is a sum with heavy
cancellation: a few pixels (paths between the curved mirrors, hits near
grazing incidence) carry per-pixel derivatives orders of magnitude above
the frame's mean, and float32 fixes those only to a few percent: one
ulp more on one component of such a pixel's ray moves its derivative by
as much as the two backends part. So `radius_check` holds the radius
over the pixels whose paths agree on both backends (every segment's
closest hit (kind, prim) and its shadow query, asked and occluded;
`paths`): the two gradients may part by the sum, over those pixels, of
RTOL times each pixel's absolute contribution (the torch backend's, by
forward-mode AD; `radius_contributions`) and of the most that one ulp
on its ray moves the contribution (`radius_spread`). Pixels whose paths
part differentiate different functions; `radius_check` counts them.

    python -m toroidal_ray_tracing_tpu_torch.experiments.grad_check \\
        [--config 3] [--width 512 --height 512] [--worst 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json

import numpy as np
import torch
import torch.autograd.forward_ad as fwad

from toroidal_ray_tracing_tpu_torch.cameras import generate_rays
from toroidal_ray_tracing_tpu_torch.render.renderer import (
    autofill_pixel_spread, check_device)
from toroidal_ray_tracing_tpu_torch.trace import shade as _shade
from toroidal_ray_tracing_tpu_torch.trace import wavefront as _wavefront
from toroidal_ray_tracing_tpu_torch.trace.wavefront import trace_rays_fixed

PARAMS = ("minor_radius_scale", "light_intensity", "light_position",
          "diffuse_scale")
RTOL = 1e-3            # tests/test_differentiable.py's bound on gradients
PARTED_MAX = 1e-3      # share of the frame whose paths may part


def torch_tile(scene) -> int:
    """Rays per tile of the torch backend's differentiated frame: its dense
    queries keep a (rays x primitives) graph, about 2^28 elements."""
    prims = max(scene.triangles.count, 8 * scene.tori.count)
    return max(4096, min(1 << 19, (1 << 28) // prims))


def grad_loss(scene, st, o, d, depth, backend, tile, keep=None):
    """(loss, {param: grad as numpy}) of the image mean of
    `trace_rays_fixed` over the rays o, d ((N, 3)), with respect to PARAMS.
    keep: an (N,) 0/1 weight on the pixels (default all). The rays are
    traced in tiles of `tile`, each tile's graph freed by its backward."""
    dev = o.device
    params = {
        "minor_radius_scale": torch.ones((), device=dev),
        "light_intensity": torch.tensor(float(st.light.intensity),
                                        device=dev),
        "light_position": st.light.position.clone(),
        "diffuse_scale": torch.ones(3, device=dev)}
    for v in params.values():
        v.requires_grad_(True)
    n = o.shape[0]
    loss = 0.0
    for s in range(0, n, tile):
        tori = dataclasses.replace(scene.tori, minor_radius=(
            scene.tori.minor_radius * params["minor_radius_scale"]))
        mats = dataclasses.replace(scene.materials, diffuse=(
            scene.materials.diffuse * params["diffuse_scale"]))
        sc = dataclasses.replace(scene, tori=tori, materials=mats)
        sc.kernel_tables = scene.kernel_tables   # keyed by their tensors
        stp = dataclasses.replace(st, light=dataclasses.replace(
            st.light, intensity=params["light_intensity"],
            position=params["light_position"]))
        hv, _ = trace_rays_fixed(sc, stp, o[s:s + tile], d[s:s + tile],
                                 depth, backend=backend)
        if keep is not None:
            hv = hv * keep[s:s + tile, None]
        part = hv.sum() / float(3 * n)
        part.backward()
        loss += float(part.detach())
    # a scene without tori leaves the radius scale out of the graph
    return loss, {k: (v.grad if v.grad is not None else
                      torch.zeros_like(v)).detach().cpu().numpy()
                  for k, v in params.items()}


def _scaled_radius(scene, scale):
    return dataclasses.replace(scene, tori=dataclasses.replace(
        scene.tori, minor_radius=scene.tori.minor_radius * scale))


@contextlib.contextmanager
def _recorded(segments: list):
    """Record each segment of `trace_rays_fixed` into `segments`: its
    closest hit's kind and prim, then its shadow query's asked (tmax > 0)
    and occluded masks."""
    hit_fns = (_wavefront.closest_hit, _wavefront.closest_hit_diff)
    any_hit = _shade.any_hit

    def recording(fn):
        def closest(*a, **k):
            hit = fn(*a, **k)
            # a miss's prim is no primitive's: each backend leaves its own
            segments.append([hit.kind, torch.where(hit.kind >= 0, hit.prim,
                                                   -1)])
            return hit
        return closest

    def shadow(scene, origins, dirs, tmax, **k):
        occluded = any_hit(scene, origins, dirs, tmax, **k)
        segments[-1] += [tmax > 0, occluded & (tmax > 0)]
        return occluded

    _wavefront.closest_hit, _wavefront.closest_hit_diff = map(recording,
                                                              hit_fns)
    _shade.any_hit = shadow
    try:
        yield
    finally:
        _wavefront.closest_hit, _wavefront.closest_hit_diff = hit_fns
        _shade.any_hit = any_hit


def paths(scene, st, o, d, depth, backend, tile):
    """(segments, 4, N) int32: every ray's path through `trace_rays_fixed`
    on `backend` (per segment: closest-hit kind and prim, shadow query
    asked and occluded), traced in tiles of `tile` rays."""
    parts = []
    for s in range(0, o.shape[0], tile):
        segments: list = []
        with _recorded(segments), torch.no_grad():
            trace_rays_fixed(scene, st, o[s:s + tile], d[s:s + tile], depth,
                             backend=backend)
        parts.append(torch.stack([torch.stack([x.to(torch.int32)
                                               for x in seg])
                                  for seg in segments]))
    return torch.cat(parts, dim=2)


def radius_contributions(scene, st, o, d, depth, tile, frame=None):
    """(N,) each pixel's share of the loss's derivative with respect to
    the minor-radius scale (they sum to it), on the torch backend by
    forward-mode AD, in tiles of `tile` rays. frame: the ray count of the
    loss's mean (default N)."""
    n = o.shape[0]
    frame = frame or n
    out = []
    with fwad.dual_level(), torch.no_grad():
        one = torch.ones((), device=o.device)
        sc = _scaled_radius(scene, fwad.make_dual(one, one))
        for s in range(0, n, tile):
            hv, _ = trace_rays_fixed(sc, st, o[s:s + tile], d[s:s + tile],
                                     depth, backend="torch")
            tangent = fwad.unpack_dual(hv).tangent    # None: no torus seen
            out.append(torch.zeros(hv.shape[0], device=o.device)
                       if tangent is None
                       else tangent.sum(dim=1) / (3 * frame))
    return torch.cat(out)


def radius_spread(scene, st, o, d, depth, tile, contrib):
    """(N,) each pixel's float32 conditioning: the largest change of its
    contribution (`contrib`, from `radius_contributions`) when one of its
    ray's six origin and direction components moves up by one ulp, on
    the torch backend; 0 where the contribution is 0 (the radius does not
    reach the pixel)."""
    idx = torch.nonzero(contrib).flatten()
    spread = torch.zeros_like(contrib)
    up = torch.tensor(float("inf"), device=o.device)
    for rays, k in itertools.product((0, 1), range(3) if len(idx) else ()):
        moved = [o[idx], d[idx]]
        moved[rays][:, k] = torch.nextafter(moved[rays][:, k], up)
        c = radius_contributions(scene, st, *moved, depth, tile, o.shape[0])
        spread[idx] = torch.maximum(spread[idx], (c - contrib[idx]).abs())
    return spread


def radius_check(scene, st, o, d, depth, tile) -> dict:
    """The radius rule (module docstring) on one frame: the pixels whose
    paths part, both backends' radius gradients over the rest, and their
    gap against `bound`, there the sum of RTOL times each pixel's
    absolute contribution (`bound_rtol`) and its one-ulp spread
    (`bound_spread`); `ok` when the gap is within it and at most
    PARTED_MAX of the frame parted."""
    n = o.shape[0]
    parted = (paths(scene, st, o, d, depth, "kernel", n)
              != paths(scene, st, o, d, depth, "torch", tile)).any(dim=1)
    parted = parted.any(dim=0)
    keep = ~parted
    lk, gk = grad_loss(scene, st, o, d, depth, "kernel", n, keep.float())
    lt, gt = grad_loss(scene, st, o, d, depth, "torch", tile, keep.float())
    contrib = radius_contributions(scene, st, o, d, depth, tile)
    spread = radius_spread(scene, st, o, d, depth, tile, contrib)
    r = PARAMS[0]
    gap = abs(float(gk[r]) - float(gt[r]))
    bound_rtol = RTOL * float(contrib[keep].abs().sum())
    bound_spread = float(spread[keep].sum())
    bound = bound_rtol + bound_spread
    n_parted = int(parted.sum())
    worst = torch.argsort(contrib.abs(), descending=True)[:4]
    return dict(
        parted=n_parted, parted_pixels=torch.nonzero(parted).flatten()
        .tolist()[:8], loss_kernel=lk, loss_torch=lt,
        kernel=float(gk[r]), torch=float(gt[r]), gap=gap, bound=bound,
        bound_rtol=bound_rtol, bound_spread=bound_spread,
        margin=bound / gap if gap else float("inf"),
        contributions_sum=float(contrib.sum()),
        contributions_abs=float(contrib.abs().sum()),
        worst=worst.tolist(), worst_contributions=contrib[worst].tolist(),
        worst_spread=spread[worst].tolist(),
        ok=gap <= bound and n_parted <= PARTED_MAX * n)


def setup(config: int, width: int, height: int, device):
    """(scene on the device, settings, origins, dirs, depth) of a ladder
    scenario at width x height."""
    from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS

    sc = SCENARIOS[config]
    st = autofill_pixel_spread(sc.settings(), sc.camera, width,
                               height).to(device)
    o, d = generate_rays(sc.camera, width, height, st, device=device)
    return sc.build().to(device), st, o, d, int(st.max_depth)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", type=int, default=3)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--worst", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    scene, st, o, d, depth = setup(args.config, args.width, args.height,
                                   device)
    n, w = o.shape[0], args.width
    tile = torch_tile(scene)
    lk, gk = grad_loss(scene, st, o, d, depth, "kernel", n)
    lt, gt = grad_loss(scene, st, o, d, depth, "torch", tile)
    rel = {k: float(np.max(np.abs(gk[k] - gt[k])
                           / np.maximum(np.abs(gt[k]), 1e-30)))
           for k in PARAMS}
    row = dict(config=args.config, width=args.width, height=args.height,
               loss_kernel=lk, loss_torch=lt, max_rel=rel,
               radius=radius_check(scene, st, o, d, depth, tile))
    print(json.dumps(row), flush=True)
    for i in row["radius"]["worst"][:args.worst]:
        one = [grad_loss(scene, st, o[i:i + 1], d[i:i + 1], depth, b, 1)[1]
               for b in ("kernel", "torch")]
        print(json.dumps(dict(
            pixel=[i % w, i // w],
            radius_grad=[float(g[PARAMS[0]]) for g in one])), flush=True)
    return row


if __name__ == "__main__":
    main()
