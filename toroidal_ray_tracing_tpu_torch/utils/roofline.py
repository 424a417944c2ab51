"""Roofline / MFU accounting for the trace kernels (the port of the JAX
package's `utils/roofline.py`).

The reference publishes no performance counters at all; this module models
the arithmetic a traceRayEXT-equivalent query costs and turns a measured
Mrays/s into a fraction of the card's peak. The work model is the JAX
package's, constant for constant, so that it reads the same work whatever
implements the trace:

* `brute_flops_per_ray(scene)` — the all-pairs upper bound: every ray
  tests every triangle (6 Woop dots + ~25 ops a pair) and every torus
  (~600-op quartic + slab).
* `measured_flops_per_ray(scene, origins, dirs)` — the post-cull model:
  the slab gates of the JAX kernels (the triangle cluster boxes
  `scene.cluster_lo/hi`; the torus chunk boxes of `_torus_boxes`, with
  chunks of TORUS_CHUNK = 8 tori, GATED_TORUS_CHUNK = 16 above 64 tori)
  are evaluated on a sample of the primary rays, and each ray is charged
  for its candidate (ray, cluster / chunk) pairs, the gate's own slab
  tests and shading. The port's kernels walk trees instead of these
  chunks; the chunks are constants of the model, not of the kernels.

`mfu()` uses the post-cull model and is capped at 1.0: it is a
utilization, and a number labeled MFU above 1 is an accounting bug. The
brute-force / post-cull ratio is `cull_speedup`.

Peaks: one NVIDIA H100 SXM at its 700 W limit (the data sheet), f32
outside the tensor cores and HBM3. State a share against them beside the
card's name and power limit.
"""

from __future__ import annotations

import numpy as np
import torch

from toroidal_ray_tracing_tpu_torch.ops.torus_kernel import _tables

PEAK_F32 = 67e12          # f32 operations / s
PEAK_BYTES = 3.35e12      # HBM bytes / s
# 32-bit integer operations / s: 132 SMs x 128 lanes x 1.98 GHz boost,
# what the SM's four schedulers issue a clock (its 64 int32 lanes, and
# integer adds issued to the f32 lanes as IMAD). The data sheet lists no
# int32 rate; the 64 int32 lanes alone are no bound: csrc/threefry.cu ran
# in 0.69x of that figure on an H100.
PEAK_INT32 = 132 * 128 * 1.98e9

TRI_FLOPS_PER_PAIR = 6 * 8 + 25      # Woop dots + hit test/argmin
TORUS_FLOPS_PER_PAIR = 25 + 600      # slab refine + quartic solve
SHADE_FLOPS_PER_RAY = 300
GATE_FLOPS_PER_BOX = 30              # slab test of one ray vs one AABB
MAX_SAMPLE_RAYS = 1 << 18            # gate-measurement subsample bound

TORUS_CHUNK = 8           # tori per chunk box, K <= 64
GATED_TORUS_CHUNK = 16    # tori per chunk box, K > 64

_F32_3E38 = float(np.float32(3e38))
_F32_TMIN = float(np.float32(1e-3))


def brute_flops_per_ray(scene) -> float:
    """All-pairs (provisioned) f32 ops per traceRayEXT-equivalent query."""
    T = int(scene.triangles.valid.shape[0])
    K = int(scene.tori.major_radius.shape[0])
    return (T * TRI_FLOPS_PER_PAIR + K * TORUS_FLOPS_PER_PAIR
            + SHADE_FLOPS_PER_RAY)


def _fma3(a, b):
    """sum_j a[..., j] * b[..., j] over j = 0..2 as fma(a2, b2, fma(a1, b1,
    a0 * b0)): the order and rounding of the JAX model's 3-term einsums on
    the CPU. Each fma runs in float64 (the product of two float32 values
    is exact there) and rounds to float32."""
    acc = a[..., 0] * b[..., 0]
    for j in (1, 2):
        acc = (a[..., j].double() * b[..., j].double() + acc.double()).float()
    return acc


def _torus_boxes(w2o_rows, rad, chunk: int):
    """Per-torus world AABBs + `chunk`-torus chunk AABBs, the JAX package's
    `ops/torus_kernel.py` `_torus_boxes` as its model evaluates it (the
    kernel's copy, `ops.torus_kernel._torus_boxes`, rounds its two 3-term
    sums without fma). w2o_rows: (Kp, 12); rad: (Kp, 2) [major, minor];
    Kp % chunk == 0. Returns (tor_lo, tor_hi, chunk_lo, chunk_hi)."""
    r0 = w2o_rows[:, 0:3]
    r1 = w2o_rows[:, 4:7]
    r2 = w2o_rows[:, 8:11]
    tv = torch.stack([w2o_rows[:, 3], w2o_rows[:, 7], w2o_rows[:, 11]], dim=1)
    c0 = torch.linalg.cross(r1, r2, dim=1)
    c1 = torch.linalg.cross(r2, r0, dim=1)
    c2 = torch.linalg.cross(r0, r1, dim=1)
    # summed left to right on every device, as the JAX model's reduce
    det = (r0[:, 0] * c0[:, 0] + r0[:, 1] * c0[:, 1]
           + r0[:, 2] * c0[:, 2])[:, None]
    ok = det.abs() > 1e-30
    inv_det = torch.where(ok, 1.0, 0.0) / torch.where(ok, det, 1.0)
    rot = torch.stack([c0, c1, c2], dim=2) * inv_det[:, :, None]  # o2w
    wc = -_fma3(rot, tv[:, None, :])
    rmin_abs = rad[:, 1].abs()
    h_obj = torch.stack([rad[:, 0] + rmin_abs, rmin_abs,
                         rad[:, 0] + rmin_abs], dim=1)
    h_w = _fma3(rot.abs(), h_obj[:, None, :])
    alive = (rad[:, 1] > 0.0)[:, None]
    tor_lo = torch.where(alive, wc - h_w, 2.0e38)
    tor_hi = torch.where(alive, wc + h_w, 2.0e38)

    C = w2o_rows.shape[0] // chunk
    any_alive = alive.reshape(C, chunk).any(dim=1)[:, None]
    clo = tor_lo.reshape(C, chunk, 3).amin(dim=1)
    chi = torch.where(alive, wc + h_w, -2.0e38).reshape(C, chunk, 3).amax(dim=1)
    chi = torch.where(any_alive, chi, 2.0e38)
    return tor_lo, tor_hi, clo, chi


def _slab_hits(lo, hi, o, d):
    """Mean boxes hit per ray. lo/hi: (C, 3); o/d: (N, 3) float32 tensors
    on one device. Blocked over rays and boxes as the JAX model is, so
    temporaries stay ~(4096, 256, 3); the count is summed on the device.
    The arithmetic is the JAX model's (its reciprocal, then (lo - o) *
    inv, then min / max), so the count is equal to its count."""
    small = d.abs() > 1e-30
    inv = torch.where(small, 1.0 / torch.where(d == 0, 1.0, d),
                      torch.where(d >= 0, _F32_3E38, -_F32_3E38))
    total = torch.zeros((), dtype=torch.int64, device=o.device)
    RB, CB = 4096, 256
    for r0 in range(0, o.shape[0], RB):
        ob = o[r0:r0 + RB, None, :]
        ib = inv[r0:r0 + RB, None, :]
        for c0 in range(0, lo.shape[0], CB):
            t0 = (lo[None, c0:c0 + CB, :] - ob) * ib
            t1 = (hi[None, c0:c0 + CB, :] - ob) * ib
            tn = torch.minimum(t0, t1).amax(dim=2)
            tf = torch.maximum(t0, t1).amin(dim=2)
            total += ((tn <= tf) & (tf >= _F32_TMIN)).sum()
    return int(total) / o.shape[0]


def measured_flops_per_ray(scene, origins, dirs) -> float:
    """Post-cull f32 ops per primary query, measured by running the JAX
    kernels' box gates on (a sample of) this ray batch, on the rays'
    device. origins/dirs: (N, 3) primary rays (tensors or arrays)."""
    o = torch.as_tensor(origins, dtype=torch.float32).reshape(-1, 3)
    d = torch.as_tensor(dirs, dtype=torch.float32,
                        device=o.device).reshape(-1, 3)
    stride = max(1, o.shape[0] // MAX_SAMPLE_RAYS)
    o, d = o[::stride], d[::stride]
    dev = o.device

    flops = float(SHADE_FLOPS_PER_RAY)

    if bool(scene.triangles.valid.any()):
        clo = scene.cluster_lo.to(dev)
        hits = _slab_hits(clo, scene.cluster_hi.to(dev), o, d)
        flops += hits * int(scene.cluster_size) * TRI_FLOPS_PER_PAIR
        flops += clo.shape[0] * GATE_FLOPS_PER_BOX

    tori = scene.tori
    if bool((tori.minor_radius > 0).any()):
        K = tori.minor_radius.shape[0]
        chunk = GATED_TORUS_CHUNK if K > 64 else TORUS_CHUNK
        w2o, rad = _tables(tori.world_to_obj, tori.major_radius,
                           tori.minor_radius, chunk)
        _, _, clo, chi = _torus_boxes(w2o.to(dev), rad.to(dev), chunk)
        hits = _slab_hits(clo, chi, o, d)
        flops += hits * chunk * TORUS_FLOPS_PER_PAIR
        flops += clo.shape[0] * GATE_FLOPS_PER_BOX

    return flops


def mfu(mrays_per_s: float, scene, rays=None,
        peak_flops: float = PEAK_F32) -> float:
    """Fraction of peak implied by a measured Mrays/s on this scene.

    rays: optional (origins, dirs) — the scenario's primary batch; with it
    the post-cull model is used, without it the brute-force model. Capped
    at 1.0: work skipped by culling belongs in `cull_speedup`."""
    if rays is not None:
        fpr = measured_flops_per_ray(scene, *rays)
    else:
        fpr = brute_flops_per_ray(scene)
    return min(mrays_per_s * 1e6 * fpr / peak_flops, 1.0)


def cull_speedup(scene, rays) -> float:
    """Brute-force flops / post-cull flops (>= 1 when the gates prune
    anything). This is the number that must NOT be called MFU."""
    return brute_flops_per_ray(scene) / measured_flops_per_ray(scene, *rays)
