"""Where the port's two backends part on the capture's frame: every bounce
segment's rays and closest hits recorded on `backend="kernel"` and on
`backend="torch"`, and compared segment by segment.

    python -m toroidal_ray_tracing_tpu_torch.experiments.backend_paths \
        [width height [device]]

The frame is the capture step that chip_smoke phase 7 holds on both
backends: config 6's scene (`SCENARIOS[6]`), the toroidal camera eye
(0, 1.5, 0) -> (8, 0, 0), rho 4, depth 10; 480x270 on the CUDA device by
default. Per segment it prints the live rays, the rays whose origin or
direction differ between the backends, the hits that differ (kind or
primitive), and how many of those are on rays equal in every bit; for the
first few such hits, both winners with t and, for a triangle, its float64
barycentrics (u, v, w = 1 - u - v: a value within ~1e-6 of 0 is a ray
through an edge). Last, the pixels off by > 1e-3 in the two images. Prints
the card's name and power limit first when the device is CUDA.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys

import torch

from toroidal_ray_tracing_tpu_torch import render
from toroidal_ray_tracing_tpu_torch.cameras import ToroidalCamera
from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
from toroidal_ray_tracing_tpu_torch.scene import RenderSettings
from toroidal_ray_tracing_tpu_torch.trace import wavefront

SHOW = 6    # differing hits printed per segment


def _recorded(scene, camera, w, h, settings, backend, device):
    """(image, per-segment dicts of rays and hits) of one render."""
    calls, real = [], wavefront.closest_hit

    def closest_hit(scene, origins, dirs, *args, **kw):
        hit = real(scene, origins, dirs, *args, **kw)
        calls.append(dict(o=origins.cpu(), d=dirs.cpu(),
                          live=kw["tmax"].cpu() > 0, t=hit.t.cpu(),
                          kind=hit.kind.cpu(), prim=hit.prim.cpu()))
        return hit

    wavefront.closest_hit = closest_hit
    try:
        image = render(scene, camera, w, h, settings, backend=backend,
                       device=device)["image"]
    finally:
        wavefront.closest_hit = real
    return image, calls


def main(argv) -> int:
    w, h = (int(argv[0]), int(argv[1])) if len(argv) >= 2 else (480, 270)
    device = argv[2] if len(argv) >= 3 else "cuda"
    if device == "cuda":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0], flush=True)
    host = SCENARIOS[6].build()
    scene = host.to(device)
    tri = host.triangles
    v0, e1, e2 = tri.v0.double(), tri.e1.double(), tri.e2.double()
    cam = ToroidalCamera(eye=(0.0, 1.5, 0.0), center=(8.0, 0.0, 0.0))
    st = dataclasses.replace(RenderSettings.default(max_depth=10), rho=4.0)
    img_k, seg_k = _recorded(scene, cam, w, h, st, "kernel", device)
    img_t, seg_t = _recorded(scene, cam, w, h, st, "torch", device)

    def winner(seg, i, o, d):
        kind, p = int(seg["kind"][i]), int(seg["prim"][i])
        text = f"kind {kind} prim {p} t {float(seg['t'][i]):.9g}"
        if kind == 0:   # float64 Moller-Trumbore on the winner
            o, d = o.double(), d.double()
            pv = torch.linalg.cross(d, e2[p])
            det = float(e1[p] @ pv)
            s = o - v0[p]
            qv = torch.linalg.cross(s, e1[p])
            u, v = float(s @ pv) / det, float(d @ qv) / det
            text += f" (f64 u {u:.2e} v {v:.2e} w {1.0 - u - v:.2e})"
        return text

    for k, (a, b) in enumerate(zip(seg_k, seg_t)):
        live = a["live"] & b["live"]
        apart = ((a["o"] != b["o"]) | (a["d"] != b["d"])).any(dim=0) & live
        differ = live & ((a["kind"] != b["kind"])
                         | ((a["prim"] != b["prim"]) & (a["kind"] >= 0)))
        print(f"segment {k}: live {int(live.sum())}, rays apart "
              f"{int(apart.sum())}, hits differ {int(differ.sum())}, of them "
              f"on equal rays {int((differ & ~apart).sum())}, live on one "
              f"backend only {int((a['live'] != b['live']).sum())}",
              flush=True)
        for i in torch.nonzero(differ)[:SHOW, 0].tolist():
            o, d = a["o"][:, i], a["d"][:, i]
            print(f"  ray {i}{' (apart)' if apart[i] else ''}: kernel "
                  f"{winner(a, i, o, d)} | torch "
                  f"{winner(b, i, b['o'][:, i], b['d'][:, i])}", flush=True)
    off = int(((img_k - img_t).abs().amax(dim=-1) > 1e-3).sum())
    print(f"{w}x{h}: {off} of {w * h} pixels off by > 1e-3", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
