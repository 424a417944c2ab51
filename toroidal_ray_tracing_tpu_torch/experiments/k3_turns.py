"""K3 (`csrc/torus_hit.cu` torus_closest_hit_small) timed on the card at
the main path's shapes, for the package on the import path, so that two
checkouts can be timed in turns in one call:

    PYTHONPATH=<checkout> python <path of this file>

(run as a file, it imports the `toroidal_ray_tracing_tpu_torch` that
PYTHONPATH names; this file itself may come from another checkout). The
calls: config 3 at 512x512 (4 tori), its primary rays with attrs and their
shadow rays toward the light (any-hit); config 7's first 1080p
closest+attrs call and first any-hit call (its mirror torus, K = 1),
captured from `render` as the main path makes them. For each: the
wrapper, CUDA events around one call, median of 5 after a warm-up (the
host's launch included); the kernel's device time (20 wrapper calls
captured in one CUDA graph, the replay timed the same way, over 20; the
wrapper launches nothing else); the hit-mask mismatches against the plain
twin, and the rays whose idx is not 0 (any-hit writes idx 0 in the JAX
kernel and the twin). Only the wrapper's signature is used, which every
checkout of the port shares. Needs an NVIDIA GPU and nvcc. Prints the
card's name and power limit, then one JSON line per call.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

from toroidal_ray_tracing_tpu_torch import render
from toroidal_ray_tracing_tpu_torch.cameras.pinhole import pick_block
from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
from toroidal_ray_tracing_tpu_torch.experiments.coop_sweep import cuda_ms
from toroidal_ray_tracing_tpu_torch.ops import torus_kernel as tk
from toroidal_ray_tracing_tpu_torch.ops.trace_kernel import _material_rows

K3_RES = 512


def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call of fn with no host time between the
    calls: reps calls captured in one CUDA graph, its replay timed with
    cuda_ms, divided by reps. (Events around one host-launched call also
    hold the host's launch of it, tens of microseconds: most of a small
    kernel's figure.)"""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay) / reps


def config3_calls(dev):
    """Config 3 at 512x512: primary rays with attrs, then their shadow
    rays."""
    sc = SCENARIOS[3]
    scene = sc.build().to(dev)
    tor = scene.tori
    tables = tk.torus_tables(tor.world_to_obj, tor.major_radius,
                             tor.minor_radius,
                             _material_rows(scene, tor.mat_id).contiguous())
    st = sc.settings()
    cam = sc.camera
    o, d = cam.device_rays(cam.ray_params(K3_RES, K3_RES, st), K3_RES,
                           K3_RES, st, block=pick_block(K3_RES, K3_RES),
                           rows=True, device=dev)
    o, d = o.contiguous(), d.contiguous()
    tm = torch.full((o.shape[1],), 1e4, device=dev)
    t = tk.torus_closest_hit_small(o, d, tm, tables)[0]
    hit = t < 1e30
    p = o + torch.where(hit, t, 0.0)[None, :] * d
    to_light = st.light.position.to(dev)[:, None] - p
    dist = torch.linalg.vector_norm(to_light, dim=0)
    return [("config3_512_closest_attrs", tables, o, d, tm, True, False),
            ("config3_512_anyhit", tables, p.contiguous(),
             (to_light / dist.clamp(min=1e-20)).contiguous(),
             torch.where(hit, dist, 0.0), False, True)]


def config7_calls(dev):
    """Config 7's first 1080p closest+attrs and any-hit K3 calls, as
    `render` makes them."""
    sc = SCENARIOS[7]
    scene = sc.build().to(dev)
    taken = []
    real = tk.torus_closest_hit_small

    def record(o, d, tm, tables, want_attrs=False, occlusion=False,
               **kw):
        taken.append((tables, o.clone(), d.clone(), tm.clone(), want_attrs,
                      occlusion))
        return real(o, d, tm, tables, want_attrs=want_attrs,
                    occlusion=occlusion, **kw)

    tk.torus_closest_hit_small = record
    try:
        render(scene, sc.camera, 1920, 1080, sc.settings(), backend="kernel",
               device=dev)
    finally:
        tk.torus_closest_hit_small = real
    calls = []
    for occl, name in ((False, "config7_1080p_closest_attrs"),
                       (True, "config7_1080p_anyhit")):
        c = next(c for c in taken if c[5] == occl)
        calls.append((name,) + c)
    return calls


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda")
    root = os.path.dirname(os.path.dirname(os.path.abspath(tk.__file__)))
    for name, tables, o, d, tm, attrs, occl in (config3_calls(dev)
                                                + config7_calls(dev)):
        def call():
            return tk.torus_closest_hit_small(o, d, tm, tables,
                                              want_attrs=attrs,
                                              occlusion=occl)

        got = call()
        ref = tk.torus_small_plain(o, d, tm, tables.par, attrs, occl)
        print(json.dumps({
            "package": root, "call": name, "rays": o.shape[1],
            "K": tables.K, "hits": int((ref[0] < 1e30).sum()),
            "mask_mismatches": int(((got[0] < 1e30)
                                    != (ref[0] < 1e30)).sum()),
            "nonzero_idx": int((got[1] != 0).sum()),
            "wrapper_ms": cuda_ms(call),
            "device_ms": graph_ms(call)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
