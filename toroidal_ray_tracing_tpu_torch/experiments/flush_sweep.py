"""K2's pair queue on the card: `kFlushPairs` swept.

K2 (`csrc/torus_hit.cu`) queues the (torus, lane) pairs that pass their
torus box in a per-warp ring and runs a round of quartics, one pair per
lane, whenever `kFlushPairs` pairs are queued (and at the end of the walk).
With 1 a round runs at every leaf some lane passes: the schedule of a plain
packet walk, each ray's bound current at every node, the warp paying one
quartic for each torus any of its rays enters. With 32 every round but the
last is full, and a ray walks on at the bound of the last round. This
script builds K2 once per value (a copy of the sources under
`build/flush<N>/`, all nvcc processes started together), then times each
build's bare launch in turns (the values in order, then in reverse), with
CUDA events, median of 5 after a warm-up, on config 4's 1080p primary rays
(closest with attrs) and their shadow rays (any-hit), and on config 3's
1080p primary rays, with the kernel's work counters (slab tests,
quartics). Every build's outputs are held against the shipped kernel's:
bit-equal for closest+attrs, equal masks for any-hit.

    python -m toroidal_ray_tracing_tpu_torch.experiments.flush_sweep [N ...]

(default values 1 32; each 1..32). Needs an NVIDIA GPU and nvcc. Prints
the card's name and power limit, then one JSON line per value, turn and
call.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys

import torch

from toroidal_ray_tracing_tpu_torch.cameras.pinhole import pick_block
from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
from toroidal_ray_tracing_tpu_torch.experiments.coop_sweep import (
    build_variants, cuda_ms, entry)
from toroidal_ray_tracing_tpu_torch.ops import kernel_common as kc
from toroidal_ray_tracing_tpu_torch.ops import torus_kernel as tk
from toroidal_ray_tracing_tpu_torch.ops.trace_kernel import _material_rows

ENTRY = "trt_torus_closest_hit"
FLUSH = re.compile(r"constexpr int kFlushPairs = \d+;")


def cell(num, dev):
    """(name, tables, [(label, origins, dirs, tmax, occlusion)]) of config
    num at 1080p: its primary rays, and for config 4 their shadow rays
    toward the light from the shipped kernel's hits."""
    sc = SCENARIOS[num]
    scene = sc.build().to(dev)
    tor = scene.tori
    tables = tk.torus_tables(tor.world_to_obj, tor.major_radius,
                             tor.minor_radius,
                             _material_rows(scene, tor.mat_id).contiguous())
    st = sc.settings()
    w, h = 1920, 1080
    cam = sc.camera
    o, d = cam.device_rays(cam.ray_params(w, h, st), w, h, st,
                           block=pick_block(w, h), rows=True, device=dev)
    o, d = o.contiguous(), d.contiguous()
    tm = torch.full((o.shape[1],), 1e4, device=dev)
    calls = [("closest_attrs", o, d, tm, False)]
    if num == 4:
        t = tk.torus_closest_hit_chunked(o, d, tm, tables)[0]
        hit = t < 1e30
        p = o + torch.where(hit, t, 0.0)[None, :] * d
        to_light = st.light.position.to(dev)[:, None] - p
        dist = torch.linalg.vector_norm(to_light, dim=0)
        calls.append(("anyhit", p.contiguous(),
                      (to_light / dist.clamp(min=1e-20)).contiguous(),
                      torch.where(hit, dist, 0.0), True))
    return sc.name, tables, calls


def main(argv) -> int:
    values = [int(a) for a in argv] or [1, 32]
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    libs = build_variants("torus_hit.cu", "torus_hit.cu", FLUSH,
                          "constexpr int kFlushPairs = {};", values, "flush")
    dev = torch.device("cuda")
    cells = [cell(4, dev), cell(3, dev)]
    for turn, value in enumerate(values + values[::-1]):
        fn = entry(libs[value], ENTRY)
        for name, tb, calls in cells:
            for label, o, d, tm, occl in calls:
                n = o.shape[1]
                rank = kc.tree_rank(kc.visit_order(tb.clo, tb.chi, o, n))
                work = torch.zeros(2, dtype=torch.int64, device=dev)
                out = [torch.empty((n,), device=dev),
                       torch.empty((n,), dtype=torch.int32, device=dev)]
                attrs = None if occl else torch.empty((15, n), device=dev)

                def run(counters=None):
                    args = (o, d, tm, n, n, tb.w2o_rows, tb.rad, tb.tree_lo,
                            tb.tree_hi, tb.tree_link, tb.tree_lo.shape[0],
                            tb.depth, rank, tb.chunk,
                            None if occl else tb.mat, int(occl), *out, attrs,
                            counters, None, 0,
                            torch.cuda.current_stream().cuda_stream)
                    rc = fn(*[x.data_ptr() if isinstance(x, torch.Tensor)
                              else x for x in args])
                    if rc != 0:
                        raise RuntimeError(f"{ENTRY} (kFlushPairs = "
                                           f"{value}): CUDA error {rc}")

                ref = tk.torus_closest_hit_chunked(o, d, tm, tb,
                                                   want_attrs=not occl,
                                                   occlusion=occl)
                run(work)
                got = out + ([attrs] if attrs is not None else [])
                same = (torch.equal(got[0] < 1e30, ref[0] < 1e30) if occl
                        else all(torch.equal(x, y)
                                 for x, y in zip(got, ref)))
                box, quartics = (int(x) for x in work.tolist())
                print(json.dumps({
                    "kFlushPairs": value, "turn": turn, "scene": name,
                    "call": label,
                    "rays": n, "bare_ms": cuda_ms(run),
                    "slab_tests_per_ray": box / n,
                    "quartics_per_ray": quartics / n,
                    "equal_to_shipped": same}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
