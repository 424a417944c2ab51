"""K5's cooperative-cluster threshold on the card: `kCoopLanes` swept.

K5 (`csrc/tri_stream.cu`, with K1's walk in `csrc/tree_walk.cuh`) tests a
cluster that at most `kCoopLanes` rays of a warp enter with all 32 lanes,
one ray at a time; a cluster that more rays enter, each lane with its own
ray. This script builds K5 once per value of that constant (a copy of the
sources under `build/coop<N>/`, all nvcc processes started together), then
times each build on config 8's 1080p primary rays (closest with attrs) and
on their shadow rays (any-hit), with CUDA events, median of 5 after a
warm-up. Every build's outputs are
held against the shipped kernel's: bit-equal for closest+attrs, equal
masks for any-hit.

    python -m toroidal_ray_tracing_tpu_torch.experiments.coop_sweep [N ...]

(default values 4 12 20 32). Needs an NVIDIA GPU and nvcc. Prints the
card's name and power limit, then one JSON line per value.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys

import torch

from toroidal_ray_tracing_tpu_torch.cameras.pinhole import pick_block
from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
from toroidal_ray_tracing_tpu_torch.ops import kernel_common as kc
from toroidal_ray_tracing_tpu_torch.ops import tri_stream as ts
from toroidal_ray_tracing_tpu_torch.ops.trace_kernel import _tri_attr_tables

ENTRY = "trt_tri_closest_hit_stream"
COOP = re.compile(r"constexpr int kCoopLanes = \d+;")


def build_variants(source, edited, pattern, line, values, tag):
    """{value: path of a library holding `source` (a file of csrc/) built
    with the one match of `pattern` in `edited` (csrc/source itself or a
    header it includes) replaced by line.format(value)}: a copy of the
    sources per value under build/<tag><value>/, all nvcc processes started
    together."""
    with open(os.path.join(kc.CSRC, edited)) as f:
        text = f.read()
    if len(pattern.findall(text)) != 1:
        raise RuntimeError(f"{pattern.pattern} does not match once in "
                           f"{edited}")
    procs, libs = [], {}
    for n in values:
        out = os.path.join(kc.BUILD_DIR, f"{tag}{n}")
        os.makedirs(out, exist_ok=True)
        for name in os.listdir(kc.CSRC):
            if name.endswith(".cuh") or name == source:
                shutil.copy(os.path.join(kc.CSRC, name), out)
        with open(os.path.join(out, edited), "w") as f:
            f.write(pattern.sub(line.format(n), text))
        libs[n] = os.path.join(out, f"lib{tag}.so")
        procs.append((f"{tag} = {n}", subprocess.Popen(
            [kc._nvcc(), *kc.NVCC_FLAGS, "-shared",
             os.path.join(out, source), "-o", libs[n]],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    kc._run(procs)
    return libs


def build(values):
    """{value: path of a library holding K5 built with kCoopLanes = value}."""
    return build_variants("tri_stream.cu", "tree_walk.cuh", COOP,
                          "constexpr int kCoopLanes = {};", values, "coop")


def entry(path, name=ENTRY):
    fn = getattr(ctypes.CDLL(path), name)
    fn.argtypes = kc._SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def cuda_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv) -> int:
    values = [int(a) for a in argv] or [4, 12, 20, 32]
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0], flush=True)
    libs = build(values)

    dev = torch.device("cuda")
    sc = SCENARIOS[8]
    scene = sc.build().to(dev)
    st = sc.settings()
    w, h = 1920, 1080
    cam = sc.camera
    o, d = cam.device_rays(cam.ray_params(w, h, st), w, h, st,
                           block=pick_block(w, h), rows=True, device=dev)
    o, d = o.contiguous(), d.contiguous()
    n = o.shape[1]
    # the tables as the main path passes them: loose tail clusters hoisted
    cs, n_cl = scene.cluster_size, scene.cluster_lo.shape[0]
    n_tail = (scene.loose_tris + cs - 1) // cs
    far = torch.full((n_tail, 3), 2.0e38, device=dev)
    clo = torch.cat([scene.cluster_lo[:n_cl - n_tail], far]).contiguous()
    chi = torch.cat([scene.cluster_hi[:n_cl - n_tail], far]).contiguous()
    tri = scene.triangles
    tb = ts.stream_tables(tri.woop_o, tri.woop_d, clo, chi, cs)
    attrs = _tri_attr_tables(scene)
    tm = torch.full((n,), 1e4, device=dev)

    ref = ts.tri_closest_hit_stream(o, d, tm, tb, attr_tables=attrs)
    hit = ref[0] < 1e30
    p = o + torch.where(hit, ref[0], 0.0)[None, :] * d
    to_light = st.light.position.to(dev)[:, None] - p
    dist = torch.linalg.vector_norm(to_light, dim=0)
    so = p.contiguous()
    sd = (to_light / dist.clamp(min=1e-20)).contiguous()
    stm = torch.where(hit, dist, 0.0)
    ref_occ = ts.tri_closest_hit_stream(so, sd, stm, tb, occlusion=True)

    def buffers(oo, occl):
        out = [torch.empty((n,), device=dev) for _ in range(4)]
        out[1] = out[1].to(torch.int32)
        if not occl:
            out.append(torch.empty((21, n), device=dev))
        return ts.tree_rank(kc.visit_order(tb.sb_lo, tb.sb_hi, oo, n)), out

    calls = ((o, d, tm, False) + buffers(o, False),
             (so, sd, stm, True) + buffers(so, True))
    for value in values:
        fn = entry(libs[value])

        def run(oo, dd, tt, occl, rank, out):
            args = (oo, dd, tt, n, n, tb.wrows, tb.wrows.shape[0], tb.tree_lo,
                    tb.tree_hi, tb.tree_link, tb.tree_lo.shape[0], tb.depth,
                    rank, tb.clo, tb.chi, tb.g, cs,
                    *((None,) * 3 if occl else attrs), int(occl), *out[:4],
                    None if occl else out[4], None, None, None, 0,
                    torch.cuda.current_stream().cuda_stream)
            rc = fn(*[x.data_ptr() if isinstance(x, torch.Tensor) else x
                      for x in args])
            if rc != 0:
                raise RuntimeError(f"{ENTRY} (kCoopLanes = {value}): CUDA "
                                   f"error {rc}")
            return out

        got = [x.clone() for x in run(*calls[0])]
        got_occ = [x.clone() for x in run(*calls[1])]
        print(json.dumps({
            "kCoopLanes": value, "rays": n,
            "closest_attrs_ms": cuda_ms(lambda: run(*calls[0])),
            "anyhit_ms": cuda_ms(lambda: run(*calls[1])),
            "bit_equal_to_shipped": all(torch.equal(x, y)
                                        for x, y in zip(got, ref)),
            "anyhit_masks_equal": torch.equal(got_occ[0] < 1e30,
                                              ref_occ[0] < 1e30)}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
