"""F1 (`csrc/frame.cu` frame_finish) and V1 (`csrc/visit.cu` visit_rank)
split on the card: where their device time goes, for the package on the
import path, so that two checkouts can be timed in turns in one call:

    PYTHONPATH=<checkout> python <path of this file> [--out PATH]

(run as a file, it imports the `toroidal_ray_tracing_tpu_torch` that
PYTHONPATH names; this file itself may come from another checkout).

F1, on the traced states of config 6's 1080p frame, the capture's
toroidal 1080p frame and config 5's 4K sample 0: row-major (HWC) and
channel-major (CHW) with the dumps, the image alone, and the image's
second sample (adds, divides). Where the checkout's frame.cu stores every
HWC output as three scalar stores a pixel (before the staged stores), the
HWC-with-dumps case is also timed on two copies of it built beside the
library: the dump stores in CHW order ("dumps_chw_order": contiguous
stores, the same values elsewhere) and no recomputed ray ("no_ray": the
ray dumps store the lane index, no trig).

V1, on the origins of the first segment that ranks a set in a `render`
of configs 6, 5 (4K, 2 spp) and 8 (3,340 superblocks), captured as the
bounce loop hands them over: with the segment's sets, and with none (m0 =
m1 = 0: the anchor's reduction alone).

Each time is the bare launch's device time: 20 launches captured in one
CUDA graph, the replay timed with CUDA events, over 20. Beside it the
byte bound (the bytes the call must move over the card's 3.35 TB/s).
Needs an NVIDIA GPU and nvcc. Prints the card's name and power limit,
then one JSON line per case; --out writes them all as one JSON file.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

from toroidal_ray_tracing_tpu_torch.cameras import ToroidalCamera
from toroidal_ray_tracing_tpu_torch.cameras.pinhole import pick_block
from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
from toroidal_ray_tracing_tpu_torch.experiments.k3_turns import graph_ms
from toroidal_ray_tracing_tpu_torch.ops import front_kernel as fk
from toroidal_ray_tracing_tpu_torch.ops import kernel_common as kc
from toroidal_ray_tracing_tpu_torch.ops import visit_kernel as vk
from toroidal_ray_tracing_tpu_torch.render import renderer as rd
from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings, build_scene,
                                                  procedural)
from toroidal_ray_tracing_tpu_torch.utils.roofline import PEAK_BYTES

FULL = (1920, 1080)
# frame.cu's HWC store before the staged stores: three scalars a pixel
_SCALAR_AT = "const size_t at = chw ? (size_t)c * n + p : (size_t)p * 3 + c;"
_RAY = "trt::lane_ray(cam, i, nullptr, o, d);"


def bound_ms(nbytes: float) -> float:
    return nbytes / PEAK_BYTES * 1e3


def recorded(module, fn):
    """(name, args) of the one `launch` that fn() makes through module."""
    seen = []
    real = module.launch

    def rec(name, *args, **kw):
        seen.append((name, args))
        return real(name, *args, **kw)

    module.launch = rec
    try:
        fn()
    finally:
        module.launch = real
    return seen[0]


def f1_variants(build_dir: str):
    """{name: C entry point} of the two copies of a frame.cu that stores
    HWC outputs as scalars; {} for any other frame.cu."""
    src = open(os.path.join(kc.CSRC, "frame.cu")).read()
    if src.count(_SCALAR_AT) != 2 or _RAY not in src or "kStaged" in src:
        return {}
    k = src.rfind(_SCALAR_AT)
    texts = {
        "dumps_chw_order": src[:k] + "const size_t at = (size_t)c * n + p;"
        + src[k + len(_SCALAR_AT):],
        "no_ray": src.replace(_RAY, "o[0] = o[1] = o[2] = d[0] = d[1] = "
                              "d[2] = (float)i;"),
    }
    os.makedirs(build_dir, exist_ok=True)
    procs = []
    for name, text in texts.items():
        path = os.path.join(build_dir, f"frame_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        so = os.path.join(build_dir, f"frame_{name}.so")
        procs.append((name, so, subprocess.Popen(
            [kc._nvcc(), *kc.NVCC_FLAGS, "-I", kc.CSRC, "-shared", "-o", so,
             path], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    out = {}
    for name, so, proc in procs:
        _, err = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on frame_{name}.cu:\n{err}")
        fn = getattr(ctypes.CDLL(so), "trt_frame_finish")
        fn.argtypes = kc._SIGNATURES["trt_frame_finish"]
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def call(fn, args):
    conv = [a.data_ptr() if isinstance(a, torch.Tensor)
            else (None if a is None else a) for a in args]
    rc = fn(*conv, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed with error {rc}")


def f1_rows(dev, variants):
    cap_cam = ToroidalCamera(eye=(0.0, 1.0, 0.0), center=(8.0, 0.0, 0.0))
    sc5, sc6 = SCENARIOS[5], SCENARIOS[6]
    frames = (
        ("config 6", sc6.camera, sc6.settings(), *FULL, sc6.build),
        ("capture", cap_cam, RenderSettings.default(rho=4.0), *FULL,
         lambda: build_scene(procedural.scene_cornellish())),
        ("config 5", sc5.camera_at(0), sc5.settings(), sc5.width,
         sc5.height, sc5.build))
    for label, cam, st, w, h, build in frames:
        scene = build().to(dev)
        st = rd.autofill_pixel_spread(st, cam, w, h)
        tr = rd._trace_frames(scene, st.to(dev),
                              [(cam, cam.ray_params(w, h, st))], w, h,
                              "kernel", None, dev)
        params, block, n = cam.ray_params(w, h, st), pick_block(w, h), w * h
        for chw, s, spp, dumps in ((False, 0, 1, True), (True, 0, 1, True),
                                   (False, 0, 1, False),
                                   (False, 1, 2, False)):
            shape = (3, h, w) if chw else (h, w, 3)
            outs = [torch.rand(shape, device=dev)] + (
                [torch.empty(shape, device=dev) for _ in range(3)] if dumps
                else [])
            args = (cam.KIND, params, w, h, block, tr.state, tr.first,
                    tr.slot, 0, outs[0], s, spp, tuple(outs[1:]) or None,
                    chw)
            name, largs = recorded(fk, lambda: fk.frame_finish(*args))
            row = {"case": f"F1 {label} {w}x{h} "
                           f"{'CHW' if chw else 'HWC'} "
                           f"{'with dumps' if dumps else 'image'}, sample "
                           f"{s} of {spp}",
                   "block": block, "compacted": tr.slot is not None,
                   "device_ms": graph_ms(lambda: kc.launch(name, *largs))}
            if dumps and not chw:
                for vname, fn in variants.items():
                    row[f"{vname}_ms"] = graph_ms(
                        lambda fn=fn: call(fn, largs))
            row["bound_ms"] = bound_ms(
                n * (24 + (12 if s > 0 else 0) + (48 if dumps else 0)))
            yield row
        del tr, scene
        torch.cuda.empty_cache()


def ranked_segment(num: int, dev):
    """(origins, n_batch, sets) of the first segment that ranks a box set
    in a `render` of config num (4K 2 spp for config 5, else 1080p), as the
    bounce loop hands them to V1."""
    sc = SCENARIOS[num]
    w, h = (sc.width, sc.height) if sc.spp > 1 else FULL
    scene = sc.build().to(dev)
    calls = []
    real = vk.visit_ranks

    def rec(o, n_batch, sets, out=None):
        got = real(o, n_batch, sets, out=out)
        if sets and not calls:
            calls.append((o.clone(), n_batch, list(sets)))
        return got

    # the segment plan calls V1 through its module
    vk.visit_ranks = rec
    try:
        rd.render(scene, sc.camera_at(0), w, h, sc.settings(),
                  backend="kernel", spp=sc.spp, device=dev)
        torch.cuda.synchronize()
    finally:
        vk.visit_ranks = real
    return calls[0]


def v1_rows(dev):
    for num in (6, 5, 8):
        o, n_batch, sets = ranked_segment(num, dev)
        row = {"case": f"V1 config {num} segment 0", "lanes": o.shape[1],
               "boxes": [int(lo.shape[0]) for lo, _ in sets]}
        for tag, ss in (("sets", sets), ("no_sets", [])):
            name, args = recorded(vk, lambda: vk.visit_ranks(o, n_batch, ss))
            row[f"{tag}_ms"] = graph_ms(lambda: kc.launch(name, *args))
        row["bound_ms"] = bound_ms(o.shape[1] * 12 + sum(
            lo.shape[0] * 28 for lo, _ in sets) + 12)
        yield row
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the rows as JSON")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("redesign_split: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", torch.cuda.current_device())
    kc.library()
    variants = f1_variants(os.path.join(kc.BUILD_DIR, "split"))
    rows = []
    for row in (*f1_rows(dev, variants), *v1_rows(dev)):
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": smi, "package": os.path.dirname(kc.CSRC),
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
