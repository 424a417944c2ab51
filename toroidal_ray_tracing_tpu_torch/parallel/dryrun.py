"""Multi-process dry run of `render_sharded`: the analog of the JAX
package's `__graft_entry__.dryrun_multichip`, and the process entry point
that the tests and `chip_smoke.py` launch.

    python -m toroidal_ray_tracing_tpu_torch.parallel.dryrun --world 8
        [--device cuda|cpu] [--cases SPEC,...] [--res WxH] [--nodes N]
        [--timeout SECONDS]

starts `--world` processes of this module (`--rank r`), which join one
gloo group through a FileStore in a temporary directory, run every case
and print one line `DRYRUN_RANK {json}`: per case the sharded frame
against a single-process `render` of the same scene (RMSE, max
differences, ray counts), the segments each rank traced with the lanes
each traced and its live spans, the kernel launches of the first sharded
render, its milliseconds, and those of a second render (the padded scene
and its tables kept) with the part spent in the collectives. The parent
checks them all and exits 1 on any failure. With no `--cases`, every
mesh shape of the world renders the flagship scene (config 3's four
tori) at 64x64.

A case is `CELL@RxP[:BACKEND][/WxH][+sppN][+seedS]` (a ("rays",
"prims") mesh of R x P ranks, backend torch by default, at WxH instead of
`--res`; with N > 1 samples a pixel, the jittered ones drawn from
`render_sharded`'s NumPy stream of seed S (0 by default), the frame is
held to a single-process trace of the same rays, and each rank also
reports its image),
`CELL@hybridP` (`multihost.make_hybrid_mesh` with P prims ranks;
`--nodes` poses the world as that many nodes through the launcher's
variables), or `tie@RxP` (synthetic per-rank hits with equal t merged
over the mesh's prims group). CELL names a scene of
`CELLS` or `config<N>` (the ladder's scene, camera and settings).

Ranks that share one card use gloo: NCCL refuses two ranks on one
device. Gloo stages each collective through host memory.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TAG = "DRYRUN_RANK "
RMSE_MAX = 1e-6

# name: (the scene function in scene.procedural, its kwargs, eye, center,
# depth)
CELLS = {
    "flagship": ("scene_multi_torus", dict(analytic=True), (8.0, 5.0, 8.0),
                 (0.0, 0.5, 0.0), 3),
    "cornellish": ("scene_cornellish", {}, (6.0, 4.0, 6.0), None, 2),
    "torus_grid16": ("scene_instanced_torus_grid", dict(n=16, analytic=True),
                     (8.0, 6.0, 8.0), None, 2),
    "multi_torus": ("scene_multi_torus", dict(analytic=True),
                    (8.0, 5.0, 8.0), (0.0, 0.5, 0.0), 2),
    "torus_plane": ("scene_torus_plane", dict(analytic=True),
                    (7.0, 4.0, 7.0), (0.0, 0.5, 0.0), 2),
    "textured": ("scene_textured_mesh", {}, (8.0, 5.0, 8.0), (0.0, 0.5, 0.0),
                 2),
}


def mesh_shapes(n: int) -> list:
    """Every (rays, prims) factorization of n."""
    return [(n // p, p) for p in range(1, n + 1) if n % p == 0]


def parse_case(spec: str) -> dict:
    head, *samples = spec.split("+")
    cell, _, rest = head.partition("@")
    rest, _, res = rest.partition("/")
    mesh, _, backend = rest.partition(":")
    case = dict(spec=spec, cell=cell, backend=backend or "torch", spp=1,
                seed=0)
    for token in samples:
        name = token.rstrip("0123456789")
        if name not in ("spp", "seed") or name == token:
            raise ValueError(f"case {spec!r}: {token!r} is not sppN or "
                             "seedS")
        case[name] = int(token[len(name):])
    if res:
        case["res"] = tuple(int(x) for x in res.split("x"))
    if mesh.startswith("hybrid"):
        case["hybrid"] = int(mesh[len("hybrid"):])
    else:
        case["mesh"] = tuple(int(x) for x in mesh.split("x"))
    return case


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------


def _cell(name: str, cache: dict):
    """(host scene, camera, settings) of a cell, built once per process."""
    if name not in cache:
        from toroidal_ray_tracing_tpu_torch.cameras import PinholeCamera
        from toroidal_ray_tracing_tpu_torch.scene import (RenderSettings,
                                                          build_scene,
                                                          procedural)

        if name.startswith("config"):
            from toroidal_ray_tracing_tpu_torch.experiments.configs import (
                SCENARIOS)

            sc = SCENARIOS[int(name[len("config"):])]
            cache[name] = (sc.build(), sc.camera, sc.settings())
        else:
            fn, kw, eye, center, depth = CELLS[name]
            cam = (PinholeCamera(eye=eye) if center is None
                   else PinholeCamera(eye=eye, center=center))
            cache[name] = (build_scene(getattr(procedural, fn)(**kw)), cam,
                           RenderSettings.default(max_depth=depth))
    return cache[name]


@contextlib.contextmanager
def _merge_timer(spent: list, device):
    """Add the milliseconds the multi-device path spends in its collectives
    (the merges, the stop test, the gather; gloo's host staging included,
    the device synchronized around each) to spent[0]."""
    from toroidal_ray_tracing_tpu_torch.parallel import sharding
    from toroidal_ray_tracing_tpu_torch.trace import intersect, wavefront

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        def call(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync()
            spent[0] += (time.perf_counter() - t0) * 1e3
            return out
        return call

    real = [(m, name, getattr(m, name))
            for m in (intersect, wavefront, sharding)
            for name in ("all_reduce", "all_gather_cols") if hasattr(m, name)]
    for m, name, fn in real:
        setattr(m, name, timed(fn))
    try:
        yield
    finally:
        for m, name, fn in real:
            setattr(m, name, fn)


def _jittered_reference(scene, cam, w, h, st, case, device) -> dict:
    """The single-process frame of `render_sharded`'s samples: the
    centered rays, then one draw a sample of its NumPy stream, each
    traced whole and row-major on one process."""
    from toroidal_ray_tracing_tpu_torch.cameras import generate_rays
    from toroidal_ray_tracing_tpu_torch.render.renderer import _setup
    from toroidal_ray_tracing_tpu_torch.trace.wavefront import trace_rays

    scene, st, device = _setup(scene, st, cam, w, h, device)
    rng = np.random.default_rng(case["seed"])
    acc = first = None
    nrays = 0
    for s in range(case["spp"]):
        jitter = (None if s == 0 else torch.from_numpy(
            rng.random((w * h, 2), dtype=np.float32)).to(device))
        o, d = generate_rays(cam, w, h, st, jitter=jitter, device=device)
        color, hitpos, nr = trace_rays(scene, st, o.T.contiguous(),
                                       d.T.contiguous(),
                                       backend=case["backend"])
        acc = color if acc is None else acc + color
        if s == 0:
            first = hitpos
        nrays += nr
    return {"image": (acc / float(case["spp"])).T.reshape(h, w, 3),
            "hit_position": first.T.reshape(h, w, 3), "rays_traced": nrays}


def _render_case(case, mesh, res, device, cache) -> dict:
    from toroidal_ray_tracing_tpu_torch import render
    from toroidal_ray_tracing_tpu_torch.ops.kernel_common import (
        LAUNCHES, reset_launches)
    from toroidal_ray_tracing_tpu_torch.parallel import render_sharded
    from toroidal_ray_tracing_tpu_torch.parallel.multihost import host_band
    from toroidal_ray_tracing_tpu_torch.utils.profiling import record_segments

    scene, cam, st = _cell(case["cell"], cache)
    w, h = case.get("res", res)
    segments = []
    reset_launches()
    t0 = time.perf_counter()
    samples = dict(spp=case["spp"], seed=case["seed"])
    with record_segments(segments):
        out = render_sharded(scene, cam, w, h, st, mesh=mesh,
                             backend=case["backend"], device=device,
                             **samples)
    if device.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in LAUNCHES.items() if v}
    # again, with the padded scene and its kernel tables kept from the
    # first call: the time in the collectives apart
    merge = [0.0]
    t0 = time.perf_counter()
    with _merge_timer(merge, device):
        render_sharded(scene, cam, w, h, st, mesh=mesh,
                       backend=case["backend"], device=device, **samples)
    if device.type == "cuda":
        torch.cuda.synchronize()
    again_ms = (time.perf_counter() - t0) * 1e3
    if case["spp"] > 1:
        ref = _jittered_reference(scene, cam, w, h, st, case, device)
    else:
        ref = render(scene, cam, w, h, st, backend=case["backend"],
                     device=device)
    img, rimg = out["image"], ref["image"]
    rows = mesh["rays"].size()
    n = w * h
    step = -(-n // rows)
    hp = ref["hit_position"].reshape(-1, 3)
    all_miss = [bool((hp[i * step:(i + 1) * step] == 0).all())
                for i in range(rows)]
    result = dict(
        rmse=float(torch.sqrt(torch.mean((img - rimg) ** 2))),
        max_diff=float((img - rimg).abs().max()),
        hit_max_diff=float((out["hit_position"]
                            - ref["hit_position"]).abs().max()),
        finite=bool(torch.isfinite(img).all()),
        rays=out["rays_traced"], ref_rays=ref["rays_traced"],
        segments=len(segments), prefixes=[s[0] for s in segments],
        live_spans=[s[1] for s in segments], ms=ms, again_ms=again_ms,
        merge_ms=merge[0], launches=launches,
        rays_rank_all_miss=all_miss)
    if case["spp"] > 1:
        result["image"] = img.flatten().tolist()
    if "hybrid" in case:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        nodes = torch.distributed.get_world_size() // local
        try:                     # a height the nodes do not divide
            host_band(h * nodes + 1, w)
            rejects = False
        except ValueError:
            rejects = True
        result.update(band=list(host_band(h, w)), height=h, nodes=nodes,
                      node=int(os.environ.get("GROUP_RANK", "0")),
                      band_rejects_uneven=rejects)
    return result


def _tie_case(mesh, device) -> dict:
    """Per-rank hits with equal t on many rays, merged over the mesh's
    prims group: the lowest prim*2+kind must win on every rank, with its
    u, v and attribute rows (`AttrRows`: 21 triangle and 15 torus rows)."""
    from toroidal_ray_tracing_tpu_torch.trace.intersect import (
        BIG, AttrRows, Hit, combine_hits_over_axis)

    prims = mesh["prims"]
    P, p = prims.size(), prims.get_local_rank()
    n = 256
    rng = np.random.default_rng(0)          # the same draws on every rank
    pick = rng.integers(0, 3, (P, n))       # t 1, t 2 or a miss
    miss = pick == 2
    t = np.array([1.0, 2.0, BIG], np.float32)[pick]
    kind = np.where(miss, -1, rng.integers(0, 2, (P, n))).astype(np.int32)
    # global ids are unique across slices: rank q holds the ids = q mod P
    prim = rng.integers(0, 6, (P, n)) * P + np.arange(P)[:, None]
    prim = np.where(miss, 0, prim).astype(np.int32)
    u = rng.random((P, n), np.float32)
    v = rng.random((P, n), np.float32)
    attr = {k: rng.random((P, rows, n), np.float32) * 10
            for k, rows in (("tri", 21), ("tor", 15))}

    def mine(a):
        return torch.from_numpy(np.ascontiguousarray(a[p])).to(device)

    hit = Hit(t=mine(t), kind=mine(kind), prim=mine(prim), u=mine(u),
              v=mine(v), attrs=AttrRows(tri=mine(attr["tri"]),
                                        tor=mine(attr["tor"])))
    got = combine_hits_over_axis(hit, prims.get_group())
    # the expected winner of each ray, over every rank's draws
    key = np.where(kind >= 0, prim * 2 + kind, np.iinfo(np.int32).max)
    tmin = t.min(axis=0)
    cand = np.where((t == tmin) & (kind >= 0), key, np.iinfo(np.int32).max)
    win = cand.argmin(axis=0)
    missed = cand.min(axis=0) == np.iinfo(np.int32).max
    cols = np.arange(n)
    want = dict(t=tmin, kind=np.where(missed, -1, kind[win, cols]),
                prim=np.where(missed, 0, prim[win, cols]),
                u=np.where(missed, 0.0, u[win, cols]),
                v=np.where(missed, 0.0, v[win, cols]))
    bad = sum(int((getattr(got, k).cpu().numpy() != want[k]).sum())
              for k in want)
    ties = int((((t == tmin) & (kind >= 0)).sum(axis=0) >= 2).sum())
    for k, full in attr.items():
        a = getattr(got.attrs, k).cpu().numpy()
        exp = np.where(missed[None], 0, full[win, :, cols].T)
        bad += int((a != exp).sum())
    return dict(mismatches=bad, tied_rays=ties, rays=n)


def run_rank(args) -> dict:
    """Body of one rank: join the group, run every case, return the
    results."""
    from toroidal_ray_tracing_tpu_torch.parallel import make_mesh, multihost
    from toroidal_ray_tracing_tpu_torch.render.renderer import check_device

    torch.set_num_threads(1)
    multihost.init_distributed(init_method=f"file://{args.store}",
                               world_size=args.world, rank=args.rank,
                               backend=args.backend)
    device = check_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
    res = tuple(int(x) for x in args.res.split("x"))
    cache: dict = {}
    results = []
    launches: dict = {}
    for spec in args.cases.split(","):
        case = parse_case(spec)
        if "hybrid" in case:
            mesh = multihost.make_hybrid_mesh(case["hybrid"], device.type)
        else:
            mesh = make_mesh(*case["mesh"], device_type=device.type)
        row = dict(case=spec, mesh=list(mesh.mesh.shape),
                   coord=list(mesh.get_coordinate()))
        if case["cell"] == "tie":
            row.update(_tie_case(mesh, device))
        else:
            row.update(_render_case(case, mesh, res, device, cache))
            for k, v in row["launches"].items():
                launches[k] = launches.get(k, 0) + v
        results.append(row)
    torch.distributed.destroy_process_group()
    return dict(rank=args.rank, device=str(device), results=results,
                launches=launches)


# ---------------------------------------------------------------------------
# the parent
# ---------------------------------------------------------------------------


def launch(world: int, cases: str, device: str = "cuda",
           res: str = "16x16", nodes: int = 1, backend: str = "gloo",
           timeout: float = 300.0) -> list:
    """Run the cases in `world` processes of this module and return each
    rank's results (rank order). device: as `render` (the CUDA device
    unless device="cpu"; without a GPU that raises here, before any
    process starts). Raises with the children's output when one fails or
    the launch outlives `timeout` seconds (every child is killed then)."""
    from toroidal_ray_tracing_tpu_torch.render.renderer import check_device

    device = str(check_device(device))
    with tempfile.TemporaryDirectory(prefix="trt_dryrun_") as tmp:
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [ROOT] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
        procs, logs = [], []
        for r in range(world):
            log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
            logs.append(log)
            # the nodes interleave ranks (node r % nodes), so a hybrid mesh
            # must reorder them to keep each node's band contiguous
            renv = dict(env, RANK=str(r), WORLD_SIZE=str(world),
                        LOCAL_RANK=str(r // nodes),
                        LOCAL_WORLD_SIZE=str(world // nodes),
                        GROUP_RANK=str(r % nodes))
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "toroidal_ray_tracing_tpu_torch.parallel.dryrun",
                 "--rank", str(r), "--world", str(world),
                 "--store", os.path.join(tmp, "store"), "--cases", cases,
                 "--device", device, "--res", res, "--backend", backend],
                stdout=log, stderr=subprocess.STDOUT, env=renv, cwd=ROOT))
        deadline = time.monotonic() + timeout
        timed_out = False
        try:
            for proc in procs:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            timed_out = True
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if timed_out or failed:
        why = (f"timed out after {timeout:.0f} s" if timed_out
               else f"ranks {failed} failed")
        tails = "\n".join(f"--- rank {r} (rc {p.returncode}):\n{t[-3000:]}"
                          for r, (p, t) in enumerate(zip(procs, texts)))
        raise RuntimeError(f"dryrun of {world} ranks {why}:\n{tails}")
    out = []
    for r, text in enumerate(texts):
        lines = [ln for ln in text.splitlines() if ln.startswith(TAG)]
        if not lines:
            raise RuntimeError(f"rank {r} printed no result:\n{text[-3000:]}")
        out.append(json.loads(lines[-1][len(TAG):]))
    return out


def failures(ranks: list) -> list:
    """Every check the ranks' results fail, as text: each sharded frame
    equals the single-process render (RMSE < 1e-6, equal ray counts,
    finite), every rank traced the same segments on the same lanes (one
    compaction bucket) for a case, a hybrid rank's band is its node's,
    synthetic ties merge to the expected winner."""
    bad = []
    for i, row in enumerate(ranks[0]["results"]):
        rows = [rk["results"][i] for rk in ranks]
        spec = row["case"]
        if "mismatches" in row:
            for rk, rw in zip(ranks, rows):
                if rw["mismatches"]:
                    bad.append(f"{spec} rank {rk['rank']}: "
                               f"{rw['mismatches']} merged values wrong")
            continue
        for rk, rw in zip(ranks, rows):
            if not (rw["rmse"] < RMSE_MAX and rw["finite"]
                    and rw["rays"] == rw["ref_rays"]):
                bad.append(f"{spec} rank {rk['rank']}: rmse {rw['rmse']:.3g}"
                           f", rays {rw['rays']} vs {rw['ref_rays']}")
        if len({tuple(rw["prefixes"]) for rw in rows}) != 1:
            bad.append(f"{spec}: segments or their lanes differ by rank "
                       f"{[rw['prefixes'] for rw in rows]}")
        for rk, rw in zip(ranks, rows):
            if "band" not in rw:
                continue
            # the node's band, and the rank's rays row inside it
            rows_of_node = rw["mesh"][0] // rw["nodes"]
            want = rw["height"] // rw["nodes"]
            if (rw["band"] != [rw["node"] * want, want]
                    or rw["coord"][0] // rows_of_node != rw["node"]):
                bad.append(f"{spec} rank {rk['rank']} (node {rw['node']}): "
                           f"band {rw['band']}, mesh row {rw['coord'][0]}")
    return bad


def dryrun_multichip(n: int, device: str = "cuda",
                     timeout: float = 300.0) -> list:
    """One sharded render of the flagship scene (config 3's four tori,
    64x64, depth 3) on every ("rays", "prims") shape of n gloo ranks,
    each held to a single-process render (RMSE < 1e-6). device: as
    `launch` (device="cpu" for the CPU). Raises on a failure; returns the
    ranks' results."""
    cases = ",".join(f"flagship@{a}x{b}" for a, b in mesh_shapes(n))
    ranks = launch(n, cases, device=device, res="64x64", timeout=timeout)
    bad = failures(ranks)
    if bad:
        raise RuntimeError("dryrun_multichip: " + "; ".join(bad))
    return ranks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--cases", default=None)
    ap.add_argument("--res", default="64x64")
    ap.add_argument("--nodes", type=int, default=1)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--store", default=None)
    args = ap.parse_args(argv)
    if args.cases is None:
        args.cases = ",".join(f"flagship@{a}x{b}"
                              for a, b in mesh_shapes(args.world))
    if args.rank is not None:
        print(TAG + json.dumps(run_rank(args)), flush=True)
        return 0
    ranks = launch(args.world, args.cases, args.device, args.res, args.nodes,
                   args.backend, args.timeout)
    for rk in ranks:
        for row in rk["results"]:
            print(f"rank {rk['rank']} {row['case']}: " + json.dumps(
                {k: v for k, v in row.items() if k != "case"}), flush=True)
    bad = failures(ranks)
    for b in bad:
        print("FAIL " + b, flush=True)
    print(json.dumps({"ok": not bad, "world": args.world,
                      "cases": args.cases.split(",")}), flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
