"""The PyTorch port imports and renders without JAX or the JAX package."""

import subprocess
import sys

CODE = """
import sys
import toroidal_ray_tracing_tpu_torch as trt
from toroidal_ray_tracing_tpu_torch.experiments.configs import SCENARIOS
from toroidal_ray_tracing_tpu_torch.ops import tex_kernel, tri_stream
from toroidal_ray_tracing_tpu_torch.scene import build_scene, procedural
cam = trt.PinholeCamera(eye=(8.0, 5.0, 8.0), center=(0.0, 0.5, 0.0))
st = trt.RenderSettings.default(max_depth=2)
for sd in (procedural.scene_multi_torus(True), SCENARIOS[7].scene()):
    scene = build_scene(sd)
    for backend in ("torch", "kernel"):
        out = trt.render(scene, cam, 8, 8, st, backend=backend, device="cpu")
        assert out["image"].shape == (8, 8, 3) and out["rays_traced"] > 0
import argparse, os, tempfile
from toroidal_ray_tracing_tpu_torch.experiments import (
    backend_paths, gtruth, reproject, rho_sweep, scene_args,
    toroidal_experiment)
from toroidal_ray_tracing_tpu_torch.geom import bvh
from toroidal_ray_tracing_tpu_torch.io import dumps, native, png
from toroidal_ray_tracing_tpu_torch.pointcloud import splat
from toroidal_ray_tracing_tpu_torch.scene import obj_loader
with tempfile.TemporaryDirectory() as tmp:
    obj = os.path.join(tmp, "tri.obj")
    with open(obj, "w") as f:
        f.write("v 0 0 0\\nv 1 0 0\\nv 0 1 0\\nf 1 2 3\\n")
    for use_native in (True, False):
        assert obj_loader.load_obj(obj, use_native).num_triangles == 1
    sd = scene_args.scene_def_from_args(argparse.Namespace(
        obj=[obj + "@0,0,-3"]))
    sd.add_model(procedural.plane(8.0, y=-1.0))
    files = rho_sweep.run_sweep(sd, tmp, width=8, height=8,
                                settings=trt.RenderSettings.default(
                                    max_depth=1), device="cpu")
    assert len(files) == 2 * 13 + 2, len(files)
from toroidal_ray_tracing_tpu_torch import bench
from toroidal_ray_tracing_tpu_torch.experiments import (
    microbench, settings_sweep)
from toroidal_ray_tracing_tpu_torch.render import raster
from toroidal_ray_tracing_tpu_torch.utils import profiling, roofline
from toroidal_ray_tracing_tpu_torch.trace.intersect import (
    ClosestHitDiff, closest_hit_diff, combine_hits_over_axis)
from toroidal_ray_tracing_tpu_torch.trace.wavefront import trace_rays_fixed
from toroidal_ray_tracing_tpu_torch.parallel import (
    make_mesh, multihost, pad_scene_for_mesh, render_sharded)
from toroidal_ray_tracing_tpu_torch.parallel import dryrun, sharding
from toroidal_ray_tracing_tpu_torch.parallel.multihost import (
    host_band, init_distributed, make_hybrid_mesh)
from toroidal_ray_tracing_tpu_torch.utils import collectives
from toroidal_ray_tracing_tpu_torch.experiments import grad_check
from toroidal_ray_tracing_tpu_torch.oracle import render_oracle
from toroidal_ray_tracing_tpu_torch.utils import prng
from toroidal_ray_tracing_tpu_torch.entry import entry
fn, args = entry(device="cpu")
assert fn(*args)[2] > 0
assert prng.uniform(prng.fold_in(prng.prng_key(0), 1), (4, 2)).shape == (4, 2)
from toroidal_ray_tracing_tpu_torch.ops import threefry_kernel
assert threefry_kernel.uniform((0, 1), (4, 2), "cpu").shape == (4, 2)
out = render_oracle(build_scene(procedural.scene_multi_torus(True)), cam, 8,
                    8, st, device="cpu")
assert out["image"].shape == (8, 8, 3)
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "flax"
       or m == "toroidal_ray_tracing_tpu"
       or m.startswith("toroidal_ray_tracing_tpu.")]
assert not bad, bad
print("ok")
"""


def test_port_imports_without_jax():
    proc = subprocess.run([sys.executable, "-c", CODE], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
