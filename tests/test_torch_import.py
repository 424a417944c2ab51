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
