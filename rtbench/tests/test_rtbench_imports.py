"""Nothing of rtbench imports JAX or the JAX package, and the reference
imports nothing of the program: each import's top-level module name is
compared whole (the program's name begins with the JAX package's)."""

import ast
import os
import subprocess
import sys

from rtbench import manifest

JAX = {"jax", "jaxlib", "flax", "toroidal_ray_tracing_tpu"}
PROGRAM = "toroidal_ray_tracing_tpu_torch"


def imported_tops(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def sources(folder: str):
    for rel, _, files in os.walk(folder):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(rel, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in sources(manifest.ROOT):
        assert not imported_tops(path) & JAX, path


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(manifest.ROOT, "reference")
    for path in sources(ref):
        assert PROGRAM not in imported_tops(path), path
    # and at run time: importing it and its inputs loads no program module
    code = ("import sys; import rtbench.reference, rtbench.reference.scene, "
            "rtbench.scenedata, rtbench.traffic.generator; "
            f"bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(JAX | {PROGRAM})!r}]; print(bad); sys.exit(bool(bad))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=os.path.dirname(manifest.ROOT))
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_names_are_compared_whole():
    assert "toroidal_ray_tracing_tpu_torch" not in JAX
    tops = imported_tops(os.path.join(manifest.ROOT, "frontdoor.py"))
    assert PROGRAM in tops and not tops & JAX
