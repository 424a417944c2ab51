"""Capture IO — text-dump writers/readers matching the reference formats;
the port of the JAX package's `io/dumps.py` (the same files, byte for byte,
for the same arrays).

The reference persists experiment artifacts as ASCII text files
(VKT/ray_tracing__before/hello_vulkan.cpp:991-1259):

* `data/renderedPosition<rho>.txt` — one "x y z" line per pixel in **SSBO
  order**, which is column-major: index = x*H + y (the raygen writes
  `rData[gl_LaunchID.x * gl_LaunchSize.y + gl_LaunchID.y]`,
  raytrace.rgen:72,111-112).
* `data/renderedColor<rho>.txt` — one "r g b" line per pixel in **row-major**
  order (the image copy walks y-then-x, hello_vulkan.cpp:1242-1247). The two
  dump orders differ in the reference; we replicate that quirk so reprojection
  tooling stays compatible (SURVEY.md §7.5).
* `data/origins.txt` / `data/directions.txt` — per-pixel ray data, SSBO order
  (`writeRenderedRays`, hello_vulkan.cpp:1195-1232).
* `data/<scene>gTruth.txt` — ground-truth image, row-major
  (VKT/ray_tracing_reflections/hello_vulkan.cpp:1065-1111).
* `data/<scene>ptCloudImage_10.txt` — point-cloud re-render, row-major
  (VKT/ray_tracing__before_second/hello_vulkan.cpp:781-826).

`<rho>` is formatted like C++ `std::to_string(float)` — six fixed decimals
("4.000000"). Values use "%.6g" (C++ default `operator<<` precision).

An `.npz` fast format (sane row-major layout) is provided alongside; a native
C writer accelerates the 2M-line ASCII serialization when built (csrc/).
The writers take host NumPy arrays: callers move tensors off the card with
`.cpu().numpy()` first.
"""

from __future__ import annotations

import os

import numpy as np

from toroidal_ray_tracing_tpu_torch.io import native

F32 = np.float32
FLOAT_LOWEST = np.float32(-3.4028235e38)  # std::numeric_limits<float>::lowest()


def rho_tag(rho: float) -> str:
    """C++ std::to_string(float): fixed, 6 decimals (hello_vulkan.cpp:1162)."""
    return f"{float(rho):.6f}"


def _data_dir(root: str) -> str:
    d = os.path.join(root, "data")
    os.makedirs(d, exist_ok=True)
    return d


def _to_ssbo_order(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) row-major -> (W*H, 3) in SSBO order (index = x*H + y)."""
    return np.asarray(img).transpose(1, 0, 2).reshape(-1, 3)


def _to_row_order(img: np.ndarray) -> np.ndarray:
    return np.asarray(img).reshape(-1, 3)


def _write_rows(path: str, rows: np.ndarray) -> None:
    rows = np.asarray(rows, dtype=F32)
    if native.available():
        native.write_xyz(path, rows)
    else:
        np.savetxt(path, rows, fmt="%.6g")


def write_rendered_position(root: str, rho: float, hit_position) -> str:
    """`writeRenderedPosition` (hello_vulkan.cpp:1150-1177): SSBO order."""
    path = os.path.join(_data_dir(root), f"renderedPosition{rho_tag(rho)}.txt")
    _write_rows(path, _to_ssbo_order(hit_position))
    return path


def write_color_image(root: str, rho: float, image) -> str:
    """`writeColorImage` (hello_vulkan.cpp:1237-1259): row-major."""
    path = os.path.join(_data_dir(root), f"renderedColor{rho_tag(rho)}.txt")
    _write_rows(path, _to_row_order(image))
    return path


def write_rendered_rays(root: str, ray_origin, ray_dir) -> tuple:
    """`writeRenderedRays` (hello_vulkan.cpp:1183-1232): SSBO order."""
    d = _data_dir(root)
    p1 = os.path.join(d, "origins.txt")
    p2 = os.path.join(d, "directions.txt")
    _write_rows(p1, _to_ssbo_order(ray_origin))
    _write_rows(p2, _to_ssbo_order(ray_dir))
    return p1, p2


def write_gtruth(root: str, scene_name: str, image) -> str:
    """Ground-truth dump (reflections app, hello_vulkan.cpp:1080-1090)."""
    path = os.path.join(_data_dir(root), f"{scene_name}gTruth.txt")
    _write_rows(path, _to_row_order(image))
    return path


def write_ptcloud_image(root: str, scene_name: str, image,
                        tag: str = "10") -> str:
    """Point-cloud re-render dump (before_second, hello_vulkan.cpp:797-805).
    tag: the filename suffix — the reference hard-codes "10" (one rho per
    build); the --all-rhos batch sweep writes one file per rho step."""
    path = os.path.join(_data_dir(root),
                        f"{scene_name}ptCloudImage_{tag}.txt")
    _write_rows(path, _to_row_order(image))
    return path


_FLOAT_PREFIX = None  # compiled lazily (re import kept out of the hot path)


def _stof_prefix(tok: str) -> float:
    """std::stof semantics on one token: parse the longest leading float
    (keeps inf / +nan like the reference); an unparseable token maps to
    FLOAT_LOWEST (where the reference's stof would throw — the one
    deliberate deviation, mirrored by csrc trt_read_xyz)."""
    global _FLOAT_PREFIX
    if _FLOAT_PREFIX is None:
        import re
        _FLOAT_PREFIX = re.compile(
            r"[+-]?(?:inf(?:inity)?|nan|(?:\d+\.?\d*|\.\d+)"
            r"(?:[eE][+-]?\d+)?)", re.IGNORECASE)
    m = _FLOAT_PREFIX.match(tok)
    return float(m.group(0)) if m else FLOAT_LOWEST


def read_points(path: str) -> np.ndarray:
    """`loadPoints` semantics (before_second/hello_vulkan.cpp:532-560):
    one row per line; fewer than three whitespace tokens -> the whole row
    becomes `std::numeric_limits<float>::lowest()`; per token, `-nan`
    anywhere in the token -> lowest, otherwise `std::stof` prefix parsing
    (so inf and bare nan pass through, exactly as the reference keeps
    them).

    Uses the native reader (csrc trt_read_xyz, identical semantics — the
    parity is pinned by tests/test_torch_experiments.py) when the library is
    built: a 2M-line capture dump parses in ~0.5 s vs several seconds for
    the Python line loop."""
    if native.available():
        n_lines = 0
        last = b"\n"
        with open(path, "rb") as f:
            for buf in iter(lambda: f.read(1 << 20), b""):
                n_lines += buf.count(b"\n")
                last = buf[-1:]
        if last != b"\n":
            n_lines += 1  # final line without a trailing newline
        return native.read_xyz(path, n_lines, FLOAT_LOWEST)

    rows = []
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 3:
                rows.append([FLOAT_LOWEST] * 3)
                continue
            rows.append([FLOAT_LOWEST if "-nan" in t else _stof_prefix(t)
                         for t in parts[:3]])
    return np.asarray(rows, dtype=F32)


def read_position_color(root: str, rho: float, width: int, height: int):
    """Load a (position, color) pair for one rho step, converting both dumps
    back to a common per-point order (SSBO order, like app 2's zip of the two
    buffers into `Point{pos, color}`, hello_vulkan.cpp:633-660).

    Raises ValueError on length mismatch (app 2 throws, :636-639).
    """
    pos = read_points(os.path.join(root, "data",
                                   f"renderedPosition{rho_tag(rho)}.txt"))
    col_rows = read_points(os.path.join(root, "data",
                                        f"renderedColor{rho_tag(rho)}.txt"))
    if len(pos) != len(col_rows):
        raise ValueError(
            f"positions ({len(pos)}) and colors ({len(col_rows)}) differ")
    # color dump is row-major; positions are SSBO order — realign colors
    col = col_rows.reshape(height, width, 3).transpose(1, 0, 2).reshape(-1, 3)
    return pos, col


# --- npz fast format (framework extension) ---------------------------------


def save_render_npz(path: str, out: dict) -> str:
    np.savez_compressed(
        path,
        image=np.asarray(out["image"], F32),
        hit_position=np.asarray(out["hit_position"], F32),
        ray_origin=np.asarray(out["ray_origin"], F32),
        ray_dir=np.asarray(out["ray_dir"], F32),
    )
    return path


def load_render_npz(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
