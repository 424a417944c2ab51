"""ctypes binding to the shared native host library (csrc/libtrt_native.so at
the repository root — the same C++ both packages build on); the port of the
JAX package's `io/native.py`.

Bound here:
* `build_sah_clusters` — the binned-SAH cluster build `scene.build` uses
  to cut the triangle table into clusters;
* `write_xyz` / `read_xyz` — the capture dumps' ASCII rows (`io.dumps`);
* `obj_parse` — the OBJ geometry parser (`scene.obj_loader`).

The library is built with `make -C csrc` on first use; if it cannot be
built, `available()` is False and every caller takes its Python path (the
scene build falls back to Morton-order chunking; host code, not a kernel).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None
_tried = False

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")
_SO = os.path.join(_CSRC, "libtrt_native.so")


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_SO):
                subprocess.run(["make", "-C", _CSRC, "-s"], check=True,
                               capture_output=True, timeout=120)
            lib = ctypes.CDLL(_SO)
        except (OSError, subprocess.SubprocessError):
            return None
        lib.trt_write_xyz.restype = ctypes.c_int
        lib.trt_write_xyz.argtypes = [ctypes.c_char_p,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_long]
        lib.trt_read_xyz.restype = ctypes.c_long
        lib.trt_read_xyz.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_float),
                                     ctypes.c_long, ctypes.c_float]
        lib.trt_build_sah_clusters.restype = ctypes.c_int64
        lib.trt_build_sah_clusters.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
        lib.trt_sah_leaves.restype = ctypes.c_int
        lib.trt_sah_leaves.argtypes = [ctypes.POINTER(ctypes.c_int64),
                                       ctypes.POINTER(ctypes.c_int64),
                                       ctypes.c_int64]
        lib.trt_obj_parse.restype = ctypes.c_int
        lib.trt_obj_parse.argtypes = [ctypes.c_char_p]
        lib.trt_obj_num_vertices.restype = ctypes.c_int64
        lib.trt_obj_num_vertices.argtypes = []
        lib.trt_obj_num_triangles.restype = ctypes.c_int64
        lib.trt_obj_num_triangles.argtypes = []
        lib.trt_obj_get.restype = ctypes.c_int
        lib.trt_obj_get.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.trt_obj_mtl_names.restype = ctypes.c_int64
        lib.trt_obj_mtl_names.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.trt_obj_mtllib.restype = ctypes.c_int64
        lib.trt_obj_mtllib.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        lib.trt_obj_free.restype = None
        lib.trt_obj_free.argtypes = []
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _library():
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def write_xyz(path: str, rows: np.ndarray) -> None:
    """Write (N, 3) float32 rows as "%.6g %.6g %.6g" lines."""
    lib = _library()
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    rc = lib.trt_write_xyz(path.encode(), _fp(rows), len(rows))
    if rc != 0:
        raise OSError(f"trt_write_xyz failed with code {rc}")


def read_xyz(path: str, max_rows: int, lowest: float) -> np.ndarray:
    """Parse up to max_rows lines of three floats (`io.dumps.read_points`
    semantics; rows it cannot parse read `lowest`)."""
    lib = _library()
    out = np.empty((max_rows, 3), np.float32)
    n = lib.trt_read_xyz(path.encode(), _fp(out), max_rows,
                         ctypes.c_float(lowest))
    if n < 0:
        raise OSError(f"trt_read_xyz failed for {path}")
    return out[:n]


def build_sah_clusters(tri_lo: np.ndarray, tri_hi: np.ndarray,
                       max_leaf: int):
    """Returns (order int32 (n,), leaf_starts int64, leaf_counts int64)."""
    lib = _library()
    n = len(tri_lo)
    lo = np.ascontiguousarray(tri_lo, np.float32)
    hi = np.ascontiguousarray(tri_hi, np.float32)
    order = np.empty(n, np.int32)
    m = lib.trt_build_sah_clusters(
        _fp(lo), _fp(hi), n, max_leaf,
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if m < 0:
        raise RuntimeError("trt_build_sah_clusters failed")
    starts = np.empty(m, np.int64)
    counts = np.empty(m, np.int64)
    rc = lib.trt_sah_leaves(
        starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), m)
    if rc != 0:
        raise RuntimeError("trt_sah_leaves failed")
    return order, starts, counts


def obj_parse(path: str):
    """Returns a dict with positions/normals/has_normal/uvs/indices/
    mat_index/mtl_names/mtllib, or None if the native library is
    unavailable or the parse fails.

    The C parser keeps its result in one global until `trt_obj_free`, so
    the whole parse-read-free sequence holds the module lock: two threads
    parsing at once would read each other's geometry."""
    lib = _load()
    if lib is None:
        return None
    with _lock:
        if lib.trt_obj_parse(path.encode()) != 0:
            return None
        try:
            nv = lib.trt_obj_num_vertices()
            nt = lib.trt_obj_num_triangles()
            pos = np.empty((nv, 3), np.float32)
            nrm = np.empty((nv, 3), np.float32)
            hasn = np.empty(nv, np.uint8)
            uv = np.empty((nv, 2), np.float32)
            idx = np.empty((nt, 3), np.int32)
            mat = np.empty(nt, np.int32)
            lib.trt_obj_get(
                _fp(pos), _fp(nrm),
                hasn.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _fp(uv),
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            ln = lib.trt_obj_mtl_names(None, 0)
            names_buf = ctypes.create_string_buffer(int(ln) + 1)
            lib.trt_obj_mtl_names(names_buf, ln)
            ln2 = lib.trt_obj_mtllib(None, 0)
            lib_buf = ctypes.create_string_buffer(int(ln2) + 1)
            lib.trt_obj_mtllib(lib_buf, ln2)
        finally:
            lib.trt_obj_free()
    names = names_buf.raw[:int(ln)].decode(errors="replace")
    return {
        "positions": pos, "normals": nrm, "has_normal": hasn.astype(bool),
        "uvs": uv, "indices": idx, "mat_index": mat,
        "mtl_names": names.split("\n") if names else [],
        "mtllib": lib_buf.raw[:int(ln2)].decode(errors="replace"),
    }
