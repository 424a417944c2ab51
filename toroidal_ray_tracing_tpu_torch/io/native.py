"""ctypes binding to the shared native host library (csrc/libtrt_native.so at
the repository root — the same C++ both packages build on).

Only the binned-SAH cluster builder is bound here: `scene.build` uses it to
cut the triangle table into clusters. The library is built with
`make -C csrc` on first use; if it cannot be built, `available()` is False
and the scene build falls back to Morton-order chunking (host code, not a
kernel).
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
        lib.trt_build_sah_clusters.restype = ctypes.c_int64
        lib.trt_build_sah_clusters.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int, ctypes.POINTER(ctypes.c_int32)]
        lib.trt_sah_leaves.restype = ctypes.c_int
        lib.trt_sah_leaves.argtypes = [ctypes.POINTER(ctypes.c_int64),
                                       ctypes.POINTER(ctypes.c_int64),
                                       ctypes.c_int64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def build_sah_clusters(tri_lo: np.ndarray, tri_hi: np.ndarray,
                       max_leaf: int):
    """Returns (order int32 (n,), leaf_starts int64, leaf_counts int64)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
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
