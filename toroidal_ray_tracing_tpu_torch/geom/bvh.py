"""Host-side median-split BVH over primitive AABBs: the port's own copy of
the JAX package's `geom/bvh.py` (NumPy, host only).

It is NOT on the trace path: the kernels walk the trees that `ops/`
builds per scene (`kernel_common`, `tree_walk.cuh`). `build_bvh` is kept
as an independent reference for cluster bounds, as in the JAX package's
tests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

F32 = np.float32
I32 = np.int32


class FlatBVH(NamedTuple):
    """Flattened depth-first BVH. Inner node: child = index of right child
    (left child is node+1). Leaf: start/count into the primitive order."""

    lo: np.ndarray       # (n_nodes, 3) f32
    hi: np.ndarray       # (n_nodes, 3) f32
    right: np.ndarray    # (n_nodes,) i32, -1 for leaf
    start: np.ndarray    # (n_nodes,) i32 (leaves)
    count: np.ndarray    # (n_nodes,) i32 (leaves)
    order: np.ndarray    # (n_prims,) i32 permutation of primitives


def build_bvh(lo: np.ndarray, hi: np.ndarray, leaf_size: int = 4) -> FlatBVH:
    """Median-split BVH over primitive AABBs (lo/hi: (N,3))."""
    n = lo.shape[0]
    centroid = (lo + hi) * 0.5
    order = np.arange(n, dtype=I32)

    nodes_lo, nodes_hi, nodes_right, nodes_start, nodes_count = [], [], [], [], []

    def emit(idx: np.ndarray) -> int:
        node = len(nodes_lo)
        nodes_lo.append(lo[idx].min(axis=0))
        nodes_hi.append(hi[idx].max(axis=0))
        nodes_right.append(-1)
        nodes_start.append(0)
        nodes_count.append(0)
        return node

    out_order: list = []

    def recurse(idx: np.ndarray) -> int:
        node = emit(idx)
        if len(idx) <= leaf_size:
            nodes_start[node] = len(out_order)
            nodes_count[node] = len(idx)
            out_order.extend(idx.tolist())
            return node
        c = centroid[idx]
        axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
        med = np.argsort(c[:, axis], kind="stable")
        half = len(idx) // 2
        recurse(idx[med[:half]])
        right = recurse(idx[med[half:]])
        nodes_right[node] = right
        return node

    if n:
        recurse(order)
    else:  # one empty leaf
        nodes_lo.append(np.zeros(3, F32))
        nodes_hi.append(np.zeros(3, F32))
        nodes_right.append(-1)
        nodes_start.append(0)
        nodes_count.append(0)

    return FlatBVH(
        lo=np.asarray(nodes_lo, F32),
        hi=np.asarray(nodes_hi, F32),
        right=np.asarray(nodes_right, I32),
        start=np.asarray(nodes_start, I32),
        count=np.asarray(nodes_count, I32),
        order=np.asarray(out_order if n else [], I32),
    )
