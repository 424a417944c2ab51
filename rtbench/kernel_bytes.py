"""The bytes a hit-kernel call must move, and a record of each call's, for
the kernels' roofline shares.

The count is the kernel's contract, each input read once and each output
written once: the call's rays in (origin and direction rows, tmax: 7
float32 a lane), its hit rows out (K1: t, index, u, v; K2: t, index), the
attribute rows when the call asks for them (K1: 21, K2: 15 float32 a
lane), the folds it writes (the next kernel's tmax, float32; the
occlusion byte, read too when it ORs into it), and the scene tables it
reads whole: the tree's node boxes and links (9 words a node) and the
visit rank (a word a leaf box), and K2's torus rows (transform 12, radii
2, material 12 words a torus). K1's Woop rows and both kernels' winners'
attribute columns are read only where rays test or keep them, which the
call's inputs do not fix: they are left out, so the count is a lower
bound, and a share of the roofline from it cannot pass 100% where the
time covers the call's work.

The record wraps the program's two query entries, `trace_kernel.
tri_closest_hit` (K1) and `torus_kernel.torus_closest_hit_chunked` (K2),
as the program's `utils.profiling.record_segments` wraps `closest_hit`.
"""

from __future__ import annotations

import contextlib
import inspect

WORD = 4
RAY_WORDS = 7
K1_HIT_ROWS, K1_ATTR_ROWS = 4, 21
K2_HIT_ROWS, K2_ATTR_ROWS = 2, 15
NODE_WORDS = 9            # tree_lo (3), tree_hi (3), tree_link (3)
TORUS_WORDS, TORUS_MAT_WORDS = 14, 12


def _folds(n: int, tmax_out: bool, occ_out: bool, occ_or: bool) -> int:
    return (n * WORD if tmax_out else 0) + \
        ((2 if occ_or else 1) * n if occ_out else 0)


def k1_bytes(n: int, nodes: int, boxes: int, attrs: bool,
             tmax_out: bool = False, occ_out: bool = False,
             occ_or: bool = False) -> int:
    """K1 on n lanes over a tree of `nodes` nodes and `boxes` cluster
    boxes."""
    rows = RAY_WORDS + K1_HIT_ROWS + (K1_ATTR_ROWS if attrs else 0)
    return n * rows * WORD + _folds(n, tmax_out, occ_out, occ_or) + \
        (nodes * NODE_WORDS + boxes) * WORD


def k2_bytes(n: int, nodes: int, boxes: int, tori: int, attrs: bool,
             occ_out: bool = False, occ_or: bool = False) -> int:
    """K2 on n lanes over a tree of `nodes` nodes, `boxes` chunk boxes and
    `tori` (padded) torus rows."""
    rows = RAY_WORDS + K2_HIT_ROWS + (K2_ATTR_ROWS if attrs else 0)
    table = tori * (TORUS_WORDS + (TORUS_MAT_WORDS if attrs else 0))
    return n * rows * WORD + _folds(n, False, occ_out, occ_or) + \
        (nodes * NODE_WORDS + boxes + table) * WORD


def _k1_call(a) -> int:
    tb = a["tables"]
    boxes = tb.clo.shape[0] if tb.box_test else 1
    return k1_bytes(a["origins"].shape[1], tb.tree_lo.shape[0], boxes,
                    a["attr_tables"] is not None, a["tmax_out"] is not None,
                    a["occ_out"] is not None, bool(a["occ_or"]))


def _k2_call(a) -> int:
    tb = a["tables"]
    return k2_bytes(a["origins"].shape[1], tb.tree_lo.shape[0],
                    tb.clo.shape[0], tb.w2o_rows.shape[0],
                    bool(a["want_attrs"]), a["occ_out"] is not None,
                    bool(a["occ_or"]))


@contextlib.contextmanager
def record_calls(out: dict):
    """Append each K1 and K2 launch's bytes inside the block to
    out["tri_closest_hit"] and out["torus_closest_hit"] (the kernels'
    names on the device)."""
    from toroidal_ray_tracing_tpu_torch.ops import torus_kernel, trace_kernel

    patched = [(trace_kernel, "tri_closest_hit", "tri_closest_hit", _k1_call),
               (torus_kernel, "torus_closest_hit_chunked",
                "torus_closest_hit", _k2_call)]
    real = [getattr(mod, attr) for mod, attr, _, _ in patched]
    for (mod, attr, name, count), fn in zip(patched, real):
        sig = inspect.signature(fn)
        calls = out.setdefault(name, [])

        def recorded(*a, _fn=fn, _sig=sig, _calls=calls, _count=count, **k):
            bound = _sig.bind(*a, **k)
            bound.apply_defaults()
            args = bound.arguments
            if args["origins"].is_cuda and args["origins"].shape[1]:
                _calls.append(_count(args))
            return _fn(*a, **k)

        setattr(mod, attr, recorded)
    try:
        yield out
    finally:
        for (mod, attr, _, _), fn in zip(patched, real):
            setattr(mod, attr, fn)
