"""K5's (csrc/tri_stream.cu, the streamed tree walk over superblocks of
triangle clusters, for meshes above 65,536 triangles) share of its
roofline: the least time its calls could take, each call's bytes
(`k5_bytes`) over the card's peak memory rate, summed, over the device
time of the host's sub-window's launches of K5 and of K6 (the grouped
variant, which runs the same walk when the program selects it), summed.

The calls are the program's own record (`utils.profiling.record_segments`
in the counted sub-window: a `HitCall` for each hit-kernel launch of a
segment). The counted and the host's sub-windows each run `trace_calls`
calls, one whole turn of the traffic's views, so they launch the same
kernels. Nothing when the recorded calls and the launches do not pair up,
or when the program's record holds no calls (a program whose segments are
[lanes, live spans] alone).

The bytes are the contract of `kernel_bytes.k1_bytes`: the rays in (7
words a lane), the hit rows out (t, index, u, v) and the 21 attribute
rows when the call asks for them, the folds it writes (the next kernel's
tmax; the occlusion byte, read too when it ORs into it), and the tables
it reads whole: the tree's nodes (9 words; its leaves are the
superblocks' boxes), a rank word a superblock and the cluster boxes (6
words) the walk tests inside a superblock. The Woop rows are read only
where rays enter their clusters, which the rays decide: they are left
out, so the share is a lower bound."""

from rtbench.kernel_bytes import k1_bytes

NAME = "k5.roofline_pct"
LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "frames_per_s"
KERNELS = ("tri_closest_hit_stream", "tri_closest_hit_stream_grouped")
BOX_WORDS = 6             # a cluster box: lo (3), hi (3)


def k5_bytes(n: int, nodes: int, superblocks: int, clusters: int,
             attrs: bool, tmax_out: bool = False, occ_out: bool = False,
             occ_or: bool = False) -> int:
    """K5 (or K6) on n lanes over a tree of `nodes` nodes, `superblocks`
    ranked superblocks and `clusters` (padded) cluster boxes: K1's count
    with a rank word a superblock and the cluster boxes as its boxes."""
    return k1_bytes(n, nodes, superblocks + BOX_WORDS * clusters, attrs,
                    tmax_out, occ_out, occ_or)


def call_bytes(c) -> int:
    """The bytes of one recorded call (a `HitCall`)."""
    return k5_bytes(c.lanes, c.nodes, c.ranked, c.boxes, c.attrs,
                    c.tmax_out, c.occ_out, c.occ_or)


def read(ctx):
    prof = ctx.host_profile
    segments = ctx.segments
    if prof is None or ctx.peak_bytes_per_s is None or not segments \
            or any(len(s) < 3 for s in segments):
        return None
    calls = [c for s in segments for c in s[2] if c.kernel in KERNELS]
    if not calls:
        return None
    launches = seconds = 0
    for kernel in KERNELS:
        n, s = prof.kernel_seconds(kernel)
        launches, seconds = launches + n, seconds + s
    if launches != len(calls) or seconds <= 0:
        return None
    return 100.0 * sum(map(call_bytes, calls)) / ctx.peak_bytes_per_s \
        / seconds
