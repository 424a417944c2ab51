"""K2's (csrc/torus_hit.cu, the tree walk over analytic tori) share of its
roofline where its tree is large: over the calls on more than 64 tori
(tori in gated chunks of 16, a tree over every torus box; config 4's
1,024), the least time they could take, each call's bytes
(`kernel_bytes.k2_bytes`) over the card's peak memory rate, summed, over
the device time of the host's sub-window's K2 launches, summed.

The calls are the program's own record (`utils.profiling.record_segments`
in the counted sub-window: a `HitCall` for each hit-kernel launch of a
segment). The counted and the host's sub-windows each run `trace_calls`
calls, whole turns of the traffic's views, so they launch the same
kernels. Nothing when the recorded calls and the launches do not pair up,
or when no such call was recorded (K2 on a few tori, no K2 at all, or a
program whose segments are [lanes, live spans] alone)."""

from rtbench.kernel_bytes import k2_bytes

NAME = "k2tree.roofline_pct"
LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "frames_per_s"
KERNEL = "torus_closest_hit"
SMALL_TREE = 64           # the most tori K2 takes in chunks of 8


def tree_calls(segments) -> list:
    """The recorded K2 calls on more than `SMALL_TREE` tori; None where a
    segment's entry holds no calls."""
    if any(len(s) < 3 for s in segments):
        return None
    return [c for s in segments for c in s[2]
            if c.kernel == KERNEL and c.tori > SMALL_TREE]


def call_bytes(c) -> int:
    """The bytes of one recorded call (a `HitCall`)."""
    return k2_bytes(c.lanes, c.nodes, c.ranked, c.tori, c.attrs, c.occ_out,
                    c.occ_or)


def read(ctx):
    prof = ctx.host_profile
    calls = tree_calls(ctx.segments)
    if prof is None or ctx.peak_bytes_per_s is None or not calls:
        return None
    launches, seconds = prof.kernel_seconds(KERNEL)
    if launches != len(calls) or seconds <= 0:
        return None
    return 100.0 * sum(map(call_bytes, calls)) / ctx.peak_bytes_per_s \
        / seconds
