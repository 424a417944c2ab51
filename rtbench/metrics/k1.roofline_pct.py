"""K1's (csrc/tri_hit.cu, the tree walk over triangle clusters) share of
its roofline in the host's profiled sub-window: the least time its calls
could take, each call's bytes (`rtbench.kernel_bytes`, recorded around
the program's query entry) over the card's peak memory rate, summed,
over the device time of its launches, summed. Nothing when the recorded
calls and the launches in the trace do not pair up."""

NAME = "k1.roofline_pct"
LAYER = "kernels"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "frames_per_s"
KERNEL = "tri_closest_hit"


def read(ctx):
    calls = ctx.kernel_calls.get(KERNEL, [])
    prof = ctx.host_profile
    if prof is None or ctx.peak_bytes_per_s is None or not calls:
        return None
    launches, seconds = prof.kernel_seconds(KERNEL)
    if launches != len(calls) or seconds <= 0:
        return None
    return 100.0 * sum(calls) / ctx.peak_bytes_per_s / seconds
