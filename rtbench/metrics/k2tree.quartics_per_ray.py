"""K2's (ray, torus) quartics a lane where its tree is large: over the
counted sub-window's K2 calls on more than 64 tori (config 4's 1,024 in
gated chunks of 16), the `quartics` its counters counted, summed, over the
calls' lanes, summed (primary and shadow queries together; a dead lane
tests nothing).

The counts are the program's own record (`utils.profiling.
record_segments`: inside it each K2 launch on the card counts its work
into a counters tensor of the record's, read once at the block's exit).
Nothing where no such call was recorded, or where one's count is None (a
program that records no counts, or a run on the CPU)."""

import os

from rtbench import manifest

NAME = "k2tree.quartics_per_ray"
LAYER = "kernels"
UNIT = "quartics"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "frames_per_s"
FIELD = "quartics"
TREE = manifest.metric(
    "k2tree.roofline_pct", os.path.dirname(os.path.dirname(__file__)))


def read(ctx):
    calls = TREE.tree_calls(ctx.segments)
    if not calls or any(getattr(c, FIELD, None) is None for c in calls):
        return None
    return sum(getattr(c, FIELD) for c in calls) / \
        sum(c.lanes for c in calls)
