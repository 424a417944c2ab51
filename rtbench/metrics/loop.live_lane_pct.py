"""Share of the lanes the bounce loop traced that sat in live 128-lane
spans, over every segment of the counted sub-window (the program's
`utils.profiling.record_segments`: live spans x 128 over lanes traced).
What compaction leaves dead is the rest."""

NAME = "loop.live_lane_pct"
LAYER = "bounce loop"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "frames_per_s"
SPAN = 128


def read(ctx):
    lanes = sum(s[0] for s in ctx.segments)
    if not lanes:
        return None
    return 100.0 * sum(min(s[1] * SPAN, s[0]) for s in ctx.segments) / lanes
