"""The whole step's share of its floor, in %: the step's inputs read once
and its output written once (the driver's ``floor_bytes``) over HBM
bandwidth, against the traced run's step time outside its profiled
sub-window (the window's wall time over its steps, diagnostics included)."""

from bench.harness import peaks


def read(ctx):
    if not ctx.floor_bytes:
        return None
    floor = peaks.bound_s(ctx.floor_bytes, 0)
    return 100.0 * floor / (ctx.wall_s / ctx.steps)
