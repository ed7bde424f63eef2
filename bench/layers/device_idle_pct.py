"""Share of the profiled sub-window in which no kernel or copy ran on the
device, in %."""


def read(ctx):
    prof = ctx.profile
    if prof is None or prof.window_s <= 0 or prof.busy_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s / prof.window_s)
