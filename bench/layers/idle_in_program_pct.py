"""Share of the device's idle time in sub-window (b) during which the host
was inside one of the program's ``repro.*`` spans, in %."""


def read(ctx):
    pp = getattr(ctx, "program_profile", None)
    if pp is None or pp.unplaced or pp.idle_s <= 0 or not pp.ranges:
        return None
    return 100.0 * pp.idle_in_program_s / pp.idle_s
