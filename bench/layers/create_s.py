"""Create in set-up: the benchmark's create span (the solver's or the
plans' Create, the penta factorisations with it), in s."""


def read(ctx):
    d = ctx.spans.durations("create")
    return sum(d) if d else None
