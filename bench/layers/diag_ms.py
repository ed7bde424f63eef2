"""One chunk's diagnostics: the benchmark's diag spans of the traced window
(after the chunk's synchronise, to the numbers on the host), their mean,
in ms."""


def read(ctx):
    d = ctx.spans.durations("diag")
    return 1e3 * sum(d) / len(d) if d else None
