"""Host time to enqueue a step: the benchmark's enqueue spans of the traced
window (each chunk's steps, before its synchronise) over its steps, in ms."""


def read(ctx):
    return 1e3 * ctx.spans.total("enqueue") / ctx.steps
