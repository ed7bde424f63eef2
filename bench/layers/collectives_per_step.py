"""Collectives a step: the change of the program's collective counters
(``repro_torch.core.domain.COLLECTIVES``: halo strips sent point to point,
all-to-all reshards, all-gathers, all-reduces), which the driver reports
under ``collective.``, over the traced window, the diagnostics' included,
over its steps.  Nothing is read from a driver without such counters."""

PREFIX = "collective."


def read(ctx):
    counts = [v for k, v in ctx.counters.items() if k.startswith(PREFIX)]
    return sum(counts) / ctx.steps if counts else None
