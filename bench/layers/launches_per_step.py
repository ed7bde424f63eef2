"""Kernel launches a step: the change of the program's launch counters
(``repro_torch.kernels._build.LAUNCHES``) over the traced window, the
diagnostics' launches included, over its steps."""


def read(ctx):
    return sum(ctx.counters.values()) / ctx.steps
