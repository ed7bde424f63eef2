"""Device time a step of the glue (PyTorch's own kernels, which no
``bench/ops`` pattern matches) launched inside the program's
``repro.ch.rhs`` span, in sub-window (b), in ms."""

from bench.harness.program import glue_under


def read(ctx):
    return glue_under(ctx, "repro.ch.rhs")
