"""Device time a step of the operations that are not the port's kernels
(PyTorch's own kernels and copies among the step's: no ``bench/ops``
pattern matches them), in ms, from the profiled sub-window."""

import re


def read(ctx):
    prof = ctx.profile
    if prof is None or not prof.device:
        return None
    ours = [re.compile(op.PATTERN) for op in ctx.ops.values()]
    glue = sum(d[2] for d in prof.in_phase("bench.steps")
               if not any(rx.search(d[0]) for rx in ours))
    return 1e3 * glue / (prof.chunks * ctx.steps_per_chunk)
