"""A kernel's share of its roofline in the profiled sub-window: the bound
of the operations it ran (``bench/ops/<kernel>.py`` at the step's calls,
``bench/harness/peaks.py``) over their device time, in %.

Nothing is read when the kernel is not in the step, when the trace holds
no device activity, or when it did not keep every launch (the count of
the kernel's activities in the steps is not its launches a step times the
steps)."""

from bench.harness import peaks
from bench.harness.profile import kernel_rows


def share(ctx, kernel: str):
    calls = [call for k, call in ctx.step_calls if k == kernel]
    if not calls or ctx.profile is None:
        return None
    op = ctx.ops[kernel]
    rows = kernel_rows(ctx.profile, op.PATTERN)
    steps = ctx.profile.chunks * ctx.steps_per_chunk
    if not rows or len(rows) != len(calls) * steps:
        return None
    bound = steps * sum(peaks.bound_s(*op.count(**call)) for call in calls)
    return 100.0 * bound / sum(d[2] for d in rows)


def reader(kernel: str):
    return lambda ctx: share(ctx, kernel)
