"""Device time a step of the NCCL kernels on rank 0 (the card the
benchmark's process drives) in the profiled steps, in ms: the reshards'
all-to-alls and the halo's sends and receives, waits for the peers
included, which are part of their cost.  Nothing is read without a
profile or when no NCCL kernel ran in the steps."""

import re

PATTERN = re.compile(r"(?i)nccl")


def read(ctx):
    prof = ctx.profile
    if prof is None:
        return None
    rows = [d[2] for d in prof.in_phase("bench.steps") if PATTERN.search(d[0])]
    if not rows:
        return None
    return 1e3 * sum(rows) / (prof.chunks * ctx.steps_per_chunk)
