"""Device time a chunk of every activity launched inside the program's
``repro.ch.diagnostics`` span, in sub-window (b), in ms."""


def read(ctx):
    pp = getattr(ctx, "program_profile", None)
    if (pp is None or pp.unplaced or not pp.device
            or "repro.ch.diagnostics" not in pp.span_names()):
        return None
    return 1e3 * sum(d[1] for d in pp.under("repro.ch.diagnostics")) / pp.chunks
