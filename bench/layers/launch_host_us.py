"""Host time of one kernel launch: the mean of the program's
``repro.launch`` spans (``kernels/_build.launch``, from the chaos hook to
the launch counter) in sub-window (a), in us."""


def read(ctx):
    records = getattr(ctx, "program_spans", None) or ()
    d = [s.dur_ns for s in records if s.name == "repro.launch"]
    return 1e-3 * sum(d) / len(d) if d else None
