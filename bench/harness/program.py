"""The program's own spans in a traced run: two sub-windows after the
profiled one, and the reduction of the second one's trace by program span.

``repro_torch.runtime.spans`` records the host's passes through the
program's layer boundaries (``repro.*``: a chunk, its RHS and update, an
ADI sweep, a plan's Compute, ``compute``, the diagnostics, a launch), and
while ``torch.profiler`` records, mirrors each as a range of the trace.

- Sub-window (a): spans on, no profiler.  Its records give the host time
  of each boundary on the host clock (``launch_host_us``).
- Sub-window (b): spans on, under ``torch.profiler``, each chunk in the
  benchmark's two ranges as the profiled sub-window runs it.  Each device
  activity goes under the program spans that held the host call which
  launched it (the runtime call of the same correlation id); each idle
  gap is labelled by the innermost program span the host was in when the
  device fell idle, or ``caller`` outside every one.

A checkout whose program has no spans module runs neither
(:func:`available` is None there).  ``bench/trace_program.py`` runs both in
one cell; the benchmark's traced run does not run them yet.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path

from bench.harness import profile

RANGE_CATS = ("cpu_op", "user_annotation")
PREFIX = "repro."


def available():
    """The program's spans module, or None where it has none."""
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    return spans


@dataclass
class ProgramProfile:
    base: profile.Profile  # the benchmark's reduction of the same trace
    chunks: int
    # (short name, duration s, phase, the program spans around its launch
    # from the outermost, or None where no launching call was found)
    device: list = field(default_factory=list)
    ranges: list = field(default_factory=list)  # (start, end, name) in us
    gaps: list = field(default_factory=list)  # [phase:span, s], longest first
    idle_s: float = 0.0  # device idle inside the window
    idle_in_program_s: float = 0.0  # ... while the host was in a program span
    unplaced: int = 0  # kernels with no launching call in the trace

    def span_names(self) -> set:
        return {name for _, _, name in self.ranges}

    def under(self, span: str, phase: str | None = None) -> list:
        """The activities launched inside ``span`` (at any depth)."""
        return [d for d in self.device if d[3] is not None and span in d[3]
                and (phase is None or d[2] == phase)]


def reduce_program(events: list, n_chunks: int) -> ProgramProfile:
    base = profile.reduce_trace(events, n_chunks)
    phases = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name") in profile.PHASES and "dur" in e)
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in events
                    if e.get("cat") in RANGE_CATS and "dur" in e
                    and str(e.get("name", "")).startswith(PREFIX))
    out = ProgramProfile(base, n_chunks, ranges=ranges)
    if not phases:
        return out
    w0, w1 = phases[0][0], max(p[1] for p in phases)
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}

    def phase_at(t):
        return next((name for a, b, name in phases if a <= t <= b), None)

    def spans_at(t):  # outermost first: ranges are sorted by start
        return tuple(name for a, b, name in ranges if a <= t <= b)

    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  profile.short_name(e.get("name", "")), e.get("cat"),
                  launched.get(e.get("args", {}).get("correlation")))
                 for e in events
                 if e.get("cat") in profile.DEVICE_CATS and "dur" in e)
    end, gaps = w0, []
    for a, b, name, cat, at in dev:
        placed = at is not None
        out.unplaced += cat == "kernel" and not placed
        out.device.append((name, (b - a) * 1e-6, phase_at(at if placed else a),
                           spans_at(at) if placed else None))
        a_c, b_c = max(a, w0), min(b, w1)
        if b_c <= a_c:
            continue
        if a_c > end:
            gaps.append((end, a_c))
        end = max(end, b_c)
    if w1 > end:
        gaps.append((end, w1))
    merged = _union([(a, b) for a, b, _ in ranges])
    for g0, g1 in gaps:
        inner = spans_at(g0)
        out.gaps.append([f"{phase_at(g0) or 'between'}:"
                         f"{inner[-1] if inner else 'caller'}", (g1 - g0) * 1e-6])
        out.idle_s += (g1 - g0) * 1e-6
        out.idle_in_program_s += sum(max(0.0, min(b, g1) - max(a, g0))
                                     for a, b in merged) * 1e-6
    out.gaps.sort(key=lambda g: -g[1])
    return out


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def spans_window(drv, sync, n_chunks: int, now):
    """Sub-window (a): ``n_chunks`` chunks as the traced window runs them
    (enqueue, synchronise, diagnostics) with the spans on.  Returns the
    records and each chunk's enqueue time by ``now()`` (s)."""
    spans = available()
    spans.take()
    enqueue = []
    spans.enable()
    try:
        for _ in range(n_chunks):
            t0 = now()
            drv.chunk()
            enqueue.append(now() - t0)
            sync()
            drv.diagnostics()
    finally:
        spans.disable()
    return spans.take(), enqueue


def profiled_window(drv, sync, n_chunks: int, trace_path: Path) -> ProgramProfile:
    """Sub-window (b): ``n_chunks`` chunks with the spans on, under
    ``torch.profiler``, in the profiled sub-window's two ranges."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    spans = available()
    spans.take()
    sync()
    spans.enable()
    try:
        with torch.profiler.profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n_chunks):
                with record_function("bench.steps"):
                    drv.chunk()
                    sync()
                with record_function("bench.diag"):
                    drv.diagnostics()
            sync()
    finally:
        spans.disable()
        spans.take()
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    try:
        events = json.loads(trace_path.read_text()).get("traceEvents", [])
    finally:
        trace_path.unlink(missing_ok=True)
    return reduce_program(events, n_chunks)


def glue_under(ctx, span: str):
    """Device time a step in (b) of the step's activities that no
    ``bench/ops`` pattern matches (the glue) launched inside ``span``, in
    ms; None where (b) did not run, lost a launching call or lacks the
    span."""
    pp = getattr(ctx, "program_profile", None)
    if pp is None or pp.unplaced or not pp.device or span not in pp.span_names():
        return None
    ours = [re.compile(op.PATTERN) for op in ctx.ops.values()]
    glue = sum(d[1] for d in pp.under(span, "bench.steps")
               if not any(rx.search(d[0]) for rx in ours))
    return 1e3 * glue / (pp.chunks * ctx.steps_per_chunk)
