"""The traced run's profiled sub-window: ``torch.profiler`` (CUPTI) over a
few chunks, and the reduction of its exported trace.

Each chunk of the sub-window runs as two annotated ranges, ``bench.steps``
(the chunk's enqueue and a synchronise) and ``bench.diag`` (the
diagnostics, read to the host).  A device activity belongs to the range
in which the host launched it (the runtime call of the same correlation
id), or, without one, to the range its start lies in.  The trace's host
and device events share one clock, to within the tens of microseconds by
which CUPTI's device timestamps can lead the host's: a kernel launched
first in a range can seem to start before it.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PHASES = ("bench.steps", "bench.diag")


def short_name(name: str) -> str:
    """A kernel's name without its namespace, return type and arguments."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:80]


@dataclass
class Profile:
    window_s: float  # first annotated range's start to the last one's end
    busy_s: float  # union of device activity inside the window
    chunks: int
    # (short name, start s, duration s, phase) of every device activity
    device: list = field(default_factory=list)
    gaps: list = field(default_factory=list)  # (label, seconds), longest first

    def in_phase(self, phase: str) -> list:
        return [d for d in self.device if d[3] == phase]

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, _, dur, _ in self.device:
            by[name] = by.get(name, 0.0) + dur
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


def run_profiled(chunk_fn, n_chunks: int, trace_path: Path) -> Profile:
    """Profile ``n_chunks`` calls of ``chunk_fn(annotate)``, where
    ``annotate(name)`` is the context manager that marks a phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_chunks):
            chunk_fn(record_function)
        torch.cuda.synchronize()
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(trace_path))
    try:
        events = json.loads(trace_path.read_text()).get("traceEvents", [])
    finally:
        trace_path.unlink(missing_ok=True)
    return reduce_trace(events, n_chunks)


def reduce_trace(events: list, n_chunks: int) -> Profile:
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in events
                    if e.get("cat") == "user_annotation" and e.get("name") in PHASES
                    and "dur" in e)
    if not ranges:
        return Profile(0.0, 0.0, n_chunks)
    w0, w1 = ranges[0][0], max(r[1] for r in ranges)
    cpu_ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                     for e in events if e.get("cat") == "cpu_op" and "dur" in e)
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  short_name(e.get("name", "")),
                  launched.get(e.get("args", {}).get("correlation"),
                               float(e["ts"])))
                 for e in events
                 if e.get("cat") in DEVICE_CATS and "dur" in e)

    def phase_at(t: float) -> str | None:
        for a, b, name in ranges:
            if a <= t <= b:
                return name
        return None

    def host_at(t: float) -> str:
        op = None
        for a, b, name in cpu_ops:  # innermost: the latest start containing t
            if a > t:
                break
            if b >= t:
                op = name
        return f"{phase_at(t) or 'between'}:{op or 'python'}"

    device, busy, gaps = [], 0.0, []
    end = w0
    for a, b, name, at in dev:
        device.append((name, a * 1e-6, (b - a) * 1e-6, phase_at(at)))
        a_c, b_c = max(a, w0), min(b, w1)
        if b_c <= a_c:
            continue
        if a_c > end:
            gaps.append((host_at(end), (a_c - end) * 1e-6))
        busy += max(0.0, b_c - max(a_c, end))
        end = max(end, b_c)
    if w1 > end:
        gaps.append((host_at(end), (w1 - end) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return Profile((w1 - w0) * 1e-6, busy * 1e-6, n_chunks, device,
                   [list(g) for g in gaps])


def kernel_rows(profile: Profile, pattern: str, phase: str = "bench.steps"):
    """The device activities of ``phase`` whose name matches ``pattern``."""
    rx = re.compile(pattern)
    return [d for d in profile.in_phase(phase) if rx.search(d[0])]
