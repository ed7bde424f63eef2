"""One run of one cell: set-up, the measured window, the profiled
sub-window of a traced run, the comparison with the plain reference, and
the result.

The window is a closed loop of one solver process: the host enqueues a
chunk's steps, then reads the chunk's diagnostics, which closes the chunk.
Chunks start until ``seconds`` have passed (and at least until the checked
chunk has run); the window ends when the last one's diagnostics reach the
host.  In a traced run each chunk synchronises between its enqueue and its
diagnostics, so that the two spans separate; a few more chunks then run
under the profiler, after the window.

The state entering the checked chunk, drawn from the seed among the
window's first chunks, and the field it leaves are copied to the host
inside the window (stream-ordered copies into buffers pinned at set-up).
Once the window has closed, the peak memory has been read and the
program's state is freed, the configuration's comparison
(``bench/reference/<config>.py`` ``judge``) runs the reference over the
whole trajectory from the initial field to the end of that chunk, and over
that chunk alone from the state that entered it, and reads the gaps that
``correct`` holds to the cell's limits.
"""

from __future__ import annotations

import gc
import math
import statistics
import subprocess
import tempfile
from pathlib import Path
from types import SimpleNamespace

from bench.harness import manifest, profile, traffic as _traffic


class _Snapshot:
    """Host copies of device tensors, into buffers allocated once."""

    def __init__(self, tensors, pinned: bool):
        import torch

        self.bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=pinned)
                     for t in tensors]
        self.pinned = pinned

    def take(self, tensors) -> None:
        for b, t in zip(self.bufs, tensors, strict=True):
            b.copy_(t, non_blocking=self.pinned)

    def saved(self) -> list:
        return [b.clone() for b in self.bufs]


def _power_limit() -> str | None:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = res.stdout.strip().splitlines()
    return lines[0] if lines else None


def passes(check: dict) -> bool:
    return check["value"] is not None and check["value"] <= check["limit"]


def _p95(values: list[float]) -> float:
    if len(values) < 2:
        return values[0]
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, spans,
             device: str = "cuda", control: bool = False, traffic=None) -> dict:
    """Run cell ``name`` once; returns the result line's object.

    ``control`` puts the configuration's control (its reference in the
    precision below the configuration's) in the program's place.
    ``traffic`` replaces the cell's traffic parameters (the CPU tests run
    small grids)."""
    man = manifest.load()
    entry = manifest.cell_entry(man, name)
    cfg = manifest.config(entry["config"])
    wl = manifest.workload(name)
    traffic = dict(wl["traffic"], **(traffic or {}))
    limits = wl["limits"]

    with spans("load"):
        import torch

        ref = manifest.load_module("reference", entry["config"])
        if not control:
            drivers = manifest.load_module("drivers", entry["config"])
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    dtype = getattr(torch, cfg["precision"])

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    with spans("ic"):
        ic = _traffic.initial_field(traffic["ic"], traffic["grid"], seed,
                                    dtype, dev)
        ic_host = ic.to("cpu", copy=True)
    factory = ref.Control if control else drivers.Driver
    drv = factory(cfg, traffic, ic, dev, spans)
    del ic
    boot_host = None if drv.boot is None else drv.boot.to("cpu", copy=True)
    checked = _traffic.checked_chunk(seed, int(traffic["checked_within"]))
    snap_in = _Snapshot(drv.state(), on_card)
    snap_out = _Snapshot([drv.current()], on_card)
    with spans("warmup"):
        for _ in range(int(traffic["warmup_chunks"])):
            drv.chunk()
            drv.diagnostics()
        snap_in.take(drv.state())
        snap_out.take([drv.current()])
        sync()
    counts0 = dict(drv.counters())

    # -- the measured window ------------------------------------------------
    t_first = spans.now()
    latencies, diags, diag_checked = [], [], None
    while True:
        k = len(latencies)
        if k > checked and spans.now() - t_first >= seconds:
            break
        t0 = spans.now()
        if k == checked:
            snap_in.take(drv.state())
        drv.chunk()
        t1 = spans.now()
        spans.add("enqueue", t0, t1, chunk=k)
        if trace:
            sync()
            t2 = spans.now()
            spans.add("sync", t1, t2, chunk=k)
        else:
            t2 = t1
        d = drv.diagnostics()
        t3 = spans.now()
        spans.add("diag", t2, t3, chunk=k)
        if k == checked:
            snap_out.take([drv.current()])
            diag_checked = d
        latencies.append(t3 - t0)
        diags.append(d)
    sync()
    t_end = spans.now()
    wall = t_end - t_first
    steps_per_chunk = drv.steps_per_chunk
    steps = len(latencies) * steps_per_chunk
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    counts = {k: v - counts0.get(k, 0) for k, v in drv.counters().items()}
    step_calls, floor_bytes = drv.step_calls(), drv.floor_bytes()

    prof = None
    if trace and on_card:
        def one_chunk(annotate):
            with annotate("bench.steps"):
                drv.chunk()
                sync()
            with annotate("bench.diag"):
                drv.diagnostics()

        tmp = Path(tempfile.gettempdir()) / "bench_trace"
        with spans("profiled"):
            prof = profile.run_profiled(
                one_chunk, int(traffic["profiled_chunks"]),
                tmp / f"{name}.{seed}.json")
    power = _power_limit() if on_card else None

    # -- the comparison, with the program's state freed ----------------------
    drv.close()
    del drv
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    with spans("check"):
        evidence = dict(ic=ic_host, boot=boot_host, state_in=snap_in.saved(),
                        current_out=snap_out.saved()[0], diag=diag_checked,
                        steps=steps_per_chunk,
                        chunks_before=int(traffic["warmup_chunks"]) + checked)
        numbers = ref.judge(cfg, traffic, evidence, dev)
        sync()
    nonfinite = sum(not all(math.isfinite(x) for x in d) for d in diags)
    checks = {"nonfinite_chunks": dict(value=nonfinite, limit=0)}
    for key, value in numbers.items():
        # a gap that is not finite is written as null: JSON has no NaN
        checks[key] = dict(value=value if math.isfinite(value) else None,
                           limit=limits[key])
    failed_checks = [k for k, c in checks.items() if not passes(c)]
    # answers that failed: chunks with a non-finite diagnostic, and the
    # checked chunk (with the start it rests on) when a comparison fails
    failed = nonfinite + any(k != "nonfinite_chunks" for k in failed_checks)

    # -- metrics ------------------------------------------------------------
    metrics = {}
    if not trace:
        values = dict(step_ms=1e3 * wall / steps,
                      chunk_p95_ms=1e3 * _p95(latencies),
                      peak_mem_gib=peak / 2**30, setup_s=t_first)
        for m in manifest.end_to_end(man, name):
            metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    else:
        ctx = SimpleNamespace(
            spans=spans, steps=steps, wall_s=wall, counters=counts,
            profile=prof, steps_per_chunk=steps_per_chunk,
            step_calls=step_calls, floor_bytes=floor_bytes,
            ops=manifest.ops_modules())
        for m in manifest.per_layer(man, name):
            v = manifest.load_module("layers", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])

    dev_info = dict(platform="gpu" if on_card else "cpu",
                    kind=torch.cuda.get_device_name(dev) if on_card else "cpu",
                    count=int(entry["chips"]), memory_peak_bytes=int(peak),
                    power_limit=power)
    result = dict(correct=not failed_checks, attempted=len(latencies),
                  failed=failed, metrics=metrics, device=dev_info)
    if prof is not None:
        dev_info.update(busy_s=prof.busy_s, window_s=prof.window_s)
        result["breakdown"] = dict(device_ops=prof.top_ops(10),
                                   idle_gaps=prof.gaps[:10])
    result["checks"] = checks

    spans.write(Path(tempfile.gettempdir()) / "bench_spans"
                / f"{name}.{seed}.trace{int(trace)}.jsonl")
    return result
