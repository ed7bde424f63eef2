#!/usr/bin/env python3
"""The program's own spans in one cell, on the card: the readings of the
five readers that read them, and what the spans cost.

    python3 bench/trace_program.py --workload ch2d.fused.4096 --seed 7 \\
        --chunks 20 --out program.json

Set-up as a run of the cell (``bench/harness/cell.py``): the initial field
from ``--seed``, Create, the bootstrap and the warm-up chunks.  Then, in
one process:

1. ``--chunks`` times, a chunk with the program's spans off, then one
   with them on (sub-window (a), ``bench/harness/program.py``), each run
   as a traced run's window runs a chunk: enqueue, synchronise,
   diagnostics;
2. the profiled sub-window of a traced run, the spans off;
3. sub-window (b): the same chunks with the spans on, under the profiler.

Prints one JSON line and writes it to ``--out``: ``metrics`` (the
readers ``launch_host_us``, ``rhs_glue_ms_per_step``,
``update_glue_ms_per_step``, ``diag_device_ms`` and ``idle_in_program_pct``
of ``bench/layers/``, each where it reads something); ``glue_ms_per_step``
and ``device_idle_pct`` of the profiled sub-window and of (b); host
enqueue a step with the spans off and on (quartiles over the chunks); the device time of (b) outside
every program span; the glue's share under one; the ten longest idle gaps
of (b) by program span; the card and its power limit.  The benchmark's
runs do not run this.
"""

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]

READERS = ("launch_host_us", "rhs_glue_ms_per_step", "update_glue_ms_per_step",
           "diag_device_ms", "idle_in_program_pct")


def run(name: str, seed: int, chunks: int, *, device="cuda",
        traffic=None) -> dict:
    import torch

    from bench.harness import cell, manifest, profile, program
    from bench.harness import traffic as _traffic
    from bench.harness.spans import Spans

    entry = manifest.cell_entry(manifest.load(), name)
    cfg = manifest.config(entry["config"])
    traffic = dict(manifest.workload(name)["traffic"], **(traffic or {}))
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(dev)

    ic = _traffic.initial_field(traffic["ic"], traffic["grid"], seed,
                                getattr(torch, cfg["precision"]), dev)
    drv = manifest.load_module("drivers", entry["config"]).Driver(
        cfg, traffic, ic, dev, Spans())
    del ic
    for _ in range(int(traffic["warmup_chunks"])):
        drv.chunk()
        drv.diagnostics()
    sync()
    spans = program.available()
    steps = drv.steps_per_chunk
    out = dict(workload=name, seed=seed, device=dict(
        kind=torch.cuda.get_device_name(dev) if on_card else "cpu",
        power_limit=cell._power_limit() if on_card else None))
    off, on, records = [], [], []
    for _ in range(chunks):
        t0 = time.perf_counter()
        drv.chunk()
        off.append(time.perf_counter() - t0)
        sync()
        drv.diagnostics()
        if spans is not None:
            recs, enq = program.spans_window(drv, sync, 1, time.perf_counter)
            records += recs
            on += enq
    out["enqueue_ms_per_step"] = dict(off=_quartiles(off, steps),
                                      on=_quartiles(on, steps) if on else None)
    tmp = Path(tempfile.gettempdir()) / "bench_trace"
    n_prof = int(traffic["profiled_chunks"])

    def one_chunk(annotate):
        with annotate("bench.steps"):
            drv.chunk()
            sync()
        with annotate("bench.diag"):
            drv.diagnostics()

    prof = pp = None
    if on_card:
        prof = profile.run_profiled(one_chunk, n_prof,
                                    tmp / f"{name}.{seed}.json")
        if spans is not None:
            pp = program.profiled_window(drv, sync, n_prof,
                                         tmp / f"{name}.{seed}.program.json")
    drv.close()

    ops = manifest.ops_modules()
    ctx = SimpleNamespace(ops=ops, steps_per_chunk=steps, profile=prof,
                          program_spans=records, program_profile=pp)
    metrics = {}
    for reader in READERS:
        v = manifest.load_module("layers", reader).read(ctx)
        if v is not None:
            metrics[reader] = v
    out["metrics"] = metrics
    glue, idle = (manifest.load_module("layers", m)
                  for m in ("glue_ms_per_step", "device_idle_pct"))
    out["profiled"] = dict(glue_ms_per_step=glue.read(ctx),
                           device_idle_pct=idle.read(ctx))
    out["launch_spans_per_step"] = (
        sum(s.name == "repro.launch" for s in records) / (chunks * steps)
        if records else None)
    if pp is not None:
        ctx_b = SimpleNamespace(**{**vars(ctx), "profile": pp.base})
        out["program_window"] = dict(glue_ms_per_step=glue.read(ctx_b),
                                     device_idle_pct=idle.read(ctx_b))
        out.update(_coverage(pp, ops))
        out["idle_gaps"] = pp.gaps[:10]
    return out


def _quartiles(seconds: list, steps: int) -> list:
    """Quartiles of chunks' times, in ms a step."""
    return [1e3 * q / steps for q in statistics.quantiles(seconds, n=4)]


def _coverage(pp, ops: dict) -> dict:
    """Where (b)'s device time was launched: outside every program span
    (ms a chunk by kernel), and the glue's share inside one."""
    import re

    ours = [re.compile(op.PATTERN) for op in ops.values()]
    outside, glue, glue_in = {}, 0.0, 0.0
    for name, dur, phase, chain in pp.device:
        if not chain:
            outside[name] = outside.get(name, 0.0) + 1e3 * dur / pp.chunks
        if phase == "bench.steps" and not any(rx.search(name) for rx in ours):
            glue += dur
            glue_in += dur if chain else 0.0
    return dict(outside_program_ms_per_chunk=outside, unplaced=pp.unplaced,
                glue_in_program_share=glue_in / glue if glue else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--chunks", type=int, default=20)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    if not torch.cuda.is_available():
        print("trace_program: no CUDA card", file=sys.stderr)
        return 2
    r = run(args.workload, args.seed, args.chunks)
    line = json.dumps(r, allow_nan=False)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
