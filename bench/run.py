#!/usr/bin/env python3
"""Run one cell of the benchmark of ``repro_torch`` once, on the card.

    python3 bench/run.py --workload ch2d.fused.4096 --seed 7 --seconds 10 --trace 0

from the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; then ``checks``, each number that
decides ``correct`` beside its limit, which also end standard error.

The run fails (a non-zero exit, no result) without a CUDA card, with
fewer cards than the cell asks for, when the checkout lacks the program,
and when the process has loaded ``jax``, ``jaxlib``, ``flax`` or the JAX
package ``repro`` (compared as whole top-level names).  The kernels build
into ``build/repro_torch/`` inside the checkout on the first run there;
every other cache the run could write goes under ``build/bench/``.  The
benchmark's own spans (set-up phases, and each chunk's enqueue,
synchronise and diagnostics) are written to ``$TMPDIR/bench_spans/``.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _caches() -> None:
    cache = ROOT / "build" / "bench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache"),
                     ("REPRO_TUNE_CACHE", "tune")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.harness import manifest
    from bench.harness.spans import Spans

    try:
        entry = manifest.cell_entry(manifest.load(ROOT), args.workload)
    except (OSError, KeyError, ValueError) as exc:
        print(f"bench: {exc}", file=sys.stderr)
        return 2
    spans = Spans(T0)
    with spans("import"):
        import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("bench: no CUDA card; the benchmark runs only on one",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(entry["chips"]):
        print(f"bench: the cell asks for {entry['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2

    from bench.harness.cell import run_cell

    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), spans=spans)
    except Exception:  # noqa: BLE001 - the run's boundary: report and fail
        traceback.print_exc()
        return 1
    loaded = manifest.forbidden_loaded(sys.modules)
    if loaded:
        print(f"bench: the run loaded {', '.join(loaded)}; no result",
              file=sys.stderr)
        return 3
    from bench.harness.cell import passes

    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if passes(c) else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
