#!/usr/bin/env python3
"""Readings that the limits of ``correct`` are set from, on the card.

    python3 bench/calibrate.py --workload ch2d.fused.4096 --seconds 2 \\
        --seeds 11,12,13 --control-seeds 21,22,23 --out readings.json

For each seed of ``--seeds`` one run of the program, and for each of
``--control-seeds`` one run of the control (the configuration's reference
in the precision below its own, in the program's place), all in one
process and each with a short window at the cell's own sizes.  Prints one
line a run and writes every number compared to ``--out``.  The
benchmark's own runs do not run this.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", type=Path, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench.harness.cell import run_cell
    from bench.harness.spans import Spans

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    runs = []
    plan = ([(int(s), False) for s in args.seeds.split(",") if s]
            + [(int(s), True) for s in args.control_seeds.split(",") if s])
    for seed, control in plan:
        r = run_cell(args.workload, seed, args.seconds, False, spans=Spans(),
                     control=control)
        row = dict(seed=seed, control=control, correct=r["correct"],
                   attempted=r["attempted"],
                   checks={k: c["value"] for k, c in r["checks"].items()})
        runs.append(row)
        print(json.dumps(row), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(workload=args.workload, runs=runs),
                                   indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
