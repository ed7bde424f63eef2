#!/usr/bin/env python3
"""Time the port's column sweep, fused x-sweep and 2D steps in one checkout.

Run from the root of a checkout, on one CUDA card::

    python3 chip_ab.py [--tree PATH] [--label NAME]

``--tree`` is the root of the checkout whose ``src/repro_torch`` is timed
(default: this one), so two commits are compared on one card by unpacking
one of them (``git archive``) into an ignored directory and running this
script on both in turns (A, B, B, A), each in its own process.  All
float64, on the main path's inputs:

- ``penta_cols`` at (1024, 1024), the 2D y-sweep of the fused step, and at
  (256, 65536), the 3D z-sweep (cyclic hyperdiffusion and diffusion bands);
- ``ch_rhs_xsweep`` at 1024^2;
- each a median of 20 calls (CUDA events around a call) and the mean
  device time of its kernel over 20 calls (``torch.profiler``), after 3
  of warm-up;
- ms/step of the fused and batched-1D Cahn–Hilliard steps at 1024^2 (CUDA
  events around 200 and 50 steps after a 20-step warm-up).

Prints one JSON line with the tree, the card (name and power limit) and
the times.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

from chip_smoke import band_limited_quench, device_ms, time_ms


def step_ms(solver, c0, steps: int) -> float:
    """ms/step of ``solver``'s multi-step driver (CUDA events)."""
    import torch

    pair = solver.make_evolve(20)(solver.initial_step(c0), c0.clone())
    evolve = solver.make_evolve(steps)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    pair = evolve(*pair)
    end.record()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(pair[0]).all()):
        raise RuntimeError("timed run produced non-finite values")
    return start.elapsed_time(end) / steps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device available", file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.core.cahn_hilliard import (
        CahnHilliardADI, CHConfig, deep_quench_ic,
    )
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import penta as P

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    _build.build()
    n = 1024
    cfg = CHConfig(nx=n, ny=n, dtype="float64")
    solver = CahnHilliardADI(cfg)
    ch_kw = dict(dt=cfg.dt, D=cfg.D, gamma=cfg.gamma, inv_h2=solver.inv_h2,
                 inv_h4=solver.inv_h4)
    cn, cm = (deep_quench_ic(n, n, seed=s) for s in (1, 2))
    rhs = deep_quench_ic(n, n, seed=3)
    n3 = 256
    r3 = 0.5 * 2e-3 / (2.0 * math.pi / n3) ** 2  # examples/diffusion3d_adi.py
    fac3 = P.cyclic_penta_factor(*P.diffusion_diagonals(n3, r3), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(6)
    u3 = torch.rand((n3, n3 * n3), generator=g, device="cuda",
                    dtype=torch.float64) * 2 - 1
    kernels = {
        "penta_cols (1024, 1024)":
            lambda: P.cyclic_penta_solve_factored(solver.op_full.fac_y, rhs),
        "penta_cols (256, 65536)":
            lambda: P.cyclic_penta_solve_factored(fac3, u3),
        "ch_rhs_xsweep 1024^2":
            lambda: ops.ch_rhs_xsweep(cn, cm, solver.op_full.fac_x, **ch_kw),
    }
    times = {}
    for name, fn in kernels.items():
        times[f"{name}, events"] = time_ms(fn)
        times[f"{name}, device"] = device_ms(fn)
    c0 = band_limited_quench(n, seed=0)
    times["fused step 1024^2 (ms/step)"] = step_ms(solver, c0, 200)
    b1d = CahnHilliardADI(CHConfig(nx=n, ny=n, rhs_mode="batch1d"))
    times["batch1d step 1024^2 (ms/step)"] = step_ms(b1d, c0, 50)
    print(json.dumps(dict(tree=str(tree), label=args.label, card=card,
                          device=torch.cuda.get_device_name(0),
                          torch=torch.__version__, ms=times)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
