#!/usr/bin/env python3
"""Time the port's kernels and steps in one checkout.

Run from the root of a checkout, on one CUDA card::

    python3 chip_ab.py [--tree PATH] [--label NAME]

``--tree`` is the root of the checkout whose ``src/repro_torch`` is timed
(default: this one), so two commits are compared on one card by unpacking
one of them (``git archive``) into an ignored directory and running this
script on both in turns (A, B, B, A), each in its own process.  All
float64, on the main path's inputs:

- ``penta_cols`` at (1024, 1024), the 2D y-sweep of the fused step, and at
  (256, 65536), the 3D z-sweep (cyclic hyperdiffusion and diffusion bands);
- ``penta_rows`` at (1024, 1024), the batch1d and bootstrap x-sweep, and
  at (65536, 256), the 3D x-sweep; ``penta_mid`` at (256, 256, 256), the
  3D y-sweep;
- ``ch_rhs_xsweep`` and ``ch_rhs`` (the standalone RHS) at 1024^2;
- ``weno5_advect`` at 1024^2 (the rotating blob of
  ``examples/weno_advection.py``) and ``stencil3d`` at 256^3 (the 3D run's
  7-point Laplacian plan, through ``compute``);
- ``stencil2d`` (the solver's 5x3 weighted plan, its 3x3 cube plan and
  the stencil mode's 5x5 biharmonic plan) and ``stencil1d_batch`` (the
  ``_D4`` plan along x, and along y on the transposed view) at 1024^2;
- each a median of 20 calls (CUDA events around a call) and the mean
  device time of its kernel over 20 calls (``torch.profiler``), after 3
  of warm-up;
- the host time of one wrapper call, ``penta_rows`` and ``penta_cols`` at
  1024^2 (the batch1d step's two sweeps): 200 calls enqueued back to back,
  the host clock over them;
- where the checkout's ``kernels/penta.py`` has the knobs, the row sweep
  with a ring of 1 and of 2 row groups (``ROWS_RING``) at both shapes and
  the plane sweep with at most 8, 16 and 32 columns a block
  (``MID_MAX_COLS``), and the 3D stencil's z chunks for 1, 2 and 4
  resident grids (``WAVES`` in ``kernels/stencil3d.py``);
- ms/step of the fused, stencil-mode and batched-1D Cahn–Hilliard steps at
  1024^2 (CUDA events around 200, 50 and 50 steps after a 20-step
  warm-up), of the 3D LOD
  diffusion step at 256^3 (20 steps after 20) and of the WENO RK3 step at
  1024^2 (200 steps after 20), with the host's enqueue time per step;
  where the checkout streams rank-3 plans, the same 3D step and the
  7-point plan with ``streams=4, max_tile_bytes=20_000_000`` (8 chunks a
  sweep or z-slabs; device time summed over the chunks' launches).
  The steps run first, before any profiler session, so that every
  checkout's steps see the same process state.

Prints one JSON line with the tree, the card (name and power limit), the
times and, for each design choice, whether its output equals the
default's bit for bit.  With ``--sass NAME ...`` it prints instead the
SASS instruction counts, by opcode, of the checkout's built kernels whose
names hold one of the NAMEs (``cuobjdump -sass``); with ``--regs NAME
...`` the registers of those kernels (the ``-Xptxas=-v`` report of a
build made in this process); with ``--fused-only`` only the fused step's
ms/step, five times over 200 steps, in a fresh process (run it on both
checkouts in rotating order).  Exits non-zero without a card or when a
choice's output differs.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

from chip_smoke import band_limited_quench, device_ms, time_ms


def timed(run, carry, steps: int) -> tuple[float, float]:
    """(ms/step by CUDA events, host enqueue ms/step) of ``run(carry)``,
    one call doing ``steps`` steps; raises on a non-finite result."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    carry = run(carry)
    end.record()
    enqueue = (time.perf_counter() - t0) * 1e3 / steps
    torch.cuda.synchronize()
    field = carry[0] if isinstance(carry, tuple) else carry
    if not bool(torch.isfinite(field).all()):
        raise RuntimeError("timed run produced non-finite values")
    return start.elapsed_time(end) / steps, enqueue


def step_ms(solver, c0, steps: int) -> tuple[float, float]:
    """:func:`timed` of ``solver``'s multi-step evolve after 20 steps."""
    pair = solver.make_evolve(20)(solver.initial_step(c0), c0.clone())
    evolve = solver.make_evolve(steps)
    return timed(lambda p: evolve(*p), pair, steps)


def lod_ms(rt, op, c, steps: int) -> tuple[float, float]:
    """:func:`timed` of the 3D LOD step ``c = compute(op, c)`` over
    ``steps`` steps after as many of warm-up."""
    def run(c):
        for _ in range(steps):
            c = rt.compute(op, c)
        return c

    return timed(run, run(c), steps)


def host_ms(fn, n: int = 200) -> float:
    """Host time of one call of ``fn`` in ms: ``n`` calls enqueued back to
    back (after 3 of warm-up), the host clock over them."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    return ms


SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)")


PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
PTXAS_REGS = re.compile(r"Used (\d+) registers")


def ptxas_registers(log: str, names: tuple[str, ...]) -> dict:
    """``{kernel: registers}`` from a build's ``-Xptxas=-v`` report, for the
    kernels whose mangled name holds one of ``names``."""
    regs, kernel = {}, None
    for line in log.splitlines():
        if m := PTXAS_ENTRY.search(line):
            kernel = m.group(1) if any(n in m.group(1) for n in names) else None
        elif kernel and (m := PTXAS_REGS.search(line)):
            regs[kernel] = int(m.group(1))
    return regs


def sass_counts(lib_dir: Path, names: tuple[str, ...]) -> dict:
    """Instruction counts by opcode (its first dotted part) of each kernel
    of the built libraries in ``lib_dir`` whose mangled name holds one of
    ``names``, from ``cuobjdump -sass``: ``{kernel: {opcode: n, ...,
    'total': n}}``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts: dict = {}
    for lib in sorted(lib_dir.glob("lib*.so")):
        text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                              text=True, check=True, timeout=300).stdout
        kernel = None
        for line in text.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                kernel = name if any(n in name for n in names) else None
                if kernel:
                    counts[kernel] = {"total": 0}
            elif kernel and (m := SASS_OP.search(line)):
                op = m.group(1).split(".")[0]
                c = counts[kernel]
                c[op] = c.get(op, 0) + 1
                c["total"] += 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--label", default=None)
    ap.add_argument("--sass", metavar="NAME", nargs="+", default=None,
                    help="build, print the SASS instruction counts of the "
                    "kernels whose names hold NAME, and exit")
    ap.add_argument("--regs", metavar="NAME", nargs="+", default=None,
                    help="build, print the registers (ptxas) of the kernels "
                    "whose names hold NAME, and exit")
    ap.add_argument("--fused-only", action="store_true",
                    help="time only the fused step, five times, and exit")
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
    import repro_torch as rt
    from repro_torch.kernels import _build, ops
    from repro_torch.core.adi import apply_along_y
    from repro_torch.kernels import penta as P
    from repro_torch.kernels import stencil3d as S3
    from repro_torch.core.weno import (
        AdvectionConfig, WenoAdvection2D, gaussian_blob, solid_body_rotation,
    )

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    built = _build.build()
    if args.sass:
        print(json.dumps(dict(tree=str(tree), label=args.label, card=card,
                              sass=sass_counts(Path(built["dir"]),
                                               tuple(args.sass)))))
        return 0
    if args.regs:
        if not built["log"]:
            print("chip_ab: the kernels were built before this process; "
                  "no ptxas report", file=sys.stderr)
            return 1
        print(json.dumps(dict(tree=str(tree), label=args.label, card=card,
                              regs=ptxas_registers(built["log"],
                                                   tuple(args.regs)))))
        return 0
    if args.fused_only:
        solver = CahnHilliardADI(CHConfig(nx=1024, ny=1024, dtype="float64"))
        c0 = band_limited_quench(1024, seed=0)
        print(json.dumps(dict(tree=str(tree), label=args.label, card=card,
                              fused_ms=[step_ms(solver, c0, 200)
                                        for _ in range(5)])))
        return 0
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
    rows3 = u3.reshape(n3 * n3, n3)
    mid3 = u3.reshape(n3, n3, n3)
    lap3 = rt.create("laplacian", (n3,) * 3, bc="periodic", h=2 * math.pi / n3)
    acfg = AdvectionConfig(nx=n, ny=n)
    blob = (gaussian_blob(acfg, x0=math.pi + 1.0, y0=math.pi, sigma=0.4),
            *solid_body_rotation(acfg))
    kernels = {
        "penta_cols (1024, 1024)":
            lambda: P.cyclic_penta_solve_factored(solver.op_full.fac_y, rhs),
        "penta_cols (256, 65536)":
            lambda: P.cyclic_penta_solve_factored(fac3, u3),
        "penta_rows (1024, 1024)":
            lambda: P.cyclic_penta_solve_factored_rows(solver.op_half.fac_x, rhs),
        "penta_rows (65536, 256)":
            lambda: P.cyclic_penta_solve_factored_rows(fac3, rows3),
        "penta_mid (256, 256, 256)":
            lambda: P.cyclic_penta_solve_factored_mid(fac3, mid3),
        "ch_rhs_xsweep 1024^2":
            lambda: ops.ch_rhs_xsweep(cn, cm, solver.op_full.fac_x, **ch_kw),
        "ch_rhs 1024^2": lambda: ops.ch_rhs(cn, cm, **ch_kw),
        "weno5_advect 1024^2":
            lambda: ops.weno_advect(*blob, dx=acfg.dx, dy=acfg.dy),
        "stencil3d 256^3 (7-point)": lambda: rt.compute(lap3, mid3),
        "stencil2d 1024^2 (5x3 weighted)": lambda: solver.plan_init_a.apply(cn),
        "stencil2d 1024^2 (3x3 cube)": lambda: solver.plan_lap_cube.apply(cn),
        "stencil2d 1024^2 (5x5 biharmonic)": lambda: solver.plan_bih.apply(cn),
        "stencil1d_batch 1024^2 (_D4 along x)":
            lambda: solver.plan_d4_1d.apply(cn),
        "stencil1d_batch 1024^2 (_D4 along y)":
            lambda: apply_along_y(solver.plan_d4_1d, cn),
    }
    rows_shapes = ("penta_rows (1024, 1024)", "penta_rows (65536, 256)")
    mid = "penta_mid (256, 256, 256)"
    # (label, module, knob, value, kernel): the design choices timed in
    # turn, each output checked bit for bit against the default's
    variants = []
    if hasattr(P, "ROWS_RING"):
        variants += [(f"ring {d}", P, "ROWS_RING", d, k) for d in (1, 2)
                     for k in rows_shapes]
    if hasattr(P, "MID_MAX_COLS"):
        variants += [(f"cols {c}", P, "MID_MAX_COLS", c, mid)
                     for c in (8, 16, 32)]
    if hasattr(S3, "WAVES"):
        variants += [(f"waves {w}", S3, "WAVES", w, "stencil3d 256^3 (7-point)")
                     for w in (1, 2, 4)]
    times = {}
    c0 = band_limited_quench(n, seed=0)
    for name, s_, steps in (("fused", solver, 200),
                            ("stencil", CahnHilliardADI(CHConfig(
                                nx=n, ny=n, rhs_mode="stencil")), 50),
                            ("batch1d", CahnHilliardADI(CHConfig(
                                nx=n, ny=n, rhs_mode="batch1d")), 50)):
        ms, enq = step_ms(s_, c0, steps)
        times[f"{name} step 1024^2 (ms/step)"] = ms
        times[f"{name} step 1024^2 (host enqueue ms/step)"] = enq
    op3 = rt.create("diffusion", (n3,) * 3, mode="adi", alpha=r3, cyclic=True)
    ms, enq = lod_ms(rt, op3, mid3.clone(), 20)
    times["3D LOD step 256^3 (ms/step)"] = ms
    times["3D LOD step 256^3 (host enqueue ms/step)"] = enq
    knobs3 = dict(streams=4, max_tile_bytes=20_000_000)
    try:
        op3s = rt.create("diffusion", (n3,) * 3, mode="adi", alpha=r3,
                         cyclic=True, **knobs3)
        lap3s = rt.create("laplacian", (n3,) * 3, bc="periodic",
                          h=2 * math.pi / n3, **knobs3)
    except NotImplementedError:  # a checkout without 3D streaming
        op3s = None
    if op3s is not None:
        ms, enq = lod_ms(rt, op3s, mid3.clone(), 20)
        times["3D LOD step 256^3 streamed (ms/step)"] = ms
        times["3D LOD step 256^3 streamed (host enqueue ms/step)"] = enq
        kernels.update({
            "stencil3d 256^3 (7-point) in 8 z-slabs":
                lambda: rt.compute(lap3s, mid3),
            "penta_rows (65536, 256) in 8 row chunks":
                lambda: op3s.solve_x(mid3),
            "penta_mid (256, 256, 256) in 8 plane chunks":
                lambda: op3s.solve_y(mid3),
            "penta_cols (256, 65536) in 8 column chunks":
                lambda: op3s.solve_z(mid3),
        })
    weno = WenoAdvection2D(acfg)
    dt_w = weno.dt_cfl(*blob[1:])

    def weno_steps(steps):
        def run(q):
            q, done = weno.run(q, *blob[1:], (steps - 0.5) * dt_w, dt=dt_w)
            assert done == steps
            return q
        return run

    ms, enq = timed(weno_steps(200), weno_steps(20)(blob[0]), 200)
    times["WENO RK3 step 1024^2 (ms/step)"] = ms
    times["WENO RK3 step 1024^2 (host enqueue ms/step)"] = enq
    for name in ("penta_rows (1024, 1024)", "penta_cols (1024, 1024)"):
        times[f"{name}, host"] = host_ms(kernels[name])
    for name, fn in kernels.items():
        times[f"{name}, events"] = time_ms(fn)
        times[f"{name}, device"] = device_ms(fn)
    def set_knob(module, knob, value):
        # the module's cached geometries read the knob: forget them
        setattr(module, knob, value)
        for obj in vars(module).values():
            if hasattr(obj, "cache_clear"):
                obj.cache_clear()

    same = {}
    for label, module, knob, value, name in variants:
        kept = getattr(module, knob)
        want = kernels[name]()
        set_knob(module, knob, value)
        try:
            times[f"{name} {label}, device"] = device_ms(kernels[name])
            same[f"{name} {label}"] = bool(torch.equal(kernels[name](), want))
        finally:
            set_knob(module, knob, kept)
    print(json.dumps(dict(tree=str(tree), label=args.label, card=card,
                          device=torch.cuda.get_device_name(0),
                          torch=torch.__version__, ms=times,
                          variant_equal_to_default=same)))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
