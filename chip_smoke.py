#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

Run from the root of a checkout::

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero without
printing a result:

1. Card: name and power limit (``nvidia-smi``), torch and CUDA versions.
2. Build: the CUDA kernels from ``src/repro_torch/kernels/csrc`` (nvcc,
   one process per source, started together); build seconds.
3. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes (1024x1024 float64), at a ragged shape (1021x1019) and in
   float32; each with its max abs error against the stated tolerance, its
   time (CUDA events, median of 20 launches), its bound and a library
   call as a yardstick the port never calls: circular-padded
   ``F.conv2d`` for the weighted periodic stencil, ``torch.linalg.lu_solve``
   on a dense LU of the cyclic band for the two sweeps.
4. Main path: the 1024x1024 float64 Cahn–Hilliard solver, bootstrap plus
   20 steps through ``ch_evolve`` from a band-limited deep quench, in
   ``rhs_mode='fused'`` on the kernels (launch counts asserted) and on the
   plain versions (``backend='torch'``), and in ``rhs_mode='stencil'``;
   fields compared, finite, mass conserved.  Then, as an observation that
   fails nothing, the same run from the full-resolution deep quench.
5. Timing: ms/step over 200 fused steps after 20 steps of warm-up (host
   clock, CUDA events, and the host's enqueue time per step).
6. The ``kernels`` JSON line, the card line, and the result line.

A full record goes to ``chiprun_out/chip_smoke.json`` and the nvcc log to
``chiprun_out/nvcc_build.log``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

N_MAIN = 1024
RAGGED = (1021, 1019)
N_STEPS = 20
N_TIMED = 200

# Published H100 SXM peaks, from NVIDIA's H100 SXM data sheet: HBM3
# bandwidth, float32 and float64 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}

# Tolerances, as tolerance_for(dtype, scale) held norm-wise:
#   max|kernel - plain| <= atol + rtol * max|plain|.
# stencil2d: one pass of <= 25 products; FMA contraction and summation
#   order move each output by a few ulp of the largest term -> scale 10.
# penta_*: a serial recurrence over M = 1024 steps forward and back; the
#   kernel's FMAs round each step differently and the difference is carried
#   through L^{-1} and U^{-1} (cond(L) <= 1 + 16 beta, about 4.5e4 here)
#   -> scale 100.
# ch_rhs_xsweep: the RHS weights the biharmonic by k_bih ~ 2.8e3 at 1024^2,
#   but max|plain| already carries that factor, so only the recurrence's
#   own rounding is left (relative to max|plain|, the same ~3e-6 in float32
#   as penta_*) -> scale 10, which keeps the float32 limit (0.26 at 1024^2)
#   under what the nonlinear term k_lap * lap(c^3 - c) adds after the
#   x-solve, so a kernel that dropped it fails.
# Main path: 21 steps each within the fused tolerance -> scale 21 * 10.
SCALE = {"stencil2d": 10, "penta_rows": 100, "penta_cols": 100,
         "ch_rhs_xsweep": 10}
SCALE_MAIN = (N_STEPS + 1) * SCALE["ch_rhs_xsweep"]
MASS_DRIFT_MAX = 1e-10

KERNEL_INFO = {
    "ch_rhs_xsweep": ("src/repro_torch/kernels/csrc/fused_ch.cu",
                      "src/repro/kernels/fused_ch.py:199"),
    "penta_cols": ("src/repro_torch/kernels/csrc/penta.cu",
                   "src/repro/kernels/penta.py:298"),
    "penta_rows": ("src/repro_torch/kernels/csrc/penta.cu",
                   "src/repro/kernels/penta.py:375"),
    "stencil2d": ("src/repro_torch/kernels/csrc/stencil2d.cu",
                  "src/repro/kernels/stencil2d.py:153"),
}


class PhaseError(RuntimeError):
    pass


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def band_limited_quench(n: int, *, seed: int, modes: int = 64):
    """The paper's deep-quench IC drawn on a ``modes`` x ``modes`` grid and
    carried onto ``n`` x ``n`` with its spectrum zero-padded.

    The eq. 3 bootstrap treats delta_y^4 explicitly in its first half step,
    so a mode with k_x = 0 grows by up to 1 + 16 beta_half (about 3.4e4 at
    1024^2, dt = 1e-3) before the y-solve divides it back; the cubic term
    evaluated on that intermediate field then overflows (phase 4 shows
    it; the reference grows the same noise alike at 192^2, ROADMAP.md,
    Faults).  A field without grid-scale modes
    keeps the bootstrap finite, and the run stays in the paper's regime:
    amplitude ~0.1 noise resolved at 64^2."""
    import torch
    from repro_torch.core.cahn_hilliard import deep_quench_ic

    spec = torch.fft.rfft2(deep_quench_ic(modes, modes, seed=seed))
    big = torch.zeros((n, n // 2 + 1), dtype=spec.dtype, device=spec.device)
    h = modes // 2
    big[:h, : h + 1] = spec[:h, : h + 1]
    big[-h:, : h + 1] = spec[-h:, : h + 1]
    return torch.fft.irfft2(big, s=(n, n)) * (n * n) / (modes * modes)


def time_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch as rt
    from repro_torch.core.cahn_hilliard import (
        CahnHilliardADI, CHConfig, ch_evolve, deep_quench_ic,
    )
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import penta as P
    from repro_torch.kernels.ref import penta_dense_cyclic
    from repro_torch.util import tolerance_for

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(exist_ok=True)
    record: dict = {}

    # -- 1. card -------------------------------------------------------------
    card = card_line()
    record["card"] = card
    record["versions"] = dict(torch=torch.__version__, cuda=torch.version.cuda,
                              python=sys.version.split()[0])
    print(f"[card] {card} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}", flush=True)

    # -- 2. build ------------------------------------------------------------
    info = _build.build()
    (OUT / "nvcc_build.log").write_text(info["log"])
    record["build_seconds"] = info["seconds"]
    print(f"[build] {info['seconds']:.1f} s -> {info['dir']}", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or (
                "spill" in line and "0 bytes spill stores, 0 bytes spill loads"
                not in line):
            print(f"[build]   {line.strip()}")
    smem, sms = _build.device_info(torch.device("cuda"))
    print(f"[build] opt-in shared memory {smem} B per block, {sms} SMs")

    # -- 3. kernels against their plain versions -----------------------------
    dev = torch.device("cuda")
    cfg = CHConfig(nx=N_MAIN, ny=N_MAIN, dtype="float64")
    solver = CahnHilliardADI(cfg)
    beta_full = (2.0 / 3.0) * cfg.D * cfg.gamma * cfg.dt / cfg.dx**4
    beta_half = 0.5 * cfg.D * cfg.gamma * cfg.dt / cfg.dx**4
    ch_kw = dict(dt=cfg.dt, D=cfg.D, gamma=cfg.gamma, inv_h2=solver.inv_h2,
                 inv_h4=solver.inv_h4)
    plans = {
        "init_a 5x3": solver.plan_init_a,
        "init_b 3x5": solver.plan_init_b,
        "lap_cube 3x3 fn": solver.plan_lap_cube,
        "bih 5x5": solver.plan_bih,
    }

    def fields(ny, nx, dtype, seeds=(1, 2)):
        return [deep_quench_ic(ny, nx, seed=s, dtype=dtype) for s in seeds]

    def stencil_call(plan, data, out_init=None, bc="periodic"):
        def run(backend):
            return ops.stencil_apply(
                data, plan.coeffs.to(data.dtype), out_init,
                point_fn=plan.point_fn, bc=bc, backend=backend,
                **plan._halo_kwargs(),
            )
        return run

    cases = []  # (kernel, label, dtype, run(backend))
    for dtype, (ny, nx), tag in (("float64", (N_MAIN, N_MAIN), "main"),
                                 ("float64", RAGGED, "ragged"),
                                 ("float32", (N_MAIN, N_MAIN), "f32")):
        cn, cm = fields(ny, nx, dtype)
        rhs = (torch.rand((ny, nx), generator=torch.Generator().manual_seed(3),
                          dtype=torch.float64) * 2 - 1).to(dev, getattr(torch, dtype))
        op = rt.create("hyperdiffusion", (ny, nx), mode="adi", alpha=beta_full,
                       dtype=dtype)
        for name, plan in plans.items():
            if tag != "main" and name == "bih 5x5":
                continue
            cases.append(("stencil2d", f"{name} periodic {tag}", dtype,
                          stencil_call(plan, cn)))
        if tag != "f32":
            init = torch.full_like(cn, 7.0)
            cases.append(("stencil2d", f"init_a 5x3 np+out_init {tag}", dtype,
                          stencil_call(solver.plan_init_a, cn, init, "np")))
            cases.append(("stencil2d", f"lap_cube 3x3 fn np {tag}", dtype,
                          stencil_call(solver.plan_lap_cube, cn, None, "np")))
        cases.append(("penta_rows", f"cyclic rows {tag}", dtype,
                      lambda b, op=op, r=rhs: P.cyclic_penta_solve_factored_rows(
                          op.fac_x, r, backend=b)))
        cases.append(("penta_rows", f"plain-band rows {tag}", dtype,
                      lambda b, op=op, r=rhs: P.penta_solve_factored_rows(
                          op.fac_x.band, r, backend=b)))
        cases.append(("penta_cols", f"cyclic cols {tag}", dtype,
                      lambda b, op=op, r=rhs: P.cyclic_penta_solve_factored(
                          op.fac_y, r, backend=b)))
        cases.append(("penta_cols", f"plain-band cols {tag}", dtype,
                      lambda b, op=op, r=rhs: P.penta_solve_factored(
                          op.fac_y.band, r, backend=b)))
        cases.append(("ch_rhs_xsweep", f"fused {tag}", dtype,
                      lambda b, op=op, cn=cn, cm=cm: ops.ch_rhs_xsweep(
                          cn, cm, op.fac_x, backend=b, **ch_kw)))

    checks, failures = [], []
    for kernel, label, dtype, run in cases:
        got = run("cuda")
        want = run("torch")
        torch.cuda.synchronize()
        tol = tolerance_for(dtype, scale=SCALE[kernel])
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        limit = tol["atol"] + tol["rtol"] * scale
        ok = bool(torch.isfinite(got).all()) and err <= limit
        checks.append(dict(kernel=kernel, label=label, dtype=dtype,
                           max_abs_err=err, limit=limit, max_abs_ref=scale,
                           ok=ok))
        print(f"[check] {'ok ' if ok else 'BAD'} {kernel:14s} {label:32s} "
              f"max|err| {err:.3e} <= {limit:.3e} (max|ref| {scale:.3e})",
              flush=True)
        if not ok:
            failures.append(f"{kernel} {label}")
    record["checks"] = checks
    if failures:
        (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
        raise PhaseError(f"kernels disagree with their plain versions: {failures}")

    # timings at the main path's shapes (float64)
    cn, cm = fields(N_MAIN, N_MAIN, "float64")
    rhs = deep_quench_ic(N_MAIN, N_MAIN, seed=3)
    N = N_MAIN * N_MAIN
    isz = 8
    n_fac = 9 * N_MAIN * isz  # five factors and the (M, 4) Woodbury matrix
    a = solver.plan_init_a
    taps = a.num_sten
    timed = {
        "stencil2d": (stencil_call(a, cn), 2 * N * isz, (2 * taps - 1) * N),
        "penta_rows": (
            lambda b: P.cyclic_penta_solve_factored_rows(
                solver.op_half.fac_x, rhs, backend=b),
            2 * N * isz + n_fac, 17 * N),
        "penta_cols": (
            lambda b: P.cyclic_penta_solve_factored(
                solver.op_full.fac_y, rhs, backend=b),
            2 * N * isz + n_fac, 17 * N),
        "ch_rhs_xsweep": (
            lambda b: ops.ch_rhs_xsweep(cn, cm, solver.op_full.fac_x,
                                        backend=b, **ch_kw),
            3 * N * isz + n_fac, 64 * N),
    }
    timings = {}
    for kernel, (run, nbytes, flops) in timed.items():
        ms = time_ms(lambda run=run: run("cuda"))
        plain_ms = time_ms(lambda run=run: run("torch"), n=5, warmup=1)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["float64"] * 1e3
        timings[kernel] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            bytes=nbytes, flops=flops, library_ms=None,
        )
    # yardstick for the weighted periodic stencil: circular pad + conv2d
    w_box = a.coeffs.reshape(a.top + a.bottom + 1, a.left + a.right + 1)

    def conv():
        x = torch.nn.functional.pad(
            cn[None, None], (a.left, a.right, a.top, a.bottom), mode="circular")
        return torch.nn.functional.conv2d(x, w_box[None, None])[0, 0]

    # yardstick for the sweeps: a dense LU of the cyclic band, factored
    # outside the timed window; lu_solve(left=False) solves X A^T = rhs,
    # i.e. A x = r for every row r of rhs (row layout).
    def dense_lu(beta, transpose=False):
        A = penta_dense_cyclic(*(torch.as_tensor(d, device=dev) for d in
                                 P.hyperdiffusion_diagonals(N_MAIN, beta)))
        return torch.linalg.lu_factor(A.mT if transpose else A)

    lu_cols = dense_lu(beta_full)
    lu_rows = dense_lu(beta_half, transpose=True)
    lib = {
        "penta_cols": lambda: torch.linalg.lu_solve(*lu_cols, rhs),
        "penta_rows": lambda: torch.linalg.lu_solve(*lu_rows, rhs, left=False),
    }
    lib_err = {}
    for kernel, fn in lib.items():
        lib_err[kernel] = float((fn() - timed[kernel][0]("cuda")).abs().max())
        timings[kernel]["library_ms"] = time_ms(fn)
    # the step's elementwise glue, c_{n+1} = 2 c_n - c_{n-1} + v, in place
    buf = cm.clone()
    timings["glue"] = dict(ms=time_ms(
        lambda: buf.neg_().add_(cn, alpha=2.0).add_(rhs)))
    conv_err = float((conv() - stencil_call(a, cn)("cuda")).abs().max())
    timings["stencil2d"]["library_ms"] = time_ms(conv)
    record["timings"] = timings
    for kernel, t in timings.items():
        if kernel == "glue":
            print(f"[time] step glue (3 in-place torch ops) {t['ms']:.4f} ms")
            continue
        lib = "" if t["library_ms"] is None else f" library {t['library_ms']:.4f} ms"
        print(f"[time] {kernel:14s} {t['ms']:.4f} ms (plain {t['plain_ms']:.3f} ms, "
              f"bound {t['bound_ms']:.4f} ms by {t['bound_by']}){lib}")
    print(f"[time] conv2d yardstick agrees with stencil2d to {conv_err:.2e}")
    for kernel, e in lib_err.items():
        print(f"[time] lu_solve yardstick agrees with {kernel} to {e:.2e}")
    record["library_max_abs_diff"] = dict(lib_err, stencil2d=conv_err)

    # -- 4. main path --------------------------------------------------------
    c0 = band_limited_quench(N_MAIN, seed=0)
    m0, a0 = float(c0.sum()), float(c0.abs().sum())

    def counts_of(fn):
        _build.reset_launches()
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
        return out, dict(_build.LAUNCHES)

    def expect(got, want, what):
        if got != want:
            raise PhaseError(f"{what}: launches {got}, expected {want}")

    _, n_boot = counts_of(lambda: solver.initial_step(c0))
    expect(n_boot, dict(stencil2d=4, penta_cols=1, penta_rows=1,
                        ch_rhs_xsweep=0), "bootstrap")
    _, n_step = counts_of(lambda: solver.step(c0, c0))
    expect(n_step, dict(stencil2d=0, penta_cols=1, penta_rows=0,
                        ch_rhs_xsweep=1), "fused step")

    t0 = time.perf_counter()
    (c_fused, _), main_launches = counts_of(lambda: ch_evolve(solver, c0, N_STEPS))
    main_s = time.perf_counter() - t0
    expect(main_launches, dict(stencil2d=4, penta_cols=1 + N_STEPS, penta_rows=1,
                               ch_rhs_xsweep=N_STEPS), "main path (fused)")
    print(f"[main] fused: bootstrap + {N_STEPS} steps in {main_s:.3f} s, "
          f"launches {main_launches}", flush=True)

    plain = CahnHilliardADI(CHConfig(nx=N_MAIN, ny=N_MAIN, backend="torch"))
    (c_plain, _), n_plain = counts_of(lambda: ch_evolve(plain, c0, N_STEPS))
    expect(n_plain, dict.fromkeys(main_launches, 0), "backend='torch' run")

    stencil = CahnHilliardADI(CHConfig(nx=N_MAIN, ny=N_MAIN, rhs_mode="stencil"))
    (c_sten, _), n_sten = counts_of(lambda: ch_evolve(stencil, c0, N_STEPS))
    expect(n_sten, dict(stencil2d=4 + 2 * N_STEPS, penta_cols=1 + N_STEPS,
                        penta_rows=1 + N_STEPS, ch_rhs_xsweep=0),
           "rhs_mode='stencil' run")

    tol = tolerance_for("float64", scale=SCALE_MAIN)
    main_checks = {}
    for name, other in (("fused kernels vs plain", c_plain),
                        ("stencil vs fused", c_sten)):
        err = float((c_fused - other).abs().max())
        limit = tol["atol"] + tol["rtol"] * float(other.abs().max())
        main_checks[name] = dict(max_abs_err=err, limit=limit)
        print(f"[main] {name}: max|diff| {err:.3e} <= {limit:.3e}")
        if not err <= limit:
            raise PhaseError(f"main path: {name} differ by {err:.3e}")
    for name, c in (("fused", c_fused), ("stencil", c_sten), ("plain", c_plain)):
        if tuple(c.shape) != (N_MAIN, N_MAIN) or not bool(torch.isfinite(c).all()):
            raise PhaseError(f"main path ({name}): bad field")
        drift = abs(float(c.sum()) - m0) / a0
        main_checks[f"mass drift {name}"] = drift
        print(f"[main] {name}: relative mass drift {drift:.3e} "
              f"(|sum c - sum c0| / sum|c0|) <= {MASS_DRIFT_MAX:.0e}")
        if not drift <= MASS_DRIFT_MAX:
            raise PhaseError(f"main path ({name}): mass drift {drift:.3e}")
    record["main"] = dict(launches=main_launches, seconds=main_s, **main_checks)

    # observation: the full-resolution deep quench through the same path
    c_deep = deep_quench_ic(N_MAIN, N_MAIN, seed=0)
    boot = solver.initial_step(c_deep)
    c_end, _ = ch_evolve(solver, c_deep, N_STEPS)
    deep = dict(boot_max_abs=float(boot.abs().max()),
                end_max_abs=float(c_end.abs().nan_to_num(float("inf")).max()),
                end_finite=bool(torch.isfinite(c_end).all()))
    record["main"]["full_resolution_deep_quench"] = deep
    print(f"[main] full-resolution deep quench (not checked): max|c| "
          f"{deep['boot_max_abs']:.3e} after the bootstrap, "
          f"{deep['end_max_abs']:.3e} after {N_STEPS} steps, finite "
          f"{deep['end_finite']}")

    # -- 5. timing -----------------------------------------------------------
    pair = (solver.initial_step(c0), c0.clone())
    pair = solver.make_evolve(N_STEPS)(*pair)
    evolve = solver.make_evolve(N_TIMED)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    pair = evolve(*pair)
    end.record()
    t_enqueued = time.perf_counter()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / N_TIMED
    enqueue_ms = (t_enqueued - t0) * 1e3 / N_TIMED
    dev_ms = start.elapsed_time(end) / N_TIMED
    if not bool(torch.isfinite(pair[0]).all()):
        raise PhaseError("timed run produced non-finite values")
    record["ms_per_step"] = dict(host=host_ms, events=dev_ms,
                                 host_enqueue=enqueue_ms, steps=N_TIMED)
    print(f"[time] fused step at {N_MAIN}^2 float64: {host_ms:.4f} ms/step "
          f"(host clock), {dev_ms:.4f} ms/step (CUDA events), host enqueue "
          f"{enqueue_ms:.4f} ms/step; {N_TIMED} steps after {N_STEPS} warm-up")

    # -- 6. result lines -----------------------------------------------------
    kernels = []
    for name in ("ch_rhs_xsweep", "penta_cols", "penta_rows", "stencil2d"):
        source, replaces = KERNEL_INFO[name]
        t = timings[name]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=main_launches[name],
            max_abs_err=max(c["max_abs_err"] for c in checks
                            if c["kernel"] == name and "main" in c["label"]),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"],
        ))
    record["kernels"] = kernels
    (OUT / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
