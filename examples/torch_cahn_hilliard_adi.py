"""Cahn–Hilliard ADI end-to-end driver on the PyTorch port (the port of
``examples/cahn_hilliard_adi.py``, the paper's §V "cuCahnPentADI"; same
arguments and printed quantities).

Runs the deep-quench coarsening experiment and reports s(t) and 1/k1(t)
with their fitted power-law exponents (paper Fig. 1 expects ~t^{1/3}).  A
registry-operator Laplacian plan computes the chemical potential
mu = C^3 - C - gamma grad^2 C before and after the run (max|grad^2 mu|
shrinking is coarsening made visible).  From the white-noise initial
condition the eq. 3 bootstrap overflows at the default ``--n 256``
(dt 2e-3) and above, and the run ends in NaN, as the reference script's
does (ROADMAP.md, Faults); ``--n 128`` stays finite to t = 8.

    PYTHONPATH=src python examples/torch_cahn_hilliard_adi.py --n 128
    PYTHONPATH=src python examples/torch_cahn_hilliard_adi.py --n 64 --t 0.3 --device cpu
"""

import argparse
import time

import numpy as np

import repro_torch as rt
from repro_torch.core.cahn_hilliard import (
    CahnHilliardADI,
    CHConfig,
    coarsening_metrics,
    deep_quench_ic,
)
from repro_torch.core.metrics import fit_power_law


def chemical_potential(lap_plan, c, gamma):
    """mu = C^3 - C - gamma grad^2 C via one facade Compute call."""
    return c**3 - c - gamma * rt.compute(lap_plan, c)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--t", type=float, default=8.0, help="final time")
    ap.add_argument("--dt", type=float, default=2e-3)
    ap.add_argument(
        "--rhs", choices=["fused", "stencil", "batch1d"], default="fused"
    )
    ap.add_argument(
        "--tune", choices=["off", "cached", "force"], default="off",
        help="Create-time autotuning (not ported: only 'off' runs)",
    )
    ap.add_argument(
        "--retune", action="store_true",
        help="force re-measurement of the tuner (not ported)",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    if args.retune and args.tune == "off":
        args.tune = "cached"

    cfg = CHConfig(
        nx=args.n, ny=args.n, dt=args.dt, D=0.6, gamma=0.01,
        rhs_mode=args.rhs, backend="auto", tune=args.tune, device=args.device,
    )
    solver = CahnHilliardADI(cfg)
    c0 = deep_quench_ic(args.n, args.n, seed=args.seed, device=args.device)
    n_steps = int(args.t / args.dt)
    save_every = max(n_steps // 16, 1)

    # Create: a registry-operator Laplacian for the mu diagnostic
    lap = rt.create("laplacian", (args.n, args.n), h=cfg.dx, backend="auto",
                    device=args.device)
    mu0 = float(rt.compute(lap, chemical_potential(lap, c0, cfg.gamma))
                .abs().max())

    print(f"# Cahn-Hilliard {args.n}^2, dt={args.dt}, {n_steps} steps, "
          f"rhs={args.rhs}")
    print("# t, s(t), 1/k1(t), F(t), mass")
    t0 = time.time()
    c_final, hist = solver.run(
        c0, n_steps, save_every=save_every, metrics_fn=coarsening_metrics(cfg)
    )
    wall = time.time() - t0
    for step, (s, invk1, F, m) in hist:
        print(f"{step*cfg.dt:8.3f} {float(s):10.5f} {float(invk1):10.5f} "
              f"{float(F):10.5f} {float(m):+.3e}")

    t = np.array([h[0] for h in hist], float)[len(hist) // 3 :] * cfg.dt
    s = np.array([float(h[1][0]) for h in hist])[len(hist) // 3 :]
    k = np.array([float(h[1][1]) for h in hist])[len(hist) // 3 :]
    print(f"# power-law fits (expect ~1/3): "
          f"s-1 ~ t^{fit_power_law(t, s - 1):.3f}, "
          f"1/k1 ~ t^{fit_power_law(t, k):.3f}")
    print(f"# wall: {wall:.1f}s  ({wall/n_steps*1e3:.2f} ms/step)")
    mu1 = float(rt.compute(lap, chemical_potential(lap, c_final, cfg.gamma))
                .abs().max())
    print(f"# max|grad^2 mu|: {mu0:.3e} -> {mu1:.3e} "
          f"(the flux divergence dying out as domains coarsen)")
    rt.destroy(lap)


if __name__ == "__main__":
    main()
