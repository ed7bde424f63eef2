"""3D diffusion via ADI splitting on the PyTorch port (the port of
``examples/diffusion3d_adi.py``, the §VI.A extension; same arguments and
printed quantities, plus ``--backend`` and ``--device``).

Solves  dC/dt = D grad^2 C  on a periodic box with a locally-one-dimensional
(LOD) backward-Euler splitting: each step applies the three factored
one-dimensional implicit operators in sequence,

    C <- L_z^{-1} L_y^{-1} L_x^{-1} C,     L_i = I - (D dt / h^2) delta_i^2,

through ``repro_torch.create(..., mode='adi')`` and ``repro_torch.compute``.
With ``--backend auto`` the sweeps are the pentadiagonal substitutions (on
the card: ``penta_rows``, ``penta_mid``, ``penta_cols``) and the diagnostic
7-point Laplacian is the ``stencil3d`` kernel; with ``--backend fft`` both
the operator and the Laplacian plan run the spectral path (a divide by each
band's symbol, a multiply by the stencil's).

On the separable mode C0 = sin(x) sin(y) sin(z) every sweep acts
diagonally, so the scheme's per-step decay factor is exactly

    g = prod_i 1 / (1 + 4 r sin^2(k h / 2)),     r = D dt / h^2,

which the driver checks against the observed field and compares with the
continuum exp(-3 D k^2 t).

    PYTHONPATH=src python examples/torch_diffusion3d_adi.py
    PYTHONPATH=src python examples/torch_diffusion3d_adi.py --n 64 --steps 200 --backend fft
    PYTHONPATH=src python examples/torch_diffusion3d_adi.py --max-tile-kb 64  # stream
"""

import argparse
import time

import numpy as np
import torch

import repro_torch as rt


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32, help="grid points per axis")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--dt", type=float, default=2e-3)
    ap.add_argument("--D", type=float, default=0.5)
    ap.add_argument(
        "--tune", choices=["off", "cached", "force"], default="off",
        help="Create-time autotuning of the sweeps (not ported: only 'off' "
        "runs)",
    )
    ap.add_argument(
        "--retune", action="store_true",
        help="force re-measurement of the tuner (not ported)",
    )
    ap.add_argument(
        "--max-tile-kb", type=int, default=None,
        help="per-chunk byte budget: stream the stencil and sweeps as "
        "z-slab / plane chunks instead of monolithic calls",
    )
    ap.add_argument(
        "--backend", choices=["auto", "fft"], default="auto",
        help="'auto': the penta sweeps and the stencil kernel; 'fft': the "
        "spectral path for both",
    )
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)

    n = args.n
    h = 2.0 * np.pi / n
    r = args.D * args.dt / h**2
    mtb = args.max_tile_kb * 1024 if args.max_tile_kb else None

    # Create: factor the three implicit operators once
    op = rt.create(
        "diffusion", (n, n, n), mode="adi", alpha=r, cyclic=True,
        backend=args.backend, max_tile_bytes=mtb,
        tune="cached" if args.retune else args.tune, device=args.device,
    )
    # Create: the explicit Laplacian plan (diagnostics), same knobs
    lap = rt.create(
        "laplacian", (n, n, n), bc="periodic", h=h, backend=args.backend,
        max_tile_bytes=mtb, device=args.device,
    )

    x = np.arange(n) * h
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    c = torch.as_tensor(np.sin(X) * np.sin(Y) * np.sin(Z), device=args.device)
    amp0 = float(c.abs().max())

    # exact per-step decay of the k=1 mode under the discrete LOD scheme
    g = float(1.0 / (1.0 + 4.0 * r * np.sin(h / 2.0) ** 2) ** 3)

    print(f"# 3D LOD-ADI diffusion {n}^3, dt={args.dt}, D={args.D}, "
          f"r={r:.4f}, streamed={'yes' if mtb else 'no'}")
    print("# step, amp, amp/exact_discrete, lap_residual")
    t0 = time.time()
    for k in range(1, args.steps + 1):
        c = rt.compute(op, c)  # one LOD step: the full implicit solve
        if k % max(args.steps // 8, 1) == 0 or k == 1:
            amp = float(c.abs().max())
            exact = amp0 * g**k
            # diffusion residual: dC/dt - D lap C -> 0 as dt -> 0
            lap_c = rt.compute(lap, c)
            res = float(((1.0 - 1.0 / g) / args.dt * c
                         - args.D * lap_c).abs().max())
            print(f"{k:6d} {amp:12.6e} {amp/exact:12.9f} {res:10.3e}")
    wall = time.time() - t0
    cont = amp0 * np.exp(-3.0 * args.D * args.steps * args.dt)
    amp = float(c.abs().max())
    print(f"# final amp {amp:.6e}; discrete-exact {amp0 * g**args.steps:.6e} "
          f"(ratio {amp/(amp0*g**args.steps):.9f}); continuum {cont:.6e}")
    print(f"# wall: {wall:.2f}s ({wall/args.steps*1e3:.2f} ms/step)")
    rt.destroy(op)
    rt.destroy(lap)


if __name__ == "__main__":
    main()
