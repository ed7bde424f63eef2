"""WENO5 advection on the PyTorch port (the port of
``examples/weno_advection.py``, the paper's ``2d_xyWENOADV_p``; same
arguments and printed quantities, plus ``--device``).

Rigid-body rotation of a Gaussian blob through one full revolution; the
final field should coincide with the initial one.  On the card each RK3
stage is one launch of the ``weno5_advect`` kernel.

    PYTHONPATH=src python examples/torch_weno_advection.py [--n 256]
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.core.weno import (
    AdvectionConfig,
    WenoAdvection2D,
    gaussian_blob,
    solid_body_rotation,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--revolutions", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernel) or 'cpu' (the plain version)")
    args = ap.parse_args(argv)

    cfg = AdvectionConfig(nx=args.n, ny=args.n, cfl=0.4, backend="auto",
                          device=args.device)
    solver = WenoAdvection2D(cfg)
    q0 = gaussian_blob(cfg, x0=np.pi + 1.0, y0=np.pi, sigma=0.4,
                       device=args.device)
    u, v = solid_body_rotation(cfg, device=args.device)

    t_final = 2 * np.pi * args.revolutions  # one revolution period is 2*pi
    t0 = time.time()
    qT, n_steps = solver.run(q0, u, v, t_final)
    wall = time.time() - t0

    l2 = float(torch.sqrt(torch.mean((qT - q0) ** 2)))
    print(f"grid {args.n}^2, {n_steps} RK3 steps in {wall:.1f}s")
    print(f"L2 error after {args.revolutions} revolution(s): {l2:.3e}")
    print(f"min/max: {float(qT.min()):+.4f} / {float(qT.max()):.4f} "
          f"(ENO: no significant over/undershoot)")


if __name__ == "__main__":
    main()
