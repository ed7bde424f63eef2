"""Quickstart on the PyTorch port — the paper's §IV.A/IV.B examples on the
four-function facade of ``repro_torch`` (the port of
``examples/quickstart.py``, same arguments and printed quantities).

8th-order central difference of sin(x) on an ny x nx grid, first with
standard weights then with a "function pointer", as cuSten's
``2d_x_np.cu`` / ``2d_x_np_fun.cu``, followed by the batched-1D family
(``1DBatch``) and a registry-operator Laplacian.  On the card the function
pointer runs from its CUDA source (``cuda_point_fn``), compiled at Create.

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --nx 512 --ny 256 --device cpu
"""

import argparse

import numpy as np
import torch

import repro_torch as rt
from repro_torch.kernels.stencil2d import cuda_point_fn


@cuda_point_fn("""
template <typename T>
__device__ T point_fn(const T* w, const T* c) {
  return c[0] * (w[0] - T(2) * w[1] + w[2]);
}
""")
def central_difference(windows, coe):
    return coe[0] * (windows[0] - 2.0 * windows[1] + windows[2])


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="cuSten quickstart on the repro_torch four-function facade"
    )
    ap.add_argument("--nx", type=int, default=1024, help="grid points in x")
    ap.add_argument("--ny", type=int, default=512, help="grid rows")
    ap.add_argument("--batch", type=int, default=64,
                    help="independent 1D lines in the 1DBatch demo")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the kernels) or 'cpu' (the plain versions)")
    args = ap.parse_args(argv)
    dev = args.device

    # -- the paper's setup: nx=1024, ny=512, lx=2*pi -----------------------
    nx, ny, lx = args.nx, args.ny, 2 * np.pi
    dx = lx / nx
    x = np.linspace(0, lx, nx, endpoint=False)
    data_old = torch.as_tensor(np.tile(np.sin(x), (ny, 1)), device=dev)
    answer = torch.as_tensor(-np.sin(x), device=dev)  # d2/dx2 sin = -sin

    # -- Create: 9-point (numSten=9, 4 left / 4 right) 8th-order weights ---
    weights = rt.central_difference_weights(8, 2, h=dx)
    plan = rt.create(weights, (ny, nx), bc="np", mode="x", device=dev)

    # -- Compute / Swap ----------------------------------------------------
    data_new = rt.compute(plan, data_old)
    err = float((data_new[:, 4:-4] - answer[4:-4]).abs().max())
    print(f"[weights ] interior max|err| = {err:.3e}")
    print(f"[weights ] boundary cells (untouched): "
          f"{data_new[0, :4].cpu().numpy()}")
    # the timestepping idiom: the fresh field becomes the next input
    data_old, data_new = rt.swap((data_new, data_old))
    rt.destroy(plan)  # Destroy (idempotent; compute now refuses it)
    data_old, data_new = rt.swap((data_new, data_old))  # flip back

    # -- Function-pointer variant (paper §IV.B): 2nd-order via coefficients -
    fun_plan = rt.create(
        central_difference, (ny, nx), bc="np", mode="x",
        coeffs=np.asarray([1.0 / dx**2]), extents=dict(left=1, right=1),
        device=dev,
    )
    data_new2 = rt.compute(fun_plan, data_old)
    err2 = float((data_new2[:, 1:-1] - answer[1:-1]).abs().max())
    print(f"[fun mode] interior max|err| = {err2:.3e} (2nd order)")
    rt.destroy(fun_plan)

    # -- periodic boundary: no untouched cells ------------------------------
    periodic = rt.create(weights, (ny, nx), bc="periodic", mode="x", device=dev)
    err3 = float((rt.compute(periodic, data_old) - answer).abs().max())
    print(f"[periodic] global max|err|  = {err3:.3e}")
    rt.destroy(periodic)

    # -- batched 1D (cuSten's 1DBatch family): mode='batch' ----------------
    # A (B, M) stack of independent 1D problems — B phase-shifted copies of
    # sin — differentiated by ONE plan in ONE Compute call.
    B, M = args.batch, nx
    phases = np.linspace(0, np.pi, B, endpoint=False)[:, None]
    stack = torch.as_tensor(np.sin(x[None, :] + phases), device=dev)  # (B, M)
    batch_plan = rt.create(weights, (B, M), mode="batch", device=dev)
    d2_stack = rt.compute(batch_plan, stack)
    err4 = float((d2_stack + stack).abs().max())  # d2/dx2 sin = -sin
    print(f"[batch1d ] {B} lines at once, global max|err| = {err4:.3e}")
    rt.destroy(batch_plan)

    # -- registry operator: a named Laplacian, no weight table in sight -----
    lap = rt.create("laplacian", (ny, nx), bc="periodic", h=dx, device=dev)
    lap_sin = rt.compute(lap, data_old)  # lap sin(x) = -sin(x)
    err5 = float((lap_sin - answer[None, :]).abs().max())
    print(f"[registry] laplacian max|err| = {err5:.3e} (2nd order), "
          f"operators: {', '.join(rt.operator_names())}")
    rt.destroy(lap)


if __name__ == "__main__":
    main()
