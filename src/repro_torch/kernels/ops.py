"""Public entry points of the kernels, with backend dispatch (counterpart of
``repro.kernels.ops``).

Every op takes ``backend in {'auto', 'cuda', 'torch'}``:

- ``auto``  picks by the tensor's device: the CUDA kernel for a CUDA
  tensor, the plain PyTorch version for a CPU tensor.  On a CUDA tensor it
  launches the kernel or raises; it never falls back to the plain version.
- ``cuda``  forces the kernel (a CPU tensor raises).
- ``torch`` forces the plain version; the tests and ``chip_smoke.py`` use
  it to hold the kernels against their plain versions on the card.

Launch counts of the kernels are in :data:`LAUNCHES`.
"""

from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels._build import (
    LAUNCHES,
    check_kernel_backend,
    reset_launches,
    resolve_backend,
)
from repro_torch.kernels.fused_ch import (
    ch_rhs_cuda,
    ch_rhs_xsweep_cuda,
    ch_rhs_xsweep_torch,
)
from repro_torch.kernels.penta import (
    cyclic_penta_factor,
    cyclic_penta_solve_factored,
    penta_factor,
    penta_solve_factored,
)
from repro_torch.kernels.stencil1d_batch import (
    stencil1d_batch_cuda,
    stencil1d_batch_torch,
)
from repro_torch.kernels.stencil2d import stencil2d_cuda, stencil2d_torch
from repro_torch.kernels.stencil3d import stencil3d_cuda, stencil3d_torch
from repro_torch.kernels.weno import weno5_advect_cuda, weno5_advect_torch
from repro_torch.util import numpy_dtype

__all__ = [
    "LAUNCHES",
    "ch_rhs",
    "ch_rhs_xsweep",
    "penta_solve",
    "reset_launches",
    "stencil_apply",
    "stencil_apply_3d",
    "stencil_apply_batch1d",
    "weno_advect",
]


def stencil_apply(
    data: torch.Tensor,
    coeffs: torch.Tensor,
    out_init: torch.Tensor | None = None,
    *,
    point_fn: Callable = _ref.weighted_point_fn,
    left: int = 0,
    right: int = 0,
    top: int = 0,
    bottom: int = 0,
    bc: str = "periodic",
    backend: str = "auto",
    taps=None,
    geometry: dict | None = None,
) -> torch.Tensor:
    """Apply a 2D stencil — the library's Compute primitive — to an
    ``(ny, nx)`` field, or to a ``(B, ny, nx)`` stack of them (one launch;
    each member bit for bit its own apply).  ``taps``: the plan's non-zero
    taps, which the kernel sums
    (:func:`repro_torch.kernels.taps.nonzero_taps`); without them it sums
    every window.  ``geometry``: a tuned plan's launch geometry, which only
    the kernel reads (:func:`repro_torch.kernels.stencil2d.stencil2d_geometry`)."""
    kw = dict(point_fn=point_fn, left=left, right=right, top=top,
              bottom=bottom, bc=bc)
    if resolve_backend(backend, data) == "cuda":
        return stencil2d_cuda(data, coeffs, out_init, taps=taps,
                              geometry=geometry, **kw)
    return stencil2d_torch(data, coeffs=coeffs, out_init=out_init, **kw)


def stencil_apply_batch1d(
    data: torch.Tensor,
    coeffs: torch.Tensor,
    out_init: torch.Tensor | None = None,
    *,
    point_fn: Callable = _ref.weighted_point_fn,
    left: int = 0,
    right: int = 0,
    bc: str = "periodic",
    backend: str = "auto",
    taps=None,
    geometry: dict | None = None,
) -> torch.Tensor:
    """Apply a 1D stencil along axis 1 of a ``(B, M)`` stack — the
    batched-1D Compute primitive (cuSten's 1DBatch family).  The stack may
    be the transpose of a contiguous field (its columns as lines).
    ``taps`` and ``geometry`` as for :func:`stencil_apply`."""
    kw = dict(point_fn=point_fn, left=left, right=right, bc=bc)
    if resolve_backend(backend, data) == "cuda":
        return stencil1d_batch_cuda(data, coeffs, out_init, taps=taps,
                                    geometry=geometry, **kw)
    return stencil1d_batch_torch(data, coeffs=coeffs, out_init=out_init, **kw)


def stencil_apply_3d(
    data: torch.Tensor,
    coeffs: torch.Tensor,
    out_init: torch.Tensor | None = None,
    *,
    point_fn: Callable = _ref.weighted_point_fn,
    halos=(0, 0, 0, 0, 0, 0),  # (front, back, top, bottom, left, right)
    bc: str = "periodic",
    backend: str = "auto",
    taps=None,
    geometry: dict | None = None,
) -> torch.Tensor:
    """Apply a 3D stencil on an ``(nz, ny, nx)`` field — the 3D Compute
    primitive.  ``taps`` and ``geometry`` as for :func:`stencil_apply`."""
    kw = dict(point_fn=point_fn, halos=tuple(int(h) for h in halos), bc=bc)
    if resolve_backend(backend, data) == "cuda":
        return stencil3d_cuda(data, coeffs, out_init, taps=taps,
                              geometry=geometry, **kw)
    return stencil3d_torch(data, coeffs=coeffs, out_init=out_init, **kw)


def ch_rhs(c_n, c_nm1, *, dt, D, gamma, inv_h2, inv_h4, backend: str = "auto"):
    """The eq. 2a explicit RHS alone (``CahnHilliardADI.rhs`` in fused
    mode)."""
    kw = dict(dt=float(dt), D=float(D), gamma=float(gamma),
              inv_h2=float(inv_h2), inv_h4=float(inv_h4))
    if resolve_backend(backend, c_n) == "cuda":
        return ch_rhs_cuda(c_n, c_nm1, **kw)
    return _ref.ch_rhs_win(c_n, c_nm1, **kw)


def ch_rhs_xsweep(
    c_n, c_nm1, fac_x, *, dt, D, gamma, inv_h2, inv_h4, backend: str = "auto"
):
    """Fused explicit RHS + transpose-free implicit x-sweep:
    ``L_x^{-1} rhs(c_n, c_nm1)`` with ``fac_x`` the Create-time cyclic
    factors along x."""
    kw = dict(dt=float(dt), D=float(D), gamma=float(gamma),
              inv_h2=float(inv_h2), inv_h4=float(inv_h4))
    if resolve_backend(backend, c_n) == "cuda":
        return ch_rhs_xsweep_cuda(c_n, c_nm1, fac_x, **kw)
    return ch_rhs_xsweep_torch(c_n, c_nm1, fac_x, **kw)


def penta_solve(l2, l1, d, u1, u2, rhs, *, cyclic: bool, backend: str = "auto"):
    """One-shot batched pentadiagonal solve: factor, then substitute.

    ``rhs`` is (M,) or (M, N) (systems down the columns); the diagonals are
    (M,) and are factored on the host in ``rhs``'s dtype, the factors moved
    to ``rhs``'s device.  For repeated solves with one operator (the ADI hot
    path) use the factor / ``*_solve_factored`` pair of
    :mod:`repro_torch.kernels.penta` — cuSten's Create/Compute split."""
    check_kernel_backend(backend)
    dt = numpy_dtype(rhs.dtype)
    bands = [np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                        dt) for a in (l2, l1, d, u1, u2)]
    if cyclic:
        fac = cyclic_penta_factor(*bands, device=rhs.device)
        return cyclic_penta_solve_factored(fac, rhs, backend=backend)
    return penta_solve_factored(penta_factor(*bands, device=rhs.device), rhs,
                                backend=backend)


def weno_advect(q, u, v, *, dx: float, dy: float, backend: str = "auto"):
    """RHS of periodic 2D advection ``-(u q_x + v q_y)`` with upwinded WENO5
    derivatives.  The kernel takes any extent, so there is no tile."""
    if resolve_backend(backend, q) == "cuda":
        return weno5_advect_cuda(q, u, v, dx=dx, dy=dy)
    return weno5_advect_torch(q, u, v, dx=dx, dy=dy)
