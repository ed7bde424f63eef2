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

import torch

from repro_torch.kernels import ref as _ref
from repro_torch.kernels._build import LAUNCHES, reset_launches, resolve_backend
from repro_torch.kernels.fused_ch import ch_rhs_xsweep_cuda, ch_rhs_xsweep_torch
from repro_torch.kernels.stencil2d import stencil2d_cuda, stencil2d_torch

__all__ = [
    "LAUNCHES",
    "ch_rhs",
    "ch_rhs_xsweep",
    "reset_launches",
    "stencil_apply",
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
) -> torch.Tensor:
    """Apply a 2D stencil — the library's Compute primitive."""
    kw = dict(point_fn=point_fn, left=left, right=right, top=top,
              bottom=bottom, bc=bc)
    if resolve_backend(backend, data) == "cuda":
        return stencil2d_cuda(data, coeffs, out_init, **kw)
    return stencil2d_torch(data, coeffs=coeffs, out_init=out_init, **kw)


def ch_rhs(c_n, c_nm1, *, dt, D, gamma, inv_h2, inv_h4, backend: str = "auto"):
    """The eq. 2a explicit RHS alone.  Its CUDA kernel (the port of
    ``fused_ch.ch_rhs_pallas``) is not written yet, so a CUDA tensor raises
    unless the plain version is asked for with ``backend='torch'``."""
    if resolve_backend(backend, c_n) == "cuda":
        raise NotImplementedError(
            "the standalone CH RHS kernel (fused_ch.ch_rhs_pallas) is not "
            "ported yet (ROADMAP.md queue 2, item 5); the solver's step uses "
            "the fused RHS + x-sweep kernel instead"
        )
    return _ref.ch_rhs_win(
        c_n, c_nm1, dt=dt, D=D, gamma=gamma, inv_h2=inv_h2, inv_h4=inv_h4
    )


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
