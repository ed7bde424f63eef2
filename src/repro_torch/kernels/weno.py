"""WENO5 upwind advection: CUDA kernel wrapper and plain version
(counterpart of ``repro.kernels.weno``, the paper's ``2d_xyADVWENO_p``
variant: the stock XY kernel extended with the velocity fields as extra
inputs and a WENO reconstruction in place of the weighted sum).

The kernel (``csrc/weno.cu``) takes any ``(ny, nx)``: each index wraps on
its own, so none of the reference's tile-divisibility rules apply, and
extents below the 7-point support work too.  It multiplies the
differences by ``1/dx`` and ``1/dy`` (passed from here), folds the
reference's divisions by 3 and 6 into the normalisation and takes its
weights with reciprocals, so it agrees with the plain version to rounding,
not bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import weno5_advect_ref


def weno5_advect_torch(q, u, v, *, dx: float, dy: float) -> torch.Tensor:
    """Plain version: the rolled-window WENO5 RHS of ``kernels/ref.py``."""
    return weno5_advect_ref(q, u, v, dx, dy)


def weno5_advect_cuda(
    q: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *, dx: float, dy: float
) -> torch.Tensor:
    """Launch the WENO5 kernel on three contiguous (ny, nx) CUDA fields:
    ``-(u q_x + v q_y)``, periodic, upwinded."""
    if q.ndim != 2:
        raise ValueError(f"q must be a (ny, nx) field, got shape {tuple(q.shape)}")
    ny, nx = q.shape
    for name, t in (("q", q), ("u", u), ("v", v)):
        _build.check_cuda(t, name, like=q, shape=(ny, nx))
    out = torch.empty_like(q)
    _build.launch(
        "weno5_advect", q.device, _build.dtype_code(q), _build.ptr(q),
        _build.ptr(u), _build.ptr(v), _build.ptr(out), ny, nx, 1.0 / dx,
        1.0 / dy,
    )
    return out
