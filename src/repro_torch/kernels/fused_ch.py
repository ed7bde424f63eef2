"""Fused Cahn–Hilliard explicit RHS + cyclic x-sweep (counterpart of
``repro.kernels.fused_ch``).

:func:`ch_rhs_xsweep_cuda` launches ``csrc/fused_ch.cu``, which computes
``L_x^{-1} rhs(c_n, c_nm1)`` in one pass: the eq. 2a RHS is assembled into
shared memory, substituted in place and closed with the Woodbury
correction, so the RHS never reaches device memory.  The plain version
composes the windowed RHS (:func:`repro_torch.kernels.ref.ch_rhs_win`)
with the row-layout solve, as the reference's jnp path does.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.penta import (
    CyclicPentaFactors,
    rows_per_block,
    rows_woodbury_correct,
    substitute_rows_torch,
)
from repro_torch.kernels.ref import ch_coefficients, ch_rhs_win


def ch_rhs_xsweep_torch(
    c_n, c_nm1, fac_x: CyclicPentaFactors, *, dt, D, gamma, inv_h2, inv_h4
) -> torch.Tensor:
    """Plain version: windowed RHS, row-layout substitution, closure."""
    rhs = ch_rhs_win(
        c_n, c_nm1, dt=dt, D=D, gamma=gamma, inv_h2=inv_h2, inv_h4=inv_h4
    )
    return rows_woodbury_correct(substitute_rows_torch(fac_x.band, rhs), fac_x.w)


def ch_rhs_xsweep_cuda(
    c_n: torch.Tensor,
    c_nm1: torch.Tensor,
    fac_x: CyclicPentaFactors,
    *,
    dt: float,
    D: float,
    gamma: float,
    inv_h2: float,
    inv_h4: float,
) -> torch.Tensor:
    """Launch the fused kernel on two contiguous (ny, nx) CUDA fields.
    ``fac_x`` is the cyclic factor set of length ``nx``."""
    ny, nx = c_n.shape
    _build.check_cuda(c_n, "c_n", like=c_n, shape=(ny, nx))
    _build.check_cuda(c_nm1, "c_nm1", like=c_n, shape=(ny, nx))
    for name, f in zip(fac_x.band._fields, fac_x.band, strict=True):
        _build.check_cuda(f, f"factor {name}", like=c_n, shape=(nx,))
    _build.check_cuda(fac_x.w, "Woodbury w", like=c_n, shape=(nx, 4))
    smem, sms = _build.device_info(c_n.device)
    R = rows_per_block(nx, c_n.element_size(), ny, smem, sms)
    k_lin, k_bih, k_lap = ch_coefficients(
        dt=dt, D=D, gamma=gamma, inv_h2=inv_h2, inv_h4=inv_h4
    )
    out = torch.empty_like(c_n)
    _build.launch(
        "ch_rhs_xsweep", c_n.device, _build.dtype_code(c_n),
        _build.ptr(c_n), _build.ptr(c_nm1),
        *(_build.ptr(f) for f in fac_x.band), _build.ptr(fac_x.w),
        _build.ptr(out), ny, nx, R, float(k_lin), float(k_bih), float(k_lap),
    )
    return out
