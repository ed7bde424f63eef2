"""Fused Cahn–Hilliard explicit-RHS kernels (counterpart of
``repro.kernels.fused_ch``), both in ``csrc/fused_ch.cu`` and both built on
one device function for the eq. 2a RHS at a point:

- :func:`ch_rhs_cuda` — the RHS alone, any extent: a block stages a 32 x
  32 tile of both fields and their halo of 2 in shared memory, each
  thread computes four outputs.  Its plain version is the windowed RHS
  :func:`repro_torch.kernels.ref.ch_rhs_win`.
- :func:`ch_rhs_xsweep_cuda` — ``L_x^{-1} rhs(c_n, c_nm1)`` in one pass: the
  RHS is assembled into shared memory, substituted in place (one warp per
  row, as a segmented recurrence) and closed with the Woodbury correction,
  so it never reaches device memory (rows too long for shared memory are
  assembled and solved in the output instead).  The plain version
  composes the windowed RHS with the row-layout solve, as the reference's
  jnp path does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.penta import (
    CyclicPentaFactors,
    rows_per_block,
    rows_woodbury_correct,
    segment_length,
    substitute_rows_torch,
)
from repro_torch.kernels.ref import ch_coefficients, ch_rhs_win


class XsweepGeometry(NamedTuple):
    """Launch geometry of the fused kernel (``ch_rhs_xsweep``)."""

    route: str  # "tile" (rows in shared memory) or "global" (a warp a row)
    rows: int  # R, rows a block; 0 on the global route
    stage: bool  # the five factors staged in shared memory beside the rows


def xsweep_rows_per_block(nx: int, itemsize: int, n_rows: int,
                          smem_optin: int, n_sms: int) -> XsweepGeometry:
    """Geometry of the fused kernel over ``n_rows`` rows of ``nx``.

    The tile route when one row (stride nx + 1) fits in shared memory:
    R rows a block, and the five factors of the band staged beside them
    when a row and the factors fit (otherwise they are read from device
    memory and the rows get the whole of it).  Else the device-memory
    route: each row's RHS is written to the output and solved there.  The
    route depends on nx and the dtype alone."""
    if (nx + 1) * itemsize > smem_optin:
        return XsweepGeometry("global", 0, False)
    fac_bytes = 5 * nx * itemsize
    stage = (nx + 1) * itemsize + fac_bytes <= smem_optin
    avail = smem_optin - fac_bytes if stage else smem_optin
    return XsweepGeometry(
        "tile", rows_per_block(nx, itemsize, n_rows, avail, n_sms), stage)


def ch_rhs_xsweep_torch(
    c_n, c_nm1, fac_x: CyclicPentaFactors, *, dt, D, gamma, inv_h2, inv_h4
) -> torch.Tensor:
    """Plain version: windowed RHS, row-layout substitution, closure."""
    rhs = ch_rhs_win(
        c_n, c_nm1, dt=dt, D=D, gamma=gamma, inv_h2=inv_h2, inv_h4=inv_h4
    )
    return rows_woodbury_correct(substitute_rows_torch(fac_x.band, rhs), fac_x.w)


def ch_rhs_cuda(
    c_n: torch.Tensor,
    c_nm1: torch.Tensor,
    *,
    dt: float,
    D: float,
    gamma: float,
    inv_h2: float,
    inv_h4: float,
    rows: tuple[int, int] | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the standalone RHS kernel on two contiguous (ny, nx) CUDA
    fields; ``rows=(r0, r1)`` computes only those rows into ``out``."""
    ny, nx = c_n.shape
    _build.check_cuda(c_n, "c_n", like=c_n, shape=(ny, nx))
    _build.check_cuda(c_nm1, "c_nm1", like=c_n, shape=(ny, nx))
    k_lin, k_bih, k_lap = ch_coefficients(
        dt=dt, D=D, gamma=gamma, inv_h2=inv_h2, inv_h4=inv_h4
    )
    r0, r1 = _build.window(rows, ny, "row", out)
    out = _build.out_like(out, c_n)
    _build.launch(
        "ch_rhs", c_n.device, _build.dtype_code(c_n), _build.ptr(c_n),
        _build.ptr(c_nm1), _build.ptr(out), ny, nx, r0, r1, float(k_lin),
        float(k_bih), float(k_lap),
    )
    return out


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
    rows: tuple[int, int] | None = None,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the fused kernel on two contiguous (ny, nx) CUDA fields.
    ``fac_x`` is the cyclic factor set of length ``nx``; ``rows=(r0, r1)``
    computes only those rows into ``out``.  Any nx: rows that do not fit
    in shared memory take the device-memory route."""
    ny, nx = c_n.shape
    _build.check_cuda(c_n, "c_n", like=c_n, shape=(ny, nx))
    _build.check_cuda(c_nm1, "c_nm1", like=c_n, shape=(ny, nx))
    for name, f in zip(fac_x.band._fields, fac_x.band, strict=True):
        _build.check_cuda(f, f"factor {name}", like=c_n, shape=(nx,))
    _build.check_cuda(fac_x.w, "Woodbury w", like=c_n, shape=(nx, 4))
    r0, r1 = _build.window(rows, ny, "row", out)
    smem, sms = _build.device_info(c_n.device)
    geo = xsweep_rows_per_block(nx, c_n.element_size(), r1 - r0, smem, sms)
    k_lin, k_bih, k_lap = ch_coefficients(
        dt=dt, D=D, gamma=gamma, inv_h2=inv_h2, inv_h4=inv_h4
    )
    out = _build.out_like(out, c_n)
    _build.launch(
        "ch_rhs_xsweep", c_n.device, _build.dtype_code(c_n),
        _build.ptr(c_n), _build.ptr(c_nm1),
        *(_build.ptr(f) for f in fac_x.band), _build.ptr(fac_x.w),
        _build.ptr(out), ny, nx, r0, r1, geo.rows, segment_length(nx),
        int(geo.stage),
        float(k_lin), float(k_bih), float(k_lap),
    )
    return out
