"""Plain PyTorch versions of the kernels (counterpart of ``repro.kernels.ref``).

These are the semantic definitions: slow but obviously right.  The CPU
path runs them, the tests hold them against the JAX reference, and
``chip_smoke.py`` holds every CUDA kernel against them on the card.

Conventions (the paper's cuSten API, as in the reference):

- A 2D field is ``(ny, nx)``; ``x`` is the fast (last) axis.
- Stencil windows are enumerated row-major from the top-left of the
  stencil; the coefficient of window ``(a, b)`` is ``coeffs[a*(left+right+1)+b]``.
- ``point_fn(windows, coeffs)`` is the "function pointer".  A point
  function that the CUDA stencil kernel can evaluate carries a
  ``device_point_fn`` tag naming its device counterpart.
- ``bc='periodic'`` wraps; ``bc='np'`` computes the interior only and
  passes ``out_init`` (default zeros) through on the boundary cells.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable, Iterator

import numpy as np
import torch


def weighted_point_fn(windows: Iterable[torch.Tensor], coeffs: torch.Tensor):
    """The linear-stencil 'function pointer': sum_k coeffs[k] * window_k,
    in window order.  ``windows`` may be a generator: the plain stencils
    hand it one that makes each window when the sum reaches it, so one
    window at a time is live, not all of them."""
    it = iter(windows)
    out = coeffs[0] * next(it)
    for k, w in enumerate(it, 1):
        out = out + coeffs[k] * w
    return out


def _windows_for(point_fn: Callable, windows: Iterator[torch.Tensor]):
    """The windows as ``point_fn`` takes them: the generator itself for the
    weighted sum, a list for any other point function."""
    return windows if point_fn is weighted_point_fn else list(windows)


weighted_point_fn.device_point_fn = "weighted"


def shifted_windows(
    data: torch.Tensor, *, left: int, right: int, top: int, bottom: int
) -> Iterator[torch.Tensor]:
    """All stencil windows of ``data`` (periodic shifts over its last two
    axes), row-major order, each made when it is reached.

    ``window[a*sx+b][..., j, i] == data[..., (j - top + a) % ny, (i - left + b) % nx]``
    """
    return (
        torch.roll(data, shifts=(top - a, left - b), dims=(-2, -1))
        for a in range(top + bottom + 1)
        for b in range(left + right + 1)
    )


def interior_mask(shape, *, left: int, right: int, top: int, bottom: int):
    """Boolean numpy mask of the cells a ``bc='np'`` stencil computes."""
    ny, nx = shape
    jj, ii = np.meshgrid(np.arange(ny), np.arange(nx), indexing="ij")
    return (ii >= left) & (ii < nx - right) & (jj >= top) & (jj < ny - bottom)


def stencil2d_ref(
    data: torch.Tensor,
    *,
    bc: str,
    left: int = 0,
    right: int = 0,
    top: int = 0,
    bottom: int = 0,
    point_fn: Callable = weighted_point_fn,
    coeffs: torch.Tensor | None = None,
    out_init: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of the generic 2D stencil apply (any direction), on an
    ``(ny, nx)`` field or a stack ``(B, ny, nx)`` of them (each member
    computed alone, by the same operations as a single field)."""
    if bc not in ("periodic", "np"):
        raise ValueError(f"bc must be 'periodic' or 'np', got {bc!r}")
    wins = shifted_windows(data, left=left, right=right, top=top, bottom=bottom)
    out = point_fn(_windows_for(point_fn, wins), coeffs)
    if bc == "np":
        out = _np_mask(out, interior_mask(data.shape[-2:], left=left, right=right,
                                          top=top, bottom=bottom), out_init)
    return out


def _np_mask(out, mask, out_init):
    """``out`` on the cells of the numpy ``mask``, ``out_init`` (zeros when
    ``None``) elsewhere: the ``bc='np'`` pass-through."""
    mask = torch.as_tensor(mask, device=out.device)
    base = torch.zeros_like(out) if out_init is None else out_init
    return torch.where(mask, out, base.to(out.dtype))


# ---------------------------------------------------------------------------
# Batched-1D stencils (cuSten's 1DBatch family)
# ---------------------------------------------------------------------------


def stencil1d_batch_ref(
    data: torch.Tensor,
    *,
    bc: str,
    left: int = 0,
    right: int = 0,
    point_fn: Callable = weighted_point_fn,
    coeffs: torch.Tensor | None = None,
    out_init: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of the batched-1D stencil apply on a ``(B, M)`` stack.

    The same 1D stencil is applied along axis 1 of every row; rows never
    couple.  Windows sweep left to right:
    ``window[b][r, i] == data[r, (i - left + b) % M]``.  ``bc='np'``
    computes the columns ``left <= i < M - right`` and passes ``out_init``
    (zeros when ``None``) through on the others.  Any strides: a
    transposed view applies the stencil along the columns of its base."""
    if bc not in ("periodic", "np"):
        raise ValueError(f"bc must be 'periodic' or 'np', got {bc!r}")
    wins = (torch.roll(data, shifts=left - b, dims=1)
            for b in range(left + right + 1))
    out = point_fn(_windows_for(point_fn, wins), coeffs)
    if bc == "np":
        ii = np.arange(data.shape[1])
        out = _np_mask(out, ((ii >= left) & (ii < data.shape[1] - right))[None, :],
                       out_init)
    return out


# ---------------------------------------------------------------------------
# 3D stencils (paper §VI.A)
# ---------------------------------------------------------------------------


def stencil3d_ref(
    data: torch.Tensor,
    *,
    bc: str,
    halos,  # (front, back, top, bottom, left, right) along (z, y, x)
    point_fn: Callable = weighted_point_fn,
    coeffs: torch.Tensor | None = None,
    out_init: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of the 3D box stencil on an ``(nz, ny, nx)`` field.
    Windows are enumerated z-major, then row-major over (y, x)."""
    if bc not in ("periodic", "np"):
        raise ValueError(f"bc must be 'periodic' or 'np', got {bc!r}")
    fr, bk, tp, bt, lf, rt = halos
    wins = (
        torch.roll(data, shifts=(fr - c, tp - a, lf - b), dims=(0, 1, 2))
        for c in range(fr + bk + 1)
        for a in range(tp + bt + 1)
        for b in range(lf + rt + 1)
    )
    out = point_fn(_windows_for(point_fn, wins), coeffs)
    if bc == "np":
        nz, ny, nx = data.shape
        kk, jj, ii = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                                 indexing="ij")
        mask = ((kk >= fr) & (kk < nz - bk) & (jj >= tp) & (jj < ny - bt)
                & (ii >= lf) & (ii < nx - rt))
        out = _np_mask(out, mask, out_init)
    return out


# ---------------------------------------------------------------------------
# Pentadiagonal solves (dense oracle)
# ---------------------------------------------------------------------------


def penta_dense(l2, l1, d, u1, u2) -> torch.Tensor:
    """Dense (M, M) matrix from the 5 diagonals (length M; out-of-band
    entries of l2, l1, u1, u2 are ignored)."""
    M = d.shape[0]
    A = torch.diag(d)
    A = A + torch.diag(l1[1:], -1) + torch.diag(l2[2:], -2)
    return A + torch.diag(u1[: M - 1], 1) + torch.diag(u2[: M - 2], 2)


def penta_dense_cyclic(l2, l1, d, u1, u2) -> torch.Tensor:
    """Dense cyclic pentadiagonal matrix: row i couples columns
    (i-2, i-1, i, i+1, i+2) mod M."""
    M = d.shape[0]
    A = torch.zeros((M, M), dtype=d.dtype, device=d.device)
    idx = torch.arange(M, device=d.device)
    for off, band in ((-2, l2), (-1, l1), (0, d), (1, u1), (2, u2)):
        A.index_put_((idx, (idx + off) % M), band, accumulate=True)
    return A


def penta_solve_ref(l2, l1, d, u1, u2, rhs, *, cyclic: bool) -> torch.Tensor:
    """Dense-solve oracle. ``rhs`` is (M,) or (M, N) batched along axis 1."""
    dense = penta_dense_cyclic if cyclic else penta_dense
    return torch.linalg.solve(dense(l2, l1, d, u1, u2), rhs)


# ---------------------------------------------------------------------------
# Cahn–Hilliard explicit RHS (scheme eq. 2a)
# ---------------------------------------------------------------------------


def laplacian_ref(c: torch.Tensor, inv_h2: float) -> torch.Tensor:
    """Periodic 5-point Laplacian: (delta_x + delta_y)/h^2 of eq. (4a)."""
    return inv_h2 * (
        torch.roll(c, 1, 0) + torch.roll(c, -1, 0)
        + torch.roll(c, 1, 1) + torch.roll(c, -1, 1)
        - 4.0 * c
    )


def biharmonic_ref(c: torch.Tensor, inv_h4: float) -> torch.Tensor:
    """Periodic 13-point biharmonic (delta_x^2 + 2 delta_x delta_y +
    delta_y^2)/h^4 of the paper's eq. (4)."""
    dx2 = (
        torch.roll(c, 2, 1) - 4 * torch.roll(c, 1, 1) + 6 * c
        - 4 * torch.roll(c, -1, 1) + torch.roll(c, -2, 1)
    )
    dy2 = (
        torch.roll(c, 2, 0) - 4 * torch.roll(c, 1, 0) + 6 * c
        - 4 * torch.roll(c, -1, 0) + torch.roll(c, -2, 0)
    )
    f = torch.roll(c, 1, 0) - 2 * c + torch.roll(c, -1, 0)
    dxdy = torch.roll(f, 1, 1) - 2 * f + torch.roll(f, -1, 1)
    return inv_h4 * (dx2 + dy2 + 2.0 * dxdy)


def ch_rhs_ref(c_n, c_nm1, *, dt, D, gamma, inv_h2, inv_h4):
    """The explicit RHS of the paper's eq. (2a):

        rhs = -(2/3)(C^n - C^{n-1}) - (2/3) dt gamma D grad^4 Cbar^{n+1}
              + (2/3) D dt grad^2 (C^3 - C)^n,   Cbar^{n+1} = 2 C^n - C^{n-1}.
    """
    cbar = 2.0 * c_n - c_nm1
    lin = -(2.0 / 3.0) * (c_n - c_nm1)
    hyper = -(2.0 / 3.0) * dt * gamma * D * biharmonic_ref(cbar, inv_h4)
    nonlin = (2.0 / 3.0) * D * dt * laplacian_ref(c_n**3 - c_n, inv_h2)
    return lin + hyper + nonlin


def _wrap_pad2(x: torch.Tensor, h: int) -> torch.Tensor:
    """Periodic halo pad on both axes (halo ``h``), by modular indexing so
    that an extent smaller than ``h`` still wraps."""
    ny, nx = x.shape
    rows = torch.arange(-h, ny + h, device=x.device) % ny
    cols = torch.arange(-h, nx + h, device=x.device) % nx
    return x[rows][:, cols]


def ch_rhs_win(c_n, c_nm1, *, dt, D, gamma, inv_h2, inv_h4):
    """The explicit RHS evaluated on one halo-padded copy of each field with
    shifted-slice windows (:func:`ch_rhs_band`); matches :func:`ch_rhs_ref`
    to rounding."""
    ny, nx = c_n.shape
    return ch_rhs_band(
        _wrap_pad2(c_n, 2), _wrap_pad2(c_nm1, 2), ny, nx,
        dt=dt, D=D, gamma=gamma, inv_h2=inv_h2, inv_h4=inv_h4,
    )


def ch_rhs_band(pn, pm, ny, nx, *, dt, D, gamma, inv_h2, inv_h4):
    """The windowed RHS on already halo-padded ``(ny+4, nx+4)`` bands.

    The biharmonic is evaluated separably: with ``u = delta_x^2 cbar`` and
    ``t = delta_y^2 cbar`` on the inner halo-1 band,
    ``grad^4 cbar = delta_x^2 u + delta_y^2 t + 2 delta_x^2 t``.
    """
    h = 2
    cbar = 2.0 * pn - pm
    nl = pn * pn * pn - pn

    def d2x(a):  # delta_x^2, shrinks axis 1 by 2
        n = a.shape[1]
        return a[:, : n - 2] - 2.0 * a[:, 1 : n - 1] + a[:, 2:]

    def d2y(a):  # delta_y^2, shrinks axis 0 by 2
        n = a.shape[0]
        return a[: n - 2, :] - 2.0 * a[1 : n - 1, :] + a[2:, :]

    u = d2x(cbar)[1:-1, :]
    t = d2y(cbar)[:, 1:-1]
    bih = d2x(u + 2.0 * t)[1:-1, :] + d2y(t[:, 1:-1])
    lap = d2x(nl)[2:-2, 1:-1] + d2y(nl)[1:-1, 2:-2]

    def centre(a):
        return a[h : h + ny, h : h + nx]

    k_lin, k_bih, k_lap = ch_coefficients(
        dt=dt, D=D, gamma=gamma, inv_h2=inv_h2, inv_h4=inv_h4
    )
    return k_lin * (centre(pn) - centre(pm)) + k_bih * bih + k_lap * lap


def ch_coefficients(*, dt, D, gamma, inv_h2, inv_h4) -> tuple[float, float, float]:
    """``(k_lin, k_bih, k_lap)``: the weights of ``c_n - c_nm1``, of the
    unscaled biharmonic of ``cbar`` and of the unscaled Laplacian of
    ``c_n^3 - c_n`` in the eq. 2a RHS (shared with the fused CUDA kernel)."""
    return (
        -(2.0 / 3.0),
        -(2.0 / 3.0) * dt * gamma * D * inv_h4,
        (2.0 / 3.0) * D * dt * inv_h2,
    )


# ---------------------------------------------------------------------------
# WENO5 Hamilton–Jacobi advection (paper §IV.C, ref Osher & Fedkiw)
# ---------------------------------------------------------------------------

_W_EPS = 1e-6


def _weno5_phi(v1, v2, v3, v4, v5):
    """Classic WENO5 combination of the five divided differences.

    Returns the left-biased approximation of the derivative given
    one-sided differences v1..v5 (Osher & Fedkiw, ch. 3.4).  The
    expression order is the reference's, operation for operation; the CUDA
    kernel (``csrc/weno.cu``) computes it to rounding with 4 divisions."""
    s1 = (13.0 / 12.0) * (v1 - 2 * v2 + v3) ** 2 + 0.25 * (v1 - 4 * v2 + 3 * v3) ** 2
    s2 = (13.0 / 12.0) * (v2 - 2 * v3 + v4) ** 2 + 0.25 * (v2 - v4) ** 2
    s3 = (13.0 / 12.0) * (v3 - 2 * v4 + v5) ** 2 + 0.25 * (3 * v3 - 4 * v4 + v5) ** 2
    a1 = 0.1 / (_W_EPS + s1) ** 2
    a2 = 0.6 / (_W_EPS + s2) ** 2
    a3 = 0.3 / (_W_EPS + s3) ** 2
    w = a1 + a2 + a3
    p1 = v1 / 3.0 - 7.0 * v2 / 6.0 + 11.0 * v3 / 6.0
    p2 = -v2 / 6.0 + 5.0 * v3 / 6.0 + v4 / 3.0
    p3 = v3 / 3.0 + 5.0 * v4 / 6.0 - v5 / 6.0
    return (a1 * p1 + a2 * p2 + a3 * p3) / w


def weno5_derivs_ref(q: torch.Tensor, dx: float, dy: float):
    """Periodic upwind WENO5 one-sided derivatives of ``q``.

    Returns (dqdx_minus, dqdx_plus, dqdy_minus, dqdy_plus): the left- and
    right-biased derivative approximations in each direction."""

    def one_axis(q, h, axis):
        # d[k] = (q_{i+k+1} - q_{i+k}) / h  for k in -3..2   (6 differences)
        diffs = [
            (torch.roll(q, -(k + 1), dims=axis) - torch.roll(q, -k, dims=axis)) / h
            for k in range(-3, 3)
        ]
        # minus (left-biased): v1..v5 = d[-3],d[-2],d[-1],d[0],d[1]
        dm = _weno5_phi(diffs[0], diffs[1], diffs[2], diffs[3], diffs[4])
        # plus (right-biased): v1..v5 = d[2],d[1],d[0],d[-1],d[-2]
        dp = _weno5_phi(diffs[5], diffs[4], diffs[3], diffs[2], diffs[1])
        return dm, dp

    dxm, dxp = one_axis(q, dx, axis=1)
    dym, dyp = one_axis(q, dy, axis=0)
    return dxm, dxp, dym, dyp


def weno5_advect_ref(q, u, v, dx, dy):
    """RHS of dq/dt = -(u q_x + v q_y) with upwinded WENO5 derivatives
    (periodic).  ``u == 0`` takes the right-biased (plus) branch, as in the
    reference."""
    dxm, dxp, dym, dyp = weno5_derivs_ref(q, dx, dy)
    qx = torch.where(u > 0, dxm, dxp)
    qy = torch.where(v > 0, dym, dyp)
    return -(u * qx + v * qy)
