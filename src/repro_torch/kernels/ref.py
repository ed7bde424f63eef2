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

from collections.abc import Callable, Sequence

import numpy as np
import torch


def weighted_point_fn(windows: Sequence[torch.Tensor], coeffs: torch.Tensor):
    """The linear-stencil 'function pointer': sum_k coeffs[k] * window_k."""
    out = coeffs[0] * windows[0]
    for k in range(1, len(windows)):
        out = out + coeffs[k] * windows[k]
    return out


weighted_point_fn.device_point_fn = "weighted"


def shifted_windows(
    data: torch.Tensor, *, left: int, right: int, top: int, bottom: int
) -> list[torch.Tensor]:
    """All stencil windows of ``data`` (periodic shifts), row-major order.

    ``window[a*sx+b][j, i] == data[(j - top + a) % ny, (i - left + b) % nx]``
    """
    return [
        torch.roll(data, shifts=(top - a, left - b), dims=(0, 1))
        for a in range(top + bottom + 1)
        for b in range(left + right + 1)
    ]


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
    """Plain version of the generic 2D stencil apply (any direction)."""
    if bc not in ("periodic", "np"):
        raise ValueError(f"bc must be 'periodic' or 'np', got {bc!r}")
    wins = shifted_windows(data, left=left, right=right, top=top, bottom=bottom)
    out = point_fn(wins, coeffs)
    if bc == "np":
        mask = torch.as_tensor(
            interior_mask(data.shape, left=left, right=right, top=top,
                          bottom=bottom),
            device=data.device,
        )
        base = torch.zeros_like(out) if out_init is None else out_init
        out = torch.where(mask, out, base.to(out.dtype))
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
