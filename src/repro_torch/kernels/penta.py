"""Batched pentadiagonal solver, the cuPentBatch analogue (counterpart of
``repro.kernels.penta``).

The ADI scheme inverts ``L = I + alpha delta^4`` along each grid direction
every step.  The band is constant in time, so the solve splits like
cuSten's Create/Compute:

- :func:`penta_factor` / :func:`cyclic_penta_factor` (Create, once): LU
  factorisation on the host in the plan's dtype, exactly as the reference
  scans it, then the factors move to the device.
- The substitutions (Compute, every step), in two layouts:
  *column layout* (:func:`penta_solve_factored`, the y-sweep; systems along
  axis 0, batch on the contiguous axis) and *row layout*
  (:func:`penta_solve_factored_rows`, the x-sweep; recurrence along the
  contiguous axis).  On a CUDA tensor each launches its CUDA kernel
  (``csrc/penta.cu``); on a CPU tensor it runs the plain version below.
- Periodic bands close with a rank-4 Woodbury correction
  ``x = y - W (V^T y)`` whose ``W = Z S^{-1}`` is precomputed at Create.
  The CUDA kernels apply it as their epilogue; the plain path applies it
  with the same four broadcast products as the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.util import ceil_div, numpy_dtype, resolve_device


class PentaFactors(NamedTuple):
    """LU factors of a pentadiagonal band (all shape (M,))."""

    sub: torch.Tensor  # e_i = l2 (unchanged sub-sub diagonal)
    low: torch.Tensor  # l_i = eliminated sub diagonal
    inv_mu: torch.Tensor  # 1/mu_i (reciprocal pivots)
    al: torch.Tensor  # alpha_i (first superdiagonal of U)
    be: torch.Tensor  # beta_i (second superdiagonal of U)


class CyclicPentaFactors(NamedTuple):
    band: PentaFactors
    z: torch.Tensor  # (M, 4) A^{-1} U
    s_inv: torch.Tensor  # (4, 4) inv(I + V^T A^{-1} U)
    w: torch.Tensor  # (M, 4) Z S^{-1}


def _host(a, dtype=None) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def _factor_host(l2, l1, d, u1, u2):
    """The reference's LU scan (``repro/kernels/penta.py:79-109``) on the
    host, in the diagonals' own dtype."""
    d = _host(d)
    dt = d.dtype
    l2, l1, u1, u2 = (_host(a, dt) for a in (l2, l1, u1, u2))
    M = d.shape[0]
    zero = dt.type(0)
    e = np.concatenate([np.zeros(2, dt), l2[2:]])
    c = np.concatenate([np.zeros(1, dt), l1[1:]])
    a = np.concatenate([u1[: M - 1], np.zeros(1, dt)])
    b = np.concatenate([u2[: M - 2], np.zeros(2, dt)])
    low, inv_mu, al, be = (np.empty(M, dt) for _ in range(4))
    a1 = a2 = b1 = b2 = zero  # alpha_{i-1}, alpha_{i-2}, beta_{i-1}, beta_{i-2}
    one = dt.type(1)
    for i in range(M):
        l_i = c[i] - e[i] * a2
        mu_i = d[i] - e[i] * b2 - l_i * a1
        inv = one / mu_i
        al_i = (a[i] - l_i * b1) * inv
        be_i = b[i] * inv
        low[i], inv_mu[i], al[i], be[i] = l_i, inv, al_i, be_i
        a1, a2, b1, b2 = al_i, a1, be_i, b1
    return e, low, inv_mu, al, be


def _to_device(arrays, device):
    return [torch.as_tensor(np.ascontiguousarray(a), device=device) for a in arrays]


def penta_factor(l2, l1, d, u1, u2, *, device="cuda") -> PentaFactors:
    """LU-factor the pentadiagonal matrix with diagonals (length M):
    ``A[i, i-2] = l2[i]``, ``A[i, i-1] = l1[i]``, ``A[i, i] = d[i]``,
    ``A[i, i+1] = u1[i]``, ``A[i, i+2] = u2[i]`` (out-of-band entries are
    ignored).  No pivoting: for the SPD / diagonally dominant operators of
    implicit time stepping.  Factors on the host in the diagonals' dtype,
    then moves the factors to ``device``."""
    dev = resolve_device(device)
    return PentaFactors(*_to_device(_factor_host(l2, l1, d, u1, u2), dev))


def cyclic_penta_factor(l2, l1, d, u1, u2, *, device="cuda") -> CyclicPentaFactors:
    """Factor the cyclic pentadiagonal matrix whose row ``i`` couples columns
    ``(i-2, i-1, i, i+1, i+2) mod M`` (reference ``:555-581``).  Needs
    M >= 6 so the corner blocks do not overlap the band."""
    dev = resolve_device(device)
    d = _host(d)
    M = d.shape[0]
    if M < 6:
        raise ValueError("cyclic pentadiagonal needs M >= 6")
    dt = d.dtype
    l2, l1, u1, u2 = (_host(a, dt) for a in (l2, l1, u1, u2))
    band = _factor_host(l2, l1, d, u1, u2)
    U = np.zeros((M, 4), dt)
    U[0, 0] = l2[0]  # (0, M-2)
    U[0, 1] = l1[0]  # (0, M-1)
    U[1, 1] = l2[1]  # (1, M-1)
    U[M - 2, 2] = u2[M - 2]  # (M-2, 0)
    U[M - 1, 2] = u1[M - 1]  # (M-1, 0)
    U[M - 1, 3] = u2[M - 1]  # (M-1, 1)
    # the Create-time solves A Z = U run the plain substitution on the CPU
    z = substitute_torch(
        PentaFactors(*map(torch.from_numpy, band)), torch.from_numpy(U)
    ).numpy()
    s = np.eye(4, dtype=dt) + np.stack([z[M - 2], z[M - 1], z[0], z[1]])
    s_inv = np.linalg.inv(s).astype(dt)
    w = (z @ s_inv).astype(dt)
    band_t = PentaFactors(*_to_device(band, dev))
    return CyclicPentaFactors(band_t, *_to_device((z, s_inv, w), dev))


def hyperdiffusion_diagonals(M: int, alpha, dtype=torch.float64):
    """Diagonals of ``I + alpha delta^4`` (eq. 4b of the paper), as host
    numpy arrays in ``dtype``."""
    one = np.ones(M, numpy_dtype(dtype))
    return (
        alpha * one,  # l2
        -4.0 * alpha * one,  # l1
        1.0 + 6.0 * alpha * one,  # d
        -4.0 * alpha * one,  # u1
        alpha * one,  # u2
    )


def diffusion_diagonals(M: int, r, dtype=torch.float64):
    """Diagonals of ``I - r delta^2`` (backward-Euler diffusion sweep) as a
    pentadiagonal band with zero outer diagonals."""
    one = np.ones(M, numpy_dtype(dtype))
    zero = np.zeros(M, numpy_dtype(dtype))
    return (zero, -r * one, 1.0 + 2.0 * r * one, -r * one, zero)


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the reference the CUDA kernels are held to)
# ---------------------------------------------------------------------------


def substitute_torch(fac: PentaFactors, rhs: torch.Tensor) -> torch.Tensor:
    """Column-layout forward/backward substitution on an (M, N) rhs."""
    M = rhs.shape[0]
    z = torch.empty_like(rhs)
    z1 = z2 = torch.zeros_like(rhs[0])
    for i in range(M):
        z[i] = (rhs[i] - fac.sub[i] * z2 - fac.low[i] * z1) * fac.inv_mu[i]
        z1, z2 = z[i], z1
    x = torch.empty_like(rhs)
    x1 = x2 = torch.zeros_like(rhs[0])
    for i in range(M - 1, -1, -1):
        x[i] = z[i] - fac.al[i] * x1 - fac.be[i] * x2
        x1, x2 = x[i], x1
    return x


def substitute_rows_torch(fac: PentaFactors, rhs: torch.Tensor) -> torch.Tensor:
    """Row-layout substitution on a (B, M) rhs, recurrence along axis 1.
    The intermediate is stored recurrence-major (M, B), as in the
    reference's ``_substitute_rows_jnp``."""
    M = rhs.shape[1]
    z = torch.empty((M,) + rhs.shape[:1], dtype=rhs.dtype, device=rhs.device)
    z1 = z2 = torch.zeros_like(rhs[:, 0])
    for i in range(M):
        z[i] = (rhs[:, i] - fac.sub[i] * z2 - fac.low[i] * z1) * fac.inv_mu[i]
        z1, z2 = z[i], z1
    x = torch.empty_like(rhs)
    x1 = x2 = torch.zeros_like(rhs[:, 0])
    for i in range(M - 1, -1, -1):
        x[:, i] = z[i] - fac.al[i] * x1 - fac.be[i] * x2
        x1, x2 = x[:, i], x1
    return x


def woodbury_correct(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Column-layout Woodbury closure ``x = y - W (V^T y)`` on an (M, N)
    band solution (reference ``:604-609``)."""
    M = y.shape[0]
    return y - (
        w[:, 0:1] * y[M - 2][None, :]
        + w[:, 1:2] * y[M - 1][None, :]
        + w[:, 2:3] * y[0][None, :]
        + w[:, 3:4] * y[1][None, :]
    )


def rows_woodbury_correct(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Row-layout Woodbury closure on a (B, M) band solution, as four
    broadcast products (reference ``rows_woodbury_correct``)."""
    M = y.shape[1]
    return y - (
        y[:, M - 2][:, None] * w[None, :, 0]
        + y[:, M - 1][:, None] * w[None, :, 1]
        + y[:, 0][:, None] * w[None, :, 2]
        + y[:, 1][:, None] * w[None, :, 3]
    )


# ---------------------------------------------------------------------------
# CUDA kernel wrappers (csrc/penta.cu)
# ---------------------------------------------------------------------------


def _check_factors(band: PentaFactors, w, rhs: torch.Tensor, M: int) -> None:
    for name, f in zip(PentaFactors._fields, band, strict=True):
        _build.check_cuda(f, f"factor {name}", like=rhs, shape=(M,))
    if w is not None:
        _build.check_cuda(w, "Woodbury w", like=rhs, shape=(M, 4))


def rows_per_block(M: int, itemsize: int, n_rows: int, smem_optin: int,
                   n_sms: int) -> int:
    """Rows a block stages in shared memory for a row-layout sweep.

    As many as fit (row stride ``M + 1``), at most 32 (one warp runs the
    recurrences), and no more than spreads ``n_rows`` over all SMs: the
    recurrence time does not shrink with more rows per block, so more,
    smaller blocks finish sooner.  Raises if one row does not fit."""
    fit = smem_optin // ((M + 1) * itemsize)
    if fit < 1:
        raise ValueError(
            f"a row of {M} x {itemsize}-byte elements does not fit in the "
            f"{smem_optin} bytes of shared memory a block can hold"
        )
    return max(1, min(fit, 32, ceil_div(n_rows, n_sms)))


def penta_cols_cuda(
    band: PentaFactors, rhs: torch.Tensor, w: torch.Tensor | None = None
) -> torch.Tensor:
    """Launch the column-layout kernel on an (M, N) CUDA rhs; with ``w``
    (the cyclic Woodbury matrix) the closure runs as its epilogue."""
    M, N = rhs.shape
    _build.check_cuda(rhs, "rhs", like=rhs, shape=(M, N))
    _check_factors(band, w, rhs, M)
    out = torch.empty_like(rhs)
    _build.launch(
        "penta_cols", rhs.device, _build.dtype_code(rhs),
        *(_build.ptr(f) for f in band), _build.ptr(w), _build.ptr(rhs),
        _build.ptr(out), M, N,
    )
    return out


def penta_rows_cuda(
    band: PentaFactors, rhs: torch.Tensor, w: torch.Tensor | None = None
) -> torch.Tensor:
    """Launch the row-layout kernel on a (B, M) CUDA rhs; with ``w`` the
    Woodbury closure runs on the kernel's write-out."""
    B, M = rhs.shape
    _build.check_cuda(rhs, "rhs", like=rhs, shape=(B, M))
    _check_factors(band, w, rhs, M)
    smem, sms = _build.device_info(rhs.device)
    R = rows_per_block(M, rhs.element_size(), B, smem, sms)
    out = torch.empty_like(rhs)
    _build.launch(
        "penta_rows", rhs.device, _build.dtype_code(rhs),
        *(_build.ptr(f) for f in band), _build.ptr(w), _build.ptr(rhs),
        _build.ptr(out), B, M, R,
    )
    return out


# ---------------------------------------------------------------------------
# Dispatch (backend 'auto' | 'cuda' | 'torch')
# ---------------------------------------------------------------------------


def _solve_cols(band, w, rhs, backend):
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[:, None]
    if _build.resolve_backend(backend, rhs) == "cuda":
        out = penta_cols_cuda(band, rhs, w)
    else:
        out = substitute_torch(band, rhs)
        if w is not None:
            out = woodbury_correct(out, w)
    return out[:, 0] if squeeze else out


def _solve_rows(band, w, rhs, backend):
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[None, :]
    if _build.resolve_backend(backend, rhs) == "cuda":
        out = penta_rows_cuda(band, rhs, w)
    else:
        out = substitute_rows_torch(band, rhs)
        if w is not None:
            out = rows_woodbury_correct(out, w)
    return out[0] if squeeze else out


def penta_solve_factored(fac: PentaFactors, rhs, *, backend: str = "auto"):
    """Solve ``A x = rhs`` given Create-time factors.  rhs: (M,) or (M, N)."""
    return _solve_cols(fac, None, rhs, backend)


def penta_solve_factored_rows(fac: PentaFactors, rhs, *, backend: str = "auto"):
    """Row-layout solve: ``rhs`` is (B, M) (or (M,)), each row one system."""
    return _solve_rows(fac, None, rhs, backend)


def cyclic_penta_solve_factored(
    fac: CyclicPentaFactors, rhs, *, backend: str = "auto"
):
    """Cyclic column-layout solve: ``x = y - W V^T y``, ``y = A^{-1} rhs``."""
    return _solve_cols(fac.band, fac.w, rhs, backend)


def cyclic_penta_solve_factored_rows(
    fac: CyclicPentaFactors, rhs, *, backend: str = "auto"
):
    """Cyclic row-layout solve on a (B, M) rhs (each row one system): the
    transpose-free x-sweep of a periodic ADI step."""
    return _solve_rows(fac.band, fac.w, rhs, backend)
