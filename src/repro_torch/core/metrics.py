"""Coarsening diagnostics for the Cahn–Hilliard runs (paper §V.C;
counterpart of ``repro.core.metrics``).

- ``s(t) = 1 / (1 - <C^2>)`` with the spatial average by composite Simpson
  over the periodic grid;
- ``k1(t) = ∫|Ĉ|² dk / ∫|k|⁻¹|Ĉ|² dk`` from the 2D FFT (``torch.fft``);
- the free energy ``F[C] = ∫ (1/4)(C²-1)² + (γ/2)|∇C|²``;
- the mass ``∫ C``, conserved exactly by the dynamics.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def simpson_weights_periodic(n: int, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """Composite Simpson weights for n (even) samples of a periodic function
    (sample n would equal sample 0, so its weight folds onto index 0)."""
    if n % 2:
        raise ValueError("Simpson needs an even number of intervals")
    w = np.zeros(n + 1)
    w[0] = w[-1] = 1.0
    w[1:-1:2] = 4.0
    w[2:-1:2] = 2.0
    w /= 3.0
    w_periodic = w[:-1].copy()
    w_periodic[0] += w[-1]
    return torch.as_tensor(w_periodic, dtype=dtype, device=device)


def spatial_average(field: torch.Tensor, lx: float, ly: float) -> torch.Tensor:
    """Simpson-rule average of a periodic 2D field."""
    ny, nx = field.shape
    kw = dict(dtype=field.dtype, device=field.device)
    wy = simpson_weights_periodic(ny, **kw) * (ly / ny)
    wx = simpson_weights_periodic(nx, **kw) * (lx / nx)
    return (wy @ field @ wx) / (lx * ly)


def s_metric(c: torch.Tensor, lx: float, ly: float) -> torch.Tensor:
    """s(t) = 1 / (1 - <C^2>)  (paper eq. 5)."""
    return 1.0 / (1.0 - spatial_average(c * c, lx, ly))


def k1_metric(c: torch.Tensor, lx: float, ly: float) -> torch.Tensor:
    """k1(t) (paper eq. 6); 1/k1 is the coarsening length scale."""
    ny, nx = c.shape
    chat2 = torch.abs(torch.fft.fft2(c)) ** 2
    kw = dict(dtype=c.dtype, device=c.device)
    kx = 2 * math.pi * torch.fft.fftfreq(nx, d=lx / nx, **kw)
    ky = 2 * math.pi * torch.fft.fftfreq(ny, d=ly / ny, **kw)
    kmag = torch.sqrt(kx[None, :] ** 2 + ky[:, None] ** 2)
    inv_k = torch.where(kmag > 0, 1.0 / torch.clamp(kmag, min=1e-30),
                        torch.zeros_like(kmag))
    return torch.sum(chat2) / torch.sum(inv_k * chat2)


def free_energy(c: torch.Tensor, gamma: float, lx: float, ly: float) -> torch.Tensor:
    """F[C] with a central-difference gradient (periodic)."""
    ny, nx = c.shape
    dx, dy = lx / nx, ly / ny
    gx = (torch.roll(c, -1, 1) - torch.roll(c, 1, 1)) / (2 * dx)
    gy = (torch.roll(c, -1, 0) - torch.roll(c, 1, 0)) / (2 * dy)
    dens = 0.25 * (c * c - 1.0) ** 2 + 0.5 * gamma * (gx * gx + gy * gy)
    return spatial_average(dens, lx, ly) * lx * ly


def mass(c: torch.Tensor, lx: float, ly: float) -> torch.Tensor:
    """∫ C dx — conserved exactly by the CH dynamics."""
    return spatial_average(c, lx, ly) * lx * ly


def fit_power_law(t: np.ndarray, y: np.ndarray) -> float:
    """Least-squares exponent of y ~ t^p (log-log fit)."""
    t, y = np.asarray(t), np.asarray(y)
    m = (t > 0) & (y > 0)
    return float(np.polyfit(np.log(t[m]), np.log(y[m]), 1)[0])
