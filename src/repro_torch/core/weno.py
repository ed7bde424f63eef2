"""2D periodic WENO5 advection solver (paper §IV.C, ``2d_xyADVWENO_p``;
counterpart of ``repro.core.weno``).

dq/dt + u q_x + v q_y = 0 with upwinded Hamilton–Jacobi WENO5 spatial
derivatives (Osher & Fedkiw — the paper's ref [2]) and third-order TVD
Runge–Kutta time stepping (Shu–Osher).  The RHS is the WENO kernel
(:func:`repro_torch.kernels.ops.weno_advect`); the Runge–Kutta glue is
plain PyTorch, as the reference computes it outside Pallas.  Everything
runs on ``AdvectionConfig.device`` (the card unless the caller asks for the
CPU).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.kernels import ops as _ops
from repro_torch.kernels._build import check_kernel_backend
from repro_torch.util import resolve_device, torch_dtype


@dataclasses.dataclass(frozen=True)
class AdvectionConfig:
    nx: int = 512
    ny: int = 512
    lx: float = 2.0 * np.pi
    ly: float = 2.0 * np.pi
    cfl: float = 0.4
    backend: str = "auto"  # 'auto' | 'cuda' | 'torch'
    device: str = "cuda"

    @property
    def dx(self) -> float:
        return self.lx / self.nx

    @property
    def dy(self) -> float:
        return self.ly / self.ny


class WenoAdvection2D:
    """Create-once advection stepper; velocities are extra streamed inputs
    exactly like the u/v fields of the paper's modified kernel."""

    def __init__(self, cfg: AdvectionConfig):
        check_kernel_backend(cfg.backend)
        self.cfg = cfg
        self.device = resolve_device(cfg.device)

    def rhs(self, q: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        return _ops.weno_advect(
            q, u, v, dx=self.cfg.dx, dy=self.cfg.dy, backend=self.cfg.backend
        )

    def dt_cfl(self, u: torch.Tensor, v: torch.Tensor) -> float:
        """The CFL time step ``cfl / max(max|u|/dx + max|v|/dy, 1e-12)``.
        The two maxima come to the host in one sync and the rest is Python
        float arithmetic (the reference returns a 0-d array)."""
        umax, vmax = torch.stack((u.abs().max(), v.abs().max())).tolist()
        return self.cfg.cfl / max(umax / self.cfg.dx + vmax / self.cfg.dy, 1e-12)

    def step(self, q, u, v, dt) -> torch.Tensor:
        """One Shu–Osher TVD-RK3 step."""
        q1 = q + dt * self.rhs(q, u, v)
        q2 = 0.75 * q + 0.25 * (q1 + dt * self.rhs(q1, u, v))
        return q / 3.0 + (2.0 / 3.0) * (q2 + dt * self.rhs(q2, u, v))

    def run(
        self,
        q0: torch.Tensor,
        u: torch.Tensor,
        v: torch.Tensor,
        t_final: float,
        *,
        dt: float | None = None,
    ) -> tuple[torch.Tensor, int]:
        """Integrate to ``t_final`` in ``ceil(t_final / dt)`` equal steps;
        returns ``(q, n_steps)``.

        The reference scans a jitted step; here a Python loop updates two
        preallocated stage buffers and the state in place, with
        :meth:`step`'s arithmetic rounding for rounding (each RHS is scaled
        by dt before it is added, as ``q + dt * r`` is).  The one host sync
        is :meth:`dt_cfl`'s; ``q0`` is left as it was."""
        dt = self.dt_cfl(u, v) if dt is None else dt
        n_steps = int(math.ceil(t_final / dt))
        dt = t_final / n_steps
        q = q0.clone()
        q1 = torch.empty_like(q)
        q2 = torch.empty_like(q)
        for _ in range(n_steps):
            torch.add(q, self.rhs(q, u, v).mul_(dt), out=q1)
            r = self.rhs(q1, u, v).mul_(dt).add_(q1).mul_(0.25)
            torch.mul(q, 0.75, out=q2).add_(r)
            r = self.rhs(q2, u, v).mul_(dt).add_(q2).mul_(2.0 / 3.0)
            q.div_(3.0).add_(r)
        return q, n_steps


def _grid(cfg: AdvectionConfig, dtype):
    """``X, Y`` of ``meshgrid(linspace(0, lx, nx, endpoint=False), ...)`` on
    the CPU, as ``l * (i / n)``: the reference's nodes to one ulp, and
    exactly when n is a power of two."""
    dt = torch_dtype(dtype)

    def nodes(n, length):
        return length * (torch.arange(n, dtype=dt) / torch.tensor(n, dtype=dt))

    Y, X = torch.meshgrid(nodes(cfg.ny, cfg.ly), nodes(cfg.nx, cfg.lx),
                          indexing="ij")
    return X, Y


# The fields are computed on the CPU and then moved, so they are the same
# values on every device.


def solid_body_rotation(cfg: AdvectionConfig, dtype="float64", device="cuda"):
    """u = -(y - pi), v = (x - pi): rigid rotation about the box centre."""
    dev = resolve_device(device)
    X, Y = _grid(cfg, dtype)
    return (-(Y - cfg.ly / 2)).to(dev), (X - cfg.lx / 2).to(dev)


def gaussian_blob(cfg: AdvectionConfig, *, x0, y0, sigma, dtype="float64",
                  device="cuda"):
    dev = resolve_device(device)
    X, Y = _grid(cfg, dtype)
    return torch.exp(-((X - x0) ** 2 + (Y - y0) ** 2) / (2 * sigma**2)).to(dev)
