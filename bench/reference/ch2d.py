"""Plain reference of the Cahn–Hilliard ADI scheme (cuSten, arXiv:1902.09931,
§V, eqs. 2-6), its control and the comparison that decides ``correct``.

Plain PyTorch only; it imports nothing of the program under test and takes
nothing it made.  The stencils are ``torch.roll`` differences; each implicit
operator ``I + beta delta^4`` along one axis is circulant on the periodic
grid, so its solve is a division by its Fourier symbol
``1 + 16 beta sin^4(pi k / n)`` (``torch.fft``), worked out here from the
configuration, not the program's LU factors.

    L_x w = -(2/3)(C^n - C^{n-1}) - (2/3) dt D gamma grad^4 Cbar
            + (2/3) D dt grad^2 (C^3 - C)^n,      Cbar = 2 C^n - C^{n-1}
    L_y v = w,        C^{n+1} = Cbar + v                          (eq. 2)

with the eq. 3 half-step pair for C^1, and the coarsening diagnostics of
§V.C: s = 1/(1 - <C^2>) (Simpson average), 1/k1 from |C^|^2, the free
energy with central differences, and the mass.
"""

from __future__ import annotations

import math

import torch


def _dxx(c, dim):
    return torch.roll(c, 1, dim) - 2.0 * c + torch.roll(c, -1, dim)


class Reference:
    def __init__(self, config: dict, grid, dtype=torch.float64, device="cpu"):
        self.ny, self.nx = (int(s) for s in grid)
        self.dtype, self.device = dtype, torch.device(device)
        self.lx, self.ly = config["lx"], config["ly"]
        self.dt, self.D, self.gamma = config["dt"], config["D"], config["gamma"]
        h = self.lx / self.nx
        self.inv_h2, self.inv_h4 = 1.0 / h**2, 1.0 / h**4
        self.beta_full = (2.0 / 3.0) * self.D * self.gamma * self.dt * self.inv_h4
        self.beta_half = 0.5 * self.D * self.gamma * self.dt * self.inv_h4

    def _symbol4(self, n: int, m: int) -> torch.Tensor:
        """16 sin^4(pi k / n) for the first m frequencies of an n-point axis
        (the delta^4 symbol)."""
        k = torch.arange(m, dtype=torch.float64, device=self.device)
        return (16.0 * torch.sin(math.pi * k / n) ** 4).to(self.dtype)

    def solve_x(self, rhs, beta):
        f = torch.fft.rfft(rhs, dim=1)
        f /= 1.0 + beta * self._symbol4(self.nx, self.nx // 2 + 1)[None, :]
        return torch.fft.irfft(f, n=self.nx, dim=1)

    def solve_y(self, rhs, beta):
        f = torch.fft.rfft(rhs, dim=0)
        f /= 1.0 + beta * self._symbol4(self.ny, self.ny // 2 + 1)[:, None]
        return torch.fft.irfft(f, n=self.ny, dim=0)

    @staticmethod
    def lap(g):
        return _dxx(g, 0) + _dxx(g, 1)

    @staticmethod
    def cross(c):
        """delta_x delta_y c (the 3x3 product stencil)."""
        return _dxx(_dxx(c, 0), 1)

    def biharmonic(self, c):
        return _dxx(_dxx(c, 1), 1) + _dxx(_dxx(c, 0), 0) + 2.0 * self.cross(c)

    def step(self, c_n, c_nm1):
        """One step of eq. 2: returns (C^{n+1}, C^n)."""
        cbar = 2.0 * c_n - c_nm1
        rhs = (-(2.0 / 3.0) * (c_n - c_nm1)
               - (2.0 / 3.0) * self.dt * self.gamma * self.D * self.inv_h4
               * self.biharmonic(cbar)
               + (2.0 / 3.0) * self.D * self.dt * self.inv_h2
               * self.lap(c_n * c_n * c_n - c_n))
        v = self.solve_y(self.solve_x(rhs, self.beta_full), self.beta_full)
        return cbar + v, c_n

    def bootstrap(self, c0):
        """The eq. 3 half-step pair: C^1 from C^0."""
        half = 0.5 * self.dt
        coef_h = self.D * self.gamma * self.inv_h4
        coef_l = self.D * self.inv_h2

        def explicit(c, along):  # delta_along^2 + 2 delta_x delta_y
            return _dxx(_dxx(c, along), along) + 2.0 * self.cross(c)

        rhs_a = c0 + half * (-coef_h * explicit(c0, 0)
                             + coef_l * self.lap(c0 * c0 * c0 - c0))
        c_half = self.solve_x(rhs_a, self.beta_half)
        rhs_b = c_half + half * (-coef_h * explicit(c_half, 1)
                                 + coef_l * self.lap(c_half**3 - c_half))
        return self.solve_y(rhs_b, self.beta_half)

    # -- diagnostics (§V.C) -------------------------------------------------
    def _simpson(self, n: int) -> torch.Tensor:
        """Composite Simpson weights of a periodic axis of n points (the
        weight of point n folds onto point 0), over n."""
        w = torch.ones(n + 1, dtype=torch.float64)
        w[1:-1:2], w[2:-1:2] = 4.0, 2.0
        w = w[:-1] / 3.0
        w[0] += 1.0 / 3.0
        return (w / n).to(self.dtype).to(self.device)

    def average(self, f):
        return self._simpson(self.ny) @ f @ self._simpson(self.nx)

    def diagnostics(self, c) -> list[float]:
        """(s, 1/k1, F, M) of the field c."""
        area = self.lx * self.ly
        s = 1.0 / (1.0 - self.average(c * c))
        chat2 = torch.abs(torch.fft.fft2(c)) ** 2
        kx = 2 * math.pi * torch.fft.fftfreq(self.nx, d=self.lx / self.nx,
                                             dtype=self.dtype, device=self.device)
        ky = 2 * math.pi * torch.fft.fftfreq(self.ny, d=self.ly / self.ny,
                                             dtype=self.dtype, device=self.device)
        kmag = torch.sqrt(kx[None, :] ** 2 + ky[:, None] ** 2)
        inv_k = torch.where(kmag > 0, 1.0 / kmag.clamp(min=1e-30),
                            torch.zeros_like(kmag))
        k1 = chat2.sum() / (inv_k * chat2).sum()
        gx = (torch.roll(c, -1, 1) - torch.roll(c, 1, 1)) * (self.nx / (2 * self.lx))
        gy = (torch.roll(c, -1, 0) - torch.roll(c, 1, 0)) * (self.ny / (2 * self.ly))
        dens = 0.25 * (c * c - 1.0) ** 2 + 0.5 * self.gamma * (gx * gx + gy * gy)
        F = self.average(dens) * area
        M = self.average(c) * area
        return torch.stack([s, 1.0 / k1, F, M]).double().tolist()


class Control:
    """The control: the reference in float32, the precision below the
    configuration's float64, in the program's place (the driver's
    interface; see ``bench/drivers/ch2d.py``)."""

    def __init__(self, config, traffic, ic, device, spans,
                 dtype=torch.float32):
        self.ref = Reference(config, traffic["grid"], dtype, device)
        self.steps_per_chunk = int(traffic["chunk"])
        c0 = ic.to(dtype)
        with spans("bootstrap"):
            c1 = self.ref.bootstrap(c0)
        self.carry, self.boot = (c1, c0), c1

    def state(self):
        return self.carry

    def current(self):
        return self.carry[0]

    def chunk(self):
        for _ in range(self.steps_per_chunk):
            self.carry = self.ref.step(*self.carry)

    def diagnostics(self):
        return self.ref.diagnostics(self.carry[0])

    def counters(self):
        return {}

    def step_calls(self):
        return []

    def floor_bytes(self):
        return 0

    def close(self):
        self.carry = self.boot = None


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want|, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / want.abs().max())


def judge(config: dict, traffic: dict, ev: dict, device) -> dict:
    """The numbers ``correct`` holds to the cell's limits:

    - ``boot_gap``: the bootstrap's C^1 against the reference's from the
      same initial field;
    - ``traj_gap``: the field the checked chunk left against the
      reference's whole trajectory from the initial field (the bootstrap,
      the warm-up chunks and every chunk up to the checked one);
    - ``chunk_gap``: the same field against the reference's chunk from the
      state that entered it;
    - ``diag_gap``: that chunk's four diagnostics against the reference's
      on its own field, each relative to its value, the mass relative to
      the area times the field's rms (the mass itself is near 0).
    """
    ref = Reference(config, traffic["grid"], torch.float64, device)
    to = dict(dtype=torch.float64, device=device)
    out = {}
    got = ev["current_out"].to(**to)
    c0 = ev["ic"].to(**to)
    c_n, c_nm1 = ref.bootstrap(c0), c0
    if ev["boot"] is not None:
        out["boot_gap"] = rel_gap(ev["boot"].to(**to), c_n)
    for _ in range((ev["chunks_before"] + 1) * ev["steps"]):
        c_n, c_nm1 = ref.step(c_n, c_nm1)
    out["traj_gap"] = rel_gap(got, c_n)
    c_n, c_nm1 = (t.to(**to) for t in ev["state_in"])
    for _ in range(ev["steps"]):
        c_n, c_nm1 = ref.step(c_n, c_nm1)
    out["chunk_gap"] = rel_gap(got, c_n)
    want = ref.diagnostics(c_n)
    mass_scale = config["lx"] * config["ly"] * float(c_n.square().mean().sqrt())
    scales = [abs(want[0]), abs(want[1]), abs(want[2]), mass_scale]
    out["diag_gap"] = max(abs(g - w) / sc
                          for g, w, sc in zip(ev["diag"], want, scales, strict=True))
    return out
