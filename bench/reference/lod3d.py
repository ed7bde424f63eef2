"""Plain reference of 3D diffusion by LOD backward-Euler ADI (the paper's 3D
extension, ``examples/diffusion3d_adi.py``), its control and the
comparison that decides ``correct``.

Plain PyTorch only; it imports nothing of the program under test.  A step
is ``C <- L_z^{-1} L_y^{-1} L_x^{-1} C`` with ``L_i = I - r delta_i^2``,
``r = D dt / h^2``, on the periodic cube.  Each ``L_i`` is circulant, so the
three solves are one multiplication by ``1 / prod_i (1 + 4 r sin^2(pi k_i /
n))`` in Fourier space, and a chunk of ``s`` steps by that factor to the
power ``s``: one transform and its inverse, not ``3 s`` band solves.
"""

from __future__ import annotations

import math

import torch


class Reference:
    def __init__(self, config: dict, grid, dtype=torch.float64, device="cpu"):
        self.n = int(grid[0])
        self.dtype, self.device = dtype, torch.device(device)
        self.h = config["length"] / self.n
        self.dt, self.D = config["dt"], config["D"]
        self.r = self.D * self.dt / self.h**2
        g = 1.0 / (1.0 + 4.0 * self.r * math.sin(self.h / 2.0) ** 2) ** 3
        self.k = (1.0 - 1.0 / g) / self.dt

    def _inverse_symbol(self, m: int) -> torch.Tensor:
        k = torch.arange(m, dtype=torch.float64, device=self.device)
        return (1.0 / (1.0 + 4.0 * self.r * torch.sin(math.pi * k / self.n) ** 2)
                ).to(self.dtype)

    def steps(self, c: torch.Tensor, s: int) -> torch.Tensor:
        n = self.n
        full, half = self._inverse_symbol(n), self._inverse_symbol(n // 2 + 1)
        f = torch.fft.rfftn(c, dim=(0, 1, 2))
        f *= (full[:, None, None] * full[None, :, None] * half[None, None, :]) ** s
        return torch.fft.irfftn(f, s=(n, n, n), dim=(0, 1, 2))

    def laplacian(self, c: torch.Tensor) -> torch.Tensor:
        out = -6.0 * c
        for dim in range(3):
            out += torch.roll(c, 1, dim) + torch.roll(c, -1, dim)
        return out / self.h**2

    def diagnostics(self, c: torch.Tensor) -> list[float]:
        """(amp, residual): max|c| and max|(1 - 1/g)/dt c - D lap c|."""
        amp = c.abs().max()
        res = (self.k * c - self.D * self.laplacian(c)).abs().max()
        return torch.stack([amp, res]).double().tolist()

    def scales(self, c: torch.Tensor) -> list[float]:
        """What each diagnostic's gap is measured against: the amplitude's
        and the residual's of the fluctuation ``c - mean(c)``.  The mean,
        which the periodic box conserves, dominates both diagnostics but
        carries no Laplacian."""
        f = c - c.mean()
        res = (self.k * f - self.D * self.laplacian(c)).abs().max()
        return torch.stack([f.abs().max(), res]).double().tolist()


class Control:
    """The control: the reference in float32, the precision below the
    configuration's float64, in the program's place (the driver's
    interface; see ``bench/drivers/lod3d.py``)."""

    def __init__(self, config, traffic, ic, device, spans,
                 dtype=torch.float32):
        self.ref = Reference(config, traffic["grid"], dtype, device)
        self.steps_per_chunk = int(traffic["chunk"])
        self.c, self.boot = ic.to(dtype), None

    def state(self):
        return (self.c,)

    def current(self):
        return self.c

    def chunk(self):
        self.c = self.ref.steps(self.c, self.steps_per_chunk)

    def diagnostics(self):
        return self.ref.diagnostics(self.c)

    def counters(self):
        return {}

    def step_calls(self):
        return []

    def floor_bytes(self):
        return 0

    def close(self):
        self.c = None


def fluct_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want - mean(want)|, in float64: the field
    soon sits within 1e-4 of its mean, so a gap is measured against the
    part that diffuses."""
    got, want = got.double(), want.double()
    return float((got - want).abs().max() / (want - want.mean()).abs().max())


def judge(config: dict, traffic: dict, ev: dict, device) -> dict:
    """The numbers ``correct`` holds to the cell's limits:

    - ``traj_gap``: the field the checked chunk left against the
      reference's whole trajectory from the initial field (the warm-up
      chunks and every chunk up to the checked one);
    - ``chunk_gap``: the same field against the reference's chunk from the
      field that entered it;
    - ``diag_gap``: that chunk's amplitude and residual against the
      reference's on its own field, each relative to the fluctuation's
      (``Reference.scales``).
    """
    ref = Reference(config, traffic["grid"], torch.float64, device)
    to = dict(dtype=torch.float64, device=device)
    got = ev["current_out"].to(**to)
    c = ref.steps(ev["ic"].to(**to), (ev["chunks_before"] + 1) * ev["steps"])
    traj = fluct_gap(got, c)
    c = ref.steps(ev["state_in"][0].to(**to), ev["steps"])
    gap = fluct_gap(got, c)
    want, scales = ref.diagnostics(c), ref.scales(c)
    diag = max(abs(g - w) / sc
               for g, w, sc in zip(ev["diag"], want, scales, strict=True))
    return dict(traj_gap=traj, chunk_gap=gap, diag_gap=diag)
