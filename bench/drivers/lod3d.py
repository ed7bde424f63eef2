"""3D diffusion by LOD backward-Euler ADI, as ``examples/
torch_diffusion3d_adi.py`` runs it: ``repro_torch.create('diffusion', (n,
n, n), mode='adi', alpha=D dt / h^2, cyclic=True)`` stepped by
``repro_torch.compute``, and after every chunk the example's diagnostic:
the ``laplacian`` plan (``stencil3d``), the residual ``max|(1 - 1/g)/dt c
- D lap c|`` with ``g`` the k = 1 mode's exact decay a step, and the
amplitude ``max|c|``, read to the host.

Traffic keys: ``grid`` (n, n, n), ``chunk`` (steps a chunk).
"""

from __future__ import annotations

import math

import torch

import repro_torch as rt
from repro_torch.kernels import _build


class Driver:
    def __init__(self, config: dict, traffic: dict, ic: torch.Tensor,
                 device: torch.device, spans):
        n = int(traffic["grid"][0])
        if tuple(traffic["grid"]) != (n, n, n):
            raise ValueError(f"lod3d wants a cube, got {traffic['grid']}")
        self.n = n
        self.steps_per_chunk = int(traffic["chunk"])
        self.itemsize = ic.element_size()
        h = config["length"] / n
        self.dt, self.D = config["dt"], config["D"]
        r = self.D * self.dt / h**2
        g = 1.0 / (1.0 + 4.0 * r * math.sin(h / 2.0) ** 2) ** 3
        self.k = (1.0 - 1.0 / g) / self.dt
        with spans("build"):
            if device.type == "cuda":
                _build.build()
        with spans("create"):
            self.op = rt.create("diffusion", (n, n, n), mode="adi", alpha=r,
                                cyclic=True, dtype=ic.dtype, device=device)
            self.lap = rt.create("laplacian", (n, n, n), bc="periodic", h=h,
                                 dtype=ic.dtype, device=device)
        self.c = ic
        self.boot = None

    def state(self):
        return (self.c,)

    def current(self) -> torch.Tensor:
        return self.c

    def chunk(self) -> None:
        c = self.c
        for _ in range(self.steps_per_chunk):
            c = rt.compute(self.op, c)
        self.c = c

    def diagnostics(self) -> list[float]:
        """``(amp, residual)`` of the current field, on the host."""
        c = self.c
        amp = c.abs().max()
        lap_c = rt.compute(self.lap, c)
        res = (self.k * c - self.D * lap_c).abs().max()
        return torch.stack([amp, res]).tolist()

    def counters(self) -> dict:
        return dict(_build.LAUNCHES)

    def step_calls(self) -> list:
        n, item = self.n, self.itemsize
        return [("penta_rows", dict(m=n, n=n * n, itemsize=item, band=1)),
                ("penta_mid", dict(p=n, m=n, q=n, itemsize=item, band=1)),
                ("penta_cols", dict(m=n, n=n * n, itemsize=item, band=1))]

    def floor_bytes(self) -> int:
        """The step's own floor: c read once and written once."""
        return 2 * self.n**3 * self.itemsize

    def close(self) -> None:
        rt.destroy(self.op)
        rt.destroy(self.lap)
        self.c = self.op = self.lap = None
