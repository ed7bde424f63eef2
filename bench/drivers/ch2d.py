"""The Cahn–Hilliard ADI solver (cuSten's cuCahnPentADI) as its users run
it: Create, the eq. 3 bootstrap step, then ``make_evolve(chunk)`` on the
carry as ``ch_evolve`` drives it, with ``coarsening_metrics`` on the
current field after every chunk, read to the host.

Traffic keys: ``grid`` (ny, nx), ``rhs_mode``, ``chunk`` (steps a chunk).
"""

from __future__ import annotations

import torch

from repro_torch import api
from repro_torch.core.cahn_hilliard import (
    CahnHilliardADI,
    CHConfig,
    coarsening_metrics,
    poison_at_chunk,
)
from repro_torch.kernels import _build


class Driver:
    def __init__(self, config: dict, traffic: dict, ic: torch.Tensor,
                 device: torch.device, spans):
        ny, nx = traffic["grid"]
        self.rhs_mode = traffic["rhs_mode"]
        self.steps_per_chunk = int(traffic["chunk"])
        self.itemsize = ic.element_size()
        self.shape = (ny, nx)
        with spans("build"):
            if device.type == "cuda":
                _build.build()
        with spans("create"):
            self.cfg = CHConfig(
                nx=nx, ny=ny, lx=config["lx"], ly=config["ly"],
                dt=config["dt"], D=config["D"], gamma=config["gamma"],
                dtype=config["precision"], rhs_mode=self.rhs_mode,
                device=str(device))
            self.solver = CahnHilliardADI(self.cfg)
            self.evolve = self.solver.make_evolve(self.steps_per_chunk)
            self.metrics = coarsening_metrics(self.cfg)
        with spans("bootstrap"):
            c1 = self.solver.initial_step(ic)
            # ch_evolve's carry: the fresh field is the current one
            self.carry = api.swap((ic, c1))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        self.boot = c1
        self.done = 1  # the bootstrap counts as step 1

    def state(self):
        return self.carry

    def current(self) -> torch.Tensor:
        return self.carry[0]

    def chunk(self) -> None:
        self.carry = poison_at_chunk(self.carry, self.done)
        self.carry = self.evolve(*self.carry)
        self.done += self.steps_per_chunk

    def diagnostics(self) -> list[float]:
        """``(s, 1/k1, F, M)`` of the current field, on the host."""
        return torch.stack(self.metrics(self.carry[0])).tolist()

    def counters(self) -> dict:
        return dict(_build.LAUNCHES)

    def step_calls(self) -> list:
        """The operations of one step, as ``(kernel, call)`` for
        ``bench/ops/<kernel>.py``'s ``count(**call)``."""
        ny, nx = self.shape
        item = self.itemsize
        grid = dict(ny=ny, nx=nx, itemsize=item)
        x_solve = ("penta_rows", dict(m=nx, n=ny, itemsize=item, band=2))
        y_solve = ("penta_cols", dict(m=ny, n=nx, itemsize=item, band=2))
        if self.rhs_mode == "fused":
            return [("ch_rhs_xsweep", grid), y_solve]
        if self.rhs_mode == "stencil":
            return [("stencil2d", dict(grid, taps=13, point="weighted")),
                    ("stencil2d", dict(grid, taps=5, point="cube")),
                    x_solve, y_solve]
        along_x = dict(b=ny, m=nx, itemsize=item)
        along_y = dict(b=nx, m=ny, itemsize=item)
        return [("stencil1d_batch", dict(along_x, taps=5, point="weighted")),
                ("stencil1d_batch", dict(along_y, taps=5, point="weighted")),
                ("stencil1d_batch", dict(along_y, taps=3, point="weighted")),
                ("stencil1d_batch", dict(along_x, taps=3, point="weighted")),
                ("stencil1d_batch", dict(along_x, taps=3, point="cube")),
                ("stencil1d_batch", dict(along_y, taps=3, point="cube")),
                x_solve, y_solve]

    def floor_bytes(self) -> int:
        """The step's own floor: c_n and c_{n-1} read once, c_{n+1}
        written once."""
        ny, nx = self.shape
        return 3 * ny * nx * self.itemsize

    def close(self) -> None:
        self.carry = self.boot = self.solver = self.evolve = None
