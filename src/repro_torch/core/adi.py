"""2D ADI (alternating-direction implicit) operator (counterpart of
``repro.core.adi``, 2D part).

Each ADI step inverts the per-direction implicit operator
``L = I + alpha delta^4`` along x and then along y.  The factorisation
happens once at Create (:func:`_make_adi_operator`); each Compute is a
batched banded substitution, transpose-free in both sweeps: the x-sweep
runs the row-layout solve on the ``(ny, nx)`` field as it lies, the y-sweep
the column-layout solve.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels._build import check_backend
from repro_torch.kernels.penta import (
    CyclicPentaFactors,
    PentaFactors,
    cyclic_penta_factor,
    cyclic_penta_solve_factored,
    cyclic_penta_solve_factored_rows,
    penta_factor,
    penta_solve_factored,
    penta_solve_factored_rows,
)
from repro_torch.util import refuse_unported, resolve_device


def _band_builder(operator: str):
    """The per-direction band builder of a named operator, resolved through
    the :mod:`repro_torch.api` registry."""
    from repro_torch import api as _api

    opdef = _api.get_operator(operator)
    if opdef.diagonals is None:
        raise ValueError(
            f"operator {opdef.name!r} defines no ADI band builder "
            "(it is stencil-weights-only)"
        )
    return opdef.diagonals


@dataclasses.dataclass(frozen=True)
class ADIOperator:
    """Factored per-direction operators ``L = I + alpha delta^4`` (or the
    registry operator's band), on the factors' device."""

    fac_x: CyclicPentaFactors | PentaFactors  # along x (length nx)
    fac_y: CyclicPentaFactors | PentaFactors  # along y (length ny)
    cyclic: bool
    backend: str = "auto"
    operator: str = "hyperdiffusion"

    @property
    def destroyed(self) -> bool:
        """True once ``repro_torch.destroy`` ran on this operator."""
        return getattr(self, "_destroyed", False)

    def solve_x(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve ``L_x w = rhs`` along the x (last) axis of an (ny, nx)
        field — row layout, transpose-free."""
        solve = (
            cyclic_penta_solve_factored_rows if self.cyclic
            else penta_solve_factored_rows
        )
        return solve(self.fac_x, rhs, backend=self.backend)

    def solve_y(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve ``L_y v = rhs`` along the y (first) axis of an (ny, nx)
        field — column layout."""
        solve = cyclic_penta_solve_factored if self.cyclic else penta_solve_factored
        return solve(self.fac_y, rhs, backend=self.backend)


def _make_adi_operator(
    ny: int,
    nx: int,
    alpha_over_h4,
    *,
    cyclic: bool = True,
    dtype=torch.float64,
    backend: str = "auto",
    alpha_over_h4_y: float | None = None,
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    tune: str = "off",
    operator: str = "hyperdiffusion",
    device="cuda",
) -> ADIOperator:
    """Create (factor) the ADI operator pair.

    ``alpha_over_h4`` is the full coefficient multiplying ``delta^4`` (e.g.
    ``(2/3) D gamma dt / h**4`` for the paper's full scheme);
    ``operator='diffusion'`` factors ``I - alpha delta^2`` instead.  The
    bands are factored on the host in ``dtype`` and the factors moved to
    ``device``."""
    refuse_unported(streams=streams, max_tile_bytes=max_tile_bytes, tune=tune)
    check_backend(backend)
    dev = resolve_device(device)
    diagonals = _band_builder(operator)
    ay = alpha_over_h4 if alpha_over_h4_y is None else alpha_over_h4_y
    factor = cyclic_penta_factor if cyclic else penta_factor
    return ADIOperator(
        fac_x=factor(*diagonals(nx, alpha_over_h4, dtype), device=dev),
        fac_y=factor(*diagonals(ny, ay, dtype), device=dev),
        cyclic=cyclic,
        backend=backend,
        operator=operator,
    )
