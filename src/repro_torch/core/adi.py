"""ADI (alternating-direction implicit) operators in 2D and 3D (counterpart
of ``repro.core.adi``), and the directional application of batched-1D
stencil plans (:func:`apply_along_x`, :func:`apply_along_y`).

Each ADI step inverts the per-direction implicit operator
``L = I + alpha delta^4`` (or the registry operator's band) along each
grid direction.  The factorisation happens once at Create
(:func:`_make_adi_operator`, :func:`_make_adi_operator_3d`); each Compute
is a batched banded substitution, transpose-free in every sweep:

- 2D :class:`ADIOperator`: the x-sweep runs the row-layout solve on the
  ``(ny, nx)`` field as it lies, the y-sweep the column-layout solve; with
  ``streams``/``max_tile_bytes`` each sweep is streamed in row or column
  chunks (:mod:`repro_torch.launch.stream`);
- 3D :class:`ADIOperator3D`: the x-sweep runs the row layout on the
  ``(nz*ny, nx)`` view, the y-sweep the plane layout on the field itself,
  the z-sweep the column layout on the ``(nz, ny*nx)`` view; with
  ``streams``/``max_tile_bytes`` each sweep is streamed in row, plane or
  column chunks.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels._build import check_backend
from repro_torch.core.stencil import StencilBatch1D
from repro_torch.launch import stream as _stream
from repro_torch.kernels.penta import (
    CyclicPentaFactors,
    PentaFactors,
    cyclic_penta_factor,
    cyclic_penta_solve_factored,
    cyclic_penta_solve_factored_mid,
    cyclic_penta_solve_factored_rows,
    penta_factor,
    penta_solve_factored,
    penta_solve_factored_mid,
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


def apply_along_x(
    plan: StencilBatch1D,
    field: torch.Tensor,
    out_init: torch.Tensor | None = None,
) -> torch.Tensor:
    """Apply a batched-1D plan along the x (last) axis of an (ny, nx) field:
    the ny rows are the batch."""
    return plan.apply(field, out_init)


def apply_along_y(
    plan: StencilBatch1D,
    field: torch.Tensor,
    out_init: torch.Tensor | None = None,
) -> torch.Tensor:
    """Apply a batched-1D plan along the y (first) axis of an (ny, nx)
    field: the nx columns are the batch.  ``field.T`` is a view, and the
    CUDA kernel reads it in place through its strides (no transposed copy);
    its result has the view's layout, so the ``.T`` that undoes it is
    contiguous again."""
    out_init_t = None if out_init is None else out_init.T
    return plan.apply(field.T, out_init_t).T


@dataclasses.dataclass(frozen=True)
class ADIOperator:
    """Factored per-direction operators ``L = I + alpha delta^4`` (or the
    registry operator's band), on the factors' device.

    ``streams``/``max_tile_bytes`` route the substitutions through the
    streamed executor: the x-sweep in row chunks
    (:func:`~repro_torch.launch.stream.stream_penta_solve_rows`), the
    y-sweep in column chunks
    (:func:`~repro_torch.launch.stream.stream_penta_solve`), each chunk one
    kernel launch on a stream of ``stream_pool``."""

    fac_x: CyclicPentaFactors | PentaFactors  # along x (length nx)
    fac_y: CyclicPentaFactors | PentaFactors  # along y (length ny)
    cyclic: bool
    backend: str = "auto"
    operator: str = "hyperdiffusion"
    streams: int | None = None
    max_tile_bytes: int | None = None
    stream_pool: tuple = dataclasses.field(default=(), compare=False, repr=False)

    @property
    def destroyed(self) -> bool:
        """True once ``repro_torch.destroy`` ran on this operator."""
        return getattr(self, "_destroyed", False)

    def _streamed(self, rhs: torch.Tensor) -> bool:
        return rhs.ndim == 2 and _stream.should_stream(
            rhs.shape, rhs.element_size(), streams=self.streams,
            max_tile_bytes=self.max_tile_bytes,
        )

    def solve_x(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve ``L_x w = rhs`` along the x (last) axis of an (ny, nx)
        field — row layout, transpose-free."""
        if self._streamed(rhs):
            return _stream.stream_penta_solve_rows(
                self.fac_x, rhs, cyclic=self.cyclic, streams=self.streams,
                max_tile_bytes=self.max_tile_bytes, backend=self.backend,
                pool=self.stream_pool,
            )
        solve = (
            cyclic_penta_solve_factored_rows if self.cyclic
            else penta_solve_factored_rows
        )
        return solve(self.fac_x, rhs, backend=self.backend)

    def solve_y(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve ``L_y v = rhs`` along the y (first) axis of an (ny, nx)
        field — column layout."""
        if self._streamed(rhs):
            return _stream.stream_penta_solve(
                self.fac_y, rhs, cyclic=self.cyclic, streams=self.streams,
                max_tile_bytes=self.max_tile_bytes, backend=self.backend,
                pool=self.stream_pool,
            )
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
    ``device``; ``streams``/``max_tile_bytes`` stream the sweeps."""
    refuse_unported(tune=tune)
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
        **_stream.stream_fields(streams, max_tile_bytes, dev),
    )


@dataclasses.dataclass(frozen=True)
class ADIOperator3D:
    """Factored per-direction operators for 3D ADI sweeps on an
    ``(nz, ny, nx)`` field, every sweep transpose-free:

    - :meth:`solve_x` — row layout on the ``(nz*ny, nx)`` view;
    - :meth:`solve_y` — plane layout on the field itself (recurrence along
      the middle axis, batch on planes x lanes);
    - :meth:`solve_z` — column layout on the ``(nz, ny*nx)`` view.

    ``streams``/``max_tile_bytes`` route each sweep through its streamed
    executor when the field exceeds one tile: the x-sweep in row chunks,
    the y-sweep in plane chunks
    (:func:`~repro_torch.launch.stream.stream_penta_solve_mid`), the
    z-sweep in column chunks, each chunk one kernel launch on a stream of
    ``stream_pool``."""

    fac_x: CyclicPentaFactors | PentaFactors  # along x (length nx)
    fac_y: CyclicPentaFactors | PentaFactors  # along y (length ny)
    fac_z: CyclicPentaFactors | PentaFactors  # along z (length nz)
    cyclic: bool
    backend: str = "auto"
    operator: str = "hyperdiffusion"
    streams: int | None = None
    max_tile_bytes: int | None = None
    stream_pool: tuple = dataclasses.field(default=(), compare=False, repr=False)

    @property
    def destroyed(self) -> bool:
        """True once ``repro_torch.destroy`` ran on this operator."""
        return getattr(self, "_destroyed", False)

    def _should_stream(self, rhs: torch.Tensor) -> bool:
        return _stream.should_stream(
            rhs.shape, rhs.element_size(), streams=self.streams,
            max_tile_bytes=self.max_tile_bytes,
        )

    def _knobs(self) -> dict:
        return dict(cyclic=self.cyclic, streams=self.streams,
                    max_tile_bytes=self.max_tile_bytes, backend=self.backend,
                    pool=self.stream_pool)

    def solve_x(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve ``L_x w = rhs`` along the x (last) axis — row layout on the
        flattened ``(nz*ny, nx)`` batch."""
        nz, ny, nx = rhs.shape
        flat = rhs.reshape(nz * ny, nx)
        if self._should_stream(rhs):
            out = _stream.stream_penta_solve_rows(self.fac_x, flat,
                                                  **self._knobs())
        else:
            solve = (
                cyclic_penta_solve_factored_rows if self.cyclic
                else penta_solve_factored_rows
            )
            out = solve(self.fac_x, flat, backend=self.backend)
        return out.reshape(rhs.shape)

    def solve_y(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve ``L_y v = rhs`` along the y (middle) axis — plane layout."""
        if self._should_stream(rhs):
            return _stream.stream_penta_solve_mid(self.fac_y, rhs,
                                                  **self._knobs())
        solve = (
            cyclic_penta_solve_factored_mid if self.cyclic
            else penta_solve_factored_mid
        )
        return solve(self.fac_y, rhs, backend=self.backend)

    def solve_z(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve ``L_z u = rhs`` along the z (first) axis — column layout on
        the ``(nz, ny*nx)`` view."""
        nz, ny, nx = rhs.shape
        flat = rhs.reshape(nz, ny * nx)
        if self._should_stream(rhs):
            out = _stream.stream_penta_solve(self.fac_z, flat, **self._knobs())
        else:
            solve = (cyclic_penta_solve_factored if self.cyclic
                     else penta_solve_factored)
            out = solve(self.fac_z, flat, backend=self.backend)
        return out.reshape(rhs.shape)


def _make_adi_operator_3d(
    nz: int,
    ny: int,
    nx: int,
    alpha,
    *,
    cyclic: bool = True,
    dtype=torch.float64,
    backend: str = "auto",
    alpha_y: float | None = None,
    alpha_z: float | None = None,
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    tune: str = "off",
    operator: str = "hyperdiffusion",
    device="cuda",
) -> ADIOperator3D:
    """Create (factor) the 3D ADI operator triple.

    ``alpha`` multiplies the per-direction difference operator:
    ``I + alpha delta^4`` for ``operator='hyperdiffusion'``,
    ``I - alpha delta^2`` for ``operator='diffusion'`` (backward-Euler heat
    sweeps, ``alpha = D dt / h^2``).  ``alpha_y``/``alpha_z`` override the
    x coefficient per direction on anisotropic grids; ``streams``/
    ``max_tile_bytes`` stream the sweeps."""
    refuse_unported(tune=tune)
    check_backend(backend)
    dev = resolve_device(device)
    diagonals = _band_builder(operator)
    ay = alpha if alpha_y is None else alpha_y
    az = alpha if alpha_z is None else alpha_z
    factor = cyclic_penta_factor if cyclic else penta_factor
    return ADIOperator3D(
        fac_x=factor(*diagonals(nx, alpha, dtype), device=dev),
        fac_y=factor(*diagonals(ny, ay, dtype), device=dev),
        fac_z=factor(*diagonals(nz, az, dtype), device=dev),
        cyclic=cyclic,
        backend=backend,
        operator=operator,
        **_stream.stream_fields(streams, max_tile_bytes, dev),
    )
