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

A cyclic operator also carries its band symbols (``sym_x``, ``sym_y``,
``sym_z``: the rfft eigenvalues of the circulant bands, computed at
Create whatever the backend); with ``backend='fft'`` each sweep divides by
its symbol in Fourier space (:func:`_fft_sweep`) instead of running the
recurrence and the Woodbury closure.  ``make_adi_operator`` and
``make_adi_operator_3d`` are one-release deprecation shims of the Create
functions.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import spectral
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
from repro_torch.util import deprecated_shim, refuse_unported, resolve_device


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
    kernel launch on a stream of ``stream_pool``.  ``sym_x``/``sym_y`` are
    the band symbols of a cyclic operator, which ``backend='fft'`` divides
    by."""

    fac_x: CyclicPentaFactors | PentaFactors  # along x (length nx)
    fac_y: CyclicPentaFactors | PentaFactors  # along y (length ny)
    cyclic: bool
    backend: str = "auto"
    operator: str = "hyperdiffusion"
    streams: int | None = None
    max_tile_bytes: int | None = None
    stream_pool: tuple = dataclasses.field(default=(), compare=False, repr=False)
    sym_x: torch.Tensor | None = dataclasses.field(default=None, compare=False,
                                                   repr=False)
    sym_y: torch.Tensor | None = dataclasses.field(default=None, compare=False,
                                                   repr=False)

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
        if self.backend == "fft":
            return _fft_sweep(self.sym_x, rhs, axis=-1)
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
        if self.backend == "fft":
            return _fft_sweep(self.sym_y, rhs, axis=0)
        if self._streamed(rhs):
            return _stream.stream_penta_solve(
                self.fac_y, rhs, cyclic=self.cyclic, streams=self.streams,
                max_tile_bytes=self.max_tile_bytes, backend=self.backend,
                pool=self.stream_pool,
            )
        solve = cyclic_penta_solve_factored if self.cyclic else penta_solve_factored
        return solve(self.fac_y, rhs, backend=self.backend)


def _fft_sweep(sym, rhs: torch.Tensor, axis: int) -> torch.Tensor:
    """The spectral implicit sweep: divide by the band symbol along one
    axis (:func:`repro_torch.kernels.spectral.solve_symbol_axis`) — the
    circulant diagonalisation of the cyclic penta solve."""
    if sym is None:
        raise spectral.SpectralBackendError(
            "this ADI operator carries no band symbol (Create attaches "
            "one only for cyclic operators)"
        )
    return spectral.solve_symbol_axis(rhs, sym, axis)


def _check_adi_backend(backend: str, cyclic: bool) -> None:
    """Create-time backend validation of the 2D and 3D factories:
    ``backend='fft'`` on a non-cyclic operator raises
    :class:`~repro_torch.kernels.spectral.SpectralBackendError`, since the
    spectral sweep is the circulant diagonalisation, which only periodic
    (cyclic) bands have."""
    check_backend(backend)
    if backend == "fft" and not cyclic:
        raise spectral.SpectralBackendError(
            "non-cyclic ADI bands are not circulants, so they do not "
            "diagonalise under the DFT; use bc='periodic' (cyclic=True) "
            "or a direct backend"
        )


def _band_symbols(diagonals, lengths_alphas, dtype, cyclic: bool, device):
    """The band symbol of each ``(length, alpha)`` sweep of a cyclic
    operator (``None`` each for a non-cyclic one), on ``device``."""
    return [
        spectral.band_symbol(*diagonals(n, a, dtype), dtype=dtype, device=device)
        if cyclic else None
        for n, a in lengths_alphas
    ]


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
    ``device``; ``streams``/``max_tile_bytes`` stream the sweeps.  A cyclic
    operator also gets its band symbols, which ``backend='fft'`` (cyclic
    only) divides by."""
    refuse_unported(tune=tune)
    _check_adi_backend(backend, cyclic)
    dev = resolve_device(device)
    diagonals = _band_builder(operator)
    ay = alpha_over_h4 if alpha_over_h4_y is None else alpha_over_h4_y
    factor = cyclic_penta_factor if cyclic else penta_factor
    sym_x, sym_y = _band_symbols(diagonals, ((nx, alpha_over_h4), (ny, ay)),
                                 dtype, cyclic, dev)
    return ADIOperator(
        fac_x=factor(*diagonals(nx, alpha_over_h4, dtype), device=dev),
        fac_y=factor(*diagonals(ny, ay, dtype), device=dev),
        cyclic=cyclic,
        backend=backend,
        operator=operator,
        sym_x=sym_x,
        sym_y=sym_y,
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
    ``stream_pool``.  ``sym_x``/``sym_y``/``sym_z`` are the band symbols of
    a cyclic operator: with ``backend='fft'`` every sweep divides by its
    symbol along its own axis, with no reshape."""

    fac_x: CyclicPentaFactors | PentaFactors  # along x (length nx)
    fac_y: CyclicPentaFactors | PentaFactors  # along y (length ny)
    fac_z: CyclicPentaFactors | PentaFactors  # along z (length nz)
    cyclic: bool
    backend: str = "auto"
    operator: str = "hyperdiffusion"
    streams: int | None = None
    max_tile_bytes: int | None = None
    stream_pool: tuple = dataclasses.field(default=(), compare=False, repr=False)
    sym_x: torch.Tensor | None = dataclasses.field(default=None, compare=False,
                                                   repr=False)
    sym_y: torch.Tensor | None = dataclasses.field(default=None, compare=False,
                                                   repr=False)
    sym_z: torch.Tensor | None = dataclasses.field(default=None, compare=False,
                                                   repr=False)

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
        if self.backend == "fft":
            return _fft_sweep(self.sym_x, rhs, axis=-1)
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
        if self.backend == "fft":
            return _fft_sweep(self.sym_y, rhs, axis=-2)
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
        if self.backend == "fft":
            return _fft_sweep(self.sym_z, rhs, axis=-3)
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
    ``max_tile_bytes`` stream the sweeps.  A cyclic operator also gets its
    band symbols, which ``backend='fft'`` (cyclic only) divides by."""
    refuse_unported(tune=tune)
    _check_adi_backend(backend, cyclic)
    dev = resolve_device(device)
    diagonals = _band_builder(operator)
    ay = alpha if alpha_y is None else alpha_y
    az = alpha if alpha_z is None else alpha_z
    factor = cyclic_penta_factor if cyclic else penta_factor
    sym_x, sym_y, sym_z = _band_symbols(
        diagonals, ((nx, alpha), (ny, ay), (nz, az)), dtype, cyclic, dev)
    return ADIOperator3D(
        fac_x=factor(*diagonals(nx, alpha, dtype), device=dev),
        fac_y=factor(*diagonals(ny, ay, dtype), device=dev),
        fac_z=factor(*diagonals(nz, az, dtype), device=dev),
        cyclic=cyclic,
        backend=backend,
        operator=operator,
        sym_x=sym_x,
        sym_y=sym_y,
        sym_z=sym_z,
        **_stream.stream_fields(streams, max_tile_bytes, dev),
    )


make_adi_operator = deprecated_shim(
    "make_adi_operator", "create(..., mode='adi')", _make_adi_operator
)
make_adi_operator_3d = deprecated_shim(
    "make_adi_operator_3d", "create(..., mode='adi')", _make_adi_operator_3d
)
