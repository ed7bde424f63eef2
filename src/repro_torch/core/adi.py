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

``tune='cached'|'force'`` at Create races each sweep's candidates
(:func:`_autotune_adi`, :func:`_autotune_adi3d`) and keeps the winners in
``x_cfg``/``y_cfg``/``z_cfg``: on the card the sweep kernel's launch
geometries (columns a block of ``penta_cols``, rows a group and ring
depth of ``penta_rows``, columns a block of ``penta_mid``; each line is
one warp's recurrence whatever the geometry, so the result is the same
bit for bit) and, for a cyclic ``backend='auto'`` operator, the fft
sweep; on the CPU the plain path and fft.  The segment length L of the
recurrence is never a knob: it fixes the recurrence's arithmetic.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import spectral
from repro_torch.kernels._build import check_backend, device_info
from repro_torch.core.stencil import StencilBatch1D
from repro_torch.launch import stream as _stream
from repro_torch.kernels.penta import (
    CyclicPentaFactors,
    PentaFactors,
    cols_geometries,
    cols_per_block,
    cyclic_penta_factor,
    cyclic_penta_solve_factored,
    cyclic_penta_solve_factored_mid,
    cyclic_penta_solve_factored_rows,
    penta_factor,
    penta_solve_factored,
    mid_geometries,
    mid_geometry,
    penta_solve_factored_mid,
    penta_solve_factored_rows,
    rows_geometries,
    rows_geometry,
)
from repro_torch.util import deprecated_shim, resolve_device


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
    by.  ``x_cfg``/``y_cfg`` are the tuned per-sweep overrides
    (``{'backend': ..., 'geometry': ...}``, :func:`_sweep_cfg`), made by
    the Create-time autotuner; the streamed executor reads their backend
    and ignores their geometry."""

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
    x_cfg: dict | None = dataclasses.field(default=None, hash=False)
    y_cfg: dict | None = dataclasses.field(default=None, hash=False)

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
        backend, geometry = _cfg(self, self.x_cfg)
        if backend == "fft":
            return _fft_sweep(self.sym_x, rhs, axis=-1)
        if self._streamed(rhs):
            return _stream.stream_penta_solve_rows(
                self.fac_x, rhs, cyclic=self.cyclic, streams=self.streams,
                max_tile_bytes=self.max_tile_bytes, backend=backend,
                pool=self.stream_pool,
            )
        solve = (
            cyclic_penta_solve_factored_rows if self.cyclic
            else penta_solve_factored_rows
        )
        return solve(self.fac_x, rhs, backend=backend, geometry=geometry)

    def solve_y(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve ``L_y v = rhs`` along the y (first) axis of an (ny, nx)
        field — column layout."""
        backend, geometry = _cfg(self, self.y_cfg)
        if backend == "fft":
            return _fft_sweep(self.sym_y, rhs, axis=0)
        if self._streamed(rhs):
            return _stream.stream_penta_solve(
                self.fac_y, rhs, cyclic=self.cyclic, streams=self.streams,
                max_tile_bytes=self.max_tile_bytes, backend=backend,
                pool=self.stream_pool,
            )
        solve = cyclic_penta_solve_factored if self.cyclic else penta_solve_factored
        return solve(self.fac_y, rhs, backend=backend, geometry=geometry)

    def grid_problems(self, shape) -> list:
        """Why this operator cannot sweep an ``(ny, nx)`` field — empty when
        it can (the ``launch_geometry_feasible`` rule's probe): factor
        lengths that do not match the extents, or a tuned sweep geometry
        the card cannot launch for them."""
        ny, nx = (int(n) for n in shape)
        problems = []
        if _fac_len(self.fac_x) != nx or _fac_len(self.fac_y) != ny:
            problems.append(
                f"factor lengths (x={_fac_len(self.fac_x)}, "
                f"y={_fac_len(self.fac_y)}) do not match the field "
                f"({ny}, {nx}); the operator was Created for another shape")
        problems += _geometry_problems(self, self.x_cfg, "x", "rows", nx, ny)
        problems += _geometry_problems(self, self.y_cfg, "y", "cols", ny, nx)
        return problems


def _cfg(op, cfg: dict | None) -> tuple[str, dict | None]:
    """A sweep's ``(backend, geometry)``: its tuned override's, or the
    operator's backend and the computed geometry."""
    cfg = cfg or {}
    return cfg.get("backend", op.backend), cfg.get("geometry")


def _fac_len(fac) -> int:
    """System length of a (cyclic) pentadiagonal factor set."""
    band = getattr(fac, "band", fac)
    return int(band.sub.shape[0])


def _fac_device(fac) -> torch.device:
    return getattr(fac, "band", fac).sub.device


def _fac_itemsize(fac) -> int:
    return getattr(fac, "band", fac).sub.element_size()


def _layout_geometry(layout: str, M: int, batch: int, itemsize: int,
                     smem_optin: int, n_sms: int, cyclic: bool,
                     geometry: dict | None, planes: int = 1):
    """The sweep kernel's geometry for a layout (``'rows'``: ``penta_rows``
    over ``batch`` rows of M; ``'cols'``: ``penta_cols`` over ``batch``
    columns; ``'mid'``: ``penta_mid`` over ``planes`` planes of M x
    ``batch``), with a tuned override; raises ``ValueError`` for one the
    card cannot launch."""
    g = geometry or {}
    if layout == "rows":
        over = dict(rows=g["rows"], depth=g["depth"]) if g else {}
        return rows_geometry(M, itemsize, batch, smem_optin, n_sms,
                             cyclic=cyclic, **over)
    if layout == "cols":
        return cols_per_block(M, itemsize, smem_optin, cols=g.get("cols"))
    return mid_geometry(planes, M, batch, itemsize, smem_optin,
                        cols=g.get("cols"))


def _geometry_problems(op, cfg, sweep: str, layout: str, M: int, batch: int,
                       planes: int = 1) -> list[str]:
    """A tuned sweep geometry the card of the operator's device cannot
    launch, or any tuned geometry on an operator off the card (which
    launches no kernel)."""
    geometry = (cfg or {}).get("geometry")
    if not geometry:
        return []
    fac = getattr(op, f"fac_{sweep}")
    dev = _fac_device(fac)
    if dev.type != "cuda":
        return [f"{sweep}-sweep tuned geometry {geometry} on an operator off "
                f"the card ({dev}): only a kernel launch has one"]
    try:
        _layout_geometry(layout, M, batch, _fac_itemsize(fac),
                         *device_info(dev), op.cyclic, geometry, planes)
    except (ValueError, KeyError) as e:
        return [f"{sweep}-sweep tuned geometry {geometry}: {e}"]
    return []


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


def _sweep_candidates(layout: str, M: int, batch: int, *, itemsize: int,
                      device, cyclic: bool, backend: str = "auto",
                      fft: bool = False, planes: int = 1,
                      geometries: bool = True) -> list[dict]:
    """One sweep's candidate space (shared by the 2D and 3D tuners): the
    operator's own backend with its computed geometry; the spectral
    divide when the operator is cyclic under ``backend='auto'``
    (``fft=True``); and, for a sweep that launches its kernel on the card
    in one piece (``geometries``: False for a streamed sweep, whose
    executor computes its own), the kernel's launch geometries at this
    shape (``layout`` as for :func:`_layout_geometry`), each only where it
    fits shared memory."""
    cands = [{"backend": backend}]
    if fft:
        cands.append({"backend": "fft"})
    dev = torch.device(device)
    if geometries and dev.type == "cuda" and backend in ("auto", "cuda"):
        smem, sms = device_info(dev)
        if layout == "rows":
            geos = rows_geometries(M, itemsize, batch, smem, sms,
                                   cyclic=cyclic)
        elif layout == "cols":
            geos = cols_geometries(M, itemsize, smem)
        else:
            geos = mid_geometries(planes, M, batch, itemsize, smem)
        cands += [{"backend": backend, **g} for g in geos]
    return cands


def _fft_arbitrage(op) -> bool:
    """fft joins a sweep's race only for cyclic ``backend='auto'``
    operators: an explicit backend is an explicit choice, and the fp64
    tuned-equals-untuned bit-match contract must survive tuning."""
    return op.backend == "auto" and op.cyclic


def _sweep_cfg(best: dict) -> dict:
    """A winning candidate -> the per-sweep override the solves read:
    ``{'backend': ..., 'geometry': {...} or None}``."""
    geometry = {k: v for k, v in best.items() if k != "backend"}
    return {"backend": best["backend"], "geometry": geometry or None}


def _autotune_sweeps(op, shape, sweeps, mode: str, cache):
    """Race each sweep of ``op`` and return the operator with the winners
    in its ``<sweep>_cfg``.  ``sweeps``: ``(name, kernel, layout, M,
    batch, planes)`` per sweep.  Candidates run through the operator's
    own sweep dispatch on a streams-knocked-out copy, so every backend is
    measured as it will run; an operator whose sweeps stream at ``shape``
    races no launch geometry (the streamed executor ignores one).  The
    operator's name is part of the cache key, so registry operators of
    equal geometry do not alias one entry."""
    from repro_torch.tune import autotune

    fac = op.fac_x
    rhs = torch.zeros(tuple(shape), dtype=getattr(fac, "band", fac).sub.dtype,
                      device=_fac_device(fac))
    kw = dict(shape=tuple(shape), dtype=rhs.dtype, backend=op.backend,
              extra={"cyclic": op.cyclic, "operator": op.operator},
              mode=mode, cache=cache)
    mono = dataclasses.replace(op, streams=None, max_tile_bytes=None,
                               stream_pool=())
    fft = _fft_arbitrage(op)
    streamed = _stream.should_stream(
        rhs.shape, rhs.element_size(), streams=op.streams,
        max_tile_bytes=op.max_tile_bytes)
    best = {}
    for name, kernel, layout, M, batch, planes in sweeps:
        def build(cfg, name=name):
            op2 = dataclasses.replace(mono, **{name + "_cfg": _sweep_cfg(cfg)})
            return getattr(op2, "solve_" + name)

        cands = _sweep_candidates(
            layout, M, batch, itemsize=rhs.element_size(), device=rhs.device,
            cyclic=op.cyclic, backend=op.backend, fft=fft, planes=planes,
            geometries=not streamed)
        best[name + "_cfg"] = _sweep_cfg(
            autotune(kernel, cands, build, (rhs,), **kw))
    return dataclasses.replace(op, **best)


def _autotune_adi(op: "ADIOperator", ny: int, nx: int, mode: str, cache):
    """Measure the 2D operator's per-sweep configurations and attach the
    winners: the x-sweep on ``penta_rows`` (ny rows of nx), the y-sweep on
    ``penta_cols`` (nx columns of ny)."""
    return _autotune_sweeps(op, (ny, nx), (
        ("x", "adi_solve_x", "rows", nx, ny, 1),
        ("y", "adi_solve_y", "cols", ny, nx, 1),
    ), mode, cache)


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
    tune_cache=None,
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
    only) divides by.  ``tune='cached'|'force'`` races each sweep's
    candidates at Create (:func:`_autotune_adi`), remembered in
    ``tune_cache``."""
    from repro_torch.tune import check_mode

    check_mode(tune)
    _check_adi_backend(backend, cyclic)
    dev = resolve_device(device)
    diagonals = _band_builder(operator)
    ay = alpha_over_h4 if alpha_over_h4_y is None else alpha_over_h4_y
    factor = cyclic_penta_factor if cyclic else penta_factor
    sym_x, sym_y = _band_symbols(diagonals, ((nx, alpha_over_h4), (ny, ay)),
                                 dtype, cyclic, dev)
    op = ADIOperator(
        fac_x=factor(*diagonals(nx, alpha_over_h4, dtype), device=dev),
        fac_y=factor(*diagonals(ny, ay, dtype), device=dev),
        cyclic=cyclic,
        backend=backend,
        operator=operator,
        sym_x=sym_x,
        sym_y=sym_y,
        **_stream.stream_fields(streams, max_tile_bytes, dev),
    )
    if tune != "off":
        op = _autotune_adi(op, ny, nx, tune, tune_cache)
    return op


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
    x_cfg: dict | None = dataclasses.field(default=None, hash=False)
    y_cfg: dict | None = dataclasses.field(default=None, hash=False)
    z_cfg: dict | None = dataclasses.field(default=None, hash=False)

    @property
    def destroyed(self) -> bool:
        """True once ``repro_torch.destroy`` ran on this operator."""
        return getattr(self, "_destroyed", False)

    def grid_problems(self, shape) -> list:
        """Why this operator cannot sweep an ``(nz, ny, nx)`` box — empty
        when it can: factor lengths that do not match the extents, or a
        tuned sweep geometry the card cannot launch for them."""
        nz, ny, nx = (int(n) for n in shape)
        problems = []
        lens = (_fac_len(self.fac_x), _fac_len(self.fac_y),
                _fac_len(self.fac_z))
        if lens != (nx, ny, nz):
            problems.append(
                f"factor lengths (x={lens[0]}, y={lens[1]}, z={lens[2]}) do "
                f"not match the field ({nz}, {ny}, {nx}); the operator was "
                "Created for another shape")
        problems += _geometry_problems(self, self.x_cfg, "x", "rows", nx,
                                       nz * ny)
        problems += _geometry_problems(self, self.y_cfg, "y", "mid", ny, nx,
                                       nz)
        problems += _geometry_problems(self, self.z_cfg, "z", "cols", nz,
                                       ny * nx)
        return problems

    def _should_stream(self, rhs: torch.Tensor) -> bool:
        return _stream.should_stream(
            rhs.shape, rhs.element_size(), streams=self.streams,
            max_tile_bytes=self.max_tile_bytes,
        )

    def _knobs(self, backend: str) -> dict:
        return dict(cyclic=self.cyclic, streams=self.streams,
                    max_tile_bytes=self.max_tile_bytes, backend=backend,
                    pool=self.stream_pool)

    def solve_x(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve ``L_x w = rhs`` along the x (last) axis — row layout on the
        flattened ``(nz*ny, nx)`` batch."""
        backend, geometry = _cfg(self, self.x_cfg)
        if backend == "fft":
            return _fft_sweep(self.sym_x, rhs, axis=-1)
        nz, ny, nx = rhs.shape
        flat = rhs.reshape(nz * ny, nx)
        if self._should_stream(rhs):
            out = _stream.stream_penta_solve_rows(self.fac_x, flat,
                                                  **self._knobs(backend))
        else:
            solve = (
                cyclic_penta_solve_factored_rows if self.cyclic
                else penta_solve_factored_rows
            )
            out = solve(self.fac_x, flat, backend=backend, geometry=geometry)
        return out.reshape(rhs.shape)

    def solve_y(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve ``L_y v = rhs`` along the y (middle) axis — plane layout."""
        backend, geometry = _cfg(self, self.y_cfg)
        if backend == "fft":
            return _fft_sweep(self.sym_y, rhs, axis=-2)
        if self._should_stream(rhs):
            return _stream.stream_penta_solve_mid(self.fac_y, rhs,
                                                  **self._knobs(backend))
        solve = (
            cyclic_penta_solve_factored_mid if self.cyclic
            else penta_solve_factored_mid
        )
        return solve(self.fac_y, rhs, backend=backend, geometry=geometry)

    def solve_z(self, rhs: torch.Tensor) -> torch.Tensor:
        """Solve ``L_z u = rhs`` along the z (first) axis — column layout on
        the ``(nz, ny*nx)`` view."""
        backend, geometry = _cfg(self, self.z_cfg)
        if backend == "fft":
            return _fft_sweep(self.sym_z, rhs, axis=-3)
        nz, ny, nx = rhs.shape
        flat = rhs.reshape(nz, ny * nx)
        if self._should_stream(rhs):
            out = _stream.stream_penta_solve(self.fac_z, flat,
                                             **self._knobs(backend))
        else:
            solve = (cyclic_penta_solve_factored if self.cyclic
                     else penta_solve_factored)
            out = solve(self.fac_z, flat, backend=backend, geometry=geometry)
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
    tune_cache=None,
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
    band symbols, which ``backend='fft'`` (cyclic only) divides by.
    ``tune='cached'|'force'`` races each sweep's candidates at Create
    (:func:`_autotune_adi3d`), remembered in ``tune_cache``."""
    from repro_torch.tune import check_mode

    check_mode(tune)
    _check_adi_backend(backend, cyclic)
    dev = resolve_device(device)
    diagonals = _band_builder(operator)
    ay = alpha if alpha_y is None else alpha_y
    az = alpha if alpha_z is None else alpha_z
    factor = cyclic_penta_factor if cyclic else penta_factor
    sym_x, sym_y, sym_z = _band_symbols(
        diagonals, ((nx, alpha), (ny, ay), (nz, az)), dtype, cyclic, dev)
    op = ADIOperator3D(
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
    if tune != "off":
        op = _autotune_adi3d(op, nz, ny, nx, tune, tune_cache)
    return op


def _autotune_adi3d(op: ADIOperator3D, nz: int, ny: int, nx: int, mode: str,
                    cache):
    """Measure the 3D operator's per-sweep configurations and attach the
    winners — the 3D twin of :func:`_autotune_adi`: the x-sweep on
    ``penta_rows`` (nz*ny rows of nx), the y-sweep on ``penta_mid`` (nz
    planes of ny x nx), the z-sweep on ``penta_cols`` (ny*nx columns of
    nz)."""
    return _autotune_sweeps(op, (nz, ny, nx), (
        ("x", "adi3d_solve_x", "rows", nx, nz * ny, 1),
        ("y", "adi3d_solve_y", "mid", ny, nx, nz),
        ("z", "adi3d_solve_z", "cols", nz, ny * nx, 1),
    ), mode, cache)


make_adi_operator = deprecated_shim(
    "make_adi_operator", "create(..., mode='adi')", _make_adi_operator
)
make_adi_operator_3d = deprecated_shim(
    "make_adi_operator_3d", "create(..., mode='adi')", _make_adi_operator_3d
)
