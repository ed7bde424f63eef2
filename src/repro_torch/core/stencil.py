"""The plan-based stencil engine (counterpart of ``repro.core.stencil``),
for the three plan families: 2D
(:class:`Stencil2D`), batched-1D (:class:`StencilBatch1D`, cuSten's
1DBatch) and 3D (:class:`Stencil3D`, paper §VI.A).

- :func:`_create_2d`, :func:`_create_1d_batch`, :func:`_create_3d` —
  Create: validate geometry, capture weights or the function pointer, the
  boundary mode and the backend, return an immutable plan whose
  coefficients already live on the plan's device.
- ``plan.apply`` — Compute, through the family's op in
  :mod:`repro_torch.kernels.ops`, or, when ``streams``/``max_tile_bytes``
  ask for it and the field exceeds one tile, through the family's streamed
  executor in :mod:`repro_torch.launch.stream` (row chunks, line chunks
  or z-slabs).  A ``backend='fft'`` plan multiplies by its Create-time
  Fourier symbol instead (:mod:`repro_torch.kernels.spectral`), never
  streamed.
- ``tune='cached'|'force'`` at Create (:meth:`PlanCore.tuned`) races the
  plan's candidates and keeps the winner: on the card the family's launch
  geometries (each sums every point's taps as the default one does) and,
  for a periodic weighted ``backend='auto'`` plan, the fft backend; on the
  CPU the plain path and fft.  ``grid_problems`` says why a plan (its
  halo, its tuned geometry) cannot serve a field shape.
- :class:`DoubleBuffer` — Swap.
- :func:`plan_destroy` — Destroy (an idempotent mark; tensors are freed by
  reference counting).

Direction is encoded by the halo extents: an X plan has ``left/right``, a
Y plan ``top/bottom``, a Z plan ``front/back``, an XY or XYZ plan all of
its axes'.  ``bc='np'`` computes interior points only and passes
``out_init`` through on the boundary.

The pre-facade per-dimension names (``stencil_create_2d``,
``stencil_compute_2d``, ... — nine in all) are one-release deprecation
shims at the bottom of this module.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.kernels import ops, spectral
from repro_torch.kernels._build import check_backend, device_info, point_fn_build
from repro_torch.kernels.ref import weighted_point_fn
from repro_torch.kernels.stencil1d_batch import (
    stencil1d_batch_geometries,
    stencil1d_batch_geometry,
)
from repro_torch.kernels.stencil2d import (
    library_point_fn_id,
    stencil2d_geometries,
    stencil2d_geometry,
    user_point_source,
)
from repro_torch.kernels.stencil3d import stencil3d_geometries, stencil3d_geometry
from repro_torch.kernels.taps import Taps, halos_1d, halos_2d, plan_taps
from repro_torch.launch import stream as _stream
from repro_torch.runtime import spans as _spans
from repro_torch.util import deprecated_shim, resolve_device, torch_dtype

_DIRECTIONS = ("x", "y", "xy")
_DIRECTIONS_3D = ("x", "y", "z", "xyz")
_BCS = ("periodic", "np")


def _split_extents(n_points: int, lo: int | None, hi: int | None):
    """Resolve a stencil length into (lo, hi) extents around the centre."""
    if lo is None and hi is None:
        if n_points % 2 == 0:
            raise ValueError("even stencil length needs explicit left/right split")
        return n_points // 2, n_points // 2
    if lo is None or hi is None:
        raise ValueError("give both or neither of the extent pair")
    if lo + hi + 1 != n_points:
        raise ValueError(f"extents {lo}+{hi}+1 != stencil length {n_points}")
    return lo, hi


@dataclasses.dataclass(frozen=True, kw_only=True)
class PlanCore:
    """What a Compute needs besides geometry: the boundary mode, the
    coefficients (weights or function-pointer coefficients, on the plan's
    device), the point function, the backend request and the streaming
    knobs (``streams`` / ``max_tile_bytes`` mirror cuSten's ``nStreams``;
    ``stream_pool`` holds the plan's CUDA streams, made at Create), and
    the non-zero taps the kernel sums (weighted and cube modes; None:
    every window), reduced at Create from the coefficients
    (:func:`repro_torch.kernels.taps.plan_taps`).  ``symbol`` is the
    Fourier symbol of the wrapped stencil kernel (rfftn layout, on the
    plan's device), attached at Create when ``backend='fft'``."""

    bc: str
    coeffs: torch.Tensor
    point_fn: Callable = weighted_point_fn
    backend: str = "auto"
    op_name: str | None = None
    streams: int | None = None
    max_tile_bytes: int | None = None
    stream_pool: tuple = dataclasses.field(default=(), compare=False, repr=False)
    taps: Taps | None = dataclasses.field(default=None, compare=False,
                                          repr=False)
    symbol: torch.Tensor | None = dataclasses.field(default=None,
                                                    compare=False, repr=False)
    # the tuned launch geometry (the reference's ``tile``): None computes
    # it per launch; a dict (the family's geometry function's override)
    # forces it on a monolithic launch on the card
    geometry: dict | None = dataclasses.field(default=None, hash=False)

    # the kernel a Compute of the family launches on the card
    kernel_name = "stencil"

    @property
    def destroyed(self) -> bool:
        """True once :func:`plan_destroy` / ``repro_torch.destroy`` ran."""
        return getattr(self, "_destroyed", False)

    def _halo_kwargs(self) -> dict:
        raise NotImplementedError

    def _geometry_candidates(self, shape) -> list[dict]:
        """The family's launch geometries besides the computed one, on the
        card of the plan's device, for fields of ``shape``."""
        raise NotImplementedError

    def _tuning_field(self, shape) -> torch.Tensor:
        """The field the candidates are timed on: zeros of ``shape`` on the
        plan's device."""
        return torch.zeros(shape, dtype=self.coeffs.dtype,
                           device=self.coeffs.device)

    def _geometry_problem(self, shape) -> str | None:
        """Why the card cannot launch the plan's tuned geometry on a field
        of ``shape`` (None: it can, or there is none)."""
        raise NotImplementedError

    def _check_geometry(self, probe) -> str | None:
        """``probe(smem_optin, n_sms)`` (a geometry function with the
        plan's override) on the card of the plan's device; its
        ``ValueError`` becomes the problem.  A plan off the card launches
        no kernel, so a geometry it carries is a problem in itself."""
        if self.geometry is None:
            return None
        if self.coeffs.device.type != "cuda":
            return (f"tuned geometry {self.geometry} on a plan off the card "
                    f"({self.coeffs.device}): only a kernel launch has one")
        try:
            probe(*device_info(self.coeffs.device))
        except ValueError as e:
            return f"tuned geometry {self.geometry}: {e}"
        return None

    def _mono_apply(self, *args, **kwargs) -> torch.Tensor:
        """The family's Compute op in :mod:`repro_torch.kernels.ops`."""
        raise NotImplementedError

    def _stream_apply(self, *args, **kwargs) -> torch.Tensor:
        """The family's streamed executor in :mod:`repro_torch.launch.stream`."""
        raise NotImplementedError

    # -- the spectral (fft) backend ----------------------------------------
    def _spectral_spec(self, shape):
        """``(weights_box, los, transform_shape)`` feeding
        :func:`repro_torch.kernels.spectral.stencil_symbol` — per family."""
        raise NotImplementedError

    def _box(self, *extents) -> np.ndarray:
        """The weights as their stencil box, on the host."""
        return self.coeffs.detach().cpu().numpy().reshape(extents)

    def _fft_ineligible(self, shape) -> str | None:
        """Why the fft backend cannot serve this plan (None: it can)."""
        if self.bc != "periodic":
            return (
                f"bc={self.bc!r} — the symbol multiply is a *circular* "
                "convolution, so only periodic boundaries diagonalise"
            )
        if self.point_fn is not weighted_point_fn:
            return (
                "function-pointer stencils have no precomputable Fourier "
                "symbol; register explicit weights instead"
            )
        if shape is None:
            return (
                "the symbol is precomputed for one field shape at Create; "
                "pass shape=(...)"
            )
        return None

    def _with_symbol(self, shape) -> "PlanCore":
        """The plan carrying its Create-time Fourier symbol."""
        box, los, tshape = self._spectral_spec(shape)
        sym = spectral.stencil_symbol(box, los, tshape, dtype=self.coeffs.dtype,
                                      device=self.coeffs.device)
        return dataclasses.replace(self, symbol=sym)

    def _fft_axes(self) -> tuple[int, ...]:
        """The transformed (trailing) axes — the rank of the symbol."""
        return tuple(range(-self.symbol.ndim, 0))

    def _fft_apply(self, data: torch.Tensor) -> torch.Tensor:
        if self.symbol is None:
            raise spectral.SpectralBackendError(
                "this plan carries no Fourier symbol (Create attaches one "
                "for periodic weighted plans)"
            )
        return spectral.apply_symbol(data, self.symbol, self._fft_axes())

    def apply(
        self, data: torch.Tensor, out_init: torch.Tensor | None = None
    ) -> torch.Tensor:
        """Apply the stencil to ``data`` (the Compute call).  For
        ``bc='np'`` the cells within the halo of the domain edge are copied
        from ``out_init`` (zeros if not given).  Span ``'repro.plan.apply'``,
        with the plan's class as ``plan``."""
        if _spans.ON:
            with _spans.span("repro.plan.apply", plan=type(self).__name__):
                return self._apply(data, out_init)
        return self._apply(data, out_init)

    def _apply(self, data: torch.Tensor, out_init: torch.Tensor | None):
        if self.backend == "fft":
            # one symbol multiply over the whole periodic extent: never
            # streamed (Create validated the boundary mode)
            return self._fft_apply(data)
        if _stream.should_stream(
            data.shape, data.element_size(), streams=self.streams,
            max_tile_bytes=self.max_tile_bytes,
        ):
            return self._stream_apply(
                data, self.coeffs, out_init, point_fn=self.point_fn,
                bc=self.bc, streams=self.streams,
                max_tile_bytes=self.max_tile_bytes, compute=self.backend,
                pool=self.stream_pool, taps=self.taps, **self._halo_kwargs(),
            )
        return self._mono_apply(
            data, self.coeffs, out_init, point_fn=self.point_fn, bc=self.bc,
            backend=self.backend, taps=self.taps, geometry=self.geometry,
            **self._halo_kwargs(),
        )

    def __call__(self, data, out_init=None):
        return self.apply(data, out_init)

    # -- Create-time autotuning (the tune= hook) ---------------------------
    def tuned(self, shape, mode: str, cache) -> "PlanCore":
        """Measure the plan's candidates on a ``shape`` field and return the
        plan with the winner baked in (``backend`` and ``geometry``).

        Candidates: the plan as it is; ``backend='fft'`` for a ``'auto'``
        plan carrying a Fourier symbol (Create attaches it speculatively);
        and, for a plan on the card that launches its kernel, the family's
        launch geometries (:meth:`_geometry_candidates`), each of which
        sums every point's taps as the default geometry does, so a tuned
        plan computes what the untuned one does, bit for bit, unless fft
        wins.  On the CPU that leaves the plain path and fft.  A plan whose
        Compute streams at ``shape`` races no geometry: the streamed
        executor ignores one, as the reference's ignores a tuned tile.
        Candidates are timed on the monolithic Compute."""
        from repro_torch.tune import autotune, check_mode

        check_mode(mode)
        if mode == "off":
            return self
        if shape is None:
            raise ValueError("tune != 'off' needs shape=(...) to measure with")
        shape = tuple(int(n) for n in shape)
        data = self._tuning_field(shape)
        default = {"backend": self.backend, "geometry": None}
        candidates = [default]
        # only 'auto' plans race fft: an explicit backend is an explicit
        # choice, and the fp64 tuned-equals-untuned contract holds only
        # where tuning cannot change the arithmetic
        if self.backend == "auto" and self.symbol is not None:
            candidates.append({"backend": "fft", "geometry": None})
        streamed = _stream.should_stream(
            shape, data.element_size(), streams=self.streams,
            max_tile_bytes=self.max_tile_bytes)
        if data.is_cuda and self.backend in ("auto", "cuda") and not streamed:
            candidates += [{"backend": self.backend, "geometry": g}
                           for g in self._geometry_candidates(shape)]
        halo_kwargs = self._halo_kwargs()

        def build(cfg):
            if cfg["backend"] == "fft":
                sym, axes = self.symbol, self._fft_axes()
                return lambda d: spectral.apply_symbol(d, sym, axes)
            return lambda d: self._mono_apply(
                d, self.coeffs, None, point_fn=self.point_fn, bc=self.bc,
                backend=cfg["backend"], taps=self.taps,
                geometry=cfg["geometry"], **halo_kwargs)

        extra = {
            "halo": [int(h) for h in self.halo],
            "fn": getattr(self.point_fn, "__name__", "fn"),
            "op": self.op_name,
        }
        # the analytic cost prior: a backend predicted far off the pace
        # (fft for a short stencil) never races; geometries all score alike
        prior = None
        if len(candidates) > 1:
            from repro_torch.tune.prior import prior_enabled, stencil_prior

            if prior_enabled():
                taps = int(torch.count_nonzero(self.coeffs))
                prior = stencil_prior(shape, max(taps, 1),
                                      data.element_size())
        best = autotune(
            self.kernel_name, candidates, build, (data,), shape=shape,
            dtype=data.dtype, bc=self.bc, backend=self.backend, extra=extra,
            mode=mode, default=default, cache=cache, prior=prior,
        )
        return dataclasses.replace(self, backend=best["backend"],
                                   geometry=best.get("geometry"))


def _build_point_fn(point_fn: Callable, nwin: int, ncoeffs: int, device,
                    backend: str) -> None:
    """Create's build of a user's point function for a plan on a card: its
    CUDA source, given or translated from the Python function, compiled
    into the stencil libraries for ``nwin`` windows
    (``_build.point_fn_build``), so a refused function or a compile error
    raises here."""
    if (library_point_fn_id(point_fn) is None
            and backend in ("auto", "cuda")
            and resolve_device(device).type == "cuda"):
        point_fn_build(user_point_source(point_fn, nwin, ncoeffs), nwin)


def _finish_plan(plan: PlanCore, shape, tune: str = "off",
                 tune_cache=None) -> PlanCore:
    """The shared Create tail: spectral validation and symbol attachment,
    then the ``tune=`` hook (:meth:`PlanCore.tuned`).

    ``backend='fft'`` is validated here, at Create — non-periodic
    boundaries, function-pointer stencils and a missing ``shape`` raise
    :class:`~repro_torch.kernels.spectral.SpectralBackendError` — and an
    eligible plan gets its Fourier symbol.  Under ``backend='auto'`` with
    tuning on, an eligible plan gets its symbol speculatively, so that
    :meth:`PlanCore.tuned` can race fft against the direct path.
    (Untuned, ``'auto'`` never picks fft.)"""
    from repro_torch.tune import check_mode

    check_mode(tune)
    wants_fft = plan.backend == "fft"
    if wants_fft or (plan.backend == "auto" and tune != "off"):
        reason = plan._fft_ineligible(shape)
        if reason is None:
            plan = plan._with_symbol(shape)
        elif wants_fft:
            raise spectral.SpectralBackendError(reason)
    return plan.tuned(shape, tune, tune_cache)


def plan_taps_of(coeffs_t: torch.Tensor, point_fn: Callable, halos):
    """Create's reduction of a plan's coefficients to the non-zero taps its
    kernel sums (:func:`repro_torch.kernels.taps.plan_taps`; halos in the
    3D order)."""
    return plan_taps(coeffs_t, halos,
                     user=library_point_fn_id(point_fn) is None)


def plan_destroy(plan) -> None:
    """Destroy, shared by every plan family: marks the plan destroyed, after
    which ``repro_torch.compute`` refuses it.  Idempotent; ``None`` and
    objects that cannot carry the mark are a no-op."""
    if plan is None:
        return
    try:
        object.__setattr__(plan, "_destroyed", True)
    except (AttributeError, TypeError):
        pass


@dataclasses.dataclass(frozen=True, kw_only=True)
class Stencil2D(PlanCore):
    """An immutable 2D stencil plan (the ``cuSten_t`` analogue)."""

    direction: str
    left: int
    right: int
    top: int
    bottom: int
    # the field shape given at Create (None when none was): what a stack
    # of fields is checked against
    shape: tuple[int, int] | None = dataclasses.field(default=None,
                                                      compare=False)

    kernel_name = "stencil2d"

    def _halo_kwargs(self) -> dict:
        return dict(left=self.left, right=self.right, top=self.top,
                    bottom=self.bottom)

    def _geometry_candidates(self, shape) -> list[dict]:
        return stencil2d_geometries(
            shape, self.halo, self.coeffs.element_size(),
            *device_info(self.coeffs.device))

    def _geometry_problem(self, shape) -> str | None:
        return self._check_geometry(lambda smem, sms: stencil2d_geometry(
            shape, self.halo, self.coeffs.element_size(), smem, sms,
            route=self.geometry.get("route")))

    def grid_problems(self, shape) -> list:
        """Why this plan cannot serve an ``(ny, nx)`` field — empty when it
        can (the ``launch_geometry_feasible`` rule's probe): a halo wider
        than the field, or a tuned geometry the card cannot launch."""
        ny, nx = (int(n) for n in shape)
        hx, hy = max(self.left, self.right), max(self.top, self.bottom)
        problems = []
        if hy > ny or hx > nx:
            problems.append(
                f"halo (hy={hy}, hx={hx}) exceeds the field ({ny}, {nx}); "
                "the stencil is wider than the domain")
        geo = self._geometry_problem((ny, nx))
        return problems + ([geo] if geo else [])

    def apply_stacked(
        self, stack: torch.Tensor, out_init: torch.Tensor | None = None
    ) -> torch.Tensor:
        """Compute on a stack ``(B, ny, nx)`` of independent fields at once:
        one ``stencil2d`` launch for the whole stack on the card, the plain
        version over the last two axes on the CPU (the reference's
        ``jax.vmap`` of Compute, which the serving engine's stacked buckets
        run).  Member ``b`` equals ``apply(stack[b], out_init[b])`` bit for
        bit.  ``out_init`` is a stack of the same shape (``bc='np'``; zeros
        when None).  The stack is checked against the plan's Create-time
        shape; a streamed plan's knobs do not apply (its streamed Compute
        equals the monolithic one bit for bit)."""
        if stack.ndim != 3:
            raise ValueError(
                f"apply_stacked takes a (B, ny, nx) stack, got shape "
                f"{tuple(stack.shape)}")
        if self.shape is not None and tuple(stack.shape[1:]) != self.shape:
            raise ValueError(
                f"stack of fields {tuple(stack.shape[1:])} on a plan created "
                f"for {self.shape}")
        if self.backend == "fft":
            return self._fft_apply(stack)
        return self._mono_apply(
            stack, self.coeffs, out_init, point_fn=self.point_fn, bc=self.bc,
            backend=self.backend, taps=self.taps, geometry=self.geometry,
            **self._halo_kwargs(),
        )

    def _mono_apply(self, *args, **kwargs):
        return ops.stencil_apply(*args, **kwargs)

    def _stream_apply(self, *args, **kwargs):
        return _stream.stream_stencil_apply(*args, **kwargs)

    def _spectral_spec(self, shape):
        box = self._box(self.top + self.bottom + 1, self.left + self.right + 1)
        return box, (self.top, self.left), tuple(shape)

    @property
    def num_sten(self) -> int:
        return (self.left + self.right + 1) * (self.top + self.bottom + 1)

    @property
    def halo(self) -> tuple[int, int, int, int]:
        return (self.left, self.right, self.top, self.bottom)


def _create_2d(
    direction: str,
    bc: str,
    *,
    weights=None,
    func: Callable | None = None,
    coeffs=None,
    num_sten_left: int | None = None,
    num_sten_right: int | None = None,
    num_sten_top: int | None = None,
    num_sten_bottom: int | None = None,
    backend: str = "auto",
    dtype=None,
    device="cuda",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    tune: str = "off",
    shape: tuple[int, int] | None = None,
    op_name: str | None = None,
    tune_cache=None,
) -> Stencil2D:
    """Create a 2D stencil plan (the Create call).

    Weighted mode: ``weights`` 1D for X/Y (symmetric split inferred for odd
    lengths) or 2D ``(sy, sx)`` for XY.  Function mode (the paper's ``Fun``
    variants): ``func(windows, coeffs)`` plus ``coeffs`` and the extents;
    ``windows`` is the row-major list of shifted views from the top-left of
    the stencil.  ``dtype`` defaults to the weights' own (float64 for
    Python or numpy float64 weights).  ``streams``/``max_tile_bytes`` route
    Compute through the streamed executor for fields larger than one tile
    (cuSten ``nStreams``; see :mod:`repro_torch.launch.stream`).
    ``backend='fft'`` needs periodic ``bc``, weights and the field's
    ``shape``, for which Create computes the Fourier symbol.
    ``tune='cached'|'force'`` races the plan's candidates on a ``shape``
    field at Create (:meth:`PlanCore.tuned`), remembered in ``tune_cache``
    (a :class:`~repro_torch.tune.TuneCache`; the default directory when
    None)."""
    if direction not in _DIRECTIONS:
        raise ValueError(f"direction must be one of {_DIRECTIONS}")
    if bc not in _BCS:
        raise ValueError(f"bc must be one of {_BCS}")
    check_backend(backend)
    if (weights is None) == (func is None):
        raise ValueError("exactly one of weights / func must be given")
    tensor = _tensor_factory(device, dtype)
    if weights is not None:
        w = _host(weights)
        if direction == "x":
            if w.ndim != 1:
                raise ValueError("x stencil weights must be 1D")
            left, right = _split_extents(w.shape[0], num_sten_left, num_sten_right)
            top = bottom = 0
        elif direction == "y":
            if w.ndim != 1:
                raise ValueError("y stencil weights must be 1D")
            top, bottom = _split_extents(w.shape[0], num_sten_top, num_sten_bottom)
            left = right = 0
        else:
            if w.ndim != 2:
                raise ValueError("xy stencil weights must be 2D (sy, sx)")
            top, bottom = _split_extents(w.shape[0], num_sten_top, num_sten_bottom)
            left, right = _split_extents(w.shape[1], num_sten_left, num_sten_right)
        coeffs_t, point_fn = tensor(w.ravel()), weighted_point_fn
    else:
        left = num_sten_left or 0
        right = num_sten_right or 0
        top = num_sten_top or 0
        bottom = num_sten_bottom or 0
        if direction == "x" and (top or bottom):
            raise ValueError("x stencil cannot have top/bottom extents")
        if direction == "y" and (left or right):
            raise ValueError("y stencil cannot have left/right extents")
        if coeffs is None:
            coeffs = np.zeros((1,), np.float32)
        coeffs_t, point_fn = tensor(_host(coeffs)), func
        _build_point_fn(func, (left + right + 1) * (top + bottom + 1),
                        coeffs_t.numel(), device, backend)

    plan = Stencil2D(
        direction=direction, bc=bc, left=left, right=right, top=top,
        bottom=bottom, shape=None if shape is None else tuple(shape),
        coeffs=coeffs_t, point_fn=point_fn,
        backend=backend, op_name=op_name,
        taps=plan_taps_of(coeffs_t, point_fn, halos_2d(left, right, top,
                                                        bottom)),
        **_stream.stream_fields(streams, max_tile_bytes, resolve_device(device)),
    )
    return _finish_plan(plan, shape, tune, tune_cache)


@dataclasses.dataclass(frozen=True, kw_only=True)
class StencilBatch1D(PlanCore):
    """An immutable batched-1D stencil plan (cuSten's 1DBatch family): one
    1D stencil (extents ``left``/``right``) along axis 1 of a ``(B, M)``
    stack, every row independently."""

    left: int
    right: int

    kernel_name = "stencil1d_batch"

    def _halo_kwargs(self) -> dict:
        return dict(left=self.left, right=self.right)

    def _geometry_candidates(self, shape) -> list[dict]:
        B, M = shape
        return stencil1d_batch_geometries(
            B, M, self.halo, self.coeffs.element_size(),
            *device_info(self.coeffs.device))

    def _tuning_field(self, shape) -> torch.Tensor:
        """The transposed layout of the ``(B, M)`` stack (the lines of
        ``apply_along_y``), where the kernel's geometries race
        (:func:`~repro_torch.kernels.stencil1d_batch.stencil1d_batch_geometries`)."""
        B, M = shape
        return super()._tuning_field((M, B)).T

    def _geometry_problem(self, shape) -> str | None:
        B, M = shape
        return self._check_geometry(lambda smem, sms: stencil1d_batch_geometry(
            B, M, self.halo, True, self.coeffs.element_size(), smem, sms,
            route=self.geometry.get("route"),
            param=self.geometry.get("param")))

    def grid_problems(self, shape) -> list:
        """Why this plan cannot serve a ``(B, M)`` stack — empty when it can:
        a halo wider than the line, or a tuned geometry the card cannot
        launch on the transposed stack it applies to."""
        B, M = (int(n) for n in shape)
        hm = max(self.left, self.right)
        problems = []
        if hm > M:
            problems.append(
                f"line halo hm={hm} exceeds the row length M={M}; the "
                "stencil is wider than the line")
        geo = self._geometry_problem((B, M))
        return problems + ([geo] if geo else [])

    def _mono_apply(self, *args, **kwargs):
        return ops.stencil_apply_batch1d(*args, **kwargs)

    def _stream_apply(self, *args, **kwargs):
        return _stream.stream_batch1d_apply(*args, **kwargs)

    def _spectral_spec(self, shape):
        # each line of the (B, M) stack transforms alone: the 1D symbol
        # broadcasts over the batch axis
        return self._box(self.left + self.right + 1), (self.left,), (tuple(shape)[-1],)

    @property
    def num_sten(self) -> int:
        return self.left + self.right + 1

    @property
    def halo(self) -> tuple[int, int]:
        return (self.left, self.right)


def _create_1d_batch(
    bc: str,
    *,
    weights=None,
    func: Callable | None = None,
    coeffs=None,
    num_sten_left: int | None = None,
    num_sten_right: int | None = None,
    backend: str = "auto",
    dtype=None,
    device="cuda",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    tune: str = "off",
    shape: tuple[int, int] | None = None,
    op_name: str | None = None,
    tune_cache=None,
) -> StencilBatch1D:
    """Create a batched-1D stencil plan (cuSten ``custenCreate1DBatch*``).

    Weighted mode: 1D ``weights`` of length ``numSten`` (symmetric split
    inferred for odd lengths, or give ``num_sten_left/right``).  Function
    mode (``Fun`` variants): ``func(windows, coeffs)`` plus ``coeffs`` and
    the explicit extents; ``windows`` sweep left to right.  The streaming
    and tuning knobs are those of :func:`_create_2d`; a plan is tuned on
    the transposed layout of its ``(B, M)`` stack (the layout whose launch
    geometry can change without changing a point's arithmetic)."""
    if bc not in _BCS:
        raise ValueError(f"bc must be one of {_BCS}")
    check_backend(backend)
    if (weights is None) == (func is None):
        raise ValueError("exactly one of weights / func must be given")
    tensor = _tensor_factory(device, dtype)
    if weights is not None:
        w = _host(weights)
        if w.ndim != 1:
            raise ValueError("batched-1D stencil weights must be 1D")
        left, right = _split_extents(w.shape[0], num_sten_left, num_sten_right)
        coeffs_t, point_fn = tensor(w), weighted_point_fn
    else:
        left = num_sten_left or 0
        right = num_sten_right or 0
        if coeffs is None:
            coeffs = np.zeros((1,), np.float32)
        coeffs_t, point_fn = tensor(_host(coeffs)), func
        _build_point_fn(func, left + right + 1, coeffs_t.numel(), device,
                        backend)
    plan = StencilBatch1D(
        bc=bc, left=left, right=right, coeffs=coeffs_t, point_fn=point_fn,
        backend=backend, op_name=op_name,
        taps=plan_taps_of(coeffs_t, point_fn, halos_1d(left, right)),
        **_stream.stream_fields(streams, max_tile_bytes, resolve_device(device)),
    )
    return _finish_plan(plan, shape, tune, tune_cache)


@dataclasses.dataclass(frozen=True, kw_only=True)
class Stencil3D(PlanCore):
    """An immutable 3D stencil plan on ``(nz, ny, nx)`` fields.  Halos:
    ``front/back`` along z, ``top/bottom`` along y, ``left/right`` along x."""

    direction: str
    front: int
    back: int
    top: int
    bottom: int
    left: int
    right: int

    kernel_name = "stencil3d"

    def _halo_kwargs(self) -> dict:
        return dict(halos=self.halos)

    def _geometry_candidates(self, shape) -> list[dict]:
        return stencil3d_geometries(
            shape, self.halos, self.coeffs.element_size(),
            *device_info(self.coeffs.device))

    def _geometry_problem(self, shape) -> str | None:
        return self._check_geometry(lambda smem, sms: stencil3d_geometry(
            shape, self.halos, self.coeffs.element_size(), smem, sms,
            route=self.geometry.get("route"), zc=self.geometry.get("zc")))

    def grid_problems(self, shape) -> list:
        """Why this plan cannot serve an ``(nz, ny, nx)`` box — empty when
        it can: a halo wider than the field, or a tuned geometry the card
        cannot launch."""
        nz, ny, nx = (int(n) for n in shape)
        hz = max(self.front, self.back)
        hy = max(self.top, self.bottom)
        hx = max(self.left, self.right)
        problems = []
        if hz > nz or hy > ny or hx > nx:
            problems.append(
                f"halo (hz={hz}, hy={hy}, hx={hx}) exceeds the field "
                f"({nz}, {ny}, {nx}); the stencil is wider than the domain")
        geo = self._geometry_problem((nz, ny, nx))
        return problems + ([geo] if geo else [])

    def _mono_apply(self, *args, **kwargs):
        return ops.stencil_apply_3d(*args, **kwargs)

    def _stream_apply(self, *args, **kwargs):
        return _stream.stream_stencil3d_apply(*args, **kwargs)

    def _spectral_spec(self, shape):
        box = self._box(self.front + self.back + 1, self.top + self.bottom + 1,
                        self.left + self.right + 1)
        return box, (self.front, self.top, self.left), tuple(shape)

    @property
    def num_sten(self) -> int:
        return ((self.front + self.back + 1) * (self.top + self.bottom + 1)
                * (self.left + self.right + 1))

    @property
    def halo(self) -> tuple[int, int, int, int, int, int]:
        return self.halos

    @property
    def halos(self) -> tuple[int, int, int, int, int, int]:
        """(front, back, top, bottom, left, right) — the kernel's order."""
        return (self.front, self.back, self.top, self.bottom, self.left,
                self.right)


def _create_3d(
    direction: str,
    bc: str,
    *,
    weights=None,
    func: Callable | None = None,
    coeffs=None,
    num_sten_front: int | None = None,
    num_sten_back: int | None = None,
    num_sten_top: int | None = None,
    num_sten_bottom: int | None = None,
    num_sten_left: int | None = None,
    num_sten_right: int | None = None,
    backend: str = "auto",
    dtype=None,
    device="cuda",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    tune: str = "off",
    shape: tuple[int, int, int] | None = None,
    op_name: str | None = None,
    tune_cache=None,
) -> Stencil3D:
    """Create a 3D stencil plan (the §VI.A Create call).

    Weighted mode: 1D ``weights`` for directions ``'x'|'y'|'z'`` (symmetric
    split inferred for odd lengths, or the explicit extent pair), or a 3D
    ``(sz, sy, sx)`` box for ``'xyz'``.  Function mode: ``func(windows,
    coeffs)`` plus the explicit extents; windows are enumerated z-major,
    then row-major over (y, x).  ``streams``/``max_tile_bytes`` stream
    Compute in z-slabs (:func:`repro_torch.launch.stream.stream_stencil3d_apply`);
    the tuning knobs are those of :func:`_create_2d`."""
    if direction not in _DIRECTIONS_3D:
        raise ValueError(f"direction must be one of {_DIRECTIONS_3D}")
    if bc not in _BCS:
        raise ValueError(f"bc must be one of {_BCS}")
    check_backend(backend)
    if (weights is None) == (func is None):
        raise ValueError("exactly one of weights / func must be given")
    tensor = _tensor_factory(device, dtype)
    front = back = top = bottom = left = right = 0
    if weights is not None:
        w = _host(weights)
        if direction == "xyz":
            if w.ndim != 3:
                raise ValueError("xyz stencil weights must be 3D (sz, sy, sx)")
            front, back = _split_extents(w.shape[0], num_sten_front, num_sten_back)
            top, bottom = _split_extents(w.shape[1], num_sten_top, num_sten_bottom)
            left, right = _split_extents(w.shape[2], num_sten_left, num_sten_right)
        else:
            if w.ndim != 1:
                raise ValueError(f"{direction} stencil weights must be 1D")
            if direction == "x":
                left, right = _split_extents(w.shape[0], num_sten_left, num_sten_right)
            elif direction == "y":
                top, bottom = _split_extents(w.shape[0], num_sten_top, num_sten_bottom)
            else:
                front, back = _split_extents(w.shape[0], num_sten_front, num_sten_back)
        coeffs_t, point_fn = tensor(w.ravel()), weighted_point_fn
    else:
        front = num_sten_front or 0
        back = num_sten_back or 0
        top = num_sten_top or 0
        bottom = num_sten_bottom or 0
        left = num_sten_left or 0
        right = num_sten_right or 0
        off_axis = {
            "x": front or back or top or bottom,
            "y": front or back or left or right,
            "z": top or bottom or left or right,
            "xyz": 0,
        }[direction]
        if off_axis:
            raise ValueError(f"{direction} stencil cannot have off-axis extents")
        if coeffs is None:
            coeffs = np.zeros((1,), np.float32)
        coeffs_t, point_fn = tensor(_host(coeffs)), func
    halos = (front, back, top, bottom, left, right)
    nwin = (front + back + 1) * (top + bottom + 1) * (left + right + 1)
    _build_point_fn(point_fn, nwin, coeffs_t.numel(), device, backend)
    plan = Stencil3D(
        direction=direction, bc=bc, front=front, back=back, top=top,
        bottom=bottom, left=left, right=right, coeffs=coeffs_t,
        point_fn=point_fn, backend=backend, op_name=op_name,
        taps=plan_taps_of(coeffs_t, point_fn, halos),
        **_stream.stream_fields(streams, max_tile_bytes, resolve_device(device)),
    )
    return _finish_plan(plan, shape, tune, tune_cache)


def central_difference_weights(order: int, derivative: int, h: float = 1.0):
    """Weights of the central finite difference of accuracy ``order``
    (even) for ``derivative`` (1 or 2), from the Vandermonde system of the
    standard Fornberg construction.  Returns a numpy array of length
    ``order + derivative - (derivative % 2) + 1`` scaled by
    ``h**-derivative``."""
    import math as _math

    if order % 2:
        raise ValueError("order must be even for central differences")
    npts = 2 * ((order + derivative - 1) // 2) + 1
    offsets = np.arange(npts) - npts // 2
    # sum_k w_k * off_k^m = m! * delta_{m, derivative}
    A = np.vander(offsets, npts, increasing=True).T.astype(np.float64)
    b = np.zeros(npts)
    b[derivative] = _math.factorial(derivative)
    w = np.linalg.solve(A, b)
    return w / h**derivative


def laplacian3d_weights(h: float = 1.0) -> np.ndarray:
    """7-point 3D Laplacian as a ``(3, 3, 3)`` box (units ``h^-2``)."""
    w = np.zeros((3, 3, 3))
    w[1, 1, 0] = w[1, 1, 2] = 1.0
    w[1, 0, 1] = w[1, 2, 1] = 1.0
    w[0, 1, 1] = w[2, 1, 1] = 1.0
    w[1, 1, 1] = -6.0
    return w / h**2


def _tensor_factory(device, dtype) -> Callable:
    """numpy array -> contiguous tensor on ``device`` in ``dtype`` (the
    array's own dtype when ``dtype`` is None)."""
    dev = resolve_device(device)
    dt = None if dtype is None else torch_dtype(dtype)

    def tensor(a: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(np.ascontiguousarray(a))
        return t.to(device=dev, dtype=dt if dt is not None else t.dtype)

    return tensor


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a)


class DoubleBuffer:
    """cuSten's Swap: flip input/output fields between time steps.

    >>> buf = DoubleBuffer(c0, torch.zeros_like(c0))
    >>> buf.new = plan.apply(buf.old); buf.swap()
    """

    __slots__ = ("old", "new")

    def __init__(self, old: torch.Tensor, new: torch.Tensor | None = None):
        self.old = old
        self.new = torch.zeros_like(old) if new is None else new

    def swap(self) -> "DoubleBuffer":
        self.old, self.new = self.new, self.old
        return self


# ---------------------------------------------------------------------------
# Deprecated per-dimension entry points (one release; use repro_torch.api)
# ---------------------------------------------------------------------------


def _compute_impl(plan, data, out_init=None):
    return plan.apply(data, out_init)


stencil_create_2d = deprecated_shim("stencil_create_2d", "create", _create_2d)
stencil_compute_2d = deprecated_shim("stencil_compute_2d", "compute", _compute_impl)
stencil_destroy_2d = deprecated_shim("stencil_destroy_2d", "destroy", plan_destroy)
stencil_create_1d_batch = deprecated_shim(
    "stencil_create_1d_batch", "create", _create_1d_batch
)
stencil_compute_1d_batch = deprecated_shim(
    "stencil_compute_1d_batch", "compute", _compute_impl
)
stencil_destroy_1d_batch = deprecated_shim(
    "stencil_destroy_1d_batch", "destroy", plan_destroy
)
stencil_create_3d = deprecated_shim("stencil_create_3d", "create", _create_3d)
stencil_compute_3d = deprecated_shim("stencil_compute_3d", "compute", _compute_impl)
stencil_destroy_3d = deprecated_shim("stencil_destroy_3d", "destroy", plan_destroy)
