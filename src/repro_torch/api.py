"""The four-function facade — Create / Compute / Swap / Destroy (counterpart
of ``repro.api``).

- :func:`create` — the plan family from the rank of ``shape`` and the
  ``mode`` hint: a :class:`~repro_torch.core.stencil.Stencil2D`
  (``mode='xy'|'x'|'y'``), a
  :class:`~repro_torch.core.stencil.StencilBatch1D` (``mode='batch'`` on a
  ``(B, M)`` stack), a :class:`~repro_torch.core.stencil.Stencil3D`
  (rank 3, ``mode='xyz'|'x'|'y'|'z'``), or a 2D/3D ADI operator
  (``mode='adi'``), built on ``device`` (the card unless the caller asks
  for the CPU).
- :func:`compute` — the single apply path for any plan.
- :func:`swap` — the double-buffer flip between time steps.
- :func:`destroy` — unified, idempotent teardown.
- :func:`plan_key` — the canonical string identity of one plan request.

The operator registry (:func:`register_operator` / :func:`get_operator`)
is the single source of named operators: stencil ``weights`` builders and
ADI band ``diagonals`` builders, with the analytic properties they declare
(``derivative``, ``symmetric``, ``zero_sum``), which stencil-lint
(:mod:`repro_torch.analysis`) verifies at register and Create time.
Built-ins: ``"laplacian"``, ``"biharmonic"``, ``"hyperdiffusion"``,
``"diffusion"``.
"""

from __future__ import annotations

import dataclasses
import json
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.core import adi as _adi
from repro_torch.core import stencil as _stencil
from repro_torch.kernels.penta import diffusion_diagonals, hyperdiffusion_diagonals

__all__ = [
    "OperatorDef",
    "compute",
    "create",
    "destroy",
    "get_operator",
    "operator_names",
    "plan_key",
    "register_operator",
    "swap",
]


@dataclasses.dataclass(frozen=True)
class OperatorDef:
    """A named difference operator: ``weights(ndim, h=1.0)`` builds explicit
    stencil weights, ``diagonals(n, alpha, dtype)`` the pentadiagonal bands
    of the implicit per-direction operator.  Either may be ``None``.
    ``derivative``/``symmetric``/``zero_sum`` are the declared analytic
    properties stencil-lint may verify; None means undeclared, and lint
    never second-guesses math it was not told."""

    name: str
    weights: Callable | None = None
    diagonals: Callable | None = None
    doc: str = ""
    derivative: int | None = None
    symmetric: bool | None = None
    zero_sum: bool | None = None


_REGISTRY: dict[str, OperatorDef] = {}


def register_operator(
    name: str,
    *,
    weights: Callable | None = None,
    diagonals: Callable | None = None,
    doc: str = "",
    overwrite: bool = False,
    derivative: int | None = None,
    symmetric: bool | None = None,
    zero_sum: bool | None = None,
    lint: str = "warn",
) -> OperatorDef:
    """Register a named operator for :func:`create`.  Re-registering an
    existing name raises unless ``overwrite=True``.

    ``derivative=``/``symmetric=``/``zero_sum=`` declare analytic
    properties of the weights that stencil-lint verifies here, on the
    weights built for 1, 2 and 3 dimensions, and at Create (moment/Taylor
    conditions, central symmetry, zero row sum); ``lint='off'|'warn'|
    'error'`` picks how the findings surface
    (:class:`~repro_torch.analysis.StencilLintWarning` /
    :class:`~repro_torch.analysis.LintError`, in which case nothing is
    registered)."""
    from repro_torch.analysis import check_lint_mode

    check_lint_mode(lint)
    if not name or not isinstance(name, str):
        raise ValueError("operator name must be a non-empty string")
    if weights is None and diagonals is None:
        raise ValueError(f"operator {name!r} needs weights= and/or diagonals=")
    if name in _REGISTRY and not overwrite:
        raise ValueError(
            f"operator {name!r} is already registered "
            "(pass overwrite=True to replace it)"
        )
    opdef = OperatorDef(
        name=name, weights=weights, diagonals=diagonals, doc=doc,
        derivative=derivative, symmetric=symmetric, zero_sum=zero_sum,
    )
    if lint != "off" and weights is not None and (
        derivative or symmetric or zero_sum
    ):
        from repro_torch.analysis import lint_operator, surface

        findings = []
        for ndim in (1, 2, 3):
            findings += lint_operator(opdef, ndim=ndim)
        surface(findings, lint)
    _REGISTRY[name] = opdef
    return opdef


def get_operator(name: str) -> OperatorDef:
    """Look up a registered operator; unknown names raise with the list."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown operator {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def operator_names() -> tuple:
    """The registered operator names, sorted."""
    return tuple(sorted(_REGISTRY))


def _dtype_name(dtype) -> str:
    """The numpy name of a dtype given as a torch dtype, a numpy dtype or a
    name (``torch.float32``, ``np.float32`` and ``'float32'`` all give
    ``'float32'``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str) and dtype == "bfloat16":
        return dtype  # numpy has no bfloat16
    return np.dtype(dtype).name


def plan_key(
    operator: str,
    shape,
    *,
    dtype,
    bc: str = "periodic",
    mode: str | None = None,
    alpha: float | None = None,
    extra=None,
) -> str:
    """Canonical string identity of one plan request: operator name, field
    shape, dtype, boundary condition, the ``mode`` hint, the ADI ``alpha``
    and an ``extra`` dict for caller-specific discriminators (backend
    request, batch quantisation, ...).  Deterministic and order-independent,
    and the same string as ``repro.plan_key`` gives for the same request; a
    torch dtype and its name give the same key.  Host identity is not part
    of it: a plan is portable.

    >>> plan_key("laplacian", (64, 64), dtype=torch.float32) == plan_key(
    ...     "laplacian", [64, 64], dtype="float32")
    True
    """
    doc = {
        "schema": 1,
        "operator": str(operator),
        "shape": [int(s) for s in shape],
        "dtype": _dtype_name(dtype),
        "bc": bc,
        "mode": mode,
        "alpha": None if alpha is None else float(alpha),
        "extra": extra,
    }
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


_D2 = np.array([1.0, -2.0, 1.0])  # delta (paper eq. 4a)
_D4 = np.array([1.0, -4.0, 6.0, -4.0, 1.0])  # delta^2 (paper eq. 4b)


def _laplacian_weights(ndim: int = 2, h: float = 1.0):
    """delta^2 in 1D, the 5-point cross in 2D, the 7-point box in 3D
    (units h^-2)."""
    if ndim == 1:
        return _D2 / h**2
    if ndim == 2:
        w = np.zeros((3, 3))
        w[1, :] += _D2
        w[:, 1] += _D2
        return w / h**2
    if ndim == 3:
        return _stencil.laplacian3d_weights(h)
    raise ValueError(f"laplacian weights: ndim must be 1|2|3, got {ndim}")


def _biharmonic_weights(ndim: int = 2, h: float = 1.0):
    """delta^4 in 1D; delta_x^2 + delta_y^2 + 2 delta_x delta_y in 2D
    (paper eq. 4, the Cahn–Hilliard hyperdiffusion stencil)."""
    if ndim == 1:
        return _D4 / h**4
    if ndim == 2:
        w = np.zeros((5, 5))
        w[2, :] += _D4
        w[:, 2] += _D4
        w[1:4, 1:4] += 2.0 * np.outer(_D2, _D2)
        return w / h**4
    raise ValueError(f"biharmonic weights: ndim must be 1|2, got {ndim}")


register_operator(
    "laplacian", weights=_laplacian_weights,
    doc="grad^2: 3-point / 5-point cross / 7-point box (units h^-2)",
    derivative=2, symmetric=True, zero_sum=True,
)
register_operator(
    "biharmonic", weights=_biharmonic_weights,
    doc="grad^4: delta^4 / the paper's 5x5 eq.-(4) stencil (units h^-4)",
    derivative=4, symmetric=True, zero_sum=True,
)
register_operator(
    "hyperdiffusion",
    weights=lambda ndim=1, h=1.0: _biharmonic_weights(ndim, h),
    diagonals=hyperdiffusion_diagonals,
    doc="implicit I + alpha delta^4 (ADI bands); explicit delta^4 weights",
    derivative=4, symmetric=True, zero_sum=True,
)
register_operator(
    "diffusion",
    weights=lambda ndim=1, h=1.0: _laplacian_weights(ndim, h),
    diagonals=diffusion_diagonals,
    doc="implicit I - alpha delta^2 (ADI bands); explicit delta^2 weights",
    derivative=2, symmetric=True, zero_sum=True,
)


_BATCH_MODES = ("batch", "batch1d", "1d_batch")
_EXTENT_KEYS = ("left", "right", "top", "bottom", "front", "back")


def _resolve_direction(rank: int, mode: str | None, wndim: int | None):
    """Plan direction from the shape rank, the mode hint, and (when
    weights are an explicit array) their dimensionality."""
    if rank == 2:
        if mode is None:
            return "xy" if wndim in (2, None) else "x"
        if mode in _stencil._DIRECTIONS:
            return mode
        raise ValueError(
            f"mode for a rank-2 shape must be one of "
            f"{_stencil._DIRECTIONS + _BATCH_MODES[:1] + ('adi',)}, "
            f"got {mode!r}"
        )
    if mode is None:
        if wndim in (3, None):
            return "xyz"
        raise ValueError(
            "1D weights on a rank-3 shape are ambiguous: pass "
            "mode='x'|'y'|'z'"
        )
    if mode in _stencil._DIRECTIONS_3D:
        return mode
    raise ValueError(
        f"mode for a rank-3 shape must be one of "
        f"{_stencil._DIRECTIONS_3D + ('adi',)}, got {mode!r}"
    )


def create(
    weights_or_fn,
    shape,
    *,
    bc: str = "periodic",
    mode: str | None = None,
    coeffs=None,
    extents: dict | None = None,
    h: float = 1.0,
    dtype=None,
    alpha=None,
    alpha_y=None,
    alpha_z=None,
    cyclic: bool | None = None,
    backend: str = "auto",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    tune: str = "off",
    tune_cache=None,
    lint: str = "warn",
    device="cuda",
):
    """Create a plan — the one entry point for every plan family.

    ``weights_or_fn`` is an explicit weights array, a point function (the
    paper's function-pointer mode; give ``coeffs`` and ``extents``), or a
    registered operator name (weights built for the inferred
    dimensionality with grid spacing ``h``).  The family comes from the
    rank of ``shape`` and ``mode``:

    ========================  =========================================
    ``shape``, ``mode``       plan
    ========================  =========================================
    ``(ny, nx)``              :class:`Stencil2D` (``mode`` = direction
                              ``'x'|'y'|'xy'``; default from weights)
    ``(B, M)``, ``'batch'``   :class:`StencilBatch1D` (one 1D stencil,
                              every row of the stack)
    ``(nz, ny, nx)``          :class:`Stencil3D` (``mode`` = direction
                              ``'x'|'y'|'z'|'xyz'``)
    any, ``'adi'``            :class:`ADIOperator` / :class:`ADIOperator3D`
                              (named operator with bands + ``alpha=``;
                              ``bc='periodic'`` gives cyclic bands)
    ========================  =========================================

    ``backend`` is ``'auto'|'cuda'|'torch'|'fft'``; ``device`` defaults to
    the card.  ``'fft'`` is the spectral path
    (:mod:`repro_torch.kernels.spectral`): the operator's Fourier symbol is
    computed at Create and Compute is a multiply (stencils) or a divide
    (cyclic ADI sweeps) in frequency space.  It needs periodic boundaries,
    explicit weights and cyclic bands, and refuses anything else with
    :class:`~repro_torch.kernels.spectral.SpectralBackendError`;
    ``'auto'`` never picks it.  ``streams``/``max_tile_bytes`` (cuSten's ``nStreams``) stream a
    plan's Compute in chunks on CUDA streams when the field exceeds one
    tile (:mod:`repro_torch.launch.stream`): row or line chunks at rank 2,
    z-slabs of a rank-3 stencil, and row, plane and column chunks of the
    3D ADI sweeps.

    ``tune='cached'|'force'`` races the plan's candidates at Create, on a
    field of ``shape`` (:mod:`repro_torch.tune`): on the card the
    kernel's launch geometries (every one computes what the default one
    does, bit for bit) and, under ``backend='auto'`` for a periodic
    weighted plan or a cyclic ADI operator, the fft backend; on the CPU
    the plain path and fft.  Winners are remembered in ``tune_cache`` (a
    :class:`~repro_torch.tune.TuneCache`; by default
    ``$REPRO_TUNE_CACHE`` or ``~/.cache/repro-tune``).

    ``lint='off'|'warn'|'error'`` runs Create-time stencil-lint (the
    registry operator's declared moments, symmetry and zero sum; ADI band
    topology, sign and conditioning; the plan's halo and launch geometry
    against ``shape``) and surfaces findings as
    :class:`~repro_torch.analysis.StencilLintWarning` or
    :class:`~repro_torch.analysis.LintError`.
    """
    from repro_torch.analysis import check_lint_mode

    check_lint_mode(lint)
    shape = tuple(int(s) for s in shape)
    rank = len(shape)
    if rank not in (2, 3):
        raise ValueError(
            f"shape must be rank 2 or 3, got {shape!r} "
            "(batched-1D stacks are rank-2 (B, M) with mode='batch')"
        )
    opdef = get_operator(weights_or_fn) if isinstance(weights_or_fn, str) else None

    if mode == "adi":
        if opdef is None:
            raise ValueError(
                "mode='adi' takes a registered operator name; its diagonals "
                "build the implicit bands"
            )
        if alpha is None:
            raise ValueError("mode='adi' needs alpha= (the band coefficient)")
        if h != 1.0:
            raise ValueError(
                "h= only scales registry stencil weights; for mode='adi' "
                "fold the grid spacing into alpha= instead"
            )
        if cyclic is None:
            cyclic = bc == "periodic"
        elif bc != "periodic" and cyclic:
            raise ValueError(
                f"bc={bc!r} asks for a non-cyclic operator but cyclic=True "
                "was passed; drop one of them"
            )
        if lint != "off":
            from repro_torch.analysis import lint_adi, surface

            ay = alpha if alpha_y is None else alpha_y
            az = alpha if alpha_z is None else alpha_z
            dirs = [("x", shape[-1], alpha), ("y", shape[-2], ay)]
            if rank == 3:
                dirs.append(("z", shape[-3], az))
            findings = []
            for dname, n, a in dirs:
                findings += lint_adi(opdef, n, a, bc=bc, cyclic=cyclic,
                                     direction=dname)
            surface(findings, lint)
        common = dict(
            cyclic=cyclic, dtype=torch.float64 if dtype is None else dtype,
            backend=backend, operator=opdef.name, device=device,
            streams=streams, max_tile_bytes=max_tile_bytes, tune=tune,
            tune_cache=tune_cache,
        )
        if rank == 2:
            if alpha_z is not None:
                raise ValueError("alpha_z only applies to rank-3 shapes")
            ny, nx = shape
            return _adi._make_adi_operator(
                ny, nx, alpha, alpha_over_h4_y=alpha_y, **common
            )
        nz, ny, nx = shape
        return _adi._make_adi_operator_3d(
            nz, ny, nx, alpha, alpha_y=alpha_y, alpha_z=alpha_z, **common
        )

    for nm, val in (("alpha", alpha), ("alpha_y", alpha_y),
                    ("alpha_z", alpha_z), ("cyclic", cyclic)):
        if val is not None:
            raise ValueError(
                f"{nm}= only applies to mode='adi' (implicit ADI plans)"
            )
    batch = mode in _BATCH_MODES
    if batch and rank != 2:
        raise ValueError("mode='batch' takes a rank-2 (B, M) stack")
    if opdef is None and h != 1.0:
        raise ValueError(
            "h= only scales registry-operator weights; explicit weights and "
            f"point functions already encode the grid spacing (got h={h!r})"
        )
    weights = func = None
    direction = None
    if opdef is not None:
        if opdef.weights is None:
            raise ValueError(
                f"operator {opdef.name!r} defines no stencil weights "
                "(band-only); use mode='adi'"
            )
        if not batch:
            direction = _resolve_direction(rank, mode, None)
        wndim = 1 if batch else {"xy": 2, "xyz": 3}.get(direction, 1)
        weights = opdef.weights(wndim, h)
    elif callable(weights_or_fn) and not isinstance(
        weights_or_fn, (np.ndarray, torch.Tensor)
    ):
        func = weights_or_fn
        if not batch:
            direction = _resolve_direction(rank, mode, None)
    else:
        weights = weights_or_fn
        if not batch:
            direction = _resolve_direction(rank, mode, np.ndim(weights))

    ext = dict(extents or {})
    allowed = _EXTENT_KEYS[:2] if batch else _EXTENT_KEYS[: 2 * rank]
    bad = sorted(set(ext) - set(allowed))
    if bad:
        raise ValueError(f"unknown extents keys {bad}; allowed: {list(allowed)}")
    common = dict(
        weights=weights, func=func, coeffs=coeffs, backend=backend,
        dtype=dtype, device=device, streams=streams,
        max_tile_bytes=max_tile_bytes, shape=shape, tune=tune,
        tune_cache=tune_cache, op_name=None if opdef is None else opdef.name,
        **{f"num_sten_{k}": v for k, v in ext.items()},
    )
    if batch:
        plan = _stencil._create_1d_batch(bc, **common)
    elif rank == 2:
        plan = _stencil._create_2d(direction, bc, **common)
    else:
        plan = _stencil._create_3d(direction, bc, **common)

    if lint != "off":
        from repro_torch.analysis import check_plan, lint_operator, surface

        findings = []
        if opdef is not None:
            wndim = 1 if batch else {"xy": 2, "xyz": 3}.get(direction, 1)
            findings += lint_operator(opdef, ndim=wndim, h=h)
        findings += check_plan(plan, shape, ("launch_geometry_feasible",))
        surface(findings, lint)
    return plan


def compute(plan, field, *extra):
    """Apply any plan to ``field`` — the single Compute path.  Stencil plans
    take an optional ``out_init`` extra; ADI plans apply the full implicit
    solve, ``L_y^{-1} L_x^{-1}`` in 2D and ``L_z^{-1} L_y^{-1} L_x^{-1}``
    in 3D."""
    if getattr(plan, "_destroyed", False):
        raise ValueError("plan has been destroyed; create a new one")
    if isinstance(plan, _stencil.PlanCore):
        return plan.apply(field, *extra)
    if isinstance(plan, (_adi.ADIOperator, _adi.ADIOperator3D)):
        if extra:
            raise TypeError("ADI compute takes no extra operands")
        out = plan.solve_y(plan.solve_x(field))
        if isinstance(plan, _adi.ADIOperator3D):
            out = plan.solve_z(out)
        return out
    raise TypeError(
        f"compute wants a stencil plan or ADI operator, got {type(plan).__name__}"
    )


def swap(buf):
    """Flip a double buffer between time steps (cuSten's Swap): an
    ``(a, b)`` pair is returned reversed; a
    :class:`~repro_torch.core.stencil.DoubleBuffer` is flipped in place."""
    if isinstance(buf, _stencil.DoubleBuffer):
        return buf.swap()
    try:
        a, b = buf
    except (TypeError, ValueError):
        raise TypeError(
            f"swap wants an (a, b) pair or a DoubleBuffer, got {type(buf).__name__}"
        ) from None
    return b, a


def destroy(plan) -> None:
    """Tear down any plan (cuSten's Destroy) — idempotent: the plan is
    marked destroyed and :func:`compute` refuses it afterwards."""
    _stencil.plan_destroy(plan)
