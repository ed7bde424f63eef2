"""The four-function facade — Create / Compute / Swap / Destroy (counterpart
of ``repro.api``, rank-2 plans).

- :func:`create` — a :class:`~repro_torch.core.stencil.Stencil2D`
  (``mode='xy'|'x'|'y'``) or a 2D :class:`~repro_torch.core.adi.ADIOperator`
  (``mode='adi'``), built on ``device`` (the card unless the caller asks for
  the CPU).
- :func:`compute` — the single apply path for any plan.
- :func:`swap` — the double-buffer flip between time steps.
- :func:`destroy` — unified, idempotent teardown.

The operator registry (:func:`register_operator` / :func:`get_operator`)
is the single source of named operators: stencil ``weights`` builders and
ADI band ``diagonals`` builders.  Built-ins: ``"laplacian"``,
``"biharmonic"``, ``"hyperdiffusion"``, ``"diffusion"``.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.core import adi as _adi
from repro_torch.core import stencil as _stencil
from repro_torch.kernels.penta import diffusion_diagonals, hyperdiffusion_diagonals
from repro_torch.util import refuse_unported

__all__ = [
    "OperatorDef",
    "compute",
    "create",
    "destroy",
    "get_operator",
    "operator_names",
    "register_operator",
    "swap",
]


@dataclasses.dataclass(frozen=True)
class OperatorDef:
    """A named difference operator: ``weights(ndim, h=1.0)`` builds explicit
    stencil weights, ``diagonals(n, alpha, dtype)`` the pentadiagonal bands
    of the implicit per-direction operator.  Either may be ``None``."""

    name: str
    weights: Callable | None = None
    diagonals: Callable | None = None
    doc: str = ""


_REGISTRY: dict[str, OperatorDef] = {}


def register_operator(
    name: str,
    *,
    weights: Callable | None = None,
    diagonals: Callable | None = None,
    doc: str = "",
    overwrite: bool = False,
) -> OperatorDef:
    """Register a named operator for :func:`create`.  Re-registering an
    existing name raises unless ``overwrite=True``."""
    if not name or not isinstance(name, str):
        raise ValueError("operator name must be a non-empty string")
    if weights is None and diagonals is None:
        raise ValueError(f"operator {name!r} needs weights= and/or diagonals=")
    if name in _REGISTRY and not overwrite:
        raise ValueError(
            f"operator {name!r} is already registered "
            "(pass overwrite=True to replace it)"
        )
    opdef = OperatorDef(name=name, weights=weights, diagonals=diagonals, doc=doc)
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


_D2 = np.array([1.0, -2.0, 1.0])  # delta (paper eq. 4a)
_D4 = np.array([1.0, -4.0, 6.0, -4.0, 1.0])  # delta^2 (paper eq. 4b)


def _rank3_refused():
    return NotImplementedError(
        "rank-3 (3D) plans are not ported yet (ROADMAP.md queue 1, item 7)"
    )


def _laplacian_weights(ndim: int = 2, h: float = 1.0):
    """delta^2 in 1D, the 5-point cross in 2D (units h^-2)."""
    if ndim == 1:
        return _D2 / h**2
    if ndim == 2:
        w = np.zeros((3, 3))
        w[1, :] += _D2
        w[:, 1] += _D2
        return w / h**2
    if ndim == 3:
        raise _rank3_refused()
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
    doc="grad^2: 3-point / 5-point cross (units h^-2)",
)
register_operator(
    "biharmonic", weights=_biharmonic_weights,
    doc="grad^4: delta^4 / the paper's 5x5 eq.-(4) stencil (units h^-4)",
)
register_operator(
    "hyperdiffusion",
    weights=lambda ndim=1, h=1.0: _biharmonic_weights(ndim, h),
    diagonals=hyperdiffusion_diagonals,
    doc="implicit I + alpha delta^4 (ADI bands); explicit delta^4 weights",
)
register_operator(
    "diffusion",
    weights=lambda ndim=1, h=1.0: _laplacian_weights(ndim, h),
    diagonals=diffusion_diagonals,
    doc="implicit I - alpha delta^2 (ADI bands); explicit delta^2 weights",
)


_EXTENT_KEYS = ("left", "right", "top", "bottom")


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
    cyclic: bool | None = None,
    backend: str = "auto",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    tune: str = "off",
    lint: str | None = None,
    device="cuda",
):
    """Create a plan — the one entry point for the rank-2 plan families.

    ``weights_or_fn`` is an explicit weights array, a point function (the
    paper's function-pointer mode; give ``coeffs`` and ``extents``), or a
    registered operator name.  ``shape`` is ``(ny, nx)``; ``mode`` is the
    stencil direction ``'x'|'y'|'xy'`` (default from the weights) or
    ``'adi'`` for an implicit operator (named operator with bands +
    ``alpha=``; ``bc='periodic'`` gives cyclic bands).  ``backend`` is
    ``'auto'|'cuda'|'torch'``; ``device`` defaults to the card.
    """
    refuse_unported(
        streams=streams, max_tile_bytes=max_tile_bytes, tune=tune, lint=lint
    )
    shape = tuple(int(s) for s in shape)
    if len(shape) == 3:
        raise _rank3_refused()
    if len(shape) != 2:
        raise ValueError(f"shape must be rank 2, got {shape!r}")
    if mode in ("batch", "batch1d", "1d_batch"):
        raise NotImplementedError(
            "mode='batch' (batched-1D plans) is not ported yet "
            "(ROADMAP.md queue 1, item 5)"
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
        ny, nx = shape
        return _adi._make_adi_operator(
            ny, nx, alpha, alpha_over_h4_y=alpha_y, cyclic=cyclic,
            dtype=torch.float64 if dtype is None else dtype, backend=backend,
            operator=opdef.name, device=device,
        )

    for nm, val in (("alpha", alpha), ("alpha_y", alpha_y), ("cyclic", cyclic)):
        if val is not None:
            raise ValueError(
                f"{nm}= only applies to mode='adi' (implicit ADI plans)"
            )
    if opdef is None and h != 1.0:
        raise ValueError(
            "h= only scales registry-operator weights; explicit weights and "
            f"point functions already encode the grid spacing (got h={h!r})"
        )
    if mode is not None and mode not in _stencil._DIRECTIONS:
        raise ValueError(
            f"mode for a rank-2 shape must be one of "
            f"{_stencil._DIRECTIONS + ('adi',)}, got {mode!r}"
        )
    weights = func = None
    if opdef is not None:
        if opdef.weights is None:
            raise ValueError(
                f"operator {opdef.name!r} defines no stencil weights "
                "(band-only); use mode='adi'"
            )
        direction = mode or "xy"
        weights = opdef.weights(2 if direction == "xy" else 1, h)
    elif callable(weights_or_fn) and not isinstance(
        weights_or_fn, (np.ndarray, torch.Tensor)
    ):
        func = weights_or_fn
        direction = mode or "xy"
    else:
        weights = weights_or_fn
        ndim = np.ndim(weights)
        direction = mode or ("xy" if ndim == 2 else "x")

    ext = dict(extents or {})
    bad = sorted(set(ext) - set(_EXTENT_KEYS))
    if bad:
        raise ValueError(f"unknown extents keys {bad}; allowed: {list(_EXTENT_KEYS)}")
    return _stencil._create_2d(
        direction, bc, weights=weights, func=func, coeffs=coeffs,
        backend=backend, dtype=dtype, device=device,
        op_name=None if opdef is None else opdef.name,
        **{f"num_sten_{k}": v for k, v in ext.items()},
    )


def compute(plan, field, *extra):
    """Apply any plan to ``field`` — the single Compute path.  Stencil plans
    take an optional ``out_init`` extra; ADI plans apply the full implicit
    solve ``L_y^{-1} L_x^{-1}``."""
    if getattr(plan, "_destroyed", False):
        raise ValueError("plan has been destroyed; create a new one")
    if isinstance(plan, _stencil.PlanCore):
        return plan.apply(field, *extra)
    if isinstance(plan, _adi.ADIOperator):
        if extra:
            raise TypeError("ADI compute takes no extra operands")
        return plan.solve_y(plan.solve_x(field))
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
