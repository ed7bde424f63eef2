"""The plan-based 2D stencil engine (counterpart of ``repro.core.stencil``,
reduced to the monolithic apply).

- :func:`_create_2d` — Create: validate geometry, capture weights or the
  function pointer, the boundary mode and the backend, return an immutable
  plan whose coefficients already live on the plan's device.
- :meth:`Stencil2D.apply` — Compute, through
  :func:`repro_torch.kernels.ops.stencil_apply`.
- :class:`DoubleBuffer` — Swap.
- :func:`plan_destroy` — Destroy (an idempotent mark; tensors are freed by
  reference counting).

Direction is encoded by the halo extents: an X plan has ``left/right``, a
Y plan ``top/bottom``, an XY plan all four.  ``bc='np'`` computes interior
points only and passes ``out_init`` through on the boundary.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels._build import check_backend
from repro_torch.kernels.ref import weighted_point_fn
from repro_torch.util import refuse_unported, resolve_device, torch_dtype

_DIRECTIONS = ("x", "y", "xy")
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
    device), the point function and the backend request."""

    bc: str
    coeffs: torch.Tensor
    point_fn: Callable = weighted_point_fn
    backend: str = "auto"
    op_name: str | None = None

    @property
    def destroyed(self) -> bool:
        """True once :func:`plan_destroy` / ``repro_torch.destroy`` ran."""
        return getattr(self, "_destroyed", False)

    def _halo_kwargs(self) -> dict:
        raise NotImplementedError

    def apply(
        self, data: torch.Tensor, out_init: torch.Tensor | None = None
    ) -> torch.Tensor:
        """Apply the stencil to ``data`` (the Compute call).  For
        ``bc='np'`` the cells within the halo of the domain edge are copied
        from ``out_init`` (zeros if not given)."""
        return ops.stencil_apply(
            data, self.coeffs, out_init, point_fn=self.point_fn, bc=self.bc,
            backend=self.backend, **self._halo_kwargs(),
        )

    def __call__(self, data, out_init=None):
        return self.apply(data, out_init)


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

    def _halo_kwargs(self) -> dict:
        return dict(left=self.left, right=self.right, top=self.top,
                    bottom=self.bottom)

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
    op_name: str | None = None,
) -> Stencil2D:
    """Create a 2D stencil plan (the Create call).

    Weighted mode: ``weights`` 1D for X/Y (symmetric split inferred for odd
    lengths) or 2D ``(sy, sx)`` for XY.  Function mode (the paper's ``Fun``
    variants): ``func(windows, coeffs)`` plus ``coeffs`` and the extents;
    ``windows`` is the row-major list of shifted views from the top-left of
    the stencil.  ``dtype`` defaults to the weights' own (float64 for
    Python or numpy float64 weights)."""
    refuse_unported(streams=streams, max_tile_bytes=max_tile_bytes, tune=tune)
    if direction not in _DIRECTIONS:
        raise ValueError(f"direction must be one of {_DIRECTIONS}")
    if bc not in _BCS:
        raise ValueError(f"bc must be one of {_BCS}")
    check_backend(backend)
    if (weights is None) == (func is None):
        raise ValueError("exactly one of weights / func must be given")
    dev = resolve_device(device)
    dt = None if dtype is None else torch_dtype(dtype)

    def tensor(a: np.ndarray) -> torch.Tensor:
        t = torch.as_tensor(np.ascontiguousarray(a))
        return t.to(device=dev, dtype=dt if dt is not None else t.dtype)

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

    return Stencil2D(
        direction=direction, bc=bc, left=left, right=right, top=top,
        bottom=bottom, coeffs=coeffs_t, point_fn=point_fn,
        backend=backend, op_name=op_name,
    )


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
