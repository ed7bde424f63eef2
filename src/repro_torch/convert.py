"""Carry the reference's state across: turn numpy arrays into the port's
objects.

The reference's factor sets, ADI operators (2D and 3D) and stencil plans
(2D, batched-1D and 3D) hold arrays;
pass ``np.asarray`` of each and these functions build the port's
counterpart on ``device``.  Feeding the reference's own factors to the
port separates differences in the substitution from differences in the
factorisation.  Each function also carries a reference plan's ``streams``
and ``max_tile_bytes`` across, and its fft backend's Create-time symbols
(a plan's ``symbol``, an operator's ``sym_x``/``sym_y``/``sym_z``; complex
arrays), so the symbols can be held apart from the transforms.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.adi import ADIOperator, ADIOperator3D
from repro_torch.core.stencil import (
    Stencil2D,
    Stencil3D,
    StencilBatch1D,
    plan_taps_of,
)
from repro_torch.kernels.penta import CyclicPentaFactors, PentaFactors
from repro_torch.kernels.ref import weighted_point_fn
from repro_torch.kernels.taps import halos_1d, halos_2d
from repro_torch.launch.stream import stream_fields
from repro_torch.util import resolve_device


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True, order="C"), device=device)


def _symbol(a, device) -> torch.Tensor | None:
    return None if a is None else _tensor(a, device)


def penta_factors(sub, low, inv_mu, al, be, *, device="cuda") -> PentaFactors:
    """A :class:`PentaFactors` from the five factor arrays (length M)."""
    dev = resolve_device(device)
    return PentaFactors(*(_tensor(a, dev) for a in (sub, low, inv_mu, al, be)))


def cyclic_penta_factors(
    band: Sequence, z, s_inv, w, *, device="cuda"
) -> CyclicPentaFactors:
    """A :class:`CyclicPentaFactors` from the band's five factor arrays and
    the Woodbury arrays ``z`` (M, 4), ``s_inv`` (4, 4), ``w`` (M, 4)."""
    dev = resolve_device(device)
    return CyclicPentaFactors(
        penta_factors(*band, device=dev),
        _tensor(z, dev), _tensor(s_inv, dev), _tensor(w, dev),
    )


def adi_operator(
    fac_x: PentaFactors | CyclicPentaFactors,
    fac_y: PentaFactors | CyclicPentaFactors,
    *,
    backend: str = "auto",
    operator: str = "hyperdiffusion",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    sym_x=None,
    sym_y=None,
) -> ADIOperator:
    """A 2D :class:`ADIOperator` from two converted factor sets (cyclic when
    both are cyclic), with the reference operator's streaming knobs and
    band symbols."""
    cyclic = isinstance(fac_x, CyclicPentaFactors)
    if cyclic != isinstance(fac_y, CyclicPentaFactors):
        raise ValueError("fac_x and fac_y must both be cyclic or both plain")
    device = (fac_x.band if cyclic else fac_x).sub.device
    return ADIOperator(
        fac_x=fac_x, fac_y=fac_y, cyclic=cyclic, backend=backend,
        operator=operator, sym_x=_symbol(sym_x, device),
        sym_y=_symbol(sym_y, device),
        **stream_fields(streams, max_tile_bytes, device),
    )


def adi_operator_3d(
    fac_x: PentaFactors | CyclicPentaFactors,
    fac_y: PentaFactors | CyclicPentaFactors,
    fac_z: PentaFactors | CyclicPentaFactors,
    *,
    backend: str = "auto",
    operator: str = "hyperdiffusion",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    sym_x=None,
    sym_y=None,
    sym_z=None,
) -> ADIOperator3D:
    """A :class:`ADIOperator3D` from three converted factor sets (cyclic
    when all three are cyclic), with the reference operator's streaming
    knobs and band symbols."""
    kinds = {isinstance(f, CyclicPentaFactors) for f in (fac_x, fac_y, fac_z)}
    if len(kinds) != 1:
        raise ValueError("fac_x, fac_y and fac_z must all be cyclic or all plain")
    cyclic = kinds.pop()
    device = (fac_x.band if cyclic else fac_x).sub.device
    return ADIOperator3D(
        fac_x=fac_x, fac_y=fac_y, fac_z=fac_z, cyclic=cyclic,
        backend=backend, operator=operator, sym_x=_symbol(sym_x, device),
        sym_y=_symbol(sym_y, device), sym_z=_symbol(sym_z, device),
        **stream_fields(streams, max_tile_bytes, device),
    )


def _check_weighted(coeffs_t: torch.Tensor, point_fn: Callable, n: int) -> None:
    if point_fn is weighted_point_fn and coeffs_t.numel() != n:
        raise ValueError("weighted coeffs must hold one weight per window")


def stencil_batch1d(
    coeffs,
    *,
    left: int,
    right: int,
    bc: str = "periodic",
    point_fn: Callable = weighted_point_fn,
    backend: str = "auto",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    symbol=None,
    device="cuda",
) -> StencilBatch1D:
    """A :class:`StencilBatch1D` from its ``coeffs`` (left to right),
    extents, streaming knobs and fft symbol."""
    dev = resolve_device(device)
    coeffs_t = _tensor(coeffs, dev).reshape(-1)
    _check_weighted(coeffs_t, point_fn, left + right + 1)
    return StencilBatch1D(
        bc=bc, left=left, right=right, coeffs=coeffs_t, point_fn=point_fn,
        backend=backend, taps=plan_taps_of(coeffs_t, point_fn, halos_1d(left, right)),
        symbol=_symbol(symbol, dev), **stream_fields(streams, max_tile_bytes, dev),
    )


def stencil3d(
    coeffs,
    *,
    halos,
    bc: str = "periodic",
    point_fn: Callable = weighted_point_fn,
    backend: str = "auto",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    symbol=None,
    device="cuda",
) -> Stencil3D:
    """A :class:`Stencil3D` from flat ``coeffs`` (z-major, then row-major
    over (y, x)), ``halos`` ``(front, back, top, bottom, left, right)``,
    its streaming knobs and fft symbol."""
    fr, bk, tp, bt, lf, rt = (int(h) for h in halos)
    dev = resolve_device(device)
    coeffs_t = _tensor(coeffs, dev).reshape(-1)
    _check_weighted(coeffs_t, point_fn, (fr + bk + 1) * (tp + bt + 1) * (lf + rt + 1))
    axes = "".join(a for a, on in (("x", lf or rt), ("y", tp or bt), ("z", fr or bk)) if on)
    return Stencil3D(
        direction=axes if len(axes) == 1 else "xyz", bc=bc, front=fr, back=bk,
        top=tp, bottom=bt, left=lf, right=rt, coeffs=coeffs_t,
        point_fn=point_fn, backend=backend,
        taps=plan_taps_of(coeffs_t, point_fn, (fr, bk, tp, bt, lf, rt)),
        symbol=_symbol(symbol, dev), **stream_fields(streams, max_tile_bytes, dev),
    )


def stencil2d(
    coeffs,
    *,
    left: int,
    right: int,
    top: int,
    bottom: int,
    bc: str = "periodic",
    point_fn: Callable = weighted_point_fn,
    backend: str = "auto",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    symbol=None,
    device="cuda",
) -> Stencil2D:
    """A :class:`Stencil2D` from flat ``coeffs`` (row-major from the
    stencil's top-left), its extents, its streaming knobs and fft
    symbol."""
    dev = resolve_device(device)
    coeffs_t = _tensor(coeffs, dev).reshape(-1)
    _check_weighted(coeffs_t, point_fn, (left + right + 1) * (top + bottom + 1))
    direction = "xy" if (left or right) and (top or bottom) else (
        "y" if (top or bottom) else "x"
    )
    return Stencil2D(
        direction=direction, bc=bc, left=left, right=right, top=top,
        bottom=bottom, coeffs=coeffs_t, point_fn=point_fn, backend=backend,
        taps=plan_taps_of(coeffs_t, point_fn, halos_2d(left, right, top, bottom)),
        symbol=_symbol(symbol, dev), **stream_fields(streams, max_tile_bytes, dev),
    )
