"""Carry the reference's state across: turn numpy arrays into the port's
objects.

The reference's factor sets, ADI operators and stencil plans hold arrays;
pass ``np.asarray`` of each and these functions build the port's
counterpart on ``device``.  Feeding the reference's own factors to the
port separates differences in the substitution from differences in the
factorisation.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.adi import ADIOperator
from repro_torch.core.stencil import Stencil2D
from repro_torch.kernels.penta import CyclicPentaFactors, PentaFactors
from repro_torch.kernels.ref import weighted_point_fn
from repro_torch.util import resolve_device


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True, order="C"), device=device)


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
) -> ADIOperator:
    """A 2D :class:`ADIOperator` from two converted factor sets (cyclic when
    both are cyclic)."""
    cyclic = isinstance(fac_x, CyclicPentaFactors)
    if cyclic != isinstance(fac_y, CyclicPentaFactors):
        raise ValueError("fac_x and fac_y must both be cyclic or both plain")
    return ADIOperator(
        fac_x=fac_x, fac_y=fac_y, cyclic=cyclic, backend=backend,
        operator=operator,
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
    device="cuda",
) -> Stencil2D:
    """A :class:`Stencil2D` from flat ``coeffs`` (row-major from the
    stencil's top-left) and its extents."""
    coeffs_t = _tensor(coeffs, resolve_device(device)).reshape(-1)
    if point_fn is weighted_point_fn and coeffs_t.numel() != (
        (left + right + 1) * (top + bottom + 1)
    ):
        raise ValueError("weighted coeffs must hold one weight per window")
    direction = "xy" if (left or right) and (top or bottom) else (
        "y" if (top or bottom) else "x"
    )
    return Stencil2D(
        direction=direction, bc=bc, left=left, right=right, top=top,
        bottom=bottom, coeffs=coeffs_t, point_fn=point_fn, backend=backend,
    )
