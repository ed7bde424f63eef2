"""Create-time tap reduction, shared by the three stencil kernels.

A weighted or cube plan's kernel sums one term a window of its stencil
box.  At Create the box's coefficients are reduced to the windows whose
weight is not zero (:func:`nonzero_taps`), in the reference's window
order, and the kernel takes them by value as a launch parameter
(``csrc/common.cuh:Taps``).  One tap type serves every rank: a 3D window
(c, a, b) of the (z, y, x) box, a 2D window (a, b) as (0, a, b), a 1D
window k as (0, 0, k).  Halos are given in the 3D kernel's order
``(front, back, top, bottom, left, right)``; :func:`halos_2d` and
:func:`halos_1d` lift the lower ranks' extents into it.

Skipping an exact-zero term changes no finite result, only the sign of an
all-zero sum.  A plan with more than :data:`MAX_TAPS` non-zero windows
keeps the dense path (every window, its coefficient read on the card); a
user's point function takes every window.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np

# the most taps a launch parameter holds (csrc/common.cuh:kMaxTaps)
MAX_TAPS = 32


class Taps(NamedTuple):
    """The non-zero taps of a stencil, in the reference's window order
    (z-major, then row-major over (y, x)): each tap's offset (dz, dy, dx)
    from the output point and its weight."""

    offsets: tuple[tuple[int, int, int], ...]
    weights: tuple[float, ...]


def halos_2d(left: int, right: int, top: int, bottom: int) -> tuple:
    """A 2D stencil's extents as the halos of a box one plane deep."""
    return (0, 0, int(top), int(bottom), int(left), int(right))


def halos_1d(left: int, right: int) -> tuple:
    """A 1D stencil's extents as the halos of a box one row deep."""
    return (0, 0, 0, 0, int(left), int(right))


def nonzero_taps(coeffs, halos) -> Taps | None:
    """The taps of a weighted or cube plan whose weight is not zero, for
    the kernel (at Create, from the host weights).  None when more than
    :data:`MAX_TAPS` remain: the kernel then reads every window's
    coefficient from device memory."""
    fr, bk, tp, bt, lf, rt = (int(h) for h in halos)
    sy, sx = tp + bt + 1, lf + rt + 1
    w = np.asarray(coeffs, dtype=np.float64).ravel()
    if w.size != (fr + bk + 1) * sy * sx:
        raise ValueError(f"{w.size} coefficients for halos {tuple(halos)}")
    keep = np.flatnonzero(w)
    if keep.size > MAX_TAPS:
        return None
    return Taps(
        tuple((int(t // (sy * sx)) - fr, int(t // sx % sy) - tp,
               int(t % sx) - lf) for t in keep),
        tuple(float(w[t]) for t in keep),
    )


def plan_taps(coeffs, halos, *, user: bool) -> Taps | None:
    """A plan's taps at Create: those of its coefficient tensor (one per
    window) for the library's point functions, None for a user's point
    function (the general path takes every window) or for coefficients
    that are not one a window."""
    nwin = 1
    for lo, hi in zip(halos[::2], halos[1::2]):
        nwin *= int(lo) + int(hi) + 1
    if user or coeffs.numel() != nwin:
        return None
    return nonzero_taps(coeffs.detach().cpu().numpy(), halos)


@functools.lru_cache(maxsize=256)
def c_taps(taps: Taps | None, halos: tuple) -> tuple:
    """The kernel's tap arguments: the count, the window coordinates
    (c, a, b) of each tap in the box, the weights; three nulls for no
    taps (the dense or general path)."""
    if taps is None:
        return (None, None, None)
    fr, _, tp, _, lf, _ = halos
    n = len(taps.weights)
    cab = [v for dz, dy, dx in taps.offsets
           for v in (dz + fr, dy + tp, dx + lf)]
    return ((ctypes.c_int * 1)(n), (ctypes.c_int * max(1, 3 * n))(*cab),
            (ctypes.c_double * max(1, n))(*taps.weights))
