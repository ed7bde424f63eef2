"""Generic 2D stencil: CUDA kernel wrapper and plain version (counterpart of
``repro.kernels.stencil2d``).

The kernel (``csrc/stencil2d.cu``) takes any extent and any halo: a
block stages a 32 x 32 tile and its halo in shared memory, wrapped
(periodic) or masked (``np``) on the staging loads, so none of the
reference's tile-divisibility rules or padded dispatch apply; halos too
wide for shared memory take a direct route, one point a thread
(:func:`stencil2d_geometry`).  A weighted or cube plan is reduced at
Create to its non-zero taps (:mod:`repro_torch.kernels.taps`), which the
kernel takes as a launch parameter.  The function-pointer mode runs a
compile-time device point function.  A
Python ``point_fn`` names its device counterpart with a
``device_point_fn`` tag (see :data:`DEVICE_POINT_FNS`), or carries the
CUDA C++ source of its own (:func:`cuda_point_fn`), which the stencil
libraries are built with (``_build.point_fn_build``); the Python function
stays the plain version.  A point function with neither is refused on the
card.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import stencil2d_ref, weighted_point_fn
from repro_torch.kernels.taps import Taps, c_taps, halos_2d
from repro_torch.util import ceil_div

# device point-function tag -> the kernel's point-function id
DEVICE_POINT_FNS = {"weighted": 0, "cube_laplacian": 1}

# the plain version: the semantic definition in kernels/ref.py
stencil2d_torch = stencil2d_ref

# csrc/stencil2d.cu: the tile a block owns
TILE_X, TILE_Y = 32, 32


class Stencil2DGeometry(NamedTuple):
    """Launch geometry of the 2D stencil on a whole field or stack."""

    route: str  # "tile" (staged in shared memory) or "direct"
    grid: int  # blocks, all in grid.x: the members' tiles, member-major
    smem: int  # dynamic shared memory a block, bytes; 0 on the direct route


def stencil2d_geometry(shape, halos, itemsize: int, smem_optin: int,
                       n_sms: int, batch: int = 1,
                       route: str | None = None) -> Stencil2DGeometry:
    """Geometry of the 2D stencil on an ``(ny, nx)`` field, or on a stack of
    ``batch`` of them, with halos ``(left, right, top, bottom)``.

    The tile route when a 32 x 32 tile and its halo, (32 + top + bottom) x
    (32 + left + right) elements, fit a block's shared memory; else the
    direct route, one point a thread in blocks of 32 x 8.  It depends on
    the shape, the halos and the itemsize alone, never on a launch's row
    window or the stack's size, so streamed row chunks and each member of
    a stack run the same code as the whole single field; a stack's grid is
    ``batch`` times a field's (the member index above the tiles in grid.x).
    ``n_sms`` is unused: one tile a block fills the card at any size the
    tile route takes.

    ``route`` (a tuned plan's geometry, :func:`stencil2d_geometries`)
    forces ``'tile'`` or ``'direct'``: both routes sum a point's taps by
    the same template code in the same order, so the choice changes no
    result.  A tile that does not fit raises ``ValueError`` here, before
    any launch."""
    ny, nx = shape
    left, right, top, bottom = (int(h) for h in halos)
    nbx = ceil_div(nx, TILE_X)
    smem = (TILE_Y + top + bottom) * (TILE_X + left + right) * itemsize
    if route not in (None, "tile", "direct"):
        raise ValueError(f"stencil2d route must be 'tile' or 'direct', got "
                         f"{route!r}")
    if route == "tile" and smem > smem_optin:
        raise ValueError(
            f"the stencil2d tile route needs {smem} bytes of shared memory "
            f"a block for halos {(left, right, top, bottom)}, more than the "
            f"card's {smem_optin}")
    if route == "direct" or smem > smem_optin:
        return Stencil2DGeometry("direct", batch * nbx * ceil_div(ny, 8), 0)
    return Stencil2DGeometry("tile", batch * nbx * ceil_div(ny, TILE_Y), smem)


def stencil2d_geometries(shape, halos, itemsize: int, smem_optin: int,
                         n_sms: int) -> list[dict]:
    """The launch geometries a tuned 2D plan races besides its default one
    (:func:`stencil2d_geometry`): the direct route where the default is
    the tile route (no other geometry exists where the tile does not
    fit)."""
    geo = stencil2d_geometry(shape, halos, itemsize, smem_optin, n_sms)
    return [{"route": "direct"}] if geo.route == "tile" else []


def cuda_point_fn(source: str) -> Callable:
    """Decorator: give a Python point function ``fn(windows, coeffs)`` its
    CUDA counterpart, C++ source that defines::

        template <typename T> __device__ T point_fn(const T* w, const T* c)

    over the plan's NWIN windows ``w`` (in the Python function's window
    order: left to right in 1D, row-major in 2D, z-major in 3D) and its
    coefficients ``c``.  The Python function stays the plain version (the
    CPU path); on the card the stencil kernels run the source."""
    if not isinstance(source, str) or "point_fn" not in source:
        raise ValueError("the CUDA source must define point_fn")

    def attach(fn: Callable) -> Callable:
        fn.device_point_source = source
        return fn

    return attach


def user_point_source(point_fn: Callable) -> str | None:
    """The CUDA source a point function runs from on the card (one given
    with :func:`cuda_point_fn` and without a library tag), else None."""
    if getattr(point_fn, "device_point_fn", None) in DEVICE_POINT_FNS:
        return None
    source = getattr(point_fn, "device_point_source", None)
    return source if isinstance(source, str) else None


def device_point_fn_id(point_fn: Callable) -> int:
    """The CUDA kernel's id for ``point_fn``: its tag's, or
    ``_build.USER_POINT_FN`` for one with CUDA source; raises for one
    with neither."""
    tag = getattr(point_fn, "device_point_fn", None)
    if tag in DEVICE_POINT_FNS:
        return DEVICE_POINT_FNS[tag]
    if user_point_source(point_fn) is not None:
        return _build.USER_POINT_FN
    raise NotImplementedError(
        f"point_fn {getattr(point_fn, '__name__', point_fn)!r} has no "
        f"CUDA counterpart (device_point_fn tag {tag!r}; the kernel "
        f"knows {sorted(DEVICE_POINT_FNS)}, or give its CUDA source with "
        "cuda_point_fn)"
    )


def device_point_fn(point_fn: Callable, nwin: int) -> tuple[int, dict | None]:
    """``(id, libraries)`` a launch of ``point_fn`` over ``nwin`` windows
    takes: a user point function's own build (made on first use; a plan
    makes it at Create), else None for the library's own."""
    fn_id = device_point_fn_id(point_fn)
    if fn_id != _build.USER_POINT_FN:
        return fn_id, None
    return fn_id, _build.point_fn_build(user_point_source(point_fn),
                                        nwin)["libs"]


def coeffs_shape(fn_id: int, n_sten: int, coeffs: torch.Tensor) -> tuple:
    """The coefficient vector a launch takes: one a window for the
    library's point functions, any length for a user's."""
    return (coeffs.numel(),) if fn_id == _build.USER_POINT_FN else (n_sten,)


def stencil2d_cuda(
    data: torch.Tensor,
    coeffs: torch.Tensor,
    out_init: torch.Tensor | None = None,
    *,
    point_fn: Callable = weighted_point_fn,
    left: int = 0,
    right: int = 0,
    top: int = 0,
    bottom: int = 0,
    bc: str = "periodic",
    rows: tuple[int, int] | None = None,
    out: torch.Tensor | None = None,
    taps: Taps | None = None,
    geometry: dict | None = None,
) -> torch.Tensor:
    """Launch the 2D stencil kernel on a contiguous (ny, nx) CUDA field, or
    on a contiguous stack (B, ny, nx) of them in one launch (each member as
    a single-field launch computes it, bit for bit; ``out_init`` is then a
    stack too).

    ``rows=(r0, r1)`` computes only those output rows (their halo comes
    from the whole field) into ``out``, which is then required; the
    streamed apply issues one such launch per row chunk.  ``taps`` are the
    plan's non-zero taps (``taps.nonzero_taps`` at Create), which a
    weighted or cube launch sums; without them it sums every window, its
    coefficient read from ``coeffs`` on the card.  A user's point function
    takes every window.  ``geometry`` (``{'route': ...}``, a tuned plan's)
    overrides the computed route (:func:`stencil2d_geometry`)."""
    if bc not in ("periodic", "np"):
        raise ValueError(f"bc must be 'periodic' or 'np', got {bc!r}")
    if min(left, right, top, bottom) < 0:
        raise ValueError("stencil extents must be >= 0")
    if data.ndim not in (2, 3):
        raise ValueError(
            f"data must be an (ny, nx) field or a (B, ny, nx) stack, got "
            f"shape {tuple(data.shape)}")
    *stack, ny, nx = data.shape
    nb = stack[0] if stack else 1
    if nb < 1:
        raise ValueError("a stack holds at least one field")
    n_sten = (left + right + 1) * (top + bottom + 1)
    fn_id, libs = device_point_fn(point_fn, n_sten)
    _build.check_cuda(data, "data", like=data, shape=data.shape)
    _build.check_cuda(coeffs, "coeffs", like=data,
                      shape=coeffs_shape(fn_id, n_sten, coeffs))
    if bc == "periodic":
        out_init = None  # every cell is computed, as in the plain version
    elif out_init is not None:
        _build.check_cuda(out_init, "out_init", like=data, shape=data.shape)
    if fn_id == _build.USER_POINT_FN:
        taps = None
    r0, r1 = _build.window(rows, ny, "row", out)
    out = _build.out_like(out, data)
    smem, sms = _build.device_info(data.device)
    geo = stencil2d_geometry((ny, nx), (left, right, top, bottom),
                             data.element_size(), smem, sms, nb,
                             route=(geometry or {}).get("route"))
    _build.launch(
        "stencil2d", data.device, _build.dtype_code(data), fn_id,
        int(bc == "periodic"), _build.ptr(data), _build.ptr(coeffs),
        _build.ptr(out_init), _build.ptr(out), nb, ny, nx, r0, r1, left, right,
        top, bottom, geo.smem,
        *c_taps(taps, halos_2d(left, right, top, bottom)), libs=libs,
    )
    return out
