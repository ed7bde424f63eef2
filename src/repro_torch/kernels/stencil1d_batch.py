"""Batched-1D stencil: CUDA kernel wrapper and plain version (counterpart of
``repro.kernels.stencil1d_batch``, cuSten's 1DBatch family).

The kernel (``csrc/stencil1d_batch.cu``) applies one 1D stencil along axis 1
of a ``(B, M)`` stack, any ``B`` and ``M`` and any halo.  The stack may be
a contiguous ``(B, M)`` tensor or the transpose of a contiguous ``(M, B)``
one: the kernel takes the line and element strides, so the y direction of
a 2D field (``field.T``) is read in place with no transposed copy, and the
output has the input's layout.  Along x a block stages segments of lines
and their halos in shared memory (short lines several to a block); along
y each thread marches down one line holding its window in registers
(:func:`stencil1d_batch_geometry`).  A weighted or cube plan is reduced at
Create to its non-zero taps (:mod:`repro_torch.kernels.taps`).  Point
functions are selected by their ``device_point_fn`` tag or run from their
CUDA source, given or translated from Python, as for the 2D stencil.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import stencil1d_batch_ref, weighted_point_fn
from repro_torch.kernels.stencil2d import coeffs_shape, device_point_fn
from repro_torch.kernels.taps import Taps, c_taps, halos_1d
from repro_torch.util import ceil_div

# the plain version: the semantic definition in kernels/ref.py
stencil1d_batch_torch = stencil1d_batch_ref

# csrc/stencil1d_batch.cu: outputs a block along x (lines x segment), lines
# a block along y, the widest window the along-y route holds in registers
SEGMENT = 1024
LINES_Y = 128
MAX_MARCH = 9
# along y: resident grids' worth of blocks the chunks of m aim for, and
# the shortest chunk (its window's halo is loaded once a chunk)
WAVES = 2
MIN_CHUNK = 8
_ROUTES = {"direct": 0, "x": 1, "y": 2}


class Batch1DGeometry(NamedTuple):
    """Launch geometry of the batched-1D stencil on a whole stack."""

    route: str  # "x" (staged segments), "y" (register march) or "direct"
    param: int  # "x": log2 of the segment; "y": elements a chunk; else 0
    grid: int  # blocks (the direct route: grid.x times grid.y)
    smem: int  # dynamic shared memory a block, bytes


def stencil1d_batch_geometry(B: int, M: int, halos, lines_fast: bool,
                             itemsize: int, smem_optin: int, n_sms: int,
                             route: str | None = None,
                             param: int | None = None) -> Batch1DGeometry:
    """Geometry of the batched-1D stencil on a ``(B, M)`` stack with halos
    ``(left, right)``; ``lines_fast``: the transposed layout (line stride
    1).

    Along x, segments of ``sw`` elements (the power of two >= M, at most
    1024) of ``1024 / sw`` lines a block, staged with their halos in shared
    memory; along y, a thread a line marching over chunks of ``mc``
    elements, as many chunks as give ``WAVES`` resident grids' worth of
    blocks (at least ``MIN_CHUNK`` elements each) for windows of at most
    ``MAX_MARCH``.  Else the direct route, one thread an element.  It
    depends on B, M, the halos, the layout and the itemsize alone, never on
    a launch's line window.

    ``route='y'`` with ``param`` (a tuned plan's geometry,
    :func:`stencil1d_batch_geometries`) forces the elements a chunk along
    y; one the card cannot launch for this stack and layout raises
    ``ValueError`` here, before any launch."""
    left, right = (int(h) for h in halos)
    if route not in (None, "y"):
        raise ValueError(f"a tuned stencil1d_batch geometry takes the 'y' "
                         f"route, got {route!r}")
    if route == "y":
        if not lines_fast or param is None or param < 1 or (
                left + right + 1 > MAX_MARCH):
            raise ValueError(
                f"the stencil1d_batch 'y' route takes a transposed stack, a "
                f"window of at most {MAX_MARCH} and chunks of at least one "
                f"element (param {param!r})")
        return Batch1DGeometry("y", param, ceil_div(B, LINES_Y)
                               * ceil_div(M, param), 0)
    if not lines_fast:
        sw_log2 = min(SEGMENT.bit_length() - 1, max(0, (M - 1).bit_length()))
        nl = SEGMENT >> sw_log2
        smem = nl * ((1 << sw_log2) + left + right) * itemsize
        if smem <= smem_optin:
            return Batch1DGeometry("x", sw_log2, ceil_div(M, 1 << sw_log2)
                                   * ceil_div(B, nl), smem)
    elif left + right + 1 <= MAX_MARCH:
        nbb = ceil_div(B, LINES_Y)
        chunks = max(1, ceil_div(WAVES * (2048 // LINES_Y) * n_sms, nbb))
        mc = max(MIN_CHUNK, ceil_div(M, chunks))
        return Batch1DGeometry("y", mc, nbb * ceil_div(M, mc), 0)
    n_u, n_v = (B, M) if lines_fast else (M, B)
    return Batch1DGeometry("direct", 0,
                           ceil_div(n_u, 32) * min(ceil_div(n_v, 8), 65535), 0)


def stencil1d_batch_geometries(B: int, M: int, halos, itemsize: int,
                               smem_optin: int, n_sms: int) -> list[dict]:
    """The launch geometries a tuned batched-1D plan races besides its
    default one: on the transposed layout of its ``(B, M)`` stack (the
    lines of ``apply_along_y``), chunks of 2, 4 and 8 times the default's
    elements, where they divide M.

    A point's arithmetic must not change with the geometry.  Along y a
    thread marches its line in an unrolled-by-4 loop, so a chunk that is a
    multiple of 4 dividing M (the default's too) keeps every point in the
    same unrolled copy of the loop body.  Along x none qualifies: a thread
    computes four outputs, and a shorter segment or the direct route moves
    a point to another of the four, which ptxas may contract differently
    (results apart in the last bit on an H100), so the contiguous layout
    has no candidate."""
    geo = stencil1d_batch_geometry(B, M, halos, True, itemsize, smem_optin,
                                   n_sms)
    mc = geo.param
    if geo.route != "y" or mc % 4 or M % mc:
        return []
    return [{"route": "y", "param": k * mc} for k in (2, 4, 8)
            if k * mc <= M and M % (k * mc) == 0]


def _like(data: torch.Tensor, lines_contiguous: bool) -> torch.Tensor:
    """An empty tensor of ``data``'s shape in the layout the kernel writes:
    contiguous, or the transpose of a contiguous tensor."""
    B, M = data.shape
    if lines_contiguous:
        return torch.empty((B, M), dtype=data.dtype, device=data.device)
    return torch.empty((M, B), dtype=data.dtype, device=data.device).T


def in_layout(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` in ``like``'s layout (contiguous, or the transpose of a
    contiguous tensor), copied only when it is not."""
    rows = like.is_contiguous()
    if t.is_contiguous() if rows else t.T.is_contiguous():
        return t
    return _like(t, rows).copy_(t)


def stencil1d_batch_cuda(
    data: torch.Tensor,
    coeffs: torch.Tensor,
    out_init: torch.Tensor | None = None,
    *,
    point_fn: Callable = weighted_point_fn,
    left: int = 0,
    right: int = 0,
    bc: str = "periodic",
    lines: tuple[int, int] | None = None,
    out: torch.Tensor | None = None,
    taps: Taps | None = None,
    geometry: dict | None = None,
) -> torch.Tensor:
    """Launch the batched-1D stencil kernel on a (B, M) CUDA stack that is
    contiguous or the transpose of a contiguous tensor; the result has the
    same layout.

    ``lines=(b0, b1)`` computes only those lines into ``out`` (in data's
    layout), which is then required; the streamed apply issues one such
    launch per line chunk.  ``taps`` are the plan's non-zero taps, as for
    :func:`repro_torch.kernels.stencil2d.stencil2d_cuda`.  ``geometry``
    (``{'route': 'y', 'param': ...}``, a tuned plan's) overrides the
    computed geometry of a transposed stack, the layout it was tuned on; a
    contiguous stack keeps its computed geometry."""
    if bc not in ("periodic", "np"):
        raise ValueError(f"bc must be 'periodic' or 'np', got {bc!r}")
    if min(left, right) < 0:
        raise ValueError("stencil extents must be >= 0")
    B, M = data.shape
    fn_id, libs = device_point_fn(point_fn, left + right + 1,
                                  coeffs.numel())
    rows = data.is_contiguous()
    base = data if rows else data.T
    _build.check_cuda(base, "data (or its transpose)", like=data,
                      shape=base.shape)
    _build.check_cuda(coeffs, "coeffs", like=data,
                      shape=coeffs_shape(fn_id, left + right + 1, coeffs))
    if bc == "periodic":
        out_init = None  # every element is computed, as in the plain version
    elif out_init is not None:
        out_init = in_layout(out_init, data)
        _build.check_cuda(out_init if rows else out_init.T, "out_init",
                          like=data, shape=base.shape)
    b0, b1 = _build.window(lines, B, "line", out)
    if out is None:
        out = _like(data, rows)
    else:
        _build.check_cuda(out if rows else out.T, "out (or its transpose)",
                          like=data, shape=base.shape)
    line_stride, elem_stride = (M, 1) if rows else (1, B)
    if fn_id == _build.USER_POINT_FN:
        taps = None
    smem, sms = _build.device_info(data.device)
    lines_fast = line_stride == 1 and elem_stride != 1
    over = (geometry or {}) if lines_fast else {}
    geo = stencil1d_batch_geometry(B, M, (left, right), lines_fast,
                                   data.element_size(), smem, sms,
                                   route=over.get("route"),
                                   param=over.get("param"))
    _build.launch(
        "stencil1d_batch", data.device, _build.dtype_code(data), fn_id,
        int(bc == "periodic"), _build.ptr(data), _build.ptr(coeffs),
        _build.ptr(out_init), _build.ptr(out), B, M, line_stride,
        elem_stride, b0, b1, left, right, _ROUTES[geo.route], geo.param,
        geo.smem, *c_taps(taps, halos_1d(left, right)), libs=libs,
    )
    return out
