"""3D box stencil: CUDA kernel wrapper and plain version (counterpart of
``repro.kernels.stencil3d``, the paper's §VI.A extension).

The kernel (``csrc/stencil3d.cu``) takes any ``(nz, ny, nx)`` extent and
any halos ``(front, back, top, bottom, left, right)``.  A block owns a
32 x 32 (x, y) tile and marches along z through a ring of planes in
shared memory (:func:`stencil3d_geometry`); halos too wide for the ring
take a direct route, one point a thread.  A weighted or cube plan is
reduced at Create to its non-zero taps
(:func:`repro_torch.kernels.taps.nonzero_taps`), which the kernel takes as
a launch parameter.  Point functions are selected by
their ``device_point_fn`` tag or run from their CUDA source, given or
translated from Python, as for the 2D stencil.  A launch may compute a window of planes ``[k0, k1)`` into a
given output, its halo planes read from the whole field: the z-slabs of
:func:`repro_torch.launch.stream.stream_stencil3d_apply`.
"""

from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.penta import resident_blocks
from repro_torch.kernels.ref import stencil3d_ref, weighted_point_fn
from repro_torch.kernels.stencil2d import coeffs_shape, device_point_fn
from repro_torch.kernels.taps import Taps, c_taps
from repro_torch.util import ceil_div

# the plain version: the semantic definition in kernels/ref.py
stencil3d_torch = stencil3d_ref

# csrc/stencil3d.cu: the tile a block owns and the planes its ring loads
# ahead of the one computed
TILE_X, TILE_Y = 32, 32
AHEAD = 2
# the grid's y and z dimensions hold at most this many blocks
GRID_YZ_MAX = 65535
# resident grids' worth of blocks the z chunks aim for (1, 2 and 4 timed
# at 256^3 in PERF.md: 2 is fastest)
WAVES = 2


class Stencil3DGeometry(NamedTuple):
    """Launch geometry of the 3D stencil."""

    route: str  # "tile" (a ring of planes in shared memory) or "direct"
    zc: int  # planes a block marches over; 0 on the direct route
    grid: tuple[int, int]  # (x, y) tiles in grid.x; z chunks or planes
    smem: int  # dynamic shared memory a block, bytes


def stencil3d_geometry(shape, halos, itemsize: int, smem_optin: int,
                       n_sms: int, planes: int | None = None,
                       route: str | None = None, zc: int | None = None,
                       waves: int = WAVES) -> Stencil3DGeometry:
    """Geometry of the 3D stencil on an ``(nz, ny, nx)`` field, over
    ``planes`` of its planes (all nz by default: a z window's depth).

    The tile route when the ring (fr + bk + 3 slots, each the tile and its
    halo: (32 + tp + bt) x (32 + lf + rt) elements) fits a block's shared
    memory; the z chunk zc is the largest that still gives ``waves``
    resident grids' worth of blocks.  Else the direct route.  The route
    depends on the halos and the dtype alone, so a window's points are
    computed as the whole field's.  The (x, y) tiles share grid.x (up to
    2^31 - 1 blocks), so any ny fits; grid.y holds the z chunks (the direct
    route: planes, looping past :data:`GRID_YZ_MAX`).

    ``route``/``zc`` (a tuned plan's geometry,
    :func:`stencil3d_geometries`) force ``'direct'``, or ``'tile'`` with
    ``zc`` planes a block (clipped to the window's depth): every route and
    chunk sums a point's taps by the same template code in the same order,
    so the choice changes no result.  A tile ring that does not fit, or
    chunks past grid.y's limit, raise ``ValueError`` here, before any
    launch."""
    _, ny, nx = shape
    nz = shape[0] if planes is None else planes
    fr, bk, tp, bt, lf, rt = halos
    smem = ((fr + bk + 1 + AHEAD) * (TILE_Y + tp + bt) * (TILE_X + lf + rt)
            * itemsize)
    if route not in (None, "tile", "direct"):
        raise ValueError(f"stencil3d route must be 'tile' or 'direct', got "
                         f"{route!r}")
    if route == "tile":
        if smem > smem_optin:
            raise ValueError(
                f"the stencil3d tile route needs {smem} bytes of shared "
                f"memory a block for halos {tuple(halos)}, more than the "
                f"card's {smem_optin}")
        if zc is None or zc < 1 or ceil_div(nz, min(zc, nz)) > GRID_YZ_MAX:
            raise ValueError(
                f"the stencil3d tile route takes chunks of at least one "
                f"plane and at most {GRID_YZ_MAX} of them (zc {zc!r}, nz "
                f"{nz})")
    if route == "direct" or smem > smem_optin:  # csrc/stencil3d.cu:launch
        return Stencil3DGeometry(
            "direct", 0, (ceil_div(nx, TILE_X) * ceil_div(ny, 8),
                          min(nz, GRID_YZ_MAX)), 0)
    tiles = ceil_div(nx, TILE_X) * ceil_div(ny, TILE_Y)
    if route is None:
        per_sm = resident_blocks(smem, smem_optin)
        chunks = min(nz, GRID_YZ_MAX,
                     max(1, ceil_div(waves * per_sm * n_sms, tiles)))
        zc = ceil_div(nz, chunks)
    zc = min(zc, nz)
    return Stencil3DGeometry("tile", zc, (tiles, ceil_div(nz, zc)), smem)


def stencil3d_geometries(shape, halos, itemsize: int, smem_optin: int,
                         n_sms: int) -> list[dict]:
    """The launch geometries a tuned 3D plan races besides its default one
    (:func:`stencil3d_geometry`): the z chunks sized for 1 and 4 resident
    grids' worth of blocks (the default sizes for ``WAVES`` = 2), where
    they differ from the default's, and the direct route.  None where the
    default is already the direct route."""
    geo = stencil3d_geometry(shape, halos, itemsize, smem_optin, n_sms)
    if geo.route != "tile":
        return []
    out = []
    for waves in (1, 4):
        zc = stencil3d_geometry(shape, halos, itemsize, smem_optin, n_sms,
                                waves=waves).zc
        if zc != geo.zc and {"route": "tile", "zc": zc} not in out:
            out.append({"route": "tile", "zc": zc})
    return out + [{"route": "direct"}]


def stencil3d_cuda(
    data: torch.Tensor,
    coeffs: torch.Tensor,
    out_init: torch.Tensor | None = None,
    *,
    point_fn: Callable = weighted_point_fn,
    halos=(0, 0, 0, 0, 0, 0),
    bc: str = "periodic",
    taps: Taps | None = None,
    planes: tuple[int, int] | None = None,
    out: torch.Tensor | None = None,
    geometry: dict | None = None,
) -> torch.Tensor:
    """Launch the 3D stencil kernel on a contiguous (nz, ny, nx) CUDA field.

    ``taps`` are the plan's non-zero taps (``taps.nonzero_taps`` at
    Create), which a weighted or cube launch sums; without them it sums
    every window, its coefficient read from ``coeffs`` on the card.  A
    user's point function takes every window.  ``planes=(k0, k1)``
    computes only those planes into ``out``.  ``geometry``
    (``{'route': ..., 'zc': ...}``, a tuned plan's) overrides the computed
    geometry (:func:`stencil3d_geometry`)."""
    if bc not in ("periodic", "np"):
        raise ValueError(f"bc must be 'periodic' or 'np', got {bc!r}")
    halos = tuple(int(h) for h in halos)
    if len(halos) != 6 or min(halos) < 0:
        raise ValueError(f"halos must be six extents >= 0, got {halos}")
    fr, bk, tp, bt, lf, rt = halos
    if data.ndim != 3:
        raise ValueError(f"data must be (nz, ny, nx), got shape {tuple(data.shape)}")
    shape = tuple(data.shape)
    n_sten = (fr + bk + 1) * (tp + bt + 1) * (lf + rt + 1)
    fn_id, libs = device_point_fn(point_fn, n_sten, coeffs.numel())
    _build.check_cuda(data, "data", like=data, shape=shape)
    _build.check_cuda(coeffs, "coeffs", like=data,
                      shape=coeffs_shape(fn_id, n_sten, coeffs))
    if bc == "periodic":
        out_init = None  # every cell is computed, as in the plain version
    elif out_init is not None:
        _build.check_cuda(out_init, "out_init", like=data, shape=shape)
    if fn_id == _build.USER_POINT_FN:
        taps = None
    k0, k1 = _build.window(planes, shape[0], "plane", out)
    smem, sms = _build.device_info(data.device)
    over = geometry or {}
    geo = stencil3d_geometry(shape, halos, data.element_size(), smem, sms,
                             planes=k1 - k0, route=over.get("route"),
                             zc=over.get("zc"))
    out = _build.out_like(out, data)
    _build.launch(
        "stencil3d", data.device, _build.dtype_code(data), fn_id,
        int(bc == "periodic"), _build.ptr(data), _build.ptr(coeffs),
        _build.ptr(out_init), _build.ptr(out), *shape, *halos, k0, k1,
        geo.zc, geo.smem, *c_taps(taps, halos), libs=libs,
    )
    return out
