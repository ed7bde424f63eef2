"""3D box stencil: CUDA kernel wrapper and plain version (counterpart of
``repro.kernels.stencil3d``, the paper's §VI.A extension).

The kernel (``csrc/stencil3d.cu``) takes any ``(nz, ny, nx)`` extent and
any halos ``(front, back, top, bottom, left, right)``: each thread wraps
(periodic) or masks (``np``) its own indices, so none of the reference's
tile rules or alignment-padded dispatch apply.  Point functions are
selected by their ``device_point_fn`` tag, as for the 2D stencil.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import stencil3d_ref, weighted_point_fn
from repro_torch.kernels.stencil2d import device_point_fn_id

# the plain version: the semantic definition in kernels/ref.py
stencil3d_torch = stencil3d_ref


def stencil3d_cuda(
    data: torch.Tensor,
    coeffs: torch.Tensor,
    out_init: torch.Tensor | None = None,
    *,
    point_fn: Callable = weighted_point_fn,
    halos=(0, 0, 0, 0, 0, 0),
    bc: str = "periodic",
) -> torch.Tensor:
    """Launch the 3D stencil kernel on a contiguous (nz, ny, nx) CUDA field."""
    if bc not in ("periodic", "np"):
        raise ValueError(f"bc must be 'periodic' or 'np', got {bc!r}")
    halos = tuple(int(h) for h in halos)
    if len(halos) != 6 or min(halos) < 0:
        raise ValueError(f"halos must be six extents >= 0, got {halos}")
    fr, bk, tp, bt, lf, rt = halos
    if data.ndim != 3:
        raise ValueError(f"data must be (nz, ny, nx), got shape {tuple(data.shape)}")
    shape = tuple(data.shape)
    fn_id = device_point_fn_id(point_fn)
    _build.check_cuda(data, "data", like=data, shape=shape)
    n_sten = (fr + bk + 1) * (tp + bt + 1) * (lf + rt + 1)
    _build.check_cuda(coeffs, "coeffs", like=data, shape=(n_sten,))
    if bc == "periodic":
        out_init = None  # every cell is computed, as in the plain version
    elif out_init is not None:
        _build.check_cuda(out_init, "out_init", like=data, shape=shape)
    out = torch.empty_like(data)
    _build.launch(
        "stencil3d", data.device, _build.dtype_code(data), fn_id,
        int(bc == "periodic"), _build.ptr(data), _build.ptr(coeffs),
        _build.ptr(out_init), _build.ptr(out), *shape, *halos,
    )
    return out
