"""Generic 2D stencil: CUDA kernel wrapper and plain version (counterpart of
``repro.kernels.stencil2d``).

The kernel (``csrc/stencil2d.cu``) takes any extent and any halo: each
thread wraps (periodic) or masks (``np``) its own indices, so none of the
reference's tile-divisibility rules or padded dispatch apply.  The
function-pointer mode is a compile-time set of device point functions; a
Python ``point_fn`` names its device counterpart with a
``device_point_fn`` tag (see :data:`DEVICE_POINT_FNS`).
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import stencil2d_ref, weighted_point_fn

# device point-function tag -> the kernel's point-function id
DEVICE_POINT_FNS = {"weighted": 0, "cube_laplacian": 1}

# the plain version: the semantic definition in kernels/ref.py
stencil2d_torch = stencil2d_ref


def device_point_fn_id(point_fn: Callable) -> int:
    """The CUDA kernel's id for ``point_fn``; raises for an untagged one."""
    tag = getattr(point_fn, "device_point_fn", None)
    if tag not in DEVICE_POINT_FNS:
        raise NotImplementedError(
            f"point_fn {getattr(point_fn, '__name__', point_fn)!r} has no "
            f"CUDA counterpart (device_point_fn tag {tag!r}; the kernel "
            f"knows {sorted(DEVICE_POINT_FNS)})"
        )
    return DEVICE_POINT_FNS[tag]


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
) -> torch.Tensor:
    """Launch the 2D stencil kernel on a contiguous (ny, nx) CUDA field."""
    if bc not in ("periodic", "np"):
        raise ValueError(f"bc must be 'periodic' or 'np', got {bc!r}")
    if min(left, right, top, bottom) < 0:
        raise ValueError("stencil extents must be >= 0")
    ny, nx = data.shape
    fn_id = device_point_fn_id(point_fn)
    _build.check_cuda(data, "data", like=data, shape=(ny, nx))
    n_sten = (left + right + 1) * (top + bottom + 1)
    _build.check_cuda(coeffs, "coeffs", like=data, shape=(n_sten,))
    if bc == "periodic":
        out_init = None  # every cell is computed, as in the plain version
    elif out_init is not None:
        _build.check_cuda(out_init, "out_init", like=data, shape=(ny, nx))
    out = torch.empty_like(data)
    _build.launch(
        "stencil2d", data.device, _build.dtype_code(data), fn_id,
        int(bc == "periodic"), _build.ptr(data), _build.ptr(coeffs),
        _build.ptr(out_init), _build.ptr(out), ny, nx, left, right, top,
        bottom,
    )
    return out
