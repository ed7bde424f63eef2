"""Batched-1D stencil: CUDA kernel wrapper and plain version (counterpart of
``repro.kernels.stencil1d_batch``, cuSten's 1DBatch family).

The kernel (``csrc/stencil1d_batch.cu``) applies one 1D stencil along axis 1
of a ``(B, M)`` stack, any ``B`` and ``M`` and any halo: each thread wraps
(periodic) or masks (``np``) its own index.  The stack may be a contiguous
``(B, M)`` tensor or the transpose of a contiguous ``(M, B)`` one: the
kernel takes the line and element strides, so the y direction of a 2D
field (``field.T``) is read in place with no transposed copy, and the
output has the input's layout.  Point functions are selected by their
``device_point_fn`` tag or run from their CUDA source, as for the 2D
stencil.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import stencil1d_batch_ref, weighted_point_fn
from repro_torch.kernels.stencil2d import coeffs_shape, device_point_fn

# the plain version: the semantic definition in kernels/ref.py
stencil1d_batch_torch = stencil1d_batch_ref


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
) -> torch.Tensor:
    """Launch the batched-1D stencil kernel on a (B, M) CUDA stack that is
    contiguous or the transpose of a contiguous tensor; the result has the
    same layout.

    ``lines=(b0, b1)`` computes only those lines into ``out`` (in data's
    layout), which is then required; the streamed apply issues one such
    launch per line chunk."""
    if bc not in ("periodic", "np"):
        raise ValueError(f"bc must be 'periodic' or 'np', got {bc!r}")
    if min(left, right) < 0:
        raise ValueError("stencil extents must be >= 0")
    B, M = data.shape
    fn_id, libs = device_point_fn(point_fn, left + right + 1)
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
    _build.launch(
        "stencil1d_batch", data.device, _build.dtype_code(data), fn_id,
        int(bc == "periodic"), _build.ptr(data), _build.ptr(coeffs),
        _build.ptr(out_init), _build.ptr(out), B, M, line_stride,
        elem_stride, b0, b1, left, right, libs=libs,
    )
    return out
