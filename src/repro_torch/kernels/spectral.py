"""Spectral (fft) execution backend — periodic stencils as symbol
multiplies (counterpart of ``repro.kernels.spectral``).

Under periodic boundaries a stencil apply is a circular convolution, so it
diagonalises in Fourier space: Compute becomes
``irfftn(rfftn(field) * symbol)``, where the symbol (the DFT of the wrapped
stencil kernel) is computed once at Create from the plan's weights.  The
cyclic constant-band pentadiagonal operator of an ADI sweep is a
circulant, so its solve is a divide by the band symbol: no recurrence, no
Woodbury closure.

The transforms are ``torch.fft`` (cuFFT on a CUDA tensor), as the
reference's are ``jnp.fft``: no hand-written kernel lies on this path, and
none of the reference's Pallas kernels computes it.

Symbols are computed on the host with numpy in float64 and committed to
the plan's device at the complex counterpart of the plan dtype.  Every
function here preserves the field's dtype: a float32 field is transformed
at complex64, and a complex128 symbol is narrowed to match it rather than
widening the pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels._build import PLAN_BACKENDS
from repro_torch.util import resolve_device, torch_dtype

__all__ = [
    "SpectralBackendError",
    "apply_symbol",
    "band_symbol",
    "solve_symbol_axis",
    "stencil_symbol",
]

# what a Create may ask for; SpectralBackendError lists these verbatim
SUPPORTED_BACKENDS = PLAN_BACKENDS


class SpectralBackendError(ValueError):
    """A Create asked the fft backend for something it cannot do.

    Raised at Create, never from a Compute, when ``backend='fft'`` meets a
    configuration the spectral path does not support: non-periodic
    boundaries (``bc='np'``), a non-cyclic ADI operator, a function-pointer
    stencil, or a missing ``shape=`` (the symbol is computed for one field
    shape).  The message names the supported backends."""

    def __init__(self, reason: str):
        super().__init__(
            f"backend='fft' unsupported here: {reason} "
            f"(supported backends: {', '.join(SUPPORTED_BACKENDS)}; the "
            "fft path needs periodic/cyclic boundaries, explicit weights "
            "and a Create-time shape)"
        )


def complex_dtype_for(real_dtype) -> torch.dtype:
    """The complex counterpart of a real floating dtype (float64 ->
    complex128, narrower floats -> complex64): the dtype a field of
    ``real_dtype`` transforms to."""
    dt = torch_dtype(real_dtype)
    return torch.complex128 if dt == torch.float64 else torch.complex64


def _wrapped_kernel(weights: np.ndarray, los, shape) -> np.ndarray:
    """Scatter stencil weights onto a zero field as a circular-convolution
    kernel: the direct apply is ``sum_w w[idx] * roll(data, lo - offset)``,
    i.e. the kernel ``k[(lo - offset) % n] += w`` per axis.  ``np.add.at``
    sums the taps that wrap onto one point (a stencil wider than the
    domain) instead of overwriting them."""
    kern = np.zeros(shape, np.float64)
    idx = np.meshgrid(
        *[(lo - np.arange(s)) % n for lo, s, n in zip(los, weights.shape, shape)],
        indexing="ij",
    )
    np.add.at(kern, tuple(i.ravel() for i in idx), weights.ravel())
    return kern


def _host64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float64)


def _dtype_of(a):
    return a.dtype if isinstance(a, torch.Tensor) else np.asarray(a).dtype


def stencil_symbol(weights, los, shape, dtype=None, *, device="cuda") -> torch.Tensor:
    """Fourier symbol of a periodic stencil apply on a ``shape`` field.

    ``weights`` is the 1D/2D/3D stencil box, ``los`` the low halo extent per
    axis (``(top, left)`` in 2D, ``(left,)`` for a line, ``(front, top,
    left)`` in 3D), ``shape`` the transformed extents.  Returns the
    ``rfftn`` of the wrapped kernel, shape ``(*shape[:-1], shape[-1]//2 +
    1)``, on ``device`` at the complex counterpart of ``dtype`` (default:
    the weights' dtype)."""
    w = _host64(weights)
    shape = tuple(int(s) for s in shape)
    if w.ndim != len(shape) or w.ndim != len(los):
        raise ValueError(
            f"stencil_symbol: weights rank {w.ndim} vs axes "
            f"{len(shape)}/{len(los)}"
        )
    sym = np.fft.rfftn(_wrapped_kernel(w, los, shape))
    out_dtype = complex_dtype_for(_dtype_of(weights) if dtype is None else dtype)
    return torch.as_tensor(sym).to(device=resolve_device(device), dtype=out_dtype)


def band_symbol(l2, l1, d, u1, u2, dtype=None, *, device="cuda") -> torch.Tensor:
    """Eigenvalues (on rfft frequencies) of the cyclic constant-band
    pentadiagonal operator given by five length-``M`` diagonals (the
    :mod:`repro_torch.kernels.penta` convention).  The constant cyclic band
    is a circulant, whose eigenvalues are the DFT of its first column, so
    the whole factor-and-substitute + Woodbury solve becomes a pointwise
    divide by this symbol (:func:`solve_symbol_axis`).  Wrap-around
    collisions on tiny systems sum."""
    bands = [_host64(b) for b in (d, l1, l2, u1, u2)]
    M = bands[0].shape[0]
    col = np.zeros(M, np.float64)
    for band, off in zip(bands, (0, 1, 2, -1, -2)):
        col[off % M] += band[off % M]
    sym = np.fft.rfft(col)
    out_dtype = complex_dtype_for(_dtype_of(d) if dtype is None else dtype)
    return torch.as_tensor(sym).to(device=resolve_device(device), dtype=out_dtype)


def _cast_symbol(symbol: torch.Tensor, field_dtype) -> torch.Tensor:
    """The symbol at the complex counterpart of the field dtype: a
    complex128 symbol is narrowed for a float32 field rather than letting
    promotion widen the whole pipeline (and its output) to 64 bits."""
    return symbol.to(complex_dtype_for(field_dtype))


def _in_layout_of(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``out`` in ``like``'s memory layout, as the kernels return theirs: a
    contiguous field gives a contiguous result (an inverse transform along
    a leading axis returns a strided one), a transposed view its
    transpose."""
    if out.stride() == like.stride():
        return out
    return torch.empty_like(like).copy_(out)


def apply_symbol(data: torch.Tensor, symbol: torch.Tensor, axes) -> torch.Tensor:
    """The spectral Compute: ``irfftn(rfftn(data) * symbol)`` over ``axes``
    (the trailing axes; leading axes are batch).  The inverse lengths are
    pinned to ``data``'s so odd and prime extents round-trip."""
    axes = tuple(axes)
    lengths = [data.shape[a] for a in axes]
    f = torch.fft.rfftn(data, dim=axes)
    out = torch.fft.irfftn(f * _cast_symbol(symbol, data.dtype), s=lengths,
                           dim=axes)
    return _in_layout_of(out, data)


def solve_symbol_axis(rhs: torch.Tensor, symbol: torch.Tensor, axis: int) -> torch.Tensor:
    """The spectral ADI sweep: solve the cyclic banded system along one
    axis as a pointwise divide by the band symbol; every other axis is
    batch."""
    n = rhs.shape[axis]
    sym = _cast_symbol(symbol, rhs.dtype)
    shape = [1] * rhs.ndim
    shape[axis] = sym.shape[0]
    f = torch.fft.rfft(rhs, dim=axis)
    return _in_layout_of(torch.fft.irfft(f / sym.reshape(shape), n=n, dim=axis),
                         rhs)
