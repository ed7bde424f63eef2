"""``stencil2d`` (``kernels/csrc/stencil2d.cu``): a periodic 2D stencil or
point function over an ``(ny, nx)`` field."""

from bench.ops._stencil import count as _count

PATTERN = r"\bstencil2d_(tile|direct)_kernel\b"


def count(ny: int, nx: int, itemsize: int, taps: int, point: str = "weighted"):
    return _count(ny * nx, taps, itemsize, point)
