"""``stencil1d_batch`` (``kernels/csrc/stencil1d_batch.cu``): a periodic 1D
stencil or point function along each of ``b`` lines of length ``m`` (along
x the rows, along y the strided columns)."""

from bench.ops._stencil import count as _count

PATTERN = r"\bbatch_(x|y|direct)_kernel\b"


def count(b: int, m: int, itemsize: int, taps: int, point: str = "weighted"):
    return _count(b * m, taps, itemsize, point)
