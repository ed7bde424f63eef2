"""``penta_cols`` (``kernels/csrc/penta.cu``): a cyclic banded solve along
axis 0 of an ``(m, n)`` field, ``n`` systems of length ``m`` (the 2D
y-sweep, the 3D z-sweep on the ``(nz, ny * nx)`` view)."""

from bench.ops._banded import count as _count

PATTERN = r"\bpenta_cols_(tile|global)_kernel\b"


def count(m: int, n: int, itemsize: int, band: int = 2):
    return _count(m, n, itemsize, band)
