"""``penta_rows`` (``kernels/csrc/penta.cu``): a cyclic banded solve along
the contiguous axis of an ``(n, m)`` field, ``n`` systems of length ``m``
(the 2D x-sweep, the 3D x-sweep on the ``(nz * ny, nx)`` view)."""

from bench.ops._banded import count as _count

PATTERN = r"\bpenta_rows_(tile|global)_kernel\b"


def count(m: int, n: int, itemsize: int, band: int = 2):
    return _count(m, n, itemsize, band)
