"""``penta_mid`` (``kernels/csrc/penta.cu``): a cyclic banded solve along
the middle axis of a ``(p, m, q)`` field, ``p * q`` systems of length
``m`` (the 3D y-sweep)."""

from bench.ops._banded import count as _count

PATTERN = r"\bpenta_mid_(tile|global)_kernel\b"


def count(p: int, m: int, q: int, itemsize: int, band: int = 2):
    return _count(m, p * q, itemsize, band)
