"""The count shared by the three layouts of one operation: solving
systems of length ``m`` of a cyclic banded matrix of half bandwidth
``band`` (1: tridiagonal, 2: pentadiagonal) whose LU factors and periodic
closure are made once at Create.

Bytes: the right-hand sides read once and the solutions written once, and
the Create-time factors read once: ``2 band + 1`` band vectors of the LU
factors and the ``2 band`` columns of the closure, each of length ``m``.
Operations a point: forward substitution ``2 band + 1`` (``band``
products and differences, one product by the reciprocal pivot), backward
``2 band``, the rank-``2 band`` closure ``x -= W (V^T y)`` another
``2 * 2 band``; a system adds ``2 * 2 band`` for ``V^T y``.
"""


def count(m: int, systems: int, itemsize: int, band: int):
    points = m * systems
    nbytes = (2 * points + (4 * band + 1) * m) * itemsize
    flops = (8 * band + 1) * points + 4 * band * systems
    return nbytes, flops
