"""``ch_rhs_xsweep`` (``kernels/csrc/fused_ch.cu``): the Cahn–Hilliard
right-hand side of eq. 2 and the cyclic pentadiagonal x-solve of it, over
an ``(ny, nx)`` grid.

Bytes: C^n and C^{n-1} read once, w written once, the x-band's factors
(``_banded``) read once.  Operations a point: Cbar 2, the linear term 2,
the 13-tap biharmonic 25, C^3 - C 3, its 5-tap Laplacian 9, two scales and
two sums 4 (45), then the solve (``_banded``, half bandwidth 2)."""

from bench.ops._banded import count as _solve

PATTERN = r"\bch_rhs_xsweep(_global)?_kernel\b"

RHS_FLOPS = 45


def count(ny: int, nx: int, itemsize: int):
    solve_bytes, solve_flops = _solve(nx, ny, itemsize, 2)
    points = ny * nx
    return solve_bytes + points * itemsize, solve_flops + RHS_FLOPS * points
