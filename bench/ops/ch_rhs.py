"""``ch_rhs`` (``kernels/csrc/fused_ch.cu``): the Cahn–Hilliard right-hand
side of eq. 2 alone, over an ``(ny, nx)`` grid (the distributed step runs
it on each rank's block of C^n and C^{n-1} padded by its halo of 2, so
``ny`` and ``nx`` are the padded extents it is launched at).

Bytes: C^n and C^{n-1} read once, the RHS written once.  Operations a
point: Cbar 2, the linear term 2, the 13-tap biharmonic 25, C^3 - C 3, its
5-tap Laplacian 9, two scales and two sums 4 (45, as ``ch_rhs_xsweep``'s
RHS)."""

PATTERN = r"\bch_rhs_tile_kernel\b"

RHS_FLOPS = 45


def count(ny: int, nx: int, itemsize: int):
    points = ny * nx
    return 3 * points * itemsize, RHS_FLOPS * points
