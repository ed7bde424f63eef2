"""The count shared by the stencil kernels: one output point from ``taps``
input windows, each input point read once and each output point written
once, and the ``taps`` weights read once.

Operations a point: a weighted stencil ``taps`` products and ``taps - 1``
sums; the point function ``sum_i w_i (c_i^3 - c_i)`` (the paper's function
pointer, the Laplacian of C^3 - C) ``4 taps`` (two products, a
difference, the weight) and ``taps - 1`` sums.
"""

PER_TAP = {"weighted": 2, "cube": 5}


def count(points: int, taps: int, itemsize: int, point: str):
    nbytes = (2 * points + taps) * itemsize
    flops = (PER_TAP[point] * taps - 1) * points
    return nbytes, flops
