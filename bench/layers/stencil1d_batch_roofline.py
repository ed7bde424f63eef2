"""``stencil1d_batch``'s share of its roofline (``_roofline``)."""

from bench.layers._roofline import reader

read = reader("stencil1d_batch")
