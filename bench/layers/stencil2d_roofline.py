"""``stencil2d``'s share of its roofline (``_roofline``)."""

from bench.layers._roofline import reader

read = reader("stencil2d")
