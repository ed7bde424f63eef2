"""``penta_cols``'s share of its roofline (``_roofline``)."""

from bench.layers._roofline import reader

read = reader("penta_cols")
