"""``ch_rhs_xsweep``'s share of its roofline (``_roofline``)."""

from bench.layers._roofline import reader

read = reader("ch_rhs_xsweep")
