"""``ch_rhs``' share of its roofline (``_roofline``), at the padded block
the distributed step launches it on."""

from bench.layers._roofline import reader

read = reader("ch_rhs")
