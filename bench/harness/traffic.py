"""The one generator of every cell's inputs, from the parameters of its
traffic (``bench/workloads/<cell>.json``) and the run's ``--seed``.

A cell is a closed loop of one solver process: the inputs are the initial
field and the chunk of the window whose answer is compared with the
reference.  The same seed gives the same inputs; every seed gives the same
work (the grid, the steps and the chunks do not depend on it).
"""

from __future__ import annotations

import numpy as np
import torch

_U64 = 1 << 64


def _seed(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % _U64, stream])


def checked_chunk(seed: int, first: int) -> int:
    """The chunk of the window whose state is kept for the comparison: one
    of the window's first ``first`` chunks, drawn from the seed."""
    return int(_seed(seed, 1).integers(0, first))


def initial_field(spec: dict, shape, seed: int, dtype, device) -> torch.Tensor:
    """The initial field of kind ``spec['kind']``:

    - ``band_limited_quench``: the paper's deep quench (uniform values in
      ``[-amp, amp]``, its Fig. 1 initial condition) drawn on a ``modes``
      x ``modes`` grid and carried onto the 2D grid with its spectrum
      zero-padded.  White noise at the grid's own scale overflows in the
      eq. 3 bootstrap step (its explicit delta_y^4 grows a k_x = 0 mode by
      up to 1 + 16 beta_half before the y-solve divides it back);
      a field without grid-scale modes stays in the paper's regime;
    - ``uniform``: independent uniform values in ``[low, high)``, drawn on
      the device.
    """
    kind = spec["kind"]
    if kind == "band_limited_quench":
        ny, nx = shape
        m, amp = int(spec["modes"]), float(spec["amp"])
        if ny != nx or m > ny:
            raise ValueError(f"band_limited_quench wants a square grid of at "
                             f"least {m} points, got {shape}")
        coarse = torch.as_tensor(_seed(seed, 0).uniform(-amp, amp, (m, m)),
                                 dtype=torch.float64, device=device)
        spec_c = torch.fft.rfft2(coarse)
        big = torch.zeros((ny, nx // 2 + 1), dtype=spec_c.dtype, device=device)
        h = m // 2
        big[:h, : h + 1] = spec_c[:h, : h + 1]
        big[-h:, : h + 1] = spec_c[-h:, : h + 1]
        field = torch.fft.irfft2(big, s=(ny, nx)) * (ny * nx) / (m * m)
        return field.to(dtype)
    if kind == "uniform":
        lo, hi = float(spec["low"]), float(spec["high"])
        gen = torch.Generator(device=device)
        gen.manual_seed(seed % _U64)
        field = torch.rand(tuple(shape), generator=gen, dtype=dtype,
                           device=device)
        return field.mul_(hi - lo).add_(lo)
    raise ValueError(f"unknown initial field kind {kind!r}")
