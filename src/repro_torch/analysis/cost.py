"""The analytic cost floors of each plan family (counterpart of the closed
forms of ``repro.analysis.cost``; its HLO parser has no counterpart here).

What the paper's roofline argument says one Compute *should* cost: the
flops it executes, the bytes it moves through memory and the memory it
holds live at peak.  A direct stencil apply reads one field and its halo
and writes one field, ``2*taps`` flops a point; an fft apply spends
``~10 n log2 n`` flops over a handful of field passes; a factored penta
solve O(1) flops a point.  :mod:`repro_torch.tune.prior` ranks the
autotuner's candidates with them.  The numbers are the reference's for the
same arguments (``tests/test_torch_cost.py`` holds them to 1e-12
relative), so ``expected_penta`` keeps the reference's six field passes a
sweep where the port's kernel moves two (PERF.md compares them with the
card's bounds).
"""

from __future__ import annotations

import dataclasses
import math

__all__ = [
    "Expected",
    "expected_ch_step",
    "expected_fft",
    "expected_penta",
    "expected_stencil",
]


@dataclasses.dataclass
class Expected:
    """The analytic floor for one Compute: what the paper's roofline
    argument says the kernel *should* cost."""

    flops: float
    bytes: float
    peak_memory: float
    # the analytic per-step traffic of one trip of the outermost loop;
    # 0 when the program has no loop floor
    step_bytes: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def expected_stencil(shape, taps: int, itemsize: int, *, halo: int = 0) -> Expected:
    """A direct stencil apply: read one field + halo, write one field;
    ``2*taps`` flops per point (multiply + accumulate per tap)."""
    n = 1
    for d in shape:
        n *= int(d)
    halo_pts = halo * (n // max(int(shape[-1]), 1)) * 2 if halo else 0
    bytes_ = (2 * n + halo_pts) * itemsize
    return Expected(
        flops=2.0 * taps * n,
        bytes=float(bytes_),
        peak_memory=float(3 * n * itemsize),  # in + out + one live temp
        step_bytes=float(bytes_),
    )


def expected_fft(shape, itemsize: int, *, transforms: int = 1) -> Expected:
    """A spectral apply: forward + inverse transform plus the symbol
    multiply — ``~2 * 5 n log2 n`` flops and a handful of field-sized
    passes (real field in/out, complex spectrum in/out, symbol read)."""
    n = 1
    for d in shape:
        n *= int(d)
    logn = max(math.log2(n), 1.0)
    flops = transforms * (2 * 5.0 * n * logn + 6.0 * n)
    # real in/out + complex intermediate (2x itemsize) passes + symbol
    bytes_ = transforms * (2 * n + 3 * 2 * n + 2 * n) * itemsize
    return Expected(
        flops=flops,
        bytes=float(bytes_),
        peak_memory=float(6 * n * itemsize),
        step_bytes=float(bytes_),
    )


def expected_penta(shape, itemsize: int, *, sweeps: int = 1) -> Expected:
    """A factored (cyclic) penta solve: forward + backward substitution
    (~2 FMAs each per unknown) plus the Woodbury closure (4 broadcast
    FMAs) — O(1) flops/point, ~constant field passes per sweep."""
    n = 1
    for d in shape:
        n *= int(d)
    per_pt_flops = 2 * (2 + 2) + 2 * 4  # substitutions + Woodbury FMAs
    # rhs read + solution write + factor rows + correction passes
    bytes_ = sweeps * 6 * n * itemsize
    return Expected(
        flops=float(sweeps * per_pt_flops * n),
        bytes=float(bytes_),
        peak_memory=float(4 * n * itemsize),
        step_bytes=float(bytes_ / max(sweeps, 1)),
    )


def expected_ch_step(shape, itemsize: int) -> Expected:
    """One fused Cahn–Hilliard ADI step: the explicit RHS (a ~25-tap
    biharmonic + 9-tap nonlinear Laplacian + axpys) and two implicit
    penta sweeps."""
    rhs = expected_stencil(shape, taps=34, itemsize=itemsize)
    solve = expected_penta(shape, itemsize, sweeps=2)
    n = 1
    for d in shape:
        n *= int(d)
    step_bytes = rhs.bytes + solve.bytes
    return Expected(
        flops=rhs.flops + solve.flops + 6.0 * n,
        bytes=step_bytes,
        peak_memory=float(6 * n * itemsize),
        step_bytes=float(step_bytes),
    )
