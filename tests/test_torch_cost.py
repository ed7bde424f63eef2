"""repro_torch.analysis.cost against repro.analysis.cost on the CPU: the
closed-form floors of each plan family, the same numbers for the same
arguments to 1e-12 relative, and the properties the reference's
``tests/test_cost.py::TestExpectedModels`` asserts."""

import dataclasses

import numpy as np
import pytest

from repro.analysis import cost as RC
from repro_torch.analysis import cost as C

REL = 1e-12

_rng = np.random.default_rng(11)
# seeded shapes: rank 1 to 3, small to the paper's sizes
SHAPES = [(64, 64), (1024, 1024), (1021, 1019), (256, 256, 256), (7,),
          tuple(int(n) for n in _rng.integers(1, 300, size=2)),
          tuple(int(n) for n in _rng.integers(1, 60, size=3))]


def _same(mine, ref):
    a, b = dataclasses.asdict(mine), dataclasses.asdict(ref)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == pytest.approx(b[k], rel=REL, abs=0.0), k


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("itemsize", [4, 8])
def test_floors_match_reference(shape, itemsize):
    for taps, halo in ((5, 0), (13, 2), (27, 1)):
        _same(C.expected_stencil(shape, taps, itemsize, halo=halo),
              RC.expected_stencil(shape, taps, itemsize, halo=halo))
    for transforms in (1, 2):
        _same(C.expected_fft(shape, itemsize, transforms=transforms),
              RC.expected_fft(shape, itemsize, transforms=transforms))
    for sweeps in (1, 2, 3):
        _same(C.expected_penta(shape, itemsize, sweeps=sweeps),
              RC.expected_penta(shape, itemsize, sweeps=sweeps))
    _same(C.expected_ch_step(shape, itemsize),
          RC.expected_ch_step(shape, itemsize))


class TestExpectedModels:
    def test_stencil_floor(self):
        e = C.expected_stencil((64, 64), taps=5, itemsize=8)
        n = 64 * 64
        assert e.flops == 2 * 5 * n
        assert e.bytes == 2 * n * 8  # read + write one field each
        assert e.peak_memory == 3 * n * 8

    def test_fft_floor_scales_n_log_n(self):
        e1 = C.expected_fft((64, 64), itemsize=8)
        e2 = C.expected_fft((128, 128), itemsize=8)
        # n quadruples, log2 n grows: superlinear in n but < n^2
        assert 4 < e2.flops / e1.flops < 8

    def test_penta_floor(self):
        # 2 substitution FMAs each way + 4 Woodbury FMAs = 16 flops/pt
        e = C.expected_penta((32, 32), itemsize=8, sweeps=2)
        assert e.flops == 16 * 32 * 32 * 2

    def test_penta_floor_counts_six_field_passes(self):
        """The reference's closed form, kept for parity: six field passes a
        sweep, where the port's sweep kernels move two (one read of the
        rhs, one write; PERF.md's bound column counts those)."""
        e = C.expected_penta((1024, 1024), itemsize=8, sweeps=1)
        assert e.bytes == 6 * 1024 * 1024 * 8

    def test_ch_step_combines_terms(self):
        e = C.expected_ch_step((32, 32), itemsize=8)
        assert e.flops > C.expected_penta((32, 32), 8, sweeps=2).flops

    def test_to_dict(self):
        e = C.expected_stencil((8, 8), taps=5, itemsize=4)
        assert e.to_dict() == RC.expected_stencil((8, 8), 5, 4).to_dict()
