"""The operation counts of ``bench/ops`` against hand counts at one small
shape, and their name patterns against the kernels' names."""

import re

import pytest

from bench.harness import manifest, peaks

OPS = manifest.ops_modules()
CSRC = manifest.ROOT / "src" / "repro_torch" / "kernels" / "csrc"


def test_penta_counts():
    # 4 systems of 8, pentadiagonal (band 2), float64: 2 * 32 points read
    # and written, 9 band vectors of 8; 17 operations a point, 8 a system
    assert OPS["penta_cols"].count(m=8, n=4, itemsize=8) == (
        (64 + 9 * 8) * 8, 17 * 32 + 8 * 4)
    assert OPS["penta_rows"].count(m=8, n=4, itemsize=8) == (
        (64 + 9 * 8) * 8, 17 * 32 + 8 * 4)
    # tridiagonal (band 1): 5 vectors, 9 operations a point, 4 a system
    assert OPS["penta_mid"].count(p=2, m=8, q=3, itemsize=8, band=1) == (
        (96 + 5 * 8) * 8, 9 * 48 + 4 * 6)


def test_stencil_counts():
    # 13 taps on a 4 x 5 grid: 20 points read and written, 13 weights;
    # 25 operations a point
    assert OPS["stencil2d"].count(ny=4, nx=5, itemsize=8, taps=13) == (
        (40 + 13) * 8, 25 * 20)
    # the point function over 5 windows: 24 operations a point
    assert OPS["stencil2d"].count(ny=4, nx=5, itemsize=8, taps=5,
                                  point="cube") == ((40 + 5) * 8, 24 * 20)
    assert OPS["stencil1d_batch"].count(b=3, m=7, itemsize=4, taps=3) == (
        (42 + 3) * 4, 5 * 21)


def test_fused_rhs_xsweep_count():
    # C^n, C^{n-1} read, w written (3 x 16 points), the x-band's 9 vectors
    # of 8; 45 + 17 operations a point, 8 a row
    assert OPS["ch_rhs_xsweep"].count(ny=2, nx=8, itemsize=8) == (
        (48 + 72) * 8, 62 * 16 + 8 * 2)


def by_bytes(nbytes, flops):
    return nbytes / peaks.HBM_BYTES_PER_S >= flops / peaks.FP64_FLOPS_PER_S


def test_the_cells_are_bound_by_bytes():
    b, f = OPS["penta_cols"].count(m=4096, n=4096, itemsize=8)
    assert by_bytes(b, f)
    b, f = OPS["ch_rhs_xsweep"].count(ny=4096, nx=4096, itemsize=8)
    assert by_bytes(b, f)
    assert peaks.bound_s(b, f) == pytest.approx(3 * 4096**2 * 8 / 3.35e12,
                                                rel=1e-3)


def test_patterns_match_the_kernels():
    source = "\n".join(p.read_text() for p in CSRC.glob("*.cu"))
    kernels = re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\) )?"
                         r"(\w+)\(", source)
    for name, op in OPS.items():
        hits = [k for k in kernels if re.search(op.PATTERN, k)]
        assert hits, name
    # a profiler's name: namespace, template arguments and signature
    prof = "void (anonymous namespace)::penta_cols_tile_kernel<double>(int, double const*)"
    from bench.harness.profile import short_name

    assert re.search(OPS["penta_cols"].PATTERN, short_name(prof))
    assert not re.search(OPS["penta_rows"].PATTERN, short_name(prof))
    assert not re.search(OPS["ch_rhs_xsweep"].PATTERN, "ch_rhs_tile_kernel<double>")
