"""repro_torch.kernels.penta held against the JAX reference on the CPU.

Inputs are made with numpy from a seed and given to both packages.  The
penta parts of the port are held against the reference's jnp paths and the
dense oracles (its Pallas substitutions need ``pl.load``, which the
installed jax lacks).  Tolerances: ``tolerance_for(dtype, scale=10)`` —
the two packages run the same recurrence with per-op rounding, but XLA may
contract multiply-adds and LAPACK's 4x4 inverse may differ by an ulp, and
both are carried over M steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import penta as RP
from repro.kernels import ref as RR
from repro_torch import convert
from repro_torch.kernels import _build
from repro_torch.kernels import penta as TP
from repro_torch.util import tolerance_for

MS = (6, 37, 64)
DTYPES = ("float64", "float32")
BATCH = 7


def _bands(M, dtype, seed=0):
    """A random diagonally dominant (non-symmetric) band, numpy in dtype."""
    rng = np.random.default_rng(seed + M)
    off = [rng.uniform(-1.0, 1.0, M) for _ in range(4)]
    d = 6.0 + rng.uniform(0.0, 1.0, M)
    l2, l1, u1, u2 = off
    return tuple(np.asarray(a, dtype) for a in (l2, l1, d, u1, u2))


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(a, b, dtype, scale=10.0):
    np.testing.assert_allclose(_np(a), _np(b), **tolerance_for(dtype, scale))


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_factor_matches_reference(dtype, M):
    bands = _bands(M, dtype)
    ref = RP.penta_factor(*(jnp.asarray(b) for b in bands))
    got = TP.penta_factor(*bands, device="cpu")
    for name in TP.PentaFactors._fields:
        assert getattr(got, name).dtype == getattr(torch, dtype)
        _close(getattr(got, name), getattr(ref, name), dtype)


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cyclic_factor_matches_reference(dtype, M):
    bands = _bands(M, dtype, seed=1)
    ref = RP.cyclic_penta_factor(*(jnp.asarray(b) for b in bands))
    got = TP.cyclic_penta_factor(*bands, device="cpu")
    for name in TP.PentaFactors._fields:
        _close(getattr(got.band, name), getattr(ref.band, name), dtype)
    for name in ("z", "s_inv", "w"):
        _close(getattr(got, name), getattr(ref, name), dtype)


def _reference_solve(layout, cyclic, ref_fac, rhs):
    r = jnp.asarray(rhs)
    if layout == "cols":
        if cyclic:
            return RP.cyclic_penta_solve_factored(ref_fac, r, backend="jnp")
        return RP._substitute_jnp(ref_fac, r)
    if cyclic:
        return RP.cyclic_penta_solve_factored_rows(ref_fac, r, backend="jnp")
    return RP._substitute_rows_jnp(ref_fac, r)


@pytest.mark.parametrize("M", MS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cyclic", [False, True], ids=["band", "cyclic"])
@pytest.mark.parametrize("layout", ["cols", "rows"])
def test_plain_solve_matches_reference_and_dense(layout, cyclic, dtype, M):
    """The port's plain column/row solves against the reference's jnp
    substitutions / cyclic solves and against the dense solve."""
    bands = _bands(M, dtype, seed=2)
    jb = [jnp.asarray(b) for b in bands]
    ref_fac = (RP.cyclic_penta_factor if cyclic else RP.penta_factor)(*jb)
    fac = (TP.cyclic_penta_factor if cyclic else TP.penta_factor)(
        *bands, device="cpu"
    )
    rng = np.random.default_rng(M)
    shape = (M, BATCH) if layout == "cols" else (BATCH, M)
    rhs = np.asarray(rng.standard_normal(shape), dtype)
    solve = {
        ("cols", False): TP.penta_solve_factored,
        ("cols", True): TP.cyclic_penta_solve_factored,
        ("rows", False): TP.penta_solve_factored_rows,
        ("rows", True): TP.cyclic_penta_solve_factored_rows,
    }[(layout, cyclic)]
    got = solve(fac, torch.as_tensor(rhs))
    _close(got, _reference_solve(layout, cyclic, ref_fac, rhs), dtype)

    # dense oracle, solved in float64 from the same (rounded) band
    dense_rhs = rhs.astype(np.float64)
    dense = RR.penta_solve_ref(
        *(jnp.asarray(b, jnp.float64) for b in bands),
        dense_rhs if layout == "cols" else dense_rhs.T, cyclic=cyclic,
    )
    dense = np.asarray(dense) if layout == "cols" else np.asarray(dense).T
    _close(got, dense, dtype, scale=100.0)


def test_torch_dense_oracle_matches_reference():
    bands = _bands(37, "float64", seed=3)
    rhs = np.random.default_rng(3).standard_normal((37, 4))
    for cyclic in (False, True):
        ref = RR.penta_solve_ref(*(jnp.asarray(b) for b in bands), rhs,
                                 cyclic=cyclic)
        from repro_torch.kernels import ref as TR

        got = TR.penta_solve_ref(
            *(torch.as_tensor(b) for b in bands), torch.as_tensor(rhs),
            cyclic=cyclic,
        )
        _close(got, ref, "float64", scale=1.0)


@pytest.mark.parametrize("M", [6, 64])
def test_diagonals_match_reference(M):
    for name in ("hyperdiffusion_diagonals", "diffusion_diagonals"):
        for dtype in DTYPES:
            ref = getattr(RP, name)(M, 0.37, dtype=jnp.dtype(dtype))
            got = getattr(TP, name)(M, 0.37, dtype=dtype)
            for a, b in zip(got, ref, strict=True):
                assert a.dtype == np.dtype(dtype)
                np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("layout", ["cols", "rows"])
def test_convert_reference_factors_round_trip(layout):
    """The reference's own factors, carried over by convert.py, give the
    reference's solve: the substitution alone is compared."""
    M = 64
    ref_fac = RP.cyclic_penta_factor(*RP.hyperdiffusion_diagonals(M, 2.5))
    fac = convert.cyclic_penta_factors(
        [np.asarray(a) for a in ref_fac.band], np.asarray(ref_fac.z),
        np.asarray(ref_fac.s_inv), np.asarray(ref_fac.w), device="cpu",
    )
    for a, b in zip(fac.band, ref_fac.band, strict=True):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    rhs = np.random.default_rng(5).standard_normal(
        (M, BATCH) if layout == "cols" else (BATCH, M)
    )
    solve = (TP.cyclic_penta_solve_factored if layout == "cols"
             else TP.cyclic_penta_solve_factored_rows)
    got = solve(fac, torch.as_tensor(rhs))
    _close(got, _reference_solve(layout, True, ref_fac, rhs), "float64",
           scale=1.0)
    plain = convert.penta_factors(*(np.asarray(a) for a in ref_fac.band),
                                  device="cpu")
    assert isinstance(plain, TP.PentaFactors)


def test_one_dimensional_rhs_squeezes():
    bands = _bands(37, "float64", seed=4)
    fac = TP.cyclic_penta_factor(*bands, device="cpu")
    rhs = torch.as_tensor(np.random.default_rng(4).standard_normal(37))
    x = TP.cyclic_penta_solve_factored(fac, rhs)
    y = TP.cyclic_penta_solve_factored_rows(fac, rhs)
    assert x.shape == y.shape == (37,)
    _close(x, y, "float64", scale=1.0)


def test_cyclic_factor_needs_six_points():
    with pytest.raises(ValueError, match="M >= 6"):
        TP.cyclic_penta_factor(*_bands(5, "float64"), device="cpu")


def test_rows_per_block():
    # 1024-wide float64 rows on an H100 (232448 B opt-in, 132 SMs)
    assert TP.rows_per_block(1024, 8, 1024, 232448, 132) == 8
    assert TP.rows_per_block(1024, 8, 1 << 20, 232448, 132) == 28
    assert TP.rows_per_block(64, 4, 1 << 20, 232448, 132) == 32
    assert TP.rows_per_block(1024, 8, 3, 232448, 132) == 1
    with pytest.raises(ValueError, match="does not fit"):
        TP.rows_per_block(40000, 8, 10, 232448, 132)


# ---------------------------------------------------------------------------
# The segmented substitution of the CUDA column and fused row sweeps
# (csrc/common.cuh:substitute_segmented), modelled in numpy: the kernels
# run only on the card, so the algorithm itself is held here against the
# reference's jnp substitution and the dense oracle.
# ---------------------------------------------------------------------------

SEG_MS = (6, 31, 32, 33, 64, 1021)
# beta of the main path's y-sweep at 1024^2: the LU recurrences decay
# slowly (about 0.87 a step), so a segment's carry reaches far into the
# next segment and a wrong carry shows.
SEG_BETA = 2.8e3


def _seg_scan(A, p, reverse):
    """Hillis-Steele inclusive scan of the 32 lanes' affine maps (axis 0),
    as ``segment_carry``: lane k composes its map after lane k - d's
    (k + d when ``reverse``), for d = 1, 2, 4, 8, 16.  Returns the state
    entering each lane's segment."""
    K = TP.WARP
    d = 1
    while d < K:
        if reverse:
            Ab, pb = np.concatenate([A[d:], A[-d:]]), np.concatenate([p[d:], p[-d:]])
            valid = np.arange(K) + d < K
        else:
            Ab, pb = np.concatenate([A[:d], A[:-d]]), np.concatenate([p[:d], p[:-d]])
            valid = np.arange(K) >= d
        p_new = np.einsum("kbij,kbj->kbi", A, pb) + p
        A_new = np.einsum("kbij,kbjl->kbil", A, Ab)
        A = np.where(valid[:, None, None, None], A_new, A)
        p = np.where(valid[:, None, None], p_new, p)
        d *= 2
    zero = np.zeros_like(p[:1])
    return np.concatenate([p[1:], zero]) if reverse else np.concatenate([zero, p[:-1]])


def _seg_direction(step, r, L, M, reverse):
    """One direction of the segmented recurrence over an (M, B) array:
    ``step(i, r_i, s1, s2)`` is the recurrence's new value at row i from
    the state (s1, s2).  Pass A: every lane runs its segment from a zero
    state and from the unit states with a zero right-hand side; the carry
    scan; pass C: every lane reruns its segment from its true state."""
    K, B = TP.WARP, r.shape[1]
    dt = r.dtype.type
    rows = np.arange(K)[:, None] * L + np.arange(L)[None, :]  # (lane, step)
    order = range(L - 1, -1, -1) if reverse else range(L)

    def run(s1, s2, rhs_on, out=None):
        for j in order:
            live = (rows[:, j] < M)[:, None]
            i = np.minimum(rows[:, j], M - 1)
            v = step(i, r[i] if rhs_on else np.zeros_like(s1), s1, s2)
            if out is not None:
                out[i[live[:, 0]]] = v[live[:, 0]]
            s1, s2 = np.where(live, v, s1), np.where(live, s1, s2)
        return s1, s2

    zero, one = np.zeros((K, B), r.dtype), np.ones((K, B), r.dtype)
    p1, p2 = run(zero, zero, True)
    u1, u2 = run(one, zero, False)
    w1, w2 = run(zero, one, False)
    A = np.stack([np.stack([u1, w1], -1), np.stack([u2, w2], -1)], -2)
    s = _seg_scan(A, np.stack([p1, p2], -1), reverse)
    out = np.empty_like(r)
    run(s[..., 0], s[..., 1], True, out)
    assert dt == out.dtype.type
    return out


def _segmented_substitute(fac, rhs, L, w=None):
    """numpy model of the segmented substitution of an (M, B) rhs with
    segments of L rows, then the Woodbury closure when ``w`` is given."""
    sub, low, imu, al, be = (_np(f) for f in fac)
    M = rhs.shape[0]
    z = _seg_direction(
        lambda i, r, z1, z2: (r - sub[i, None] * z2 - low[i, None] * z1)
        * imu[i, None], rhs, L, M, reverse=False)
    x = _seg_direction(
        lambda i, r, x1, x2: r - al[i, None] * x1 - be[i, None] * x2,
        z, L, M, reverse=True)
    if w is not None:
        x = _np(TP.woodbury_correct(torch.as_tensor(x), torch.as_tensor(_np(w))))
    return x


@pytest.mark.parametrize("L", ["port", 32])
@pytest.mark.parametrize("M", SEG_MS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cyclic", [False, True], ids=["band", "cyclic"])
def test_segmented_substitution_model(cyclic, dtype, M, L):
    """The segmented algorithm against the reference's jnp substitution and
    the dense oracle.  L = 'port' is the kernels' segment length (9 for
    these M but 1021, where it is 33: a line shorter than one segment and
    ragged last segments); L = 32 adds lines shorter than one segment (6,
    31), one segment or two exactly (32, 64) and ragged ones (33, 1021)."""
    L = TP.segment_length(M) if L == "port" else L
    bands = TP.hyperdiffusion_diagonals(M, SEG_BETA, dtype)
    jb = [jnp.asarray(b) for b in bands]
    rhs = np.asarray(np.random.default_rng(M).standard_normal((M, BATCH)), dtype)
    if cyclic:
        ref_fac = RP.cyclic_penta_factor(*jb)
        fac = TP.cyclic_penta_factor(*bands, device="cpu")
        want = RP.cyclic_penta_solve_factored(ref_fac, jnp.asarray(rhs),
                                              backend="jnp")
        got = _segmented_substitute(fac.band, rhs, L, fac.w)
    else:
        ref_fac = RP.penta_factor(*jb)
        fac = TP.penta_factor(*bands, device="cpu")
        want = RP._substitute_jnp(ref_fac, jnp.asarray(rhs))
        got = _segmented_substitute(fac, rhs, L)
    assert got.dtype == np.dtype(dtype)
    _close(got, want, dtype)
    dense = RR.penta_solve_ref(*(jnp.asarray(b, jnp.float64) for b in bands),
                               rhs.astype(np.float64), cyclic=cyclic)
    _close(got, dense, dtype, scale=100.0)


def test_segment_geometry():
    """Segment length: odd, at least 9, 32 of them cover the line, and a
    function of M alone; the column sweep's tile stride and columns a
    block (H100: 232448 B opt-in shared memory a block)."""
    for M in (1, 6, 31, 32, 33, 64, 256, 1021, 1024, 1056, 1057, 40000):
        L = TP.segment_length(M)
        assert L % 2 == 1 and L >= 9 and 32 * L >= M
    assert [TP.segment_length(M) for M in (6, 256, 1021, 1024, 40000)] == [
        9, 9, 33, 33, 1251]
    assert TP.tile_stride(1024, 8) == 1026
    assert TP.tile_stride(1021, 4) == 1028
    assert TP.cols_per_block(1024, 8, 232448) == 8
    assert TP.cols_per_block(256, 8, 232448) == 8
    assert TP.cols_per_block(4000, 8, 232448) == 2
    assert TP.cols_per_block(40000, 8, 232448) == 0


def test_xsweep_rows_per_block():
    from repro_torch.kernels.fused_ch import xsweep_rows_per_block

    # 1024-wide float64 rows and their factors on an H100
    assert xsweep_rows_per_block(1024, 8, 1024, 232448, 132) == (8, True)
    assert xsweep_rows_per_block(1024, 8, 128, 232448, 132) == (1, True)
    # a float64 row of 8000 fits, its factors do not
    assert xsweep_rows_per_block(8000, 8, 3, 232448, 132) == (1, False)
    with pytest.raises(ValueError, match="does not fit"):
        xsweep_rows_per_block(40000, 8, 3, 232448, 132)


def test_backend_dispatch_on_cpu():
    fac = TP.penta_factor(*_bands(8, "float64"), device="cpu")
    rhs = torch.ones((8, 3), dtype=torch.float64)
    assert _build.resolve_backend("auto", rhs) == "torch"
    with pytest.raises(ValueError, match="CUDA tensor"):
        TP.penta_solve_factored(fac, rhs, backend="cuda")
    with pytest.raises(NotImplementedError, match="queue 1, item 8"):
        TP.penta_solve_factored(fac, rhs, backend="fft")
    with pytest.raises(ValueError, match="backend must be one of"):
        TP.penta_solve_factored(fac, rhs, backend="pallas")
