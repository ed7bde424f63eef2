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
from repro_torch.util import next_multiple, tolerance_for

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


def _seg_scan(A, p, reverse, blocks=1):
    """The carries of the segmented recurrence: the state entering each
    lane's segment, for ``blocks`` blocks of 32 lanes (axis 0, block-major)
    that split one line.  In each block, the Hillis-Steele inclusive scan of
    its 32 lanes' affine maps, as ``segment_scan``: lane k composes its map
    after lane k - d's (k + d when ``reverse``), for d = 1, 2, 4, 8, 16.
    Across blocks, as ``ClusterCarry``: the zero start runs through the
    composed maps of the blocks before each block (after it when
    ``reverse``), in line order, then through the composed map of the lanes
    before each lane in its block.  One block is ``segment_carry``."""
    K = TP.WARP
    A = A.reshape((blocks, K) + A.shape[1:])
    p = p.reshape((blocks, K) + p.shape[1:])
    d = 1
    while d < K:
        if reverse:
            Ab = np.concatenate([A[:, d:], A[:, -d:]], 1)
            pb = np.concatenate([p[:, d:], p[:, -d:]], 1)
            valid = np.arange(K) + d < K
        else:
            Ab = np.concatenate([A[:, :d], A[:, :-d]], 1)
            pb = np.concatenate([p[:, :d], p[:, :-d]], 1)
            valid = np.arange(K) >= d
        p_new = np.einsum("gkbij,gkbj->gkbi", A, pb) + p
        A_new = np.einsum("gkbij,gkbjl->gkbil", A, Ab)
        A = np.where(valid[:, None, None, None], A_new, A)
        p = np.where(valid[:, None, None], p_new, p)
        d *= 2
    # the composed map of the lanes before each lane (the identity first)
    eye = np.broadcast_to(np.eye(2, dtype=A.dtype), A[:, :1].shape)
    zero = np.zeros_like(p[:, :1])
    if reverse:
        eA, ep = np.concatenate([A[:, 1:], eye], 1), np.concatenate([p[:, 1:], zero], 1)
    else:
        eA, ep = np.concatenate([eye, A[:, :-1]], 1), np.concatenate([zero, p[:, :-1]], 1)
    # the state entering each block: its predecessors' maps in line order
    last = 0 if reverse else K - 1
    t = np.zeros_like(p[:, 0])
    order = range(blocks - 2, -1, -1) if reverse else range(1, blocks)
    for g in order:
        prev = g + 1 if reverse else g - 1
        t[g] = np.einsum("bij,bj->bi", A[prev, last], t[prev]) + p[prev, last]
    s = np.einsum("gkbij,gbj->gkbi", eA, t) + ep
    return s.reshape((blocks * K,) + s.shape[2:])


def _seg_direction(step, r, L, M, reverse, blocks=1):
    """One direction of the segmented recurrence over an (M, B) array:
    ``step(i, r_i, s1, s2)`` is the recurrence's new value at row i from
    the state (s1, s2).  ``blocks`` blocks split the line, block g holding
    the rows [g Mb, g Mb + Mb), Mb = ceil(M / blocks), each of its 32 lanes
    a segment of L of them.  Pass A: every lane runs its segment from a
    zero state and from the unit states with a zero right-hand side; the
    carries (:func:`_seg_scan`); pass C: every lane reruns its segment from
    its true state."""
    K, B = TP.WARP, r.shape[1]
    dt = r.dtype.type
    Mb = -(-M // blocks)
    lane = np.arange(blocks * K)
    first = (lane // K) * Mb + (lane % K) * L
    stop = np.minimum(np.minimum(first + L, (lane // K + 1) * Mb), M)
    rows = first[:, None] + np.arange(L)[None, :]  # (lane, step)
    alive = rows < stop[:, None]
    order = range(L - 1, -1, -1) if reverse else range(L)

    def run(s1, s2, rhs_on, out=None):
        for j in order:
            live = alive[:, j][:, None]
            i = np.minimum(rows[:, j], M - 1)
            v = step(i, r[i] if rhs_on else np.zeros_like(s1), s1, s2)
            if out is not None:
                out[i[live[:, 0]]] = v[live[:, 0]]
            s1, s2 = np.where(live, v, s1), np.where(live, s1, s2)
        return s1, s2

    n = blocks * K
    zero, one = np.zeros((n, B), r.dtype), np.ones((n, B), r.dtype)
    p1, p2 = run(zero, zero, True)
    u1, u2 = run(one, zero, False)
    w1, w2 = run(zero, one, False)
    A = np.stack([np.stack([u1, w1], -1), np.stack([u2, w2], -1)], -2)
    s = _seg_scan(A, np.stack([p1, p2], -1), reverse, blocks)
    out = np.empty_like(r)
    run(s[..., 0], s[..., 1], True, out)
    assert dt == out.dtype.type
    return out


def _segmented_substitute(fac, rhs, L, w=None, blocks=1):
    """numpy model of the segmented substitution of an (M, B) rhs with
    segments of L rows, the line split across ``blocks`` blocks (the
    column sweep's cluster route), then the Woodbury closure when ``w`` is
    given."""
    sub, low, imu, al, be = (_np(f) for f in fac)
    M = rhs.shape[0]
    z = _seg_direction(
        lambda i, r, z1, z2: (r - sub[i, None] * z2 - low[i, None] * z1)
        * imu[i, None], rhs, L, M, reverse=False, blocks=blocks)
    x = _seg_direction(
        lambda i, r, x1, x2: r - al[i, None] * x1 - be[i, None] * x2,
        z, L, M, reverse=True, blocks=blocks)
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


@pytest.mark.parametrize("M", (6, 33, 256, 1021))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cyclic", [False, True], ids=["band", "cyclic"])
def test_segmented_substitution_model_planes(cyclic, dtype, M):
    """The plane sweep's decomposition (csrc/penta.cu:penta_mid_tile_kernel)
    modelled in numpy: P = 3 planes of a (P, M, N) rhs, each cut into
    column groups of C = 4 (the last ragged, N = 7), every group's (M, C)
    tile run through the segmented model with the port's L and closed with
    the Woodbury correction, against the reference's plane-layout jnp
    substitution and ``mid_woodbury_correct`` and the dense oracle."""
    P, N, C = 3, 7, 4
    L = TP.segment_length(M)
    bands = TP.hyperdiffusion_diagonals(M, SEG_BETA, dtype)
    jb = [jnp.asarray(b) for b in bands]
    rhs = np.asarray(np.random.default_rng(M).standard_normal((P, M, N)), dtype)
    if cyclic:
        ref_fac = RP.cyclic_penta_factor(*jb)
        fac = TP.cyclic_penta_factor(*bands, device="cpu")
        want = RP.mid_woodbury_correct(
            RP._substitute_mid_jnp(ref_fac.band, jnp.asarray(rhs)), ref_fac.w)
        band, w = fac.band, fac.w
    else:
        ref_fac = RP.penta_factor(*jb)
        fac = TP.penta_factor(*bands, device="cpu")
        want = RP._substitute_mid_jnp(ref_fac, jnp.asarray(rhs))
        band, w = fac, None
    got = np.empty_like(rhs)
    for p in range(P):
        for c0 in range(0, N, C):
            got[p, :, c0:c0 + C] = _segmented_substitute(
                band, rhs[p, :, c0:c0 + C], L, w)
    assert got.dtype == np.dtype(dtype)
    _close(got, want, dtype)
    dense = RR.penta_solve_ref(*(jnp.asarray(b, jnp.float64) for b in bands),
                               rhs.transpose(1, 0, 2).reshape(M, P * N)
                               .astype(np.float64), cyclic=cyclic)
    dense = np.asarray(dense).reshape(M, P, N).transpose(1, 0, 2)
    _close(got, dense, dtype, scale=100.0)


# H100: opt-in shared memory a block (bytes), SMs
H100_SMEM = 232448
H100 = (H100_SMEM, 132)


@pytest.mark.parametrize("M", (2305, 4096, 4097))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cyclic", [False, True], ids=["band", "cyclic"])
def test_segmented_substitution_model_cluster(cyclic, dtype, M):
    """The column sweep's cluster route (csrc/penta.cu:ClusterCarry)
    modelled in numpy: each line split across the K blocks of the float64
    geometry on an H100, 32 lanes a block, the carries composed within each
    block and then across the blocks in the kernel's order, against the
    reference's jnp substitution and the dense oracle.  K = 4 at all three
    M; ragged last segments (2305: Mb = 577, L = 19; 4097: Mb = 1025,
    L = 33) and a short last block (574 and 1022 rows)."""
    geo = TP.cols_geometry(M, 8, H100_SMEM)
    assert (geo.route, geo.cluster) == ("cluster", 4)
    bands = TP.hyperdiffusion_diagonals(M, SEG_BETA, dtype)
    jb = [jnp.asarray(b) for b in bands]
    rhs = np.asarray(np.random.default_rng(M).standard_normal((M, 3)), dtype)
    if cyclic:
        ref_fac = RP.cyclic_penta_factor(*jb)
        fac = TP.cyclic_penta_factor(*bands, device="cpu")
        want = RP.cyclic_penta_solve_factored(ref_fac, jnp.asarray(rhs),
                                              backend="jnp")
        got = _segmented_substitute(fac.band, rhs, geo.seg, fac.w,
                                    blocks=geo.cluster)
    else:
        ref_fac = RP.penta_factor(*jb)
        fac = TP.penta_factor(*bands, device="cpu")
        want = RP._substitute_jnp(ref_fac, jnp.asarray(rhs))
        got = _segmented_substitute(fac, rhs, geo.seg, blocks=geo.cluster)
    assert got.dtype == np.dtype(dtype)
    _close(got, want, dtype)
    dense = RR.penta_solve_ref(*(jnp.asarray(b, jnp.float64) for b in bands),
                               rhs.astype(np.float64), cyclic=cyclic)
    _close(got, dense, dtype, scale=100.0)


@pytest.mark.parametrize("M", (2906, 4096, 4097, 8192))
@pytest.mark.parametrize("cyclic", [False, True], ids=["band", "cyclic"])
def test_segmented_substitution_model_rows_cluster(cyclic, M):
    """The row sweep's cluster route (csrc/penta.cu:rows_cluster_sweep)
    modelled in numpy on the transposed (M, B) layout: each float64 row
    split across the K blocks of the cyclic row geometry on an H100, 32
    lanes a block with L = segment_length(Mb), the carries composed within
    each block and then across the blocks in the kernel's order, the
    closure from the whole row's ends, against the reference's jnp row
    substitution and the dense oracle.  K = 8 at all four M: parts of 364,
    512, 513 and 1024 (L = 13, 17, 17, 33), a short last block at 2906
    (358) and 4097 (506).  The plain band runs the same split (at 2906 and
    4096 its rows take the tile route, at 8192 this one)."""
    geo = TP.rows_geometry(M, 8, 3, *H100, cyclic=True)
    assert (geo.route, geo.cluster) == ("cluster", 8)
    L = TP.segment_length(-(-M // geo.cluster))
    bands = TP.hyperdiffusion_diagonals(M, SEG_BETA, "float64")
    jb = [jnp.asarray(b) for b in bands]
    rhs = np.random.default_rng(M).standard_normal((3, M))
    if cyclic:
        ref_fac = RP.cyclic_penta_factor(*jb)
        fac = TP.cyclic_penta_factor(*bands, device="cpu")
        want = RP.cyclic_penta_solve_factored_rows(ref_fac, jnp.asarray(rhs),
                                                   backend="jnp")
        got = _segmented_substitute(fac.band, rhs.T.copy(), L, fac.w,
                                    blocks=geo.cluster).T
    else:
        ref_fac = RP.penta_factor(*jb)
        fac = TP.penta_factor(*bands, device="cpu")
        want = RP._substitute_rows_jnp(ref_fac, jnp.asarray(rhs))
        got = _segmented_substitute(fac, rhs.T.copy(), L,
                                    blocks=geo.cluster).T
    assert got.dtype == np.float64
    _close(got, want, "float64")
    dense = RR.penta_solve_ref(*(jnp.asarray(b) for b in bands), rhs.T,
                               cyclic=cyclic)
    _close(got, np.asarray(dense).T, "float64", scale=100.0)


def test_cols_geometry():
    """The column sweep's routes on an H100: the tile route with 8 columns
    where they fit beside the whole line's factors (the 3D z-sweep at 256,
    1024^2, float32 at 4096); past that, in float64, the cluster route,
    each line split across K blocks (K = 4 at 4096: blocks of 1024 rows,
    two an SM; K = 8 at 8192) up to what 8 blocks hold; beyond, the global
    route.  The route depends on M and the dtype alone."""
    for M in (256, 1024):
        g = TP.cols_geometry(M, 8, H100_SMEM)
        assert g == TP.ColsGeometry(
            "tile", 1, 8, M, TP.segment_length(M), TP.tile_stride(M, 8),
            (5 * M + 8 * TP.tile_stride(M, 8)) * 8)
    g = TP.cols_geometry(4096, 4, H100_SMEM)
    assert (g.route, g.cluster, g.cols, g.rows, g.seg) == ("tile", 1, 8, 4096,
                                                          129)
    cluster = (5 * 1024 + 8 * 1026 + 12 * 8) * 8
    for M, K in ((4096, 4), (8192, 8)):
        g = TP.cols_geometry(M, 8, H100_SMEM)
        assert g == TP.ColsGeometry("cluster", K, 8, 1024, 33, 1026, cluster)
    assert TP.resident_blocks(cluster, H100_SMEM) == 2
    # the switch: fewer than 8 columns beside the whole line's factors
    assert TP.cols_per_block(2224, 8, H100_SMEM) == 8
    assert TP.cols_per_block(2225, 8, H100_SMEM) == 7
    assert TP.cols_geometry(2224, 8, H100_SMEM).route == "tile"
    g = TP.cols_geometry(2225, 8, H100_SMEM)
    assert (g.route, g.cluster, g.rows, g.seg) == ("cluster", 4, 557, 19)
    # two blocks an SM from K = 4 up; one of 8 up to the limit of 8 blocks
    g = TP.cols_geometry(12000, 8, H100_SMEM)
    assert (g.route, g.cluster, g.rows, g.seg) == ("cluster", 8, 1500, 47)
    assert TP.resident_blocks(g.smem, H100_SMEM) == 1
    assert TP.cols_geometry(17792, 8, H100_SMEM).route == "cluster"
    for M in (17793, 40000):
        assert TP.cols_geometry(M, 8, H100_SMEM) == TP.ColsGeometry(
            "global", 1, 0, M, TP.segment_length(M), 0, 0)
    g = TP.cols_geometry(8192, 4, H100_SMEM)
    assert (g.route, g.cluster, g.rows, g.seg) == ("cluster", 4, 2048, 65)
    # tuned geometries: 1, 2 and 4 columns on the tile route, none on the
    # others; a forced C keeps K and L as the default's
    assert TP.cols_geometries(256, 8, H100_SMEM) == [
        {"cols": 1}, {"cols": 2}, {"cols": 4}]
    for M in (4096, 8192, 40000):
        assert TP.cols_geometries(M, 8, H100_SMEM) == []
    g = TP.cols_geometry(4096, 8, H100_SMEM, cols=2)
    assert g == TP.ColsGeometry("cluster", 4, 2, 1024, 33, 1026,
                                (5 * 1024 + 2 * 1026 + 24) * 8)
    for bad in (0, 9):
        with pytest.raises(ValueError, match="1 to 8 columns"):
            TP.cols_geometry(4096, 8, H100_SMEM, cols=bad)
    with pytest.raises(ValueError, match="device-memory route"):
        TP.cols_geometry(40000, 8, H100_SMEM, cols=1)


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


@pytest.mark.parametrize("case", ["tile", "cluster4096", "cluster8192",
                                  "global"])
def test_rows_geometry(case):
    """The row sweep's geometry on an H100 (232448 B opt-in shared memory a
    block, 132 SMs): route, rows a group, ring depth, blocks, and the
    long-row switches, which depend on M, the dtype and the closure alone:
    past the tile route each row splits across a cluster of K blocks of
    Mb = ceil(M / K) (K = 8: the smallest K whose blocks of 8 rows with a
    ring of 2 fit two to an SM, else 8), L = segment_length(Mb); past what
    8 blocks hold, the row is solved in device memory."""
    H100 = (232448, 132)
    if case != "tile":
        _rows_geometry_long(case, H100)
        return
    g = TP.rows_geometry(1024, 8, 1024, *H100, cyclic=True, depth=2)
    # factors and W (72 KB) and two groups of 8 rows of 8 KB: one block an SM
    assert g == TP.RowsGeometry("tile", 8, 2, 128, 204816, 1)
    assert g.smem == TP.rows_tile_bytes(1024, 8, True, 8, 2) == 16 + (9 * 1024 + 16 * 1024) * 8
    g = TP.rows_geometry(1024, 8, 1024, *H100, cyclic=True, depth=1)
    assert (g.route, g.rows, g.depth, g.blocks, g.smem) == ("tile", 8, 1, 128, 139280)
    # the 3D x-sweep: 8192 groups over one grid of resident blocks
    g = TP.rows_geometry(256, 8, 65536, *H100, cyclic=True, depth=2)
    assert g == TP.RowsGeometry("tile", 8, 2, 4 * 132, 51216, 4)
    g = TP.rows_geometry(256, 8, 65536, *H100, cyclic=True, depth=1)
    assert (g.depth, g.blocks, g.blocks_per_sm) == (1, 6 * 132, 6)
    # the card's occupancy (registers) lowers the grid, not the group
    g = TP.rows_geometry(256, 8, 65536, *H100, cyclic=True, depth=2,
                         blocks_per_sm=3)
    assert (g.rows, g.depth, g.blocks) == (8, 2, 3 * 132)
    # few rows spread one a block; a ragged row stride rounds up to 16 B
    assert TP.rows_geometry(1024, 8, 7, *H100, cyclic=True, depth=2)[:4] == (
        "tile", 1, 2, 7)
    assert TP.rows_geometry(1021, 4, 128, *H100, cyclic=False, depth=2).smem \
        == 16 + (next_multiple(5 * 1021, 4) + 2 * 1024) * 4
    # two rows fit beside the factors: one a slot; one row: one slot
    g = TP.rows_geometry(4000, 8, 7, *H100, cyclic=False, depth=2)
    assert (g.route, g.rows, g.depth) == ("tile", 1, 2)
    g = TP.rows_geometry(4400, 8, 7, *H100, cyclic=False, depth=2)
    assert (g.route, g.rows, g.depth) == ("tile", 1, 1)
    # the long-row switch: a row beside the factors (and W when cyclic);
    # past it, the cluster route with K = 8 (parts of Mb = ceil(M / 8), whose
    # blocks of 8 rows with a ring of 2 fit three or two to an SM), for 3
    # rows one row a group, a cluster a group
    for M, cyclic, isz, Mb, L, per_sm in (
            (2905, True, 8, 364, 13, 3), (4842, False, 8, 606, 19, 2),
            (5810, True, 4, 727, 23, 3), (9684, False, 4, 1211, 39, 2)):
        assert TP.rows_geometry(M, isz, 3, *H100, cyclic=cyclic).route == "tile"
        g = TP.rows_geometry(M + 1, isz, 3, *H100, cyclic=cyclic)
        smem = TP.rows_tile_bytes(Mb, isz, cyclic, 1, 2, 8)
        assert g == TP.RowsGeometry("cluster", 1, 2, 8 * 3, smem,
                                    TP.resident_blocks(smem, H100[0]), 8)
        assert -(-(M + 1) // g.cluster) == Mb and TP.segment_length(Mb) == L
        assert TP.resident_blocks(TP.rows_tile_bytes(
            Mb, isz, cyclic, 8, 2, 8), H100[0]) == per_sm
    assert TP.rows_geometry(40000, 8, 65536, *H100, cyclic=True) == \
        TP.RowsGeometry("global", 0, 0, 8192, 0, 0)
    # the route never depends on the window
    for n in (1, 7, 128, 1024, 65536):
        assert TP.rows_geometry(1024, 8, n, *H100, cyclic=True).route == "tile"


def _rows_geometry_long(case, H100):
    """The cluster and global routes of :func:`test_rows_geometry`."""
    if case == "global":
        # past what 8 blocks hold (a part of a row beside its factors, W,
        # the maps and the ends), the row is solved in device memory
        for M, cyclic, isz in ((23136, True, 8), (38560, False, 8),
                               (46376, True, 4), (77304, False, 4)):
            for n in (1, 3, 4096):
                g = TP.rows_geometry(M, isz, n, *H100, cyclic=cyclic)
                assert (g.route, g.cluster, g.rows, g.depth) == (
                    "cluster", 8, 1, 1)
                assert g.smem <= H100[0]
                assert TP.rows_geometry(M + 1, isz, n, *H100, cyclic=cyclic) \
                    == TP.RowsGeometry("global", 0, 0, -(-n // 8), 0, 0)
        # a forced ring that does not fit raises on the cluster route too
        with pytest.raises(ValueError, match="cannot ring"):
            TP.rows_geometry(23136, 8, 64, *H100, cyclic=True, rows=1, depth=2)
        return
    # the 4096^2 x-sweep (cyclic float64 rows): K = 8, parts of 512, 8 rows
    # a group and a ring of 2, 101 KB a block, two an SM (K = 4, parts of
    # 1024, 201 KB: one); 33 clusters on 132 SMs.  The 8192-long rows of the
    # distributed x-sweep (2048 a card): K = 8, parts of 1024, one block an
    # SM; 16 clusters.
    M, n_rows, smem, per_sm, L = {
        "cluster4096": (4096, 4096, 16 + (9 * 512 + 16 * 512 + 128) * 8, 2,
                        17),
        "cluster8192": (8192, 2048, 16 + (9 * 1024 + 16 * 1024 + 128) * 8, 1,
                        33),
    }[case]
    g = TP.rows_geometry(M, 8, n_rows, *H100, cyclic=True)
    assert (g.route, g.cluster, g.rows, g.smem) == ("cluster", 8, 8, smem)
    assert g == TP.RowsGeometry("cluster", 8, 2, 8 * (per_sm * 132 // 8),
                                smem, per_sm, 8)
    assert TP.segment_length(-(-M // g.cluster)) == L
    assert TP.resident_blocks(TP.rows_tile_bytes(M // 4, 8, True, 8, 2, 4),
                              H100[0]) == 1
    # the card's clusters size the grid, never the route, K or the group
    g5 = TP.rows_geometry(M, 8, n_rows, *H100, cyclic=True, clusters=5)
    assert g5 == g._replace(blocks=8 * 5)
    # the route, K and L depend on M, the dtype and the closure alone: not on
    # the rows of a launch's window
    for n in (1, 3, 7, 128, 511, n_rows, 65536):
        gn = TP.rows_geometry(M, 8, n, *H100, cyclic=True)
        assert (gn.route, gn.cluster) == ("cluster", 8)
        assert gn.blocks % 8 == 0 and gn.blocks <= 8 * -(-n // gn.rows)
    # the plain band of the same length: the tile route at 4096 (a row fits
    # beside the five factors), the cluster route at 8192
    assert TP.rows_geometry(M, 8, n_rows, *H100, cyclic=False)[:1] == (
        ("tile",) if M == 4096 else ("cluster",))
    # no tuned geometry is raced on the cluster route; a forced one keeps K
    assert TP.rows_geometries(M, 8, n_rows, *H100, cyclic=True) == []
    gf = TP.rows_geometry(M, 8, n_rows, *H100, cyclic=True, rows=2, depth=1)
    assert (gf.route, gf.cluster, gf.rows, gf.depth) == ("cluster", 8, 2, 1)


def test_mid_geometry():
    """The plane sweep's geometry on an H100 (232448 B opt-in shared memory
    a block): columns a block (a power of two, at most max_cols, as many as
    fit), the tile's line stride, the (column groups, planes) grid, and the
    long-M switch to device memory."""
    smem = 232448
    g = TP.mid_geometry(256, 256, 256, 8, smem, max_cols=8)
    assert g == TP.MidGeometry("tile", 8, 258, (32, 256), 26752)
    assert TP.mid_tile_stride(256, 8, 8) == TP.tile_stride(256, 8)
    assert TP.mid_tile_stride(1024, 4, 8) == TP.tile_stride(1024, 4)
    # rows of 32 columns (256 B)
    g = TP.mid_geometry(256, 256, 256, 8, smem, max_cols=32)
    assert g == TP.MidGeometry("tile", 32, 257, (8, 256), 76032)
    assert TP.mid_geometry(256, 256, 256, 8, smem, max_cols=16).grid == (16, 256)
    # planes beyond the grid's y limit are walked in a loop
    assert TP.mid_geometry(70000, 16, 8, 8, smem).grid == (1, 65535)
    # narrow N takes the power of two that covers it
    assert TP.mid_geometry(1, 1021, 7, 8, smem, max_cols=32)[:3] == (
        "tile", 8, 1026)
    assert TP.mid_geometry(2, 33, 1021, 4, smem, max_cols=16).grid == (64, 2)
    # float32 at M = 6000: four columns fit; float64: not one (device memory)
    assert TP.mid_geometry(2, 6000, 16, 4, smem, max_cols=8)[:2] == ("tile", 4)
    assert TP.mid_geometry(2, 6000, 16, 8, smem, max_cols=8) == \
        TP.MidGeometry("global", 0, 0, (4, 1), 0)
    # the long-M switch depends on M and the dtype alone
    for isz, M in ((8, 4838), (4, 9676)):
        for N in (1, 16, 1024):
            assert TP.mid_geometry(2, M, N, isz, smem).route == "tile"
            assert TP.mid_geometry(2, M + 1, N, isz, smem).route == "global"


def test_xsweep_rows_per_block():
    from repro_torch.kernels.fused_ch import xsweep_rows_per_block

    # 1024-wide float64 rows and their factors on an H100
    assert xsweep_rows_per_block(1024, 8, 1024, 232448, 132) == ("tile", 8, True)
    assert xsweep_rows_per_block(1024, 8, 128, 232448, 132) == ("tile", 1, True)
    # a float64 row of 8000 fits, its factors do not
    assert xsweep_rows_per_block(8000, 8, 3, 232448, 132) == ("tile", 1, False)
    # a float64 row of 40000 does not fit: the device-memory route
    assert xsweep_rows_per_block(40000, 8, 3, 232448, 132) == ("global", 0, False)
    # the route depends on nx and the dtype alone, never on the rows
    for n_rows in (1, 3, 128, 1 << 20):
        for isz, nx in ((8, 29055), (4, 58111)):
            assert xsweep_rows_per_block(nx, isz, n_rows, 232448, 132).route == "tile"
            assert xsweep_rows_per_block(nx + 1, isz, n_rows, 232448,
                                         132).route == "global"


def test_backend_dispatch_on_cpu():
    fac = TP.penta_factor(*_bands(8, "float64"), device="cpu")
    rhs = torch.ones((8, 3), dtype=torch.float64)
    assert _build.resolve_backend("auto", rhs) == "torch"
    with pytest.raises(ValueError, match="CUDA tensor"):
        TP.penta_solve_factored(fac, rhs, backend="cuda")
    # the spectral backend is a plan's: at a kernel wrapper it is a bug
    with pytest.raises(ValueError, match="backend='fft' reached a kernel"):
        TP.penta_solve_factored(fac, rhs, backend="fft")
    with pytest.raises(ValueError, match="backend must be one of"):
        TP.penta_solve_factored(fac, rhs, backend="pallas")
