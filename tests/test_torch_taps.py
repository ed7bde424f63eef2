"""Create-time taps of every plan rank, and the launch geometry of the 2D,
batched-1D and 3D stencil kernels and of the plane sweep, on the CPU.

A weighted or cube plan is reduced at Create to its non-zero windows
(``repro_torch.kernels.taps``), which the card's kernels sum in the
reference's window order; summing them here with ``torch.roll`` must give
the plain version's result (tolerance ``tolerance_for(float64, scale=10)``:
the same products, summed with the zero terms left out).  The geometry
functions are pure: the route and grid follow from the shape, the halos,
the layout and the dtype, never from a launch's row, line or plane
window, so a streamed chunk runs the same code as the whole field.  The launches
themselves run in ``tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro.core.cahn_hilliard import init_explicit_weights_a as ref_init_a
import repro_torch as rt
from repro_torch.core.cahn_hilliard import (
    CahnHilliardADI,
    CHConfig,
    cube_laplacian_point_fn,
)
from repro_torch.kernels import _build
from repro_torch.kernels import stencil1d_batch as S1
from repro_torch.kernels import stencil2d as S2
from repro_torch.kernels import stencil3d as S3
from repro_torch.kernels import taps as TP
from repro_torch.kernels.ref import stencil1d_batch_ref, stencil2d_ref
from repro_torch.kernels.stencil2d import cuda_point_fn
from repro_torch.util import tolerance_for

TOL = tolerance_for("float64", scale=10)
SMEM, SMS = 232448, 132  # an H100's opt-in shared memory a block and SMs
GRID_YZ_MAX = 65535


@pytest.fixture(scope="module")
def solver():
    return CahnHilliardADI(CHConfig(nx=16, ny=16, device="cpu"))


@pytest.mark.parametrize(("plan", "n_taps", "n_windows"), [
    ("plan_bih", 13, 25), ("plan_init_a", 11, 15), ("plan_init_b", 11, 15),
    ("plan_lap_cube", 5, 9), ("plan_d4_1d", 5, 5), ("plan_d2_1d", 3, 3),
    ("plan_lap_cube_1d", 3, 3)])
def test_solver_plans_carry_their_taps(solver, plan, n_taps, n_windows):
    """The Cahn–Hilliard solver's rank-2 and batch plans (weighted and cube)
    carry their non-zero taps."""
    p = getattr(solver, plan)
    assert p.num_sten == n_windows
    assert len(p.taps.weights) == n_taps
    assert np.count_nonzero(p.coeffs.numpy()) == n_taps


def test_taps_of_each_rank():
    # rank 2: init_explicit_weights_a (the reference's 5x3 box), 11 of 15,
    # window (a, b) as (0, a - top, b - left)
    w = np.asarray(ref_init_a())
    plan = rt.create(w, (8, 8), device="cpu")
    assert len(plan.taps.weights) == 11
    keep = np.flatnonzero(w)
    assert plan.taps.weights == tuple(float(w.flat[k]) for k in keep)
    assert plan.taps.offsets == tuple((0, int(k // 3) - 2, int(k % 3) - 1)
                                      for k in keep)
    # rank 1: _D4 along a line, all 5 windows, (0, 0, k - left)
    d4 = rt.create(np.array([1.0, -4.0, 6.0, -4.0, 1.0]), (8, 8), mode="batch",
                   device="cpu")
    assert d4.taps == TP.Taps(tuple((0, 0, k) for k in range(-2, 3)),
                              (1.0, -4.0, 6.0, -4.0, 1.0))
    # rank 3: the 7-point Laplacian, 7 of 27
    assert len(rt.create("laplacian", (6, 6, 6), device="cpu").taps.offsets) == 7
    # more than MAX_TAPS non-zero windows keep the dense path
    assert TP.MAX_TAPS < 49
    assert rt.create(np.ones((7, 7)), (8, 8), device="cpu").taps is None
    assert rt.create(np.ones(49), (8, 64), mode="batch",
                     device="cpu").taps is None


def test_cube_and_user_plans():
    lap = np.array([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]])
    ext = dict(left=1, right=1, top=1, bottom=1)
    cube = rt.create(cube_laplacian_point_fn, (8, 8), coeffs=lap.ravel(),
                     extents=ext, device="cpu")
    assert cube.taps.offsets == ((0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1),
                                 (0, 1, 0))
    # a user's point function takes every window: no taps
    user = cuda_point_fn("template <typename T> __device__ T point_fn("
                         "const T* w, const T* c) { return w[0]; }")(
        lambda w, c: w[0])
    assert rt.create(user, (8, 8), coeffs=lap.ravel(), extents=ext,
                     device="cpu").taps is None


@pytest.mark.parametrize("halos", [(2, 2, 2, 2), (0, 3, 1, 0), (4, 1, 0, 0)])
def test_taps_reproduce_the_2d_weighted_sum(halos):
    left, right, top, bottom = halos
    n = (left + right + 1) * (top + bottom + 1)
    rng = np.random.default_rng(2)
    w = rng.standard_normal(n)
    w[rng.random(n) < 0.5] = 0.0
    w[-1] = 0.25
    data = torch.as_tensor(rng.uniform(-1.0, 1.0, (9, 11)))
    taps = TP.nonzero_taps(w, TP.halos_2d(*halos))
    got = sum(wt * torch.roll(data, shifts=(-dy, -dx), dims=(0, 1))
              for (dz, dy, dx), wt in zip(taps.offsets, taps.weights))
    want = stencil2d_ref(data, coeffs=torch.as_tensor(w), left=left,
                         right=right, top=top, bottom=bottom, bc="periodic")
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("halos", [(2, 2), (0, 4), (3, 0)])
def test_taps_reproduce_the_1d_weighted_sum(halos):
    left, right = halos
    rng = np.random.default_rng(3)
    w = rng.standard_normal(left + right + 1)
    w[0] = 0.0
    data = torch.as_tensor(rng.uniform(-1.0, 1.0, (5, 13)))
    taps = TP.nonzero_taps(w, TP.halos_1d(left, right))
    assert all(dz == dy == 0 for dz, dy, _ in taps.offsets)
    got = sum(wt * torch.roll(data, shifts=-dx, dims=1)
              for (_, _, dx), wt in zip(taps.offsets, taps.weights))
    want = stencil1d_batch_ref(data, coeffs=torch.as_tensor(w), left=left,
                               right=right, bc="periodic")
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_c_taps_hold_window_coordinates():
    taps = TP.nonzero_taps([0.0, 2.0, 0.0, 3.0], TP.halos_1d(1, 2))
    n, cab, w = TP.c_taps(taps, TP.halos_1d(1, 2))
    assert n[0] == 2 and list(cab[:6]) == [0, 0, 1, 0, 0, 3]
    assert list(w[:2]) == [2.0, 3.0]
    assert TP.c_taps(None, TP.halos_1d(1, 2)) == (None, None, None)


def test_stencil2d_geometry():
    # 1024^2 float64 5x5: a 36 x 36 tile a block, 32 x 32 blocks
    geo = S2.stencil2d_geometry((1024, 1024), (2, 2, 2, 2), 8, SMEM, SMS)
    assert geo == S2.Stencil2DGeometry("tile", 1024, 36 * 36 * 8)
    # halos too wide for shared memory: one point a thread
    wide = S2.stencil2d_geometry((40, 45), (100,) * 4, 8, SMEM, SMS)
    assert wide.route == "direct" and wide.smem == 0
    assert S2.stencil2d_geometry((40, 45), (100,) * 4, 4, SMEM,
                                 SMS).route == "tile"
    # the tall fields that once asked for more than 65535 blocks in grid.y
    for ny in (524289, 2097153):
        for halos in ((1, 1, 2, 2), (100,) * 4):
            g = S2.stencil2d_geometry((ny, 8), halos, 8, SMEM, SMS)
            assert g.grid < 2**31 and g.grid >= ny // 32


def test_stencil3d_geometry_at_tall_fields():
    for ny in (524289, 2097153):
        for halos, route in (((1,) * 6, "tile"),
                             ((30, 30, 0, 0, 0, 0), "direct")):
            g = S3.stencil3d_geometry((1, ny, 8), halos, 8, SMEM, SMS)
            assert g.route == route
            assert g.grid[0] < 2**31 and g.grid[1] <= GRID_YZ_MAX


@pytest.mark.parametrize(("B", "M", "lines_fast", "route", "param"), [
    (1024, 1024, False, "x", 10), (65536, 16, False, "x", 4),
    (3, 40000, False, "x", 10), (1, 1, False, "x", 0),
    (1024, 1024, True, "y", 8), (65536, 16, True, "y", 8),
    (3, 40000, True, "y", 10)])
def test_stencil1d_batch_geometry(B, M, lines_fast, route, param):
    g = S1.stencil1d_batch_geometry(B, M, (2, 2), lines_fast, 8, SMEM, SMS)
    assert (g.route, g.param) == (route, param)
    if route == "x":
        sw = 1 << param
        # short lines pack several to a block: 1024 outputs a block
        assert sw * (S1.SEGMENT // sw) == S1.SEGMENT
        assert g.grid == -(-M // sw) * -(-B // (S1.SEGMENT // sw))


def test_stencil1d_batch_geometry_routes():
    # halos too wide for shared memory along x, windows wider than the
    # register march along y: the direct route, its grid.y capped
    assert S1.stencil1d_batch_geometry(
        4, 5, (20000, 20000), False, 8, SMEM, SMS).route == "direct"
    g = S1.stencil1d_batch_geometry(8, 524289, (5, 5), True, 8, SMEM, SMS)
    assert g.route == "direct"
    assert g.grid <= 1 * GRID_YZ_MAX
    assert S1.stencil1d_batch_geometry(8, 64, (4, 4), True, 8, SMEM,
                                       SMS).route == "y"


class _Launches:
    """Stand-ins for the card's side of a launch: the wrapper's checks
    pass CPU tensors, the device info is an H100's, and each launch's
    arguments are recorded."""

    def __init__(self, monkeypatch):
        self.args = []
        monkeypatch.setattr(_build, "check_cuda", lambda *a, **k: None)
        monkeypatch.setattr(_build, "device_info", lambda d: (SMEM, SMS))
        monkeypatch.setattr(_build, "launch",
                            lambda name, dev, *a, libs=None: self.args.append(a))


def test_stencil2d_launch_geometry_ignores_the_row_window(monkeypatch):
    rec = _Launches(monkeypatch)
    data = torch.zeros((96, 40), dtype=torch.float64)
    plan = rt.create("biharmonic", data.shape, device="cpu")
    out = torch.empty_like(data)
    for rows in (None, (0, 32), (32, 40), (95, 96)):
        S2.stencil2d_cuda(data, plan.coeffs, None, rows=rows,
                          out=None if rows is None else out, taps=plan.taps,
                          left=2, right=2, top=2, bottom=2)
    # (..., nb, ny, nx, row0, row1, left, right, top, bottom, smem, taps)
    assert {a[7:10] for a in rec.args} == {(1, 96, 40)}
    assert {a[16] for a in rec.args} == {36 * 36 * 8}
    assert [a[10:12] for a in rec.args] == [(0, 96), (0, 32), (32, 40), (95, 96)]
    assert all(a[17][0] == 13 for a in rec.args)  # the 13 taps


@pytest.mark.parametrize("halos", [(2, 2, 2, 2), (100, 100, 100, 100)])
def test_stencil2d_stacked_launch_geometry(monkeypatch, halos):
    """A (B, ny, nx) stack is one launch with the single field's tile
    geometry (route, shared memory, taps, row window): only the batch
    extent and the grid, B times a field's, differ."""
    rec = _Launches(monkeypatch)
    left, right, top, bottom = halos
    one = torch.zeros((96, 40), dtype=torch.float64)
    w = np.ones((top + bottom + 1, left + right + 1))
    plan = rt.create(w, one.shape, device="cpu")
    for b in (1, 3, 80):
        S2.stencil2d_cuda(torch.zeros((b, 96, 40), dtype=torch.float64),
                          plan.coeffs, taps=plan.taps, left=left, right=right,
                          top=top, bottom=bottom)
    S2.stencil2d_cuda(one, plan.coeffs, taps=plan.taps, left=left,
                      right=right, top=top, bottom=bottom)
    assert [a[7] for a in rec.args] == [1, 3, 80, 1]
    # ny, nx, the row window, the halos and the shared memory; the taps
    assert {a[8:17] for a in rec.args} == {rec.args[-1][8:17]}
    assert all(TP.c_taps(plan.taps, TP.halos_2d(*halos))[0] is None
               or a[17][0] == rec.args[-1][17][0] for a in rec.args)
    single = S2.stencil2d_geometry((96, 40), halos, 8, SMEM, SMS)
    for b in (1, 3, 80):
        geo = S2.stencil2d_geometry((96, 40), halos, 8, SMEM, SMS, b)
        assert geo == single._replace(grid=b * single.grid)
    # 80 members of 1024^2: more blocks than grid.y could hold, in grid.x
    big = S2.stencil2d_geometry((1024, 1024), (2, 2, 1, 1), 8, SMEM, SMS, 80)
    assert 65535 < big.grid == 80 * 1024 < 2**31
    with pytest.raises(ValueError, match="stack"):
        S2.stencil2d_cuda(torch.zeros((0, 96, 40), dtype=torch.float64),
                          plan.coeffs, taps=plan.taps, left=left,
                          right=right, top=top, bottom=bottom)


@pytest.mark.parametrize("transposed", [False, True])
def test_stencil1d_batch_launch_geometry_ignores_the_line_window(
        monkeypatch, transposed):
    rec = _Launches(monkeypatch)
    field = torch.zeros((64, 48), dtype=torch.float64)
    data = field.T if transposed else field
    plan = rt.create(np.array([1.0, -4.0, 6.0, -4.0, 1.0]), data.shape,
                     mode="batch", device="cpu")
    out = torch.empty_like(data)
    B = data.shape[0]
    for lines in (None, (0, 16), (16, B)):
        S1.stencil1d_batch_cuda(data, plan.coeffs, None, lines=lines,
                                out=None if lines is None else out,
                                taps=plan.taps, left=2, right=2)
    # (..., B, M, line stride, elem stride, line0, line1, left, right,
    #  route, param, smem, taps)
    assert len({a[7:11] for a in rec.args}) == 1
    assert len({a[15:18] for a in rec.args}) == 1
    assert rec.args[0][15] == (2 if transposed else 1)
    assert [a[11:13] for a in rec.args] == [(0, B), (0, 16), (16, B)]


@pytest.mark.parametrize(("halos", "route"), [((1,) * 6, "tile"),
                                              ((13, 13, 0, 0, 0, 0), "direct")])
def test_stencil3d_launch_geometry_follows_only_the_plane_window(
        monkeypatch, halos, route):
    """z windows: the route and shared memory of the whole field, the
    window's planes, and z chunks sized for the window's depth."""
    rec = _Launches(monkeypatch)
    shape = (256, 64, 64)
    data = torch.zeros(shape, dtype=torch.float64)
    nwin = (halos[0] + halos[1] + 1) * (halos[2] + halos[3] + 1) * (
        halos[4] + halos[5] + 1)
    coeffs = torch.ones(nwin, dtype=torch.float64)
    out = torch.empty_like(data)
    windows = [None, (0, 32), (32, 256), (255, 256)]
    for planes in windows:
        S3.stencil3d_cuda(data, coeffs, None, planes=planes,
                          out=None if planes is None else out, halos=halos)
    # (dtype, fn, periodic, data, coeffs, init, out, nz, ny, nx, 6 halos,
    #  k0, k1, zc, smem, taps)
    assert [a[16:18] for a in rec.args] == [(0, 256), (0, 32), (32, 256),
                                            (255, 256)]
    assert {a[7:16] for a in rec.args} == {(*shape, *halos)}
    assert len({a[19] for a in rec.args}) == 1
    whole = S3.stencil3d_geometry(shape, halos, 8, SMEM, SMS)
    assert whole.route == route
    for a, planes in zip(rec.args, windows):
        depth = 256 if planes is None else planes[1] - planes[0]
        geo = S3.stencil3d_geometry(shape, halos, 8, SMEM, SMS, planes=depth)
        assert (geo.route, geo.smem) == (whole.route, whole.smem)
        assert a[18] == geo.zc and (geo.zc == 0) == (route == "direct")


def test_penta_mid_launch_window_is_a_slab_of_planes(monkeypatch):
    """Plane windows: the launch takes the window's slab of rhs and out by
    pointer offset, with the whole call's L, columns a block and stride."""
    from repro_torch.kernels import penta as P

    rec = _Launches(monkeypatch)
    Pn, M, N = 12, 40, 24
    fac = P.cyclic_penta_factor(*P.diffusion_diagonals(M, 0.7), device="cpu")
    rhs = torch.zeros((Pn, M, N), dtype=torch.float64)
    out = torch.empty_like(rhs)
    for planes in (None, (0, 4), (4, 12)):
        P.penta_mid_cuda(fac.band, rhs, fac.w, planes=planes,
                         out=None if planes is None else out)
    # (dtype, 5 factors, w, rhs, out, P, M, N, L, C, ldt)
    plane = M * N * 8
    assert [a[7] - rhs.data_ptr() for a in rec.args[1:]] == [0, 4 * plane]
    assert [a[8] - out.data_ptr() for a in rec.args[1:]] == [0, 4 * plane]
    assert [a[9] for a in rec.args] == [12, 4, 8]
    assert len({a[10:15] for a in rec.args}) == 1
