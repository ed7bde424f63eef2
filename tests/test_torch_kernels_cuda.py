"""repro_torch's CUDA kernels against their plain versions, on the card.

These need a CUDA card and ``nvcc`` (the kernels are built at first use);
without a card they skip.  On the card::

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports jax, which the card's host
need not have.)

``chip_smoke.py`` runs the same comparisons at the main path's sizes.
Tolerances as in ``chip_smoke.py`` (norm-wise ``tolerance_for`` scales):
10 for the 2D, batched-1D and 3D stencils, the two RHS kernels and WENO,
100 for the recurrences.  A user's point function (CUDA source, or a
plain PyTorch function translated by ``repro_torch.kernels.point_fn``) is
built at Create into its own copy of the stencil libraries.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import compute, create
from repro_torch.analysis.audit import SEED_RULES
from repro_torch.core.adi import apply_along_x, apply_along_y
from repro_torch.core.cahn_hilliard import cube_laplacian_point_fn
from repro_torch.kernels import _build, ops
from repro_torch.kernels import penta as P
from repro_torch.kernels.ref import weighted_point_fn
from repro_torch.kernels.stencil2d import cuda_point_fn
from repro_torch.kernels.taps import MAX_TAPS, nonzero_taps
from repro_torch.util import tolerance_for

# a point function that is not a sum of per-window terms, with its CUDA
# source: the general path of every stencil kernel
MIXED_SOURCE = """
template <typename T>
__device__ T point_fn(const T* w, const T* c) {
  return w[0] * w[1] - c[0] * w[2];
}
"""


@cuda_point_fn(MIXED_SOURCE)
def mixed_point_fn(windows, coeffs):
    return windows[0] * windows[1] - coeffs[0] * windows[2]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_close(got, want, dtype, scale):
    tol = tolerance_for(dtype, scale)
    err = float((got - want).abs().max())
    assert bool(torch.isfinite(got).all())
    assert err <= tol["atol"] + tol["rtol"] * float(want.abs().max()), err


def _field(shape, dtype, device, seed):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.uniform(-0.5, 0.5, shape), dtype=dtype, device=device)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(64, 64), (37, 29)])
@pytest.mark.parametrize("bc", ["periodic", "np"])
@pytest.mark.parametrize("point_fn", [weighted_point_fn, cube_laplacian_point_fn])
def test_stencil2d(cuda, point_fn, bc, shape, dtype):
    data = _field(shape, dtype, cuda, 0)
    coeffs = _field((15,), dtype, cuda, 1)
    init = _field(shape, dtype, cuda, 2) if bc == "np" else None
    kw = dict(point_fn=point_fn, left=1, right=1, top=2, bottom=2, bc=bc)
    before = _build.LAUNCHES["stencil2d"]
    got = ops.stencil_apply(data, coeffs, init, **kw)
    assert _build.LAUNCHES["stencil2d"] == before + 1
    _assert_close(got, ops.stencil_apply(data, coeffs, init, backend="torch", **kw),
                  dtype, 10)



# Rank-2 plans on the redesigned kernel: the tile route (a 32 x 32 tile and
# its halo staged in shared memory) at whole and ragged tiles, one row, one
# column, halos wider than the extent (periodic: the modulo wrap; np: every
# cell copied), and halos too wide for shared memory (the direct route).
# Each (shape, extents (left, right, top, bottom)).
# A user's point function is built for its window count, so it takes the
# narrow cases alone.
S2_CASES = [((64, 64), (2, 2, 2, 2)), ((37, 29), (1, 1, 2, 2)),
            ((1, 37), (2, 1, 0, 0)), ((29, 1), (0, 0, 1, 2)),
            ((1, 1), (1, 1, 1, 1)), ((3, 5), (7, 2, 4, 6)),
            ((70, 33), (1, 0, 3, 1)), ((40, 45), (100, 100, 100, 100))]
S2_PLANS = [(shape, extents, kind) for shape, extents in S2_CASES
            for kind in ("weighted", "cube", "user")
            if kind != "user" or sum(extents) <= 8]


def _plan_2d(kind, extents, bc, dtype, **kw):
    """A rank-2 plan of ``kind``: weighted with a third of its weights zero,
    the cube point function on the same coefficients, or the user's
    point function."""
    left, right, top, bottom = extents
    shape_w = (top + bottom + 1, left + right + 1)
    w = np.random.default_rng(31).uniform(-1.0, 1.0, shape_w)
    w.flat[::3] = 0.0
    ext = dict(left=left, right=right, top=top, bottom=bottom)
    if kind == "weighted":
        return create(w, (8, 8), mode="xy", bc=bc, dtype=dtype, extents=ext,
                      **kw)
    fn, coeffs = ((cube_laplacian_point_fn, w.ravel()) if kind == "cube"
                  else (mixed_point_fn, np.array([0.7, -1.3])))
    return create(fn, (8, 8), bc=bc, dtype=dtype, coeffs=coeffs, extents=ext,
                  **kw)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("bc", ["periodic", "np", "np+out_init"])
@pytest.mark.parametrize(("shape", "extents", "kind"), S2_PLANS)
def test_stencil2d_plans(cuda, shape, extents, kind, bc, dtype):
    """Rank-2 plans (Create-time taps, or the user's source) against their
    plain versions; streamed row windows bit for bit the monolithic
    launch."""
    mode = "np" if bc.startswith("np") else bc
    plan = _plan_2d(kind, extents, mode, dtype)
    plain = _plan_2d(kind, extents, mode, dtype, backend="torch")
    # the taps, or (user, or more than MAX_TAPS non-zero weights) none
    n_taps = int(np.count_nonzero(plan.coeffs.cpu().numpy()))
    assert (plan.taps is None) == (kind == "user" or n_taps > MAX_TAPS)
    data = _field(shape, dtype, cuda, 32)
    init = _field(shape, dtype, cuda, 33) if bc == "np+out_init" else None
    before = _build.LAUNCHES["stencil2d"]
    got = plan.apply(data, init)
    assert _build.LAUNCHES["stencil2d"] == before + 1
    _assert_close(got, plain.apply(data, init), dtype, 10)
    if shape[0] > 1:
        rows = 1 if shape[0] % 2 else 2
        streamed = _plan_2d(kind, extents, mode, dtype, streams=2,
                            max_tile_bytes=rows * (shape[1] + 512) * 8)
        assert torch.equal(streamed.apply(data, init), got)


# Batch stacks (B, M): one element, three long lines, many short lines,
# the main path's 1024^2, and lines shorter than the halo; along x (the
# staged segments) and along y (the register march on the transposed
# view).  Windows of 5 (left 3, right 1) and of 11 (the along-y direct
# route: wider than MAX_MARCH).
B1_SHAPES = [(1, 1), (3, 40000), (65536, 16), (1024, 1024), (37, 3), (5, 2)]


def _plan_1d(kind, extents, bc, dtype, **kw):
    left, right = extents
    w = np.random.default_rng(34).uniform(-1.0, 1.0, left + right + 1)
    w[1] = 0.0
    ext = dict(left=left, right=right)
    if kind == "weighted":
        return create(w, (8, 8), mode="batch", bc=bc, dtype=dtype,
                      extents=ext, **kw)
    fn, coeffs = ((cube_laplacian_point_fn, w) if kind == "cube"
                  else (mixed_point_fn, np.array([0.7, -1.3])))
    return create(fn, (8, 8), mode="batch", bc=bc, dtype=dtype, coeffs=coeffs,
                  extents=ext, **kw)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("bc", ["periodic", "np", "np+out_init"])
@pytest.mark.parametrize("kind", ["weighted", "cube", "user"])
@pytest.mark.parametrize("extents", [(3, 1), (5, 5)])
@pytest.mark.parametrize("shape", B1_SHAPES)
def test_stencil1d_batch_stacks(cuda, shape, extents, kind, bc, dtype):
    """Batch plans along x and along y against their plain versions;
    streamed line windows bit for bit the monolithic launch."""
    mode = "np" if bc.startswith("np") else bc
    plan = _plan_1d(kind, extents, mode, dtype)
    plain = _plan_1d(kind, extents, mode, dtype, backend="torch")
    assert (plan.taps is None) == (kind == "user")
    data = _field(shape, dtype, cuda, 35)
    init = _field(shape, dtype, cuda, 36) if bc == "np+out_init" else None
    for along, lines in ((apply_along_x, shape[0]), (apply_along_y, shape[1])):
        before = _build.LAUNCHES["stencil1d_batch"]
        got = along(plan, data, init)
        assert _build.LAUNCHES["stencil1d_batch"] == before + 1
        assert got.is_contiguous()
        _assert_close(got, along(plain, data, init), dtype, 10)
        if lines > 1:
            chunk = 1 if lines % 2 else lines // 2
            streamed = _plan_1d(kind, extents, mode, dtype, streams=2,
                                max_tile_bytes=chunk * (max(shape) + 10) * 8)
            assert torch.equal(along(streamed, data, init), got)


# The grid-limit shapes: the smallest ny at which the first launchers asked
# for more than 65535 blocks in grid.y (a tile of 8 rows: 524281; 16 rows:
# 1048561; 32 rows: 2097121), each with a narrow nx.
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_grid_limit_shapes(cuda, dtype):
    h = dict(dt=1e-3, D=0.6, gamma=0.01, inv_h2=1.0, inv_h4=1.0)
    tall = _field((524281, 8), dtype, cuda, 40)
    tall2 = _field((524281, 8), dtype, cuda, 41)
    bih = create("biharmonic", tall.shape, bc="periodic", dtype=dtype)
    bih_plain = create("biharmonic", tall.shape, bc="periodic", dtype=dtype,
                       backend="torch")
    _assert_close(bih.apply(tall), bih_plain.apply(tall), dtype, 10)
    _assert_close(ops.ch_rhs(tall, tall2, **h),
                  ops.ch_rhs(tall, tall2, backend="torch", **h), dtype, 10)
    q, u, v = (_field((1048561, 8), dtype, cuda, s) for s in (42, 43, 44))
    kw = dict(dx=0.1, dy=0.1)
    _assert_close(ops.weno_advect(q, u, v, **kw),
                  ops.weno_advect(q, u, v, backend="torch", **kw), dtype, 10)
    # stencil3d: the direct route (halos too wide for the ring) at 524281
    # rows, the tile route at 2097121
    for shape, halos in (((1, 524281, 8), (30, 30, 0, 0, 0, 0)),
                         ((1, 2097121, 8), (1,) * 6)):
        n = (halos[0] + halos[1] + 1) * (halos[2] + halos[3] + 1) * (
            halos[4] + halos[5] + 1)
        data = _field(shape, dtype, cuda, 45)
        c = _field((n,), dtype, cuda, 46)
        taps = nonzero_taps(c.cpu().numpy(), halos)
        got = ops.stencil_apply_3d(data, c, halos=halos, taps=taps)
        want = ops.stencil_apply_3d(data, c, halos=halos, backend="torch")
        _assert_close(got, want, dtype, 10)

@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("bc", ["periodic", "np"])
def test_user_point_fn_in_every_stencil_kernel(cuda, bc, dtype):
    """A user's point function (CUDA source) through rank-2, batch and
    rank-3 plans: built at Create, launched on the card (the counters
    say so), within the stencil tolerance of the plain path.  The 2D and
    batched-1D plans also streamed, bit for bit the monolithic result."""
    coeffs = np.array([0.7, -1.3])
    cases = [
        ("stencil2d", (37, 29), None, dict(left=1, right=0, top=2, bottom=1)),
        ("stencil1d_batch", (37, 29), "batch", dict(left=2, right=1)),
        ("stencil3d", (11, 13, 35), None,
         dict(front=1, back=0, top=0, bottom=1, left=1, right=1)),
    ]
    for kernel, shape, mode, extents in cases:
        kw = dict(bc=bc, mode=mode, coeffs=coeffs, extents=extents, dtype=dtype)
        plan = create(mixed_point_fn, shape, **kw)
        plain = create(mixed_point_fn, shape, backend="torch", **kw)
        data = _field(shape, dtype, cuda, 21)
        init = _field(shape, dtype, cuda, 22) if bc == "np" else None
        before = _build.LAUNCHES[kernel]
        got = plan.apply(data, init)
        assert _build.LAUNCHES[kernel] == before + 1, kernel
        _assert_close(got, plain.apply(data, init), dtype, 10)
        if kernel != "stencil3d":
            streamed = create(mixed_point_fn, shape, streams=2,
                              max_tile_bytes=4096, **kw)
            assert torch.equal(streamed.apply(data, init), got), kernel
    # a plain callable the translator refuses raises on the card, at
    # Create and at a launch; none runs the plain version
    with pytest.raises(NotImplementedError,
                       match="no CUDA counterpart: aten.sum.default"):
        create(_window_sum, (8, 8), coeffs=coeffs,
               extents=dict(left=1, right=1), dtype=dtype)
    before = dict(_build.LAUNCHES)
    with pytest.raises(NotImplementedError,
                       match="no CUDA counterpart: aten.sum.default"):
        ops.stencil_apply(_field((8, 8), dtype, cuda, 23),
                          torch.ones(1, dtype=dtype, device=cuda),
                          point_fn=_window_sum, left=1, right=1)
    assert _build.LAUNCHES == before


def _window_sum(windows, coeffs):
    """Not a point function the translator takes: a reduction."""
    return windows[0].sum() * coeffs[0]


def _central_difference(windows, coe):  # examples/quickstart.py
    return coe[0] * (windows[0] - 2.0 * windows[1] + windows[2])


def _cube_sum(windows, coe):  # tests/test_kernels_allclose.py
    return sum(c * (w * w * w - w) for c, w in zip(coe, windows, strict=True))


def _square_sum(windows, coe):  # tests/test_stencil3d.py
    return sum(c * w * w for c, w in zip(coe, windows, strict=True))


def _bare_mixed(windows, coeffs):  # mixed_point_fn without its source
    return windows[0] * windows[1] - coeffs[0] * windows[2]


def _where_pow_sin(windows, coe):
    w0, w1, w2 = windows[0], windows[1], windows[2]
    return (coe[0] * (w0 - 2.0 * w1 + w2)
            + torch.where(w1 > 0, w1 ** 3, -w1) + torch.sin(w0))


# (kernel, shape, mode, extents) of the three plan families, and the
# translated functions with their coefficient count (None: one a window)
TRANSLATED_PLANS = [
    ("stencil2d", (37, 29), "x", dict(left=1, right=1)),
    ("stencil2d", (37, 29), None, dict(left=1, right=1, top=1, bottom=1)),
    ("stencil1d_batch", (37, 29), "batch", dict(left=1, right=1)),
    ("stencil3d", (11, 13, 35), "z", dict(front=1, back=1)),
    ("stencil3d", (11, 13, 35), None,
     dict(front=1, back=1, top=1, bottom=1, left=1, right=1)),
]
TRANSLATED_FNS = [(_central_difference, 1), (_cube_sum, None),
                  (_square_sum, None), (_bare_mixed, 1), (_where_pow_sin, 1)]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("bc", ["periodic", "np"])
@pytest.mark.parametrize("fn", [f for f, _ in TRANSLATED_FNS],
                         ids=[f.__name__ for f, _ in TRANSLATED_FNS])
def test_translated_point_fn_in_every_stencil_kernel(cuda, fn, bc, dtype):
    """A plain Python point function with no CUDA source through rank-2,
    batch and rank-3 plans: translated and built at Create, launched on
    the card (the counters say so), within the stencil tolerance of the
    plain path; np with out_init; a streamed plan bit for bit its
    monolithic launch."""
    ncoeffs = dict(TRANSLATED_FNS)[fn]
    for kernel, shape, mode, extents in TRANSLATED_PLANS:
        nwin = 1
        for lo, hi in zip(list(extents.values())[::2],
                          list(extents.values())[1::2]):
            nwin *= lo + hi + 1
        coeffs = np.random.default_rng(nwin).uniform(
            0.5, 1.5, ncoeffs or nwin)
        kw = dict(bc=bc, mode=mode, coeffs=coeffs, extents=extents,
                  dtype=dtype)
        plan = create(fn, shape, **kw)
        plain = create(fn, shape, backend="torch", **kw)
        data = _field(shape, dtype, cuda, 24)
        init = _field(shape, dtype, cuda, 25) if bc == "np" else None
        before = _build.LAUNCHES[kernel]
        got = plan.apply(data, init)
        assert _build.LAUNCHES[kernel] == before + 1, kernel
        _assert_close(got, plain.apply(data, init), dtype, 10)
        per_chunk = data[0].numel() * data.element_size() * 3
        streamed = create(fn, shape, streams=2, max_tile_bytes=per_chunk,
                          **kw)
        before = _build.LAUNCHES[kernel]
        assert torch.equal(streamed.apply(data, init), got), kernel
        assert _build.LAUNCHES[kernel] > before + 1, kernel


def test_user_point_fn_compile_error_raises_at_create(cuda):
    bad = cuda_point_fn("template <typename T> __device__ T point_fn("
                        "const T* w, const T* c) { return w[0] +; }")(
        lambda w, c: w[0])
    with pytest.raises(RuntimeError, match="nvcc failed"):
        create(bad, (8, 8), coeffs=np.ones(1), extents=dict(left=1, right=1))


# (ny, nx): the column sweep solves lines of ny, the row sweep lines of nx
# (each where the line holds the cyclic band's 6 points).  Past the first
# two, the segmented recurrence's edges: lines of 6 (shorter than one
# segment), 31, 33 and 1021 (ragged last segments) and 1024 (32 segments of
# 33 but the last), 1 or 7 lines; 4000 rows (fewer than 8 float64 columns
# fit beside the line's factors: the cluster route, 4 blocks of 1000 rows;
# float32 stays on the tile route), 8192 (the cluster route in both dtypes:
# float64 8 blocks of 1024 rows, two to an SM, float32 4 blocks of 2048),
# 17792 (float64 near the route's end: 8 blocks of 2224 rows, one to an SM)
# and 40000 (not even 8 blocks hold a line: the column sweep in device
# memory).
# Then the row sweep's: rows of 256 (1, 7 and the 3D x-sweep's 65536: many
# groups a block through the ring), 1 or 7 rows of 1021 and 1024 (float64
# 1021 and float32 1021 take cp.async of one element, 1024 the bulk copy),
# 4000 (float64 cyclic split across a cluster of 8 blocks, the plain band
# in a tile of one row a group) and 40000 (float64: not even 8 blocks hold
# a row, the row in device memory; float32: the cluster route; 1 and 3
# rows).
PENTA_SHAPES = [(64, 64), (37, 29), (6, 7), (31, 1), (33, 7), (1021, 1),
                (1024, 7), (7, 6), (1, 31), (7, 33), (1, 1021), (7, 1024),
                (4000, 7), (8192, 7), (17792, 3), (40000, 4),
                (1, 6), (1, 33), (1, 256), (7, 256), (65536, 256), (7, 1021),
                (1, 1024), (1, 4000), (7, 4000), (1, 40000), (3, 40000)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", PENTA_SHAPES)
def test_penta_sweeps(cuda, shape, dtype):
    ny, nx = shape
    rhs = _field(shape, getattr(torch, dtype), cuda, 3)
    runs = []  # (kernel, solve, factors)
    for n, kernel, cyclic_solve, band_solve in (
            (nx, "penta_rows", P.cyclic_penta_solve_factored_rows,
             P.penta_solve_factored_rows),
            (ny, "penta_cols", P.cyclic_penta_solve_factored,
             P.penta_solve_factored)):
        if n >= 6:
            fac = P.cyclic_penta_factor(
                *P.hyperdiffusion_diagonals(n, 3.0, dtype), device=cuda)
            runs += [(kernel, cyclic_solve, fac), (kernel, band_solve, fac.band)]
    assert runs
    for kernel, solve, fac in runs:
        before = _build.LAUNCHES[kernel]
        got = solve(fac, rhs)
        assert _build.LAUNCHES[kernel] == before + 1
        _assert_close(got, solve(fac, rhs, backend="torch"), dtype, 100)


@pytest.mark.parametrize("cyclic", [True, False], ids=["cyclic", "band"])
def test_penta_cols_cluster_route_4096(cuda, cyclic):
    """The 2D y-sweep at 4096^2 float64 on the cluster route (each column
    split across a cluster of 4 blocks) against the plain substitution and
    Woodbury closure."""
    n = 4096
    smem, _ = _build.device_info(cuda)
    assert P.cols_geometry(n, 8, smem)[:2] == ("cluster", 4)
    fac = P.cyclic_penta_factor(
        *P.hyperdiffusion_diagonals(n, 3.0, torch.float64), device=cuda)
    band, w = fac.band, (fac.w if cyclic else None)
    rhs = _field((n, n), torch.float64, cuda, 41)
    before = P.ROUTES["cluster"]
    got = P.penta_cols_cuda(band, rhs, w)
    assert P.ROUTES["cluster"] == before + 1
    want = P.substitute_torch(band, rhs)
    if cyclic:
        want = P.woodbury_correct(want, w)
    _assert_close(got, want, "float64", 100)


def test_penta_cols_streamed_4096_bit_for_bit(cuda):
    """The y-sweep at 4096^2 float64 (cluster route) in column chunks
    equals the monolithic launch bit for bit, one launch a chunk: the
    streamed executor's 8 chunks of 512, and ragged windows of 1001 (the
    last 92; each window's last column group holds one or four of its 8
    columns)."""
    from repro_torch.launch.stream import stream_penta_solve

    n = 4096
    rhs = _field((n, n), torch.float64, cuda, 42)
    fac = P.cyclic_penta_factor(
        *P.hyperdiffusion_diagonals(n, 3.0, torch.float64), device=cuda)
    for cyclic, f in ((True, fac), (False, fac.band)):
        want = (P.cyclic_penta_solve_factored if cyclic
                else P.penta_solve_factored)(f, rhs)
        before = _build.LAUNCHES["penta_cols"]
        got = stream_penta_solve(f, rhs, cyclic=cyclic, chunk_cols=512,
                                 streams=2)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["penta_cols"] == before + 8
        assert torch.equal(got, want), cyclic
        got = torch.empty_like(rhs)
        for c0 in range(0, n, 1001):
            P.penta_cols_cuda(fac.band, rhs, fac.w if cyclic else None,
                              cols=(c0, min(c0 + 1001, n)), out=got)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["penta_cols"] == before + 13
        assert torch.equal(got, want), cyclic


def test_penta_cols_routes_counted(cuda):
    """``penta.ROUTES`` counts each ``penta_cols`` launch under its route:
    one ``cluster`` launch a y-sweep at 4096^2 and one ``tile`` launch at
    256^2; the ``repro.launch`` span names the route; ``_build.LAUNCHES``
    counts each launch once, under its kernel."""
    from repro_torch.runtime import spans

    for n, route in ((4096, "cluster"), (256, "tile")):
        data = _field((n, n), torch.float64, cuda, 43)
        op = create("hyperdiffusion", (n, n), mode="adi", alpha=3.0,
                    device=cuda)
        op.solve_y(data)  # warm
        torch.cuda.synchronize()
        routes, launches = dict(P.ROUTES), dict(_build.LAUNCHES)
        spans.enable()
        try:
            op.solve_y(data)
        finally:
            spans.disable()
        torch.cuda.synchronize()
        moved = {k: v - routes[k] for k, v in P.ROUTES.items()
                 if v != routes[k]}
        assert moved == {route: 1}, (n, moved)
        launched = {k: v - launches[k] for k, v in _build.LAUNCHES.items()
                    if v != launches[k]}
        assert launched == {"penta_cols": 1}, (n, launched)
        got = [s.fields for s in spans.take() if s.name == "repro.launch"]
        assert got == [{"kernel": "penta_cols", "route": route}], (n, got)
    assert not set(P.ROUTES) & set(_build.LAUNCHES)


def _rows_route(cuda, M, cyclic):
    """(route, K) of a float64 row sweep over rows of M on the card."""
    geo = P.rows_geometry(M, 8, 64, *_build.device_info(cuda), cyclic=cyclic)
    return geo.route, geo.cluster


@pytest.mark.parametrize("cyclic", [True, False], ids=["cyclic", "band"])
@pytest.mark.parametrize("shape", [(4096, 4096), (2048, 8192)])
def test_penta_rows_cluster_route(cuda, shape, cyclic):
    """The x-sweep at 4096^2 and on the distributed cell's 2048 rows of 8192,
    float64, against the plain substitution and Woodbury closure: each
    cyclic row split across a cluster of 8 blocks (the plain band's rows of
    4096 fit a block whole: the tile route), one launch counted under its
    route in ``P.ROWS_ROUTES``."""
    B, M = shape
    route = ("tile", 1) if (M, cyclic) == (4096, False) else ("cluster", 8)
    assert _rows_route(cuda, M, cyclic) == route
    fac = P.cyclic_penta_factor(
        *P.hyperdiffusion_diagonals(M, 3.0, torch.float64), device=cuda)
    band, w = fac.band, (fac.w if cyclic else None)
    rhs = _field(shape, torch.float64, cuda, 44)
    before = dict(P.ROWS_ROUTES)
    got = P.penta_rows_cuda(band, rhs, w)
    moved = {k: v - before[k] for k, v in P.ROWS_ROUTES.items()
             if v != before[k]}
    assert moved == {route[0]: 1}, moved
    want = P.substitute_rows_torch(band, rhs)
    if cyclic:
        want = P.rows_woodbury_correct(want, w)
    _assert_close(got, want, "float64", 100)


@pytest.mark.parametrize("M", [4096, 4097])
def test_penta_rows_cluster_streamed_bit_for_bit(cuda, M):
    """The row sweep on its cluster route in row windows equals the
    monolithic launch bit for bit, one launch a window: the streamed
    executor's 4 chunks of 256, row 0 alone and windows of 203 rows from
    row 1 (each window's last group ragged), and a rhs that starts 8 bytes
    off 16, whose pieces load by element copies where the aligned rhs's
    (M = 4096) load by bulk copies.  M = 4097 (parts of 513) loads by
    element copies throughout, its last block's part short (506)."""
    from repro_torch.launch.stream import stream_penta_solve_rows

    B = 1024
    fac = P.cyclic_penta_factor(
        *P.hyperdiffusion_diagonals(M, 3.0, torch.float64), device=cuda)
    assert _rows_route(cuda, M, True) == ("cluster", 8)
    base = _field((B * M + 1,), torch.float64, cuda, 45)
    rhs = base[:-1].view(B, M).clone()
    shifted = base[1:].view(B, M)  # 8 bytes off: element copies
    rhs.copy_(shifted)
    assert shifted.data_ptr() % 16 == 8
    for cyclic, f in ((True, fac), (False, fac.band)):
        w = fac.w if cyclic else None
        before = _build.LAUNCHES["penta_rows"]
        want = P.penta_rows_cuda(fac.band, rhs, w)
        assert torch.equal(P.penta_rows_cuda(fac.band, shifted, w), want)
        got = stream_penta_solve_rows(f, rhs, cyclic=cyclic, chunk_rows=256,
                                      streams=2)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["penta_rows"] == before + 2 + 4
        assert torch.equal(got, want), cyclic
        got = torch.full_like(rhs, float("nan"))
        P.penta_rows_cuda(fac.band, rhs, w, rows=(0, 1), out=got)
        for r0 in range(1, B, 203):
            P.penta_rows_cuda(fac.band, rhs, w, rows=(r0, min(r0 + 203, B)),
                              out=got)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["penta_rows"] == before + 6 + 1 + 6
        assert torch.equal(got, want), cyclic


def test_penta_rows_routes_counted(cuda):
    """``penta.ROWS_ROUTES`` counts each ``penta_rows`` launch under its
    route: one ``cluster`` launch an x-sweep at 4096^2, one ``tile`` launch
    at 256^2; the ``repro.launch`` span names the route; ``_build.LAUNCHES``
    counts each launch once, under its kernel."""
    from repro_torch.runtime import spans

    for n, route in ((4096, "cluster"), (256, "tile")):
        data = _field((n, n), torch.float64, cuda, 46)
        op = create("hyperdiffusion", (n, n), mode="adi", alpha=3.0,
                    device=cuda)
        op.solve_x(data)  # warm
        torch.cuda.synchronize()
        routes, launches = dict(P.ROWS_ROUTES), dict(_build.LAUNCHES)
        spans.enable()
        try:
            op.solve_x(data)
        finally:
            spans.disable()
        torch.cuda.synchronize()
        moved = {k: v - routes[k] for k, v in P.ROWS_ROUTES.items()
                 if v != routes[k]}
        assert moved == {route: 1}, (n, moved)
        launched = {k: v - launches[k] for k, v in _build.LAUNCHES.items()
                    if v != launches[k]}
        assert launched == {"penta_rows": 1}, (n, launched)
        got = [s.fields for s in spans.take() if s.name == "repro.launch"]
        assert got == [{"kernel": "penta_rows", "route": route}], (n, got)
    assert not set(P.ROWS_ROUTES) & set(_build.LAUNCHES)


# Past the first three, the segmented row recurrence's edges (rows of 6,
# 31, 33, 1021 and 1024; 1 or 7 of them), rows of 8000, whose factors do
# not fit in shared memory beside a float64 row, and rows of 40000 (a
# float64 row fits no block: the device-memory route; float32 fits).
# Long rows come 3 or 7 at a time: a single noise row of ~1024 has no
# y-terms, so its solve divides the RHS by up to 1 + 16 beta (~4.5e4) and
# even the plain float32 result is about the scale-10 limit away from the
# float64 answer on its inputs.
@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", [(64, 64), (37, 29), (1, 8), (7, 6), (1, 31),
                                   (7, 33), (7, 1021), (7, 1024), (3, 8000),
                                   (3, 40000)])
def test_ch_rhs_xsweep(cuda, shape, dtype):
    ny, nx = shape
    # a row longer than the main path's is a longer box at its spacing (at
    # h = 2 pi / 8000, beta ~ 1e7 and float32 cannot solve the band)
    h = 2 * np.pi / min(nx, 1024)
    p = dict(dt=1e-3, D=0.6, gamma=0.01, inv_h2=h**-2, inv_h4=h**-4)
    beta = (2 / 3) * 0.6 * 0.01 * 1e-3 * h**-4
    fac_x = P.cyclic_penta_factor(
        *P.hyperdiffusion_diagonals(nx, beta, dtype), device=cuda)
    cn = _field(shape, getattr(torch, dtype), cuda, 4)
    cm = _field(shape, getattr(torch, dtype), cuda, 5)
    before = _build.LAUNCHES["ch_rhs_xsweep"]
    got = ops.ch_rhs_xsweep(cn, cm, fac_x, **p)
    assert _build.LAUNCHES["ch_rhs_xsweep"] == before + 1
    want = ops.ch_rhs_xsweep(cn, cm, fac_x, backend="torch", **p)
    _assert_close(got, want, dtype, 10)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_ch_rhs_xsweep_long_rows_streamed(cuda, dtype):
    """Rows of 40000 in chunks of one row: each chunk is one launch and the
    result equals the monolithic call bit for bit (the route depends on nx
    and the dtype alone)."""
    from repro_torch.kernels.fused_ch import xsweep_rows_per_block
    from repro_torch.launch.stream import stream_ch_rhs_xsweep

    ny, nx = 3, 40000
    smem, sms = _build.device_info(cuda)
    route = xsweep_rows_per_block(nx, getattr(torch, dtype).itemsize, ny, smem,
                                  sms).route
    assert route == ("global" if dtype == "float64" else "tile")
    h = 2 * np.pi / 1024
    p = dict(dt=1e-3, D=0.6, gamma=0.01, inv_h2=h**-2, inv_h4=h**-4)
    beta = (2 / 3) * 0.6 * 0.01 * 1e-3 * h**-4
    fac_x = P.cyclic_penta_factor(
        *P.hyperdiffusion_diagonals(nx, beta, dtype), device=cuda)
    cn = _field((ny, nx), getattr(torch, dtype), cuda, 4)
    cm = _field((ny, nx), getattr(torch, dtype), cuda, 5)
    want = ops.ch_rhs_xsweep(cn, cm, fac_x, **p)
    before = _build.LAUNCHES["ch_rhs_xsweep"]
    got = stream_ch_rhs_xsweep(cn, cm, fac_x, chunk_rows=1, streams=2, **p)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ch_rhs_xsweep"] == before + ny
    assert torch.equal(got, want)


# The staged tile of the RHS at its edges: whole and ragged tiles, one row
# or column (the halo wraps onto itself: the modulo), a tile smaller than
# its halo, and 524281 rows (16384 tiles in grid.x).
RHS_SHAPES = [(64, 64), (37, 29), (1, 8), (1024, 1024), (1021, 1019), (1, 1),
              (8, 1), (3, 5), (524281, 8)]


def _rhs_inputs(shape, dtype, cuda):
    h = 2 * np.pi / min(shape[1], 1024)
    p = dict(dt=1e-3, D=0.6, gamma=0.01, inv_h2=h**-2, inv_h4=h**-4)
    cn = _field(shape, getattr(torch, dtype), cuda, 6)
    cm = _field(shape, getattr(torch, dtype), cuda, 7)
    return cn, cm, p


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", RHS_SHAPES)
def test_ch_rhs(cuda, shape, dtype):
    cn, cm, p = _rhs_inputs(shape, dtype, cuda)
    before = _build.LAUNCHES["ch_rhs"]
    got = ops.ch_rhs(cn, cm, **p)
    assert _build.LAUNCHES["ch_rhs"] == before + 1
    _assert_close(got, ops.ch_rhs(cn, cm, backend="torch", **p), dtype, 10)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize(("shape", "chunk"), [((1024, 1024), 128), ((37, 29), 1),
                                              ((3, 5), 1)])
def test_ch_rhs_streamed_and_fused(cuda, shape, chunk, dtype):
    """Row chunks of the RHS equal the monolithic launch bit for bit, one
    launch a chunk; and the RHS equals the one the fused kernel assembles
    (``ch_rhs_xsweep`` with the identity band, whose solve is exact), bit
    for bit where the fused kernel applies (nx >= 6)."""
    from repro_torch.kernels.penta import CyclicPentaFactors, PentaFactors
    from repro_torch.launch.stream import stream_ch_rhs

    cn, cm, p = _rhs_inputs(shape, dtype, cuda)
    want = ops.ch_rhs(cn, cm, **p)
    before = _build.LAUNCHES["ch_rhs"]
    got = stream_ch_rhs(cn, cm, chunk_rows=chunk, streams=4, **p)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["ch_rhs"] == before + shape[0] // chunk
    assert torch.equal(got, want)
    nx = shape[1]
    if nx < 6:
        return
    zero = torch.zeros(nx, dtype=cn.dtype, device=cuda)
    one = torch.ones(nx, dtype=cn.dtype, device=cuda)
    identity = CyclicPentaFactors(
        PentaFactors(zero, zero, one, zero, zero),
        torch.zeros((nx, 4), dtype=cn.dtype, device=cuda),
        torch.eye(4, dtype=cn.dtype, device=cuda),
        torch.zeros((nx, 4), dtype=cn.dtype, device=cuda))
    assert torch.equal(ops.ch_rhs_xsweep(cn, cm, identity, **p), want)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(64, 64), (37, 29)])
@pytest.mark.parametrize("bc", ["periodic", "np"])
@pytest.mark.parametrize("point_fn", [weighted_point_fn, cube_laplacian_point_fn])
def test_stencil1d_batch(cuda, point_fn, bc, shape, dtype):
    """Along x (contiguous lines) and along y (the transposed view, read in
    place through the kernel's strides)."""
    data = _field(shape, dtype, cuda, 8)
    w = _field((5,), dtype, cuda, 9).cpu().numpy()
    init = _field(shape, dtype, cuda, 10) if bc == "np" else None
    kw = dict(coeffs=w, extents=dict(left=3, right=1)) \
        if point_fn is cube_laplacian_point_fn else dict(extents=dict(left=3, right=1))
    fn = point_fn if point_fn is cube_laplacian_point_fn else w
    plan = create(fn, shape, mode="batch", bc=bc, dtype=dtype, **kw)
    plain = create(fn, shape, mode="batch", bc=bc, dtype=dtype, backend="torch", **kw)
    for along in (apply_along_x, apply_along_y):
        before = _build.LAUNCHES["stencil1d_batch"]
        got = along(plan, data, init)
        assert _build.LAUNCHES["stencil1d_batch"] == before + 1
        assert got.is_contiguous()
        _assert_close(got, along(plain, data, init), dtype, 10)


# Shapes: tiles whole and ragged (61 x 67 x 71), small, and extents below
# the halos.  Halos: the 27-point box, asymmetric ones, halos wider than an
# extent (the modulo wrap: 5 > 3 along x, 4 > 3 along y on the (2, 3, 3)
# box), and ones too wide for the shared-memory ring in float64 (the
# direct route; float32 fits it).  Coefficients: dense, and with most taps
# zero; each summed over every window and over its non-zero taps.
S3_CASES = [(shape, halos)
            for shape in ((16, 16, 32), (7, 11, 13), (61, 67, 71), (2, 3, 3))
            for halos in ((1, 1, 1, 1, 1, 1), (0, 2, 1, 0, 2, 1),
                          (2, 0, 4, 1, 0, 5))]
S3_CASES += [(shape, (12, 12, 12, 12, 0, 0)) for shape in ((7, 11, 13), (2, 3, 3))]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("bc", ["periodic", "np"])
@pytest.mark.parametrize(("shape", "halos"), S3_CASES)
def test_stencil3d(cuda, shape, halos, bc, dtype):
    fr, bk, tp, bt, lf, rt = halos
    n = (fr + bk + 1) * (tp + bt + 1) * (lf + rt + 1)
    data = _field(shape, dtype, cuda, 11)
    coeffs = _field((n,), dtype, cuda, 12)
    sparse = coeffs.clone()
    sparse[torch.arange(n, device=cuda) % 5 != 0] = 0.0
    init = _field(shape, dtype, cuda, 13) if bc == "np" else None
    for point_fn in (weighted_point_fn, cube_laplacian_point_fn):
        for c in (coeffs, sparse):
            kw = dict(point_fn=point_fn, halos=halos, bc=bc)
            want = ops.stencil_apply_3d(data, c, init, backend="torch", **kw)
            # every window, then the non-zero taps (None past 32 of them)
            for taps in (None, nonzero_taps(c.cpu().numpy(), halos)):
                before = _build.LAUNCHES["stencil3d"]
                got = ops.stencil_apply_3d(data, c, init, taps=taps, **kw)
                assert _build.LAUNCHES["stencil3d"] == before + 1
                _assert_close(got, want, dtype, 10)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("bc", ["periodic", "np"])
def test_stencil3d_laplacian_plan_256(cuda, bc, dtype):
    """The 3D run's 7-point plan at 256^3 through compute (its Create-time
    taps), np with out_init."""
    import repro_torch as rt

    shape = (256, 256, 256)
    lap = create("laplacian", shape, bc=bc, h=2 * np.pi / 256, dtype=dtype)
    plain = create("laplacian", shape, bc=bc, h=2 * np.pi / 256, dtype=dtype,
                   backend="torch")
    assert len(lap.taps.offsets) == 7
    data = _field(shape, dtype, cuda, 24)
    init = _field(shape, dtype, cuda, 25) if bc == "np" else None
    before = _build.LAUNCHES["stencil3d"]
    got = rt.compute(lap, data, init)
    assert _build.LAUNCHES["stencil3d"] == before + 1
    _assert_close(got, rt.compute(plain, data, init), dtype, 10)


# z windows of the 3D stencil: the path's slabs of 32 planes at 256^3 and
# ragged windows of 61 x 67 x 71, on the tile route (the 27-point box) and
# the direct route (front = back = 13: the ring of 29 planes does not fit
# in float64; in float32 the same halos take the tile route).
S3_WINDOWS = [((256, 256, 256), [(k, k + 32) for k in range(0, 256, 32)]),
              ((61, 67, 71), [(0, 1), (1, 7), (7, 30), (30, 60), (60, 61)])]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("bc", ["periodic", "np"])
@pytest.mark.parametrize("halos", [(1,) * 6, (13, 13, 0, 0, 0, 0)],
                         ids=["box", "z13"])
@pytest.mark.parametrize(("shape", "windows"), S3_WINDOWS,
                         ids=["256", "61x67x71"])
def test_stencil3d_windows(cuda, shape, windows, halos, bc, dtype):
    """Each window of planes, launched into one output, equals the whole
    field's launch bit for bit (its halo planes read from the whole field;
    np's interior tested with the global k)."""
    from repro_torch.kernels.stencil3d import stencil3d_cuda, stencil3d_geometry

    fr, bk, tp, bt, lf, rt = halos
    n = (fr + bk + 1) * (tp + bt + 1) * (lf + rt + 1)
    smem, sms = _build.device_info(cuda)
    route = stencil3d_geometry(shape, halos, dtype.itemsize, smem, sms).route
    assert route == ("direct" if fr == 13 and dtype == torch.float64 else "tile")
    data = _field(shape, dtype, cuda, 26)
    coeffs = _field((n,), dtype, cuda, 27)
    taps = nonzero_taps(coeffs.cpu().numpy(), halos)
    init = _field(shape, dtype, cuda, 28) if bc == "np" else None
    kw = dict(halos=halos, bc=bc, taps=taps)
    want = stencil3d_cuda(data, coeffs, init, **kw)
    got = torch.full_like(data, float("nan"))
    before = _build.LAUNCHES["stencil3d"]
    for w in windows:
        stencil3d_cuda(data, coeffs, init, planes=w, out=got, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["stencil3d"] == before + len(windows)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("cyclic", [True, False], ids=["cyclic", "plain"])
@pytest.mark.parametrize(("shape", "windows"), S3_WINDOWS,
                         ids=["256", "61x67x71"])
def test_penta_mid_windows(cuda, shape, windows, cyclic, dtype):
    """Each window of planes of the plane sweep equals the whole call bit
    for bit (route, columns a block and L depend on M, N and the dtype)."""
    M = shape[1]
    fac = P.cyclic_penta_factor(*P.diffusion_diagonals(M, 1.7, dtype),
                                device=cuda)
    band, w = (fac.band, fac.w) if cyclic else (fac.band, None)
    rhs = _field(shape, getattr(torch, dtype), cuda, 29)
    want = P.penta_mid_cuda(band, rhs, w)
    got = torch.full_like(rhs, float("nan"))
    before = _build.LAUNCHES["penta_mid"]
    for win in windows:
        P.penta_mid_cuda(band, rhs, w, planes=win, out=got)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["penta_mid"] == before + len(windows)
    assert torch.equal(got, want)


@pytest.mark.parametrize("bc", ["periodic", "np"])
def test_streamed_3d_plan_and_operator(cuda, bc):
    """The 256^3 float64 path with streams=4 and a 20 MB budget: the
    Laplacian plan in 8 z-slabs and each sweep of the diffusion operator in
    8 chunks (rows, planes, columns), every chunk one launch, each result
    equal to the monolithic one bit for bit."""
    shape, budget = (256, 256, 256), 20_000_000
    knobs = dict(streams=4, max_tile_bytes=budget)
    h = 2 * np.pi / 256
    data = _field(shape, torch.float64, cuda, 30)
    init = _field(shape, torch.float64, cuda, 31) if bc == "np" else None
    lap = lambda k: create("laplacian", shape, bc=bc, h=h, **k)
    op = lambda k: create("diffusion", shape, mode="adi", bc=bc, alpha=1.7, **k)
    cases = [("laplacian", "stencil3d", lap, lambda p: p.apply(data, init)),
             ("x-sweep", "penta_rows", op, lambda o: o.solve_x(data)),
             ("y-sweep", "penta_mid", op, lambda o: o.solve_y(data)),
             ("z-sweep", "penta_cols", op, lambda o: o.solve_z(data))]
    for name, kernel, make, run in cases:
        want = run(make({}))
        streamed = make(knobs)
        assert len(streamed.stream_pool) == 4
        before = dict(_build.LAUNCHES)
        got = run(streamed)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                    if v != before[k]}
        assert launched == {kernel: 8}, (name, launched)
        assert torch.equal(got, want), name


# (P, M, N).  The first two through a rank-3 ADI plan (every extent >= 6:
# the cyclic bands need it), also its x- and z-sweeps; the rest through the
# plane-layout solve alone: three 256^2 planes, ragged columns (1021, a
# column group of fewer than C), 7 columns of 1021 and 6000 rows (no tile
# of one column fits in float64: the plane sweep in device memory; four
# columns a block in float32).
MID_SHAPES = [(8, 16, 32), (6, 9, 7), (3, 256, 256), (2, 33, 1021),
              (1, 1021, 7), (2, 6000, 16)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", MID_SHAPES)
@pytest.mark.parametrize("bc", ["periodic", "np"])
def test_penta_mid_and_3d_sweeps(cuda, bc, shape, dtype):
    if min(shape) < 6:
        M = shape[1]
        fac = P.cyclic_penta_factor(
            *P.hyperdiffusion_diagonals(M, 3.0, dtype), device=cuda)
        solve, fac = ((P.cyclic_penta_solve_factored_mid, fac) if bc == "periodic"
                      else (P.penta_solve_factored_mid, fac.band))
        rhs = _field(shape, getattr(torch, dtype), cuda, 14)
        before = _build.LAUNCHES["penta_mid"]
        got = solve(fac, rhs)
        assert _build.LAUNCHES["penta_mid"] == before + 1
        _assert_close(got, solve(fac, rhs, backend="torch"), dtype, 100)
        return
    op = create("hyperdiffusion", shape, mode="adi", bc=bc, alpha=2.0,
                alpha_y=3.0, alpha_z=0.5, dtype=dtype)
    plain = create("hyperdiffusion", shape, mode="adi", bc=bc, alpha=2.0,
                   alpha_y=3.0, alpha_z=0.5, dtype=dtype, backend="torch")
    rhs = _field(shape, getattr(torch, dtype), cuda, 14)
    before = _build.LAUNCHES["penta_mid"]
    got = op.solve_y(rhs)
    assert _build.LAUNCHES["penta_mid"] == before + 1
    _assert_close(got, plain.solve_y(rhs), dtype, 100)
    for sweep in ("solve_x", "solve_z"):
        _assert_close(getattr(op, sweep)(rhs), getattr(plain, sweep)(rhs), dtype, 100)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(1024, 1024), (1021, 1019), (6, 5), (2, 3),
                                   (1, 1), (2, 2), (3, 3), (31, 33), (33, 31),
                                   (1, 37), (40, 2)])
def test_weno5_advect(cuda, shape, dtype):
    """1024^2, ragged, extents below the 7-point support (the +-3 offsets
    wrap more than half a line; below 3 the general modulo), and extents
    around the 32 x 16 tile."""
    ny, nx = shape
    q, u, v = (_field(shape, dtype, cuda, s) for s in (15, 16, 17))
    u[::3] = 0.0  # u == 0 takes the right-biased branch in both versions
    kw = dict(dx=2 * np.pi / nx, dy=2 * np.pi / ny)
    before = _build.LAUNCHES["weno5_advect"]
    got = ops.weno_advect(q, u, v, **kw)
    assert _build.LAUNCHES["weno5_advect"] == before + 1
    _assert_close(got, ops.weno_advect(q, u, v, backend="torch", **kw), dtype, 10)


def test_streamed_equals_monolithic_bit_for_bit(cuda):
    """Every streamed executor at 1024^2 float64 with streams=4 and a
    budget of 8 chunks: the result equals the monolithic launch bit for bit
    and each chunk is one launch of the kernel."""
    from repro_torch.core.cahn_hilliard import CahnHilliardADI, CHConfig
    from repro_torch.launch.stream import n_chunks_for

    n, budget = 1024, 1_100_000
    knobs = dict(streams=4, max_tile_bytes=budget)
    assert n_chunks_for(n, n, 8, halos=(2, 2, 2, 2), max_tile_bytes=budget,
                        streams=4) == 8
    data = _field((n, n), torch.float64, cuda, 18)
    data2 = _field((n, n), torch.float64, cuda, 19)
    init = _field((n, n), torch.float64, cuda, 20)
    d4 = np.array([1.0, -4.0, 6.0, -4.0, 1.0])
    cases = []  # (name, kernel, run(plan-or-solver))
    for bc in ("periodic", "np"):
        cases.append((f"stencil2d {bc}", "stencil2d",
                      lambda k, bc=bc: create("biharmonic", (n, n), bc=bc, **k),
                      lambda p: p.apply(data, init)))
        for along in (apply_along_x, apply_along_y):
            cases.append((f"batch {along.__name__} {bc}", "stencil1d_batch",
                          lambda k, bc=bc: create(d4, (n, n), mode="batch",
                                                  bc=bc, **k),
                          lambda p, a=along: a(p, data, init)))
    adi = lambda k: create("hyperdiffusion", (n, n), mode="adi", alpha=3.0, **k)
    cases.append(("x-sweep", "penta_rows", adi, lambda op: op.solve_x(data)))
    cases.append(("y-sweep", "penta_cols", adi, lambda op: op.solve_y(data)))
    ch = lambda k: CahnHilliardADI(CHConfig(nx=n, ny=n, **k))
    cases.append(("ch_rhs", "ch_rhs", ch, lambda s: s.rhs(data, data2)))
    cases.append(("ch_rhs_xsweep", "ch_rhs_xsweep", ch,
                  lambda s: s._fused_xsweep(data, data2)))
    for name, kernel, make, run in cases:
        want = run(make({}))
        streamed = make(knobs)
        before = dict(_build.LAUNCHES)
        got = run(streamed)
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                    if v != before[k]}
        assert launched == {kernel: 8}, (name, launched)
        assert torch.equal(got, want), name


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["2d", "2d-x", "batch", "3d", "adi", "adi3d"])
def test_fft_plans_stay_on_card(cuda, case, dtype):
    """backend='fft' on a CUDA tensor: torch.fft on the card, the input's
    dtype, no kernel of the port launched, and within scale 50 of the same
    plan on the kernels (tests/test_torch_spectral.py holds it against the
    reference)."""
    shape, name, kw = {
        "2d": ((64, 61), "biharmonic", {}),
        "2d-x": ((33, 64), "laplacian", dict(mode="x")),
        "batch": ((16, 61), "hyperdiffusion", dict(mode="batch")),
        "3d": ((16, 17, 18), "laplacian", {}),
        "adi": ((64, 61), "hyperdiffusion", dict(mode="adi", alpha=0.2)),
        "adi3d": ((16, 17, 18), "diffusion", dict(mode="adi", alpha=0.3)),
    }[case]
    x = _field(shape, dtype, cuda, 19)
    fft = create(name, shape, backend="fft", dtype=dtype, device=cuda, **kw)
    kernel = create(name, shape, dtype=dtype, device=cuda, **kw)
    want = compute(kernel, x)
    _build.reset_launches()
    got = compute(fft, x)
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == dtype and got.shape == x.shape
    assert sum(_build.LAUNCHES.values()) == 0, dict(_build.LAUNCHES)
    _assert_close(got, want, dtype, 50)


# -- the stacked 2D launch (the serving engine's rank-2 buckets) -----------

STACK_CASES = [
    # (B, (ny, nx), operator or weights, dtype)
    (1, (1024, 1024), "biharmonic", torch.float64),
    (3, (1024, 1024), "biharmonic", torch.float64),
    (3, (1021, 1019), "laplacian", torch.float64),
    (5, (64, 64), "5x3", torch.float32),
    (64, (64, 64), "biharmonic", torch.float64),
    (80, (1024, 1024), "5x3", torch.float64),  # 81920 tiles: > 65535
    (7, (37, 29), "wide", torch.float64),  # the direct route
    (3, (64, 64), "cube", torch.float64),
    (4, (37, 29), "user", torch.float32),
]


def _stack_plan(op, shape, dtype, bc, cuda):
    if op == "5x3":
        w = np.random.default_rng(3).standard_normal((5, 3))
        return create(w, shape, bc=bc, dtype=dtype, device=cuda)
    if op in ("cube", "user"):
        fn, c = ((cube_laplacian_point_fn, np.linspace(-1.0, 1.0, 9))
                 if op == "cube" else (mixed_point_fn, [0.7, -1.3]))
        return create(fn, shape, bc=bc, dtype=dtype, device=cuda, coeffs=c,
                      extents=dict(left=1, right=1, top=1, bottom=1))
    if op == "wide":  # 881 rows of halo: no tile fits shared memory
        w = np.random.default_rng(4).standard_normal((881, 1))
        return create(w, shape, bc=bc, dtype=dtype, device=cuda)
    return create(op, shape, bc=bc, dtype=dtype, device=cuda)


@pytest.mark.parametrize("bc", ["periodic", "np"])
@pytest.mark.parametrize(("B", "shape", "op", "dtype"), STACK_CASES)
def test_stencil2d_stacked_equals_single_launches(cuda, B, shape, op, dtype, bc):
    plan = _stack_plan(op, shape, dtype, bc, cuda)
    stack = _field((B,) + shape, dtype, cuda, 5)
    inits = [None] if bc == "periodic" else [None, _field((B,) + shape, dtype,
                                                          cuda, 6)]
    for init in inits:
        before = _build.LAUNCHES["stencil2d"]
        got = plan.apply_stacked(stack, init)
        assert _build.LAUNCHES["stencil2d"] == before + 1
        torch.cuda.synchronize()
        for b in range(B):
            one = plan.apply(stack[b].clone(),
                             None if init is None else init[b].clone())
            assert torch.equal(got[b], one), b
        # the kernel against its plain version on the whole stack
        plain = ops.stencil_apply(stack, plan.coeffs, init, backend="torch",
                                  point_fn=plan.point_fn, bc=bc,
                                  **plan._halo_kwargs())
        _assert_close(got, plain, dtype, 10 if op != "wide" else 100)


def test_served_mixed_stream_bit_for_bit(cuda):
    """A served mixed stream on the card equals the port's sequential
    create/compute on the card, one stencil2d launch per stacked bucket."""
    from repro_torch.serve import ServeEngine
    from repro_torch.serve.cli import build_requests, sequential_reference

    requests = build_requests(24, seed=0, steps=2)
    with ServeEngine(max_batch=8, device=cuda) as engine:
        engine.solve_many(build_requests(4, seed=1, steps=2))  # warm
        _build.reset_launches()
        results = engine.solve_many(requests)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        stats = engine.stats()
    refs = sequential_reference(requests, device=cuda)
    assert [r.tag for r in results] == list(range(24))
    for res, ref in zip(results, refs):
        assert torch.equal(res.out, ref), res.tag
    assert stats["degraded"] == 0 and stats["retries"] == 0

    def buckets(rank):  # a bucket of n results counts 1/n for each
        return round(sum(1 / r.batch_size for r in results
                         if len(r.request.shape) == rank and r.request.mode is None))

    # one launch a step per stacked bucket; the ADI members one by one
    assert launches["stencil2d"] == 2 * buckets(2) > 0
    assert launches["stencil1d_batch"] == 2 * buckets(1) > 0
    assert launches["penta_rows"] == launches["penta_cols"] == 2 * 6


def test_served_injected_kernel_failure_degrades(cuda):
    from repro_torch.runtime import chaos
    from repro_torch.serve import ServeEngine, SolveRequest

    f = _field((64, 64), torch.float64, cuda, 7)
    g = _field((48, 48), torch.float64, cuda, 8)
    plan = chaos.FaultPlan(seed=1).add("kernel.dispatch", "backend_error", at=1)
    with ServeEngine(device=cuda) as engine:
        with chaos.injected(plan):
            bad = engine.solve(SolveRequest(field=f, operator="laplacian"))
            ok = engine.solve(SolveRequest(field=g, operator="biharmonic"))
        stats = engine.stats()
    assert bad.degraded and not ok.degraded and stats["degraded"] == 1
    kernel = compute(create("laplacian", (64, 64), device=cuda), f).cpu()
    _assert_close(bad.out, kernel, torch.float64, 10)
    assert torch.equal(ok.out, compute(create("biharmonic", (48, 48),
                                              device=cuda), g).cpu())


# ---------------------------------------------------------------------------
# Create-time tuning on the card: every launch geometry a tuned plan or
# operator may race computes what the default geometry computes, bit for
# bit, at the path's shapes; tuned fp64 plans and operators equal the
# untuned ones unless fft wins; a second cached Create measures nothing
# ---------------------------------------------------------------------------


def _cube_lap():
    return np.array([[0.0, 1, 0], [1, -4, 1], [0, 1, 0]])


# name -> (create args, create kwargs, shape)
_PLAN_CASES = {
    "2d biharmonic 1024^2": (("biharmonic", (1024, 1024)), {}, (1024, 1024)),
    "2d 5x3 np 1021x1019": ((np.arange(15.0).reshape(5, 3) - 7.0, (1021, 1019)),
                            dict(bc="np"), (1021, 1019)),
    "2d cube 1024^2": ((cube_laplacian_point_fn, (1024, 1024)),
                       dict(coeffs=_cube_lap().ravel(),
                            extents=dict(left=1, right=1, top=1, bottom=1)),
                       (1024, 1024)),
    "2d user 1024^2": ((mixed_point_fn, (1024, 1024)),
                       dict(coeffs=np.array([0.5]),
                            extents=dict(left=1, right=1)), (1024, 1024)),
    "2d biharmonic float32": (("biharmonic", (1024, 1024)),
                              dict(dtype="float32"), (1024, 1024)),
    "batch D4 1024^2": (("biharmonic", (1024, 1024)), dict(mode="batch"),
                        (1024, 1024)),
    "batch cube 1024^2": ((cube_laplacian_point_fn, (1024, 1024)),
                          dict(mode="batch", coeffs=np.array([1.0, -2, 1]),
                               extents=dict(left=1, right=1)), (1024, 1024)),
    "batch D2 np (4096, 512)": (("laplacian", (4096, 512)),
                                dict(mode="batch", bc="np"), (4096, 512)),
    "3d laplacian 256^3": (("laplacian", (256, 256, 256)), {}, (256,) * 3),
    "3d laplacian np 61x67x71": (("laplacian", (61, 67, 71)), dict(bc="np"),
                                 (61, 67, 71)),
}


@pytest.mark.parametrize("case", sorted(_PLAN_CASES))
def test_every_plan_geometry_is_bit_for_bit_the_default(cuda, case):
    import dataclasses

    args, kw, shape = _PLAN_CASES[case]
    plan = create(*args, device=cuda, **kw)
    dtype = plan.coeffs.dtype

    def field(seed):  # in the layout the plan is tuned on
        if kw.get("mode") == "batch":  # the lines of apply_along_y
            return _field(shape[::-1], dtype, cuda, seed).T
        return _field(shape, dtype, cuda, seed)

    data = field(31)
    init = field(32) if plan.bc == "np" else None
    want = plan.apply(data, init)
    geos = plan._geometry_candidates(shape)
    assert geos, f"{case}: no geometry to race"
    for g in geos:
        other = dataclasses.replace(plan, geometry=g)
        assert other.grid_problems(shape) == []
        before = dict(_build.LAUNCHES)
        got = other.apply(data, init)
        assert _build.LAUNCHES[plan.kernel_name] == \
            before[plan.kernel_name] + 1
        assert torch.equal(got, want), (case, g)


# (layout, shape) of each sweep at the path's shapes, cyclic and not (the
# column sweep's cluster route, 4096^2, offers no geometry to race)
_SWEEP_CASES = {
    "cols 1024^2": ("cols", (1024, 1024)),
    "cols 3D z (256, 65536)": ("cols", (256, 256 * 256)),
    "rows 1024^2": ("rows", (1024, 1024)),
    "rows 3D x (65536, 256)": ("rows", (256 * 256, 256)),
    "rows 1021x1019": ("rows", (1021, 1019)),
    "mid 256^3": ("mid", (256, 256, 256)),
    "mid 61x67x71": ("mid", (61, 67, 71)),
}


@pytest.mark.parametrize("cyclic", [True, False])
@pytest.mark.parametrize("case", sorted(_SWEEP_CASES))
def test_every_sweep_geometry_is_bit_for_bit_the_default(cuda, case, cyclic):
    layout, shape = _SWEEP_CASES[case]
    M = {"cols": shape[0], "rows": shape[-1], "mid": shape[1]}[layout]
    bands = P.hyperdiffusion_diagonals(M, 0.3, torch.float64)
    fac = (P.cyclic_penta_factor if cyclic else P.penta_factor)(*bands,
                                                                device=cuda)
    band, w = (fac.band, fac.w) if cyclic else (fac, None)
    rhs = _field(shape, torch.float64, cuda, 33)
    smem, sms = _build.device_info(cuda)
    if layout == "cols":
        launch, geos = P.penta_cols_cuda, P.cols_geometries(M, 8, smem)
    elif layout == "rows":
        launch = P.penta_rows_cuda
        geos = P.rows_geometries(M, 8, shape[0], smem, sms, cyclic=cyclic)
    else:
        launch, geos = P.penta_mid_cuda, P.mid_geometries(*shape, 8, smem)
    want = launch(band, rhs, w)
    assert geos, f"{case}: no geometry to race"
    for g in geos:
        assert torch.equal(launch(band, rhs, w, geometry=g), want), (case, g)


def test_tuned_plans_and_operators_bit_for_bit_untuned(cuda, tmp_path):
    """Tuned fp64 plans and operators (``tune='force'``, fft in the race
    under 'auto') equal the untuned ones bit for bit whenever the winner is
    not fft, and within the fft scale 50 when it is; a second
    ``tune='cached'`` Create measures nothing and gets the same winners."""
    from repro_torch import tune as T

    cases = [
        (("biharmonic", (1024, 1024)), {}),
        (("laplacian", (1024, 1024)), dict(mode="batch")),
        (("laplacian", (128, 128, 128)), {}),
        (("hyperdiffusion", (1024, 1024)), dict(mode="adi", alpha=0.5)),
        (("diffusion", (128, 128, 128)), dict(mode="adi", alpha=1.7)),
    ]
    for args, kw in cases:
        shape = args[1]
        x = _field(shape, torch.float64, cuda, 34)
        untuned = create(*args, device=cuda, **kw)
        T.reset_stats()
        tuned = create(*args, device=cuda, tune="force",
                       tune_cache=T.TuneCache(tmp_path), **kw)
        assert T.stats.measure_runs > 0, args
        assert len(T.stats.races) >= 1
        cfgs = ([tuned.x_cfg, tuned.y_cfg] + (
            [tuned.z_cfg] if len(shape) == 3 else [])
                if kw.get("mode") == "adi" else [dict(backend=tuned.backend)])
        fft = any(c["backend"] == "fft" for c in cfgs)
        got, want = compute(tuned, x), compute(untuned, x)
        if fft:
            _assert_close(got, want, torch.float64, 50)
        else:
            assert torch.equal(got, want), (args, cfgs)
        T.reset_stats()
        again = create(*args, device=cuda, tune="cached",
                       tune_cache=T.TuneCache(tmp_path), **kw)
        assert T.stats.measure_runs == 0 and T.stats.cache_hits >= 1, args
        if kw.get("mode") == "adi":
            assert (again.x_cfg, again.y_cfg) == (tuned.x_cfg, tuned.y_cfg)
        else:
            assert (again.backend, again.geometry) == (tuned.backend,
                                                       tuned.geometry)


def test_tuned_streamed_solver_bit_for_bit_untuned(cuda, tmp_path,
                                                   monkeypatch):
    """The streamed fused step's (streams x chunk_rows) race on the card:
    the tuned solver's steps equal the untuned streamed solver's."""
    from repro_torch import tune as T
    from repro_torch.core.cahn_hilliard import CahnHilliardADI, CHConfig, ch_evolve

    monkeypatch.setenv(T.ENV_VAR, str(tmp_path))
    n = 256
    kw = dict(nx=n, ny=n, streams=4, max_tile_bytes=n * n * 8 // 8,
              backend="cuda")
    s0 = CahnHilliardADI(CHConfig(**kw))
    T.reset_stats()
    s1 = CahnHilliardADI(CHConfig(**kw, tune="force"))
    assert any(r["kernel"] == "ch_stream_geometry" for r in T.stats.races)
    # a smooth start field: grid-scale noise overflows the eq. 3 bootstrap
    # at this grid (ROADMAP.md, Faults)
    x = torch.arange(n, device=cuda, dtype=torch.float64) * (2 * np.pi / n)
    c0 = 0.1 * torch.sin(x)[:, None] * torch.cos(2 * x)[None, :] + 0.05 * \
        torch.cos(3 * x[:, None] + x[None, :])
    a0, _ = ch_evolve(s0, c0, 10)
    a1, _ = ch_evolve(s1, c0, 10)
    assert bool(torch.isfinite(a0).all())
    assert torch.equal(a0, a1), (s1._streams_eff, s1._chunk_rows_eff)


@pytest.mark.parametrize("family", ["2d", "batch", "3d", "adi", "adi3d"])
def test_infeasible_tuned_geometry_is_reported(cuda, family):
    """A geometry the card cannot launch for the shape, on each family, is
    reported by ``grid_problems`` on the host against the card's own
    limits, before any launch."""
    import dataclasses

    if family == "2d":
        # halos of 450 + 450: a 32 x 932 float64 tile, 238592 bytes
        plan = create(np.ones((1, 901)), (8, 1024), device=cuda)
        bad = dataclasses.replace(plan, geometry={"route": "tile"})
        shape = (8, 1024)
    elif family == "batch":
        plan = create(np.ones(11), (4, 512), mode="batch", device=cuda)
        # a window of 11 is wider than the 'y' route's register march
        bad = dataclasses.replace(plan, geometry={"route": "y", "param": 16})
        shape = (4, 512)
    elif family == "3d":
        plan = create("laplacian", (8, 8, 8), device=cuda)
        bad = dataclasses.replace(plan, geometry={"route": "tile", "zc": 0})
        shape = (8, 8, 8)
    elif family == "adi":
        plan = create("hyperdiffusion", (32, 40000), mode="adi", alpha=0.2,
                      device=cuda)
        bad = dataclasses.replace(plan, x_cfg={
            "backend": "auto", "geometry": {"rows": 8, "depth": 2}})
        shape = (32, 40000)
    else:
        plan = create("diffusion", (8, 12, 16), mode="adi", alpha=0.2,
                      device=cuda)
        bad = dataclasses.replace(plan, y_cfg={
            "backend": "auto", "geometry": {"cols": 3}})
        shape = (8, 12, 16)
    assert plan.grid_problems(shape) == []
    problems = bad.grid_problems(shape)
    assert len(problems) == 1 and "tuned geometry" in problems[0]
    assert "off the card" not in problems[0]


def test_plan_rule_flags_a_geometry_over_shared_memory(cuda):
    """The reference's infeasible ``tile`` on the card: a tile route whose
    halo overflows shared memory is flagged by the plan rule at the lint
    knob's severity; the direct route at the same halo is not."""
    import dataclasses

    from repro_torch import analysis as an

    plan = create(np.ones((1, 901)), (8, 1024), device=cuda, lint="off")
    bad = dataclasses.replace(plan, geometry={"route": "tile"})
    findings = an.check_plan(bad, (8, 1024))
    assert [f.rule for f in findings] == ["launch_geometry_feasible"]
    assert "shared memory" in findings[0].message
    with pytest.raises(an.LintError):
        an.surface(findings, "error")
    assert an.check_plan(plan, (8, 1024)) == []
    ok = dataclasses.replace(plan, geometry={"route": "direct"})
    assert an.check_plan(ok, (8, 1024)) == []


def test_streamed_objects_race_no_geometry(cuda, tmp_path):
    """A plan or operator whose Compute streams at the Create shape races
    no launch geometry (the streamed executor ignores one): its races hold
    the default geometry and fft alone."""
    from repro_torch import tune as T

    knobs = dict(streams=4, max_tile_bytes=1_100_000, tune="force",
                 tune_cache=T.TuneCache(tmp_path), device=cuda)
    T.reset_stats()
    plan = create("biharmonic", (1024, 1024), **knobs)
    op = create("hyperdiffusion", (1024, 1024), mode="adi", alpha=0.5,
                **knobs)
    for r in T.stats.races:
        for m in r["measured"]:
            assert not m["config"].get("geometry"), r
            assert set(m["config"]) <= {"backend", "geometry"}, r
    assert plan.geometry is None
    assert op.x_cfg["geometry"] is None and op.y_cfg["geometry"] is None


# -- the card: a one-rank NCCL world ----------------------------------------

_NCCL_SCRIPT = textwrap.dedent("""
    import dataclasses
    import numpy as np, torch, torch.distributed as dist
    import repro_torch as rt
    from repro_torch.core import domain as D
    from repro_torch.core.cahn_hilliard import CHConfig, CahnHilliardADI
    from repro_torch.core.dist_ch import DistributedCahnHilliard
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.launch.stream import stream_stencil_apply_dist
    from repro_torch.util import tolerance_for

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    dd = D.DomainDecomposition(make_mesh_for())
    rng = np.random.default_rng(0)
    f = torch.as_tensor(rng.standard_normal((256, 192)), device="cuda")
    w = np.zeros((5, 5)); w[2, :] += [1, -4, 6, -4, 1]; w[:, 2] += [1, -4, 6, -4, 1]
    tol = tolerance_for("float64", scale=10)
    for bc in ("periodic", "np"):
        plan = rt.create(w, (256, 192), bc=bc, mode="xy")
        want = plan.apply(f)
        for overlap, n in ((True, 5), (False, 1)):
            _build.reset_launches()
            got = D.distributed_stencil_apply(plan, f, dd, overlap=overlap)
            assert _build.LAUNCHES["stencil2d"] == n, _build.LAUNCHES
            err = float((got.to_local() - want).abs().max())
            assert err <= tol["atol"] + tol["rtol"] * float(want.abs().max())
        s = stream_stencil_apply_dist(plan, f, dd, chunk_rows=32)
        one = D.distributed_stencil_apply(plan, f, dd, overlap=False)
        assert torch.equal(s.to_local(), one.to_local())

    # a cube plan (device tag) and a point function with CUDA source
    # through the same padded-block launch; a plain Python point function
    # raises on the card
    from repro_torch.core.cahn_hilliard import cube_laplacian_point_fn
    from repro_torch.kernels.stencil2d import cuda_point_fn

    @cuda_point_fn("template <typename T> __device__ T point_fn("
                   "const T* w, const T* c) { return w[0] * w[1] - c[0] * w[2]; }")
    def mixed(windows, coeffs):
        return windows[0] * windows[1] - coeffs[0] * windows[2]

    def plain(windows, coeffs):  # translated at Create
        return windows[0] - coeffs[0] * windows[2] ** 3

    def refused(windows, coeffs):
        return windows[0].sum() * coeffs[0]

    ext = dict(left=1, right=1, top=1, bottom=1)
    for fn, coeffs in ((cube_laplacian_point_fn, np.arange(9.0)),
                       (mixed, np.array([0.5])), (plain, np.array([0.5]))):
        plan = rt.create(fn, (256, 192), mode="xy", coeffs=coeffs, extents=ext)
        want = plan.apply(f)
        for overlap in (True, False):
            _build.reset_launches()
            got = D.distributed_stencil_apply(plan, f, dd, overlap=overlap)
            assert _build.LAUNCHES["stencil2d"] >= 1, _build.LAUNCHES
            err = float((got.to_local() - want).abs().max())
            assert err <= tol["atol"] + tol["rtol"] * float(want.abs().max()), err
    # Create refuses it on the card; a plan made for the plain path and
    # asked for the kernel raises at the launch
    plan = rt.create(refused, (256, 192), mode="xy", coeffs=np.array([0.5]),
                     extents=ext, backend="torch")
    try:
        D.distributed_stencil_apply(dataclasses.replace(plan, backend="auto"),
                                    f, dd)
    except NotImplementedError as e:
        assert "aten.sum.default" in str(e), e
    else:
        raise AssertionError("a refused point function ran on the card")
    cfg = CHConfig(nx=128, ny=128)
    c0 = torch.as_tensor(rng.uniform(-0.1, 0.1, (128, 128)), device="cuda")
    single = CahnHilliardADI(cfg)
    c1 = single.initial_step(c0)
    solver = DistributedCahnHilliard(cfg, dd)
    _build.reset_launches()
    a, b = solver.step(c1, c0)
    assert _build.LAUNCHES["ch_rhs"] == 1 and _build.LAUNCHES["penta_rows"] == 1
    assert _build.LAUNCHES["penta_cols"] == 1, _build.LAUNCHES
    want, _ = single.step(c1, c0)
    tol = tolerance_for("float64", scale=100)
    err = float((a.to_local() - want).abs().max())
    assert err <= tol["atol"] + tol["rtol"] * float(want.abs().max()), err
    # the eq. 3 bootstrap through the plans' padded-block launches and the
    # sharded diagnostics, against the single-device results
    from repro_torch.core.cahn_hilliard import coarsening_metrics
    boot = solver.initial_step(c0)
    err = float((boot.to_local() - c1).abs().max())
    assert err <= tol["atol"] + tol["rtol"] * float(c1.abs().max()), err
    D.reset_collectives()
    got = [float(v) for v in solver.metrics()(a)]
    assert D.COLLECTIVES["all_reduce"] == 0, D.COLLECTIVES  # one rank
    want = [float(v) for v in coarsening_metrics(cfg)(a.to_local())]
    scales = [abs(want[0]), abs(want[1]), abs(want[2]),
              cfg.lx * cfg.ly * float(a.to_local().square().mean().sqrt())]
    for g, w, sc in zip(got, want, scales):
        assert abs(g - w) <= 1e-12 * sc, (got, want)
    dist.destroy_process_group()
    print("NCCL-OK")
""")


def test_one_rank_nccl_world(cuda):
    """The distribution (``repro_torch.core.domain``, ``core.dist_ch``,
    ``stream_stencil_apply_dist``) in a one-rank NCCL world, in a
    subprocess of its own: the distributed stencil (weighted, cube,
    CUDA-source and translated point functions; one the translator
    refuses raises) and CH step, its eq. 3 bootstrap and its sharded
    diagnostics against the single-device kernels, their launches, the
    streamed apply bit for bit the unstreamed one."""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-c", _NCCL_SCRIPT], capture_output=True, text=True,
        timeout=300, cwd=root,
        env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert proc.returncode == 0 and "NCCL-OK" in proc.stdout, proc.stderr[-3000:]


# ---------------------------------------------------------------------------
# the audit gate on the card (repro_torch.analysis)
# ---------------------------------------------------------------------------

def test_card_audit_is_clean_on_cuda_cells(cuda):
    """The invariant and cost audits of a subset of the cuda cells on the
    card: the kernels' Computes, the fused CH step on the kernel path with
    its in-place evolve driver, the sync-debug call and the profiler's
    kernel list of the transpose-free families."""
    from repro_torch.analysis import audit as A

    kw = dict(operators=("laplacian", "hyperdiffusion"),
              families=("stencil2d", "adi2d", "fused_ch"), backends=("cuda",),
              device="cuda")
    cache = A.CellArtifacts()
    report = A.run_audit(cache=cache, **kw)
    ran = [r for r in report.results if r.skipped is None]
    assert report.ok, [r.to_dict() for r in report.violations]
    assert {(r.family, r.operator) for r in ran if r.rules[0] != "rebuild_budget"} == {
        ("stencil2d", "laplacian"), ("stencil2d", "hyperdiffusion"),
        ("adi2d", "hyperdiffusion"), ("fused_ch", "hyperdiffusion")}
    cost = A.run_cost_audit(cache=cache, **kw)
    assert cost.ok, [r.to_dict() for r in cost.violations]
    for r in cost.results:
        if r.skipped is None:
            # a launch counts the floor's flops: the kernels' cells sit at
            # the closed form
            assert 0.9 <= r.measured.flops / r.expected.flops <= 1.1, r.cell


def test_kernel_list_is_read_in_a_fresh_process(cuda):
    """Where this process's profiler windows record nothing, the audit
    reads a cuda cell's kernel list in a process of its own: the ADI
    step's list there holds its two sweep kernels and no copy."""
    from repro_torch.analysis import audit as A

    names = A._fresh_kernel_names("adi2d", "hyperdiffusion", "cuda",
                                  (32, 32), None)
    assert names is not None
    assert any("penta" in n for n in names), names
    assert not any("copy" in n.lower() or "transpose" in n.lower()
                   for n in names), names


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("seed", list(SEED_RULES))
def test_each_seed_fails_closed_on_the_card(cuda, seed, backend):
    from repro_torch.analysis import audit as A

    rule, family, op = SEED_RULES[seed]
    kw = dict(operators=(op,), families=(family,), backends=(backend,),
              seed_violation=seed, device="cuda")
    if seed in A.COST_SEEDS:
        rep = A.run_cost_audit(**kw)
    else:
        rep = A.run_audit(retrace=False, **kw)
    assert not rep.ok
    assert rule in {f.rule for r in rep.results for f in r.findings}


def test_in_place_evolve_reads_the_allocator(cuda):
    """On the card the rule reads the allocator's cumulative count, which
    a cached block reused still raises: the solver's driver passes, one
    that allocates a new carry each step fails."""
    from repro_torch.analysis import RULES
    from repro_torch.core.cahn_hilliard import (
        CahnHilliardADI, CHConfig, deep_quench_ic)

    solver = CahnHilliardADI(CHConfig(nx=64, ny=64))
    c0 = deep_quench_ic(64, 64, seed=0)
    c1 = solver.initial_step(c0)
    ctx = {"args": (c1, c0), "steps": 4, "increment": solver._increment}
    assert RULES["in_place_evolve"].check(solver.make_evolve, ctx) == []

    def make_copying(k):
        def evolve(a, b):
            for _ in range(k):
                a, b = solver.step(a, b)
            return a, b
        return evolve

    findings = RULES["in_place_evolve"].check(make_copying, ctx)
    assert {f.primitive for f in findings} == {"data_ptr", "allocation"}


@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-base",
                                  "jamba-v0.1-52b"])
def test_lm_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One ``make_train_step`` (accum 2) of a reduced config on the card
    and on the CPU from the same weights, float32, TF32 off: loss and every
    param leaf within ``tolerance_for(float32, 10)`` norm-wise (the CPU
    tests' gradient tolerance; no kernel of the port is on this path)."""
    from repro_torch.configs import get_config
    from repro_torch.data import make_source
    from repro_torch.launch.cells import make_train_step
    from repro_torch.models.api import build_model
    from repro_torch.runtime.sharding import Shardings
    from repro_torch.util import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, device=dev)
        step = make_train_step(model, sh=Shardings.none(), accum=2, lr=1e-3)
        params = tree_map(lambda p: p.to(dev),
                          build_model(cfg, device="cpu").init(0))
        state = step.optimizer.init(params)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in make_source(
            cfg, global_batch=4, seq_len=64, seed=0).get_batch(0).items()}
        params, state, m = step(params, state, batch)
        out[str(dev)] = (m["loss"].cpu(), [x.cpu() for x in
                                          tree_leaves(params)])
    (lc, pc), (lg, pg) = out["cpu"], out["cuda"]
    _assert_close(lg, lc, torch.float32, 10)
    for a, b in zip(pg, pc, strict=True):
        _assert_close(a, b, torch.float32, 10)
