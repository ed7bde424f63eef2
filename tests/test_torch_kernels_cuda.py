"""repro_torch's CUDA kernels against their plain versions, on the card.

These need a CUDA card and ``nvcc`` (the kernels are built at first use);
without a card they skip.  On the card::

    PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider \
        tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports jax, which the card's host
need not have.)

``chip_smoke.py`` runs the same comparisons at the main path's sizes.
Tolerances as in ``chip_smoke.py`` (norm-wise ``tolerance_for`` scales):
10 for the stencil, 100 for the recurrences, 10 for the fused RHS.
"""

import numpy as np
import pytest
import torch

from repro_torch import create
from repro_torch.core.cahn_hilliard import cube_laplacian_point_fn
from repro_torch.kernels import _build, ops
from repro_torch.kernels import penta as P
from repro_torch.kernels.ref import weighted_point_fn
from repro_torch.util import tolerance_for

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


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", [(64, 64), (37, 29)])
def test_penta_sweeps(cuda, shape, dtype):
    op = create("hyperdiffusion", shape, mode="adi", alpha=3.0, dtype=dtype)
    rhs = _field(shape, getattr(torch, dtype), cuda, 3)
    for solve, fac in ((P.cyclic_penta_solve_factored_rows, op.fac_x),
                       (P.cyclic_penta_solve_factored, op.fac_y),
                       (P.penta_solve_factored_rows, op.fac_x.band),
                       (P.penta_solve_factored, op.fac_y.band)):
        _assert_close(solve(fac, rhs), solve(fac, rhs, backend="torch"), dtype, 100)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", [(64, 64), (37, 29), (1, 8)])
def test_ch_rhs_xsweep(cuda, shape, dtype):
    ny, nx = shape
    h = 2 * np.pi / nx
    p = dict(dt=1e-3, D=0.6, gamma=0.01, inv_h2=h**-2, inv_h4=h**-4)
    beta = (2 / 3) * 0.6 * 0.01 * 1e-3 * h**-4
    fac_x = P.cyclic_penta_factor(
        *P.hyperdiffusion_diagonals(nx, beta, dtype), device=cuda)
    cn = _field(shape, getattr(torch, dtype), cuda, 4)
    cm = _field(shape, getattr(torch, dtype), cuda, 5)
    got = ops.ch_rhs_xsweep(cn, cm, fac_x, **p)
    want = ops.ch_rhs_xsweep(cn, cm, fac_x, backend="torch", **p)
    _assert_close(got, want, dtype, 10)
