"""repro_torch's fused Cahn–Hilliard RHS kernels held against the JAX
reference on the CPU.

``repro_torch.kernels.ops.ch_rhs_xsweep`` (the plain version, as a CPU
tensor selects it) against ``repro.kernels.ops.ch_rhs_xsweep(backend='jnp')``
(its Pallas kernel needs ``pl.load``, which the installed jax lacks);
``ops.ch_rhs`` against the reference's ``ch_rhs_pallas`` in interpret mode
and its jnp path; and the plain RHS pieces against ``repro.kernels.ref``.  Tolerance
``tolerance_for(dtype, scale=100)``: the RHS weights the biharmonic by
``(2/3) dt gamma D / h^4`` (about 11 at 64^2), so its rounding is an order
above the fields', and the recurrence carries it over ``nx`` steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as RO
from repro.kernels import penta as RP
from repro.kernels import ref as RR
from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.kernels import penta as TP
from repro_torch.kernels import ref as TR
from repro_torch.util import tolerance_for

SHAPES = [(16, 16), (13, 11), (64, 64)]


def _params(nx, dt=1e-3, D=0.6, gamma=0.01):
    h = 2 * np.pi / nx
    return dict(dt=dt, D=D, gamma=gamma, inv_h2=1 / h**2, inv_h4=1 / h**4)


def _fields(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [np.asarray(rng.uniform(-0.5, 0.5, shape), dtype) for _ in range(2)]


def _beta(p):
    return (2.0 / 3.0) * p["D"] * p["gamma"] * p["dt"] * p["inv_h4"]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", SHAPES, ids=["16x16", "13x11", "64x64"])
def test_xsweep_matches_reference(shape, dtype):
    ny, nx = shape
    p = _params(nx)
    cn, cm = _fields(shape, dtype)
    diag = RP.hyperdiffusion_diagonals(nx, _beta(p), dtype=jnp.dtype(dtype))
    ref_fac = RP.cyclic_penta_factor(*diag)
    want = RO.ch_rhs_xsweep(jnp.asarray(cn), jnp.asarray(cm), ref_fac,
                            backend="jnp", **p)
    tol = tolerance_for(dtype, scale=100)
    # the port's own factors ...
    fac = TP.cyclic_penta_factor(
        *TP.hyperdiffusion_diagonals(nx, _beta(p), dtype=dtype), device="cpu"
    )
    got = ops.ch_rhs_xsweep(torch.as_tensor(cn), torch.as_tensor(cm), fac, **p)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    # ... and the reference's, carried over (substitution differences only)
    fac_ref = convert.cyclic_penta_factors(
        [np.asarray(a) for a in ref_fac.band], np.asarray(ref_fac.z),
        np.asarray(ref_fac.s_inv), np.asarray(ref_fac.w), device="cpu",
    )
    got = ops.ch_rhs_xsweep(torch.as_tensor(cn), torch.as_tensor(cm), fac_ref, **p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("shape", SHAPES[:2], ids=["16x16", "13x11"])
def test_rhs_pieces_match_reference(shape):
    ny, nx = shape
    p = _params(nx)
    cn, cm = _fields(shape, "float64", seed=1)
    tn, tm = torch.as_tensor(cn), torch.as_tensor(cm)
    jn, jm = jnp.asarray(cn), jnp.asarray(cm)
    tol = tolerance_for("float64", scale=100)
    win = TR.ch_rhs_win(tn, tm, **p)
    np.testing.assert_allclose(win.numpy(), np.asarray(RR.ch_rhs_win(jn, jm, **p)), **tol)
    full = TR.ch_rhs_ref(tn, tm, **p)
    np.testing.assert_allclose(full.numpy(), np.asarray(RR.ch_rhs_ref(jn, jm, **p)), **tol)
    # the windowed separable form equals the rolled 13-point form
    np.testing.assert_allclose(win.numpy(), full.numpy(), **tol)
    np.testing.assert_allclose(
        TR.biharmonic_ref(tn, 1.0).numpy(), np.asarray(RR.biharmonic_ref(jn, 1.0)),
        **tolerance_for("float64"),
    )
    np.testing.assert_allclose(
        TR.laplacian_ref(tn, 1.0).numpy(), np.asarray(RR.laplacian_ref(jn, 1.0)),
        **tolerance_for("float64"),
    )
    np.testing.assert_allclose(
        ops.ch_rhs(tn, tm, **p).numpy(),
        np.asarray(RO.ch_rhs(jn, jm, backend="jnp", **p)), **tol,
    )


@pytest.mark.parametrize("shape", [(1, 8), (8, 1), (1, 1), (3, 7)])
def test_rhs_win_wraps_extents_below_the_halo(shape):
    """The windowed RHS pads halo 2 by modular indexing, so an extent of 1
    wraps onto itself and matches the rolled form.  The reference's
    ``ch_rhs_win`` pads with slices and drops the rows (ROADMAP.md,
    Faults), so here the port is held against its ``ch_rhs_ref``."""
    p = _params(shape[1])
    cn, cm = _fields(shape, "float64", seed=2)
    tn, tm = torch.as_tensor(cn), torch.as_tensor(cm)
    win = TR.ch_rhs_win(tn, tm, **p)
    assert tuple(win.shape) == shape
    want = np.asarray(RR.ch_rhs_ref(jnp.asarray(cn), jnp.asarray(cm), **p))
    tol = tolerance_for("float64", scale=100)
    np.testing.assert_allclose(win.numpy(), want, **tol)
    if shape[0] == 1:
        assert RR.ch_rhs_win(jnp.asarray(cn), jnp.asarray(cm), **p).shape[0] == 0
    if shape[1] >= 6:  # the cyclic x-sweep needs nx >= 6
        fac = TP.cyclic_penta_factor(
            *TP.hyperdiffusion_diagonals(shape[1], _beta(p)), device="cpu")
        got = ops.ch_rhs_xsweep(tn, tm, fac, **p)
        ref_fac = RP.cyclic_penta_factor(
            *RP.hyperdiffusion_diagonals(shape[1], _beta(p), dtype=jnp.float64))
        np.testing.assert_allclose(
            got.numpy(),
            np.asarray(RP.cyclic_penta_solve_factored_rows(
                ref_fac, jnp.asarray(want), backend="jnp")),
            **tol,
        )


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape, tile", [((16, 16), (8, 8)), ((13, 11), (13, 11)),
                                         ((64, 64), (16, 16))],
                         ids=["16x16", "13x11", "64x64"])
def test_standalone_rhs_matches_pallas(shape, tile, dtype):
    """``ops.ch_rhs`` (the RHS alone, whose CUDA kernel is the port of
    ``ch_rhs_pallas``) against that Pallas kernel run in interpret mode on
    (ty, tx) tiles, and against the reference's jnp path."""
    p = _params(shape[1])
    cn, cm = _fields(shape, dtype, seed=3)
    got = ops.ch_rhs(torch.as_tensor(cn), torch.as_tensor(cm), **p)
    assert got.dtype == getattr(torch, dtype)
    tol = tolerance_for(dtype, scale=100)
    jn, jm = jnp.asarray(cn), jnp.asarray(cm)
    for backend, extra in (("pallas", dict(interpret=True, tile=tile)), ("jnp", {})):
        want = RO.ch_rhs(jn, jm, backend=backend, **p, **extra)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol,
                                   err_msg=backend)


def test_standalone_rhs_kernel_is_refused_on_cuda_backend():
    """``backend='cuda'`` launches the RHS kernel or raises: a CPU tensor is
    refused, never run on the plain path."""
    p = _params(16)
    c = torch.zeros((16, 16), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.ch_rhs(c, c, backend="cuda", **p)
    fac = TP.cyclic_penta_factor(*TP.hyperdiffusion_diagonals(16, 0.1), device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.ch_rhs_xsweep(c, c, fac, backend="cuda", **p)
