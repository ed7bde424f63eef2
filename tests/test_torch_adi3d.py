"""repro_torch's 3D ADI path held against the JAX reference on the CPU.

The plane-layout substitution (``substitute_mid_torch`` and its Woodbury
closure) against the reference's ``_substitute_mid_jnp`` and against the
dense oracle; ``ADIOperator3D`` and rank-3 ``create``/``compute`` against
the reference's ``backend='jnp'`` path (its Pallas substitutions need
``pl.load``, which the installed jax lacks), cyclic and not, sweep by
sweep and whole; the reference's factors carried over by ``convert.py``;
the LOD diffusion scheme of ``examples/diffusion3d_adi.py``, whose
decay on the separable mode is known exactly; and the streamed operator
(``streams``/``max_tile_bytes``: row, plane and column chunks), which
equals the port's monolithic one bit for bit and the reference's streamed
operator within the same tolerance.  Tolerance
``tolerance_for(dtype, scale=10)``: the same recurrences with per-op
rounding, which XLA may contract into multiply-adds, carried over at most
14 steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.kernels import penta as RP
import repro_torch as rt
from repro_torch import convert
from repro_torch.kernels import penta as TP
from repro_torch.kernels import ref as TR
from repro_torch.launch import stream as TS
from repro_torch.util import tolerance_for

SHAPE = (12, 10, 14)


def _bands(M, dtype, seed):
    rng = np.random.default_rng(seed + M)
    l2, l1, u1, u2 = (rng.uniform(-1.0, 1.0, M) for _ in range(4))
    d = 6.0 + rng.uniform(0.0, 1.0, M)
    return tuple(np.asarray(a, dtype) for a in (l2, l1, d, u1, u2))


@pytest.mark.parametrize("cyclic", [False, True], ids=["plain", "cyclic"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plane_layout_matches_reference(dtype, cyclic):
    P, M, N = 3, 11, 7
    bands = _bands(M, dtype, seed=1)
    rhs = np.asarray(np.random.default_rng(2).standard_normal((P, M, N)), dtype)
    tol = tolerance_for(dtype, scale=10)
    jb = [jnp.asarray(b) for b in bands]
    if cyclic:
        fac = TP.cyclic_penta_factor(*bands, device="cpu")
        got = TP.cyclic_penta_solve_factored_mid(fac, torch.as_tensor(rhs))
        ref_fac = RP.cyclic_penta_factor(*jb)
        want = RP.cyclic_penta_solve_factored_mid(ref_fac, jnp.asarray(rhs),
                                                  backend="jnp")
        # the closure alone, on the same band solution
        y = np.array(RP._substitute_mid_jnp(ref_fac.band, jnp.asarray(rhs)))
        np.testing.assert_allclose(
            TP.mid_woodbury_correct(torch.as_tensor(y), fac.w).numpy(),
            np.asarray(RP.mid_woodbury_correct(jnp.asarray(y), ref_fac.w)), **tol)
    else:
        fac = TP.penta_factor(*bands, device="cpu")
        got = TP.penta_solve_factored_mid(fac, torch.as_tensor(rhs))
        want = RP._substitute_mid_jnp(RP.penta_factor(*jb), jnp.asarray(rhs))
        np.testing.assert_array_equal(
            TP.substitute_mid_torch(fac, torch.as_tensor(rhs)).numpy(), got.numpy())
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (P, M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    # the dense oracle, plane by plane
    tb = [torch.as_tensor(b) for b in bands]
    dense = np.stack([
        TR.penta_solve_ref(*tb, torch.as_tensor(rhs[p]), cyclic=cyclic).numpy()
        for p in range(P)])
    np.testing.assert_allclose(got.numpy(), dense, **tol)
    with pytest.raises(ValueError, match=r"\(P, M, N\)"):
        TP.penta_solve_factored_mid(TP.penta_factor(*bands, device="cpu"),
                                    torch.as_tensor(rhs[0]))


@pytest.mark.parametrize("bc", ["periodic", "np"])
@pytest.mark.parametrize("operator", ["hyperdiffusion", "diffusion"])
def test_operator_matches_reference(operator, bc):
    c = np.random.default_rng(3).standard_normal(SHAPE)
    kw = dict(mode="adi", bc=bc, alpha=0.7, alpha_y=0.3, alpha_z=0.5)
    op = rt.create(operator, SHAPE, device="cpu", **kw)
    ref = repro.create(operator, SHAPE, backend="jnp", lint="off", **kw)
    assert type(op).__name__ == "ADIOperator3D"
    assert op.cyclic == ref.cyclic == (bc == "periodic")
    tol = tolerance_for("float64", scale=10)
    tc, jc = torch.as_tensor(c), jnp.asarray(c)
    for sweep in ("solve_x", "solve_y", "solve_z"):
        np.testing.assert_allclose(
            getattr(op, sweep)(tc).numpy(), np.asarray(getattr(ref, sweep)(jc)),
            **tol, err_msg=sweep)
    np.testing.assert_allclose(rt.compute(op, tc).numpy(),
                               np.asarray(repro.compute(ref, jc)), **tol)


def test_convert_carries_reference_factors():
    """The reference's three factor sets, carried over: the port's sweeps on
    them match the reference's (substitution differences only)."""
    ref = repro.create("hyperdiffusion", SHAPE, mode="adi", alpha=0.4,
                       backend="jnp", lint="off")

    def carry(f):
        return convert.cyclic_penta_factors(
            [np.asarray(a) for a in f.band], np.asarray(f.z),
            np.asarray(f.s_inv), np.asarray(f.w), device="cpu")

    op = convert.adi_operator_3d(carry(ref.fac_x), carry(ref.fac_y),
                                 carry(ref.fac_z))
    assert op.cyclic
    c = np.random.default_rng(4).standard_normal(SHAPE)
    np.testing.assert_allclose(
        rt.compute(op, torch.as_tensor(c)).numpy(),
        np.asarray(repro.compute(ref, jnp.asarray(c))),
        **tolerance_for("float64", scale=10))
    with pytest.raises(ValueError, match="all be cyclic"):
        convert.adi_operator_3d(carry(ref.fac_x), carry(ref.fac_y).band,
                                carry(ref.fac_z))


def test_lod_diffusion_exact_decay():
    """The LOD step of ``examples/diffusion3d_adi.py`` at 16^3: on
    sin(x) sin(y) sin(z) each sweep acts diagonally, so the amplitude decays
    by exactly g = (1 + 4 r sin^2(h/2))^-3 per step; the port matches the
    reference field and keeps amp / (amp0 g^k) at 1 to rounding, and the
    Laplacian plan's residual stays at the scheme's truncation level."""
    n, D, dt, steps = 16, 0.5, 2e-3, 12
    h = 2 * np.pi / n
    r = D * dt / h**2
    op = rt.create("diffusion", (n, n, n), mode="adi", alpha=r, cyclic=True,
                   device="cpu")
    lap = rt.create("laplacian", (n, n, n), bc="periodic", h=h, device="cpu")
    ref = repro.create("diffusion", (n, n, n), mode="adi", alpha=r, cyclic=True,
                       backend="jnp", lint="off")
    x = np.arange(n) * h
    Z, Y, X = np.meshgrid(x, x, x, indexing="ij")
    c0 = np.sin(X) * np.sin(Y) * np.sin(Z)
    c, cj = torch.as_tensor(c0), jnp.asarray(c0)
    amp0 = float(c.abs().max())
    g = float(1.0 / (1.0 + 4.0 * r * np.sin(h / 2.0) ** 2) ** 3)
    for k in range(1, steps + 1):
        c, cj = rt.compute(op, c), repro.compute(ref, cj)
        assert abs(float(c.abs().max()) / (amp0 * g**k) - 1.0) <= 1e-12
    np.testing.assert_allclose(c.numpy(), np.asarray(cj),
                               **tolerance_for("float64", scale=10))
    res = float(((1.0 - 1.0 / g) / dt * c - D * rt.compute(lap, c)).abs().max())
    assert res < 1e-2  # O(dt) splitting + O(h^2) truncation at this grid


def test_validation():
    with pytest.raises(ValueError, match="alpha_z only applies"):
        rt.create("diffusion", (8, 8), mode="adi", alpha=0.1, alpha_z=0.2,
                  device="cpu")
    with pytest.raises(ValueError, match="only applies to mode='adi'"):
        rt.create("laplacian", (4, 8, 8), alpha_z=0.2, device="cpu")
    # rank-3 plans stream; a slab height that does not divide nz raises
    with pytest.raises(ValueError, match="must divide"):
        TS.stream_stencil3d_apply(torch.zeros((12, 8, 8), dtype=torch.float64),
                                  torch.ones(7, dtype=torch.float64),
                                  halos=(1,) * 6, chunk_slabs=5)
    op = rt.create("diffusion", (6, 8, 8), mode="adi", alpha=0.1, device="cpu")
    rt.destroy(op)
    with pytest.raises(ValueError, match="destroyed"):
        rt.compute(op, torch.zeros((6, 8, 8), dtype=torch.float64))


# (nz, ny, nx) of the reference's streamed-operator test
# (tests/test_adi3d.py::TestADIOperator3D)
STREAM_SHAPE = (8, 12, 16)


@pytest.mark.parametrize("bc", ["periodic", "np"])
@pytest.mark.parametrize("operator", ["hyperdiffusion", "diffusion"])
def test_streamed_operator_equals_monolithic(operator, bc, monkeypatch):
    """streams=2 and a budget of a quarter of the field: each sweep runs
    its streamed executor (x in row chunks, y in plane chunks, z in column
    chunks), bit for bit the monolithic sweep, and within the tolerance of
    the reference's streamed operator."""
    rhs = np.random.default_rng(5).standard_normal(STREAM_SHAPE)
    knobs = dict(streams=2, max_tile_bytes=rhs.nbytes // 4)
    kw = dict(mode="adi", bc=bc, alpha=0.3, alpha_y=0.2, alpha_z=0.4)
    mono = rt.create(operator, STREAM_SHAPE, device="cpu", **kw)
    streamed = rt.create(operator, STREAM_SHAPE, device="cpu", **knobs, **kw)
    ref = repro.create(operator, STREAM_SHAPE, backend="jnp", lint="off",
                       **knobs, **kw)
    assert (streamed.streams, streamed.max_tile_bytes) == (2, rhs.nbytes // 4)
    assert streamed.stream_pool == ()  # no CUDA streams on the CPU
    calls = []
    for name in ("stream_penta_solve_rows", "stream_penta_solve_mid",
                 "stream_penta_solve"):
        real = getattr(TS, name)
        monkeypatch.setattr(TS, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    tol = tolerance_for("float64", scale=10)
    tc, jc = torch.as_tensor(rhs), jnp.asarray(rhs)
    for sweep in ("solve_x", "solve_y", "solve_z"):
        got = getattr(streamed, sweep)(tc)
        np.testing.assert_array_equal(got.numpy(),
                                      getattr(mono, sweep)(tc).numpy(),
                                      err_msg=sweep)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(getattr(ref, sweep)(jc)),
                                   **tol, err_msg=sweep)
    assert calls == ["stream_penta_solve_rows", "stream_penta_solve_mid",
                     "stream_penta_solve"]
    np.testing.assert_array_equal(rt.compute(streamed, tc).numpy(),
                                  rt.compute(mono, tc).numpy())


def test_streamed_operator_within_budget_stays_monolithic(monkeypatch):
    """One stream and a field within the budget: no sweep streams."""
    calls = []
    for name in ("stream_penta_solve_rows", "stream_penta_solve_mid",
                 "stream_penta_solve"):
        monkeypatch.setattr(TS, name, lambda *a, _n=name, **k: calls.append(_n))
    rhs = torch.as_tensor(np.random.default_rng(6).standard_normal(STREAM_SHAPE))
    op = rt.create("diffusion", STREAM_SHAPE, mode="adi", alpha=0.3,
                   streams=1, max_tile_bytes=rhs.numel() * 8, device="cpu")
    mono = rt.create("diffusion", STREAM_SHAPE, mode="adi", alpha=0.3,
                     device="cpu")
    np.testing.assert_array_equal(rt.compute(op, rhs).numpy(),
                                  rt.compute(mono, rhs).numpy())
    assert calls == []


def test_convert_carries_the_streaming_knobs():
    """convert.adi_operator_3d takes the reference operator's knobs."""
    knobs = dict(streams=2, max_tile_bytes=8 * 12 * 16 * 8 // 4)
    ref = repro.create("hyperdiffusion", STREAM_SHAPE, mode="adi", alpha=0.4,
                       backend="jnp", lint="off", **knobs)

    def carry(f):
        return convert.cyclic_penta_factors(
            [np.asarray(a) for a in f.band], np.asarray(f.z),
            np.asarray(f.s_inv), np.asarray(f.w), device="cpu")

    op = convert.adi_operator_3d(carry(ref.fac_x), carry(ref.fac_y),
                                 carry(ref.fac_z), streams=ref.streams,
                                 max_tile_bytes=ref.max_tile_bytes)
    assert (op.streams, op.max_tile_bytes) == (2, knobs["max_tile_bytes"])
    c = np.random.default_rng(7).standard_normal(STREAM_SHAPE)
    np.testing.assert_allclose(
        rt.compute(op, torch.as_tensor(c)).numpy(),
        np.asarray(repro.compute(ref, jnp.asarray(c))),
        **tolerance_for("float64", scale=10))
