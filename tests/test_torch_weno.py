"""repro_torch's WENO5 advection path against the JAX reference, on the CPU.

The same numpy inputs go through ``repro`` and ``repro_torch``
(``device='cpu'``, so the port runs its plain PyTorch version):

- the RHS ``weno_advect`` against the reference's ``backend='jnp'`` path at
  64^2, a ragged 61x67 and extents below the 7-point support, and against
  ``weno5_advect_pallas`` in interpret mode at 64^2 (tiles 32x32);
- the solver (``WenoAdvection2D.step``/``run``) against the reference's;
- the reference's four physics checks (``tests/test_weno.py``), mirrored.

Tolerances are norm-wise, ``max|port - ref| <= atol + rtol * max|ref|``
with ``tolerance_for(dtype, scale)``.  RHS: scale 10.  The two packages
evaluate the same expressions, but torch computes ``c / x`` for a Python
scalar ``c`` as ``c * (1 / x)`` and XLA may contract or reassociate, so
each output moves by a few ulp of the largest term.  Runs: scale 10 per
RK3 step over the few steps compared.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import weno as RW
from repro.kernels import ops as ROPS
from repro.kernels.weno import weno5_advect_pallas
from repro_torch.core import weno as TW
from repro_torch.kernels import ops
from repro_torch.util import tolerance_for


def _np(t):
    return t.detach().cpu().numpy()


def _assert_close(got, want, dtype, scale):
    tol = tolerance_for(dtype, scale)
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    limit = tol["atol"] + tol["rtol"] * np.abs(want).max()
    assert err <= limit, (err, limit)


def _inputs(shape, dtype, seed):
    """q in [-1, 1], velocities of both signs with some exact zeros (u == 0
    takes the right-biased branch in both packages)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1.0, 1.0, shape)
    u, v = rng.uniform(-2.0, 2.0, (2,) + shape)
    u[::3, ::5] = 0.0
    v[1::4, ::2] = 0.0
    return tuple(a.astype(dtype) for a in (q, u, v))


def _both(q, u, v, *, dx, dy):
    want = ROPS.weno_advect(*map(jnp.asarray, (q, u, v)), dx=dx, dy=dy,
                            backend="jnp")
    got = ops.weno_advect(*map(torch.as_tensor, (q, u, v)), dx=dx, dy=dy)
    return got, want


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", [(64, 64), (61, 67)])
def test_weno_advect_matches_reference(shape, dtype):
    q, u, v = _inputs(shape, dtype, 0)
    dx, dy = 2 * np.pi / shape[1], 2 * np.pi / shape[0]
    got, want = _both(q, u, v, dx=dx, dy=dy)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == shape
    _assert_close(_np(got), want, dtype, 10)


@pytest.mark.parametrize("shape", [(6, 5), (3, 2), (1, 1), (7, 4)])
def test_weno_advect_extents_below_the_support(shape):
    """A +-3 offset wraps more than half a line; the reference's rolls wrap
    any extent, and so does the port (the Pallas kernel refuses them)."""
    q, u, v = _inputs(shape, "float64", 1)
    got, want = _both(q, u, v, dx=0.3, dy=0.2)
    _assert_close(_np(got), want, "float64", 10)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_weno_advect_matches_pallas_interpret(dtype):
    q, u, v = _inputs((64, 64), dtype, 2)
    dx = dy = 2 * np.pi / 64
    want = weno5_advect_pallas(*map(jnp.asarray, (q, u, v)), dx=dx, dy=dy,
                               ty=32, tx=32, interpret=True)
    got = ops.weno_advect(*map(torch.as_tensor, (q, u, v)), dx=dx, dy=dy)
    _assert_close(_np(got), want, dtype, 10)


def test_weno_advect_backend_dispatch():
    q, u, v = map(torch.as_tensor, _inputs((8, 8), "float64", 3))
    plain = ops.weno_advect(q, u, v, dx=0.1, dy=0.1, backend="torch")
    assert torch.equal(ops.weno_advect(q, u, v, dx=0.1, dy=0.1), plain)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.weno_advect(q, u, v, dx=0.1, dy=0.1, backend="cuda")
    with pytest.raises(ValueError, match="backend"):
        ops.weno_advect(q, u, v, dx=0.1, dy=0.1, backend="pallas")
    # the spectral backend is a plan's (the reference's weno_advect refuses
    # it as an unknown backend)
    with pytest.raises(ValueError, match="backend='fft' reached a kernel"):
        ops.weno_advect(q, u, v, dx=0.1, dy=0.1, backend="fft")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_initial_fields_match_reference(dtype):
    for ny, nx in ((64, 64), (61, 67)):
        rc = RW.AdvectionConfig(nx=nx, ny=ny)
        tc = TW.AdvectionConfig(nx=nx, ny=ny, device="cpu")
        ru, rv = RW.solid_body_rotation(rc, dtype=dtype)
        tu, tv = TW.solid_body_rotation(tc, dtype=dtype, device="cpu")
        blob = dict(x0=np.pi + 1.0, y0=np.pi, sigma=0.4, dtype=dtype)
        rq = RW.gaussian_blob(rc, **blob)
        tq = TW.gaussian_blob(tc, device="cpu", **blob)
        for got, want in ((tu, ru), (tv, rv), (tq, rq)):
            assert got.dtype == getattr(torch, dtype)
            # the nodes l * (i / n) agree with jnp.linspace's to one ulp
            _assert_close(_np(got), want, dtype, 1)


def _solvers(n, **kw):
    ref = RW.WenoAdvection2D(RW.AdvectionConfig(nx=n, ny=n, backend="jnp", **kw))
    port = TW.WenoAdvection2D(TW.AdvectionConfig(nx=n, ny=n, device="cpu", **kw))
    return ref, port


def _rotation_case(n, dtype="float64"):
    ref, port = _solvers(n)
    blob = dict(x0=np.pi + 1.0, y0=np.pi, sigma=0.4, dtype=dtype)
    q0 = np.array(RW.gaussian_blob(ref.cfg, **blob))
    u, v = (np.array(a) for a in RW.solid_body_rotation(ref.cfg, dtype=dtype))
    return ref, port, q0, u, v


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_run_matches_reference(dtype):
    """A few RK3 steps of the rotating blob at 64^2 from the same inputs."""
    ref, port, q0, u, v = _rotation_case(64, dtype)
    # the reference reduces in the fields' dtype, the port in Python floats
    assert port.dt_cfl(*map(torch.as_tensor, (u, v))) == pytest.approx(
        float(ref.dt_cfl(jnp.asarray(u), jnp.asarray(v))),
        rel=10 * np.finfo(dtype).eps)
    t_final = 0.03  # dt_cfl = 0.00625: 5 steps
    want, n_ref = ref.run(*map(jnp.asarray, (q0, u, v)), t_final)
    q0_t = torch.as_tensor(q0)
    got, n_port = port.run(q0_t, torch.as_tensor(u), torch.as_tensor(v), t_final)
    assert n_port == n_ref == 5
    np.testing.assert_array_equal(_np(q0_t), q0)  # the caller's field survives
    _assert_close(_np(got), want, dtype, 10 * n_ref)


def test_run_is_step_rounding_for_rounding():
    """The in-place loop of ``run`` and the functional ``step`` agree bit
    for bit, and the functional step matches the reference's."""
    ref, port, q0, u, v = _rotation_case(32)
    q, tu, tv = map(torch.as_tensor, (q0, u, v))
    dt = 0.01
    a = q
    for _ in range(3):
        a = port.step(a, tu, tv, dt)
    b, n = port.run(q, tu, tv, 3 * dt, dt=dt)
    assert n == 3
    assert torch.equal(a, b)
    want = ref.step(*map(jnp.asarray, (q0, u, v)), dt)
    _assert_close(_np(port.step(q, tu, tv, dt)), want, "float64", 10)


def test_solver_validates_its_config():
    with pytest.raises(ValueError, match="backend"):
        TW.WenoAdvection2D(TW.AdvectionConfig(backend="pallas", device="cpu"))
    if torch.cuda.is_available():
        return  # the default device is present: nothing to refuse
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.WenoAdvection2D(TW.AdvectionConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TW.solid_body_rotation(TW.AdvectionConfig())


# -- the reference's physics checks (tests/test_weno.py), mirrored ----------


class TestWenoAdvection:
    def test_constant_field_invariant(self):
        cfg = TW.AdvectionConfig(nx=64, ny=64, device="cpu")
        solver = TW.WenoAdvection2D(cfg)
        q = torch.full((64, 64), 3.7, dtype=torch.float64)
        u, v = TW.solid_body_rotation(cfg, device="cpu")
        np.testing.assert_allclose(_np(solver.rhs(q, u, v)), 0.0, atol=1e-11)

    def test_uniform_translation_error_small(self):
        # translate a smooth blob once round the periodic box: after a full
        # period it must coincide with the initial condition
        cfg = TW.AdvectionConfig(nx=128, ny=128, cfl=0.4, device="cpu")
        solver = TW.WenoAdvection2D(cfg)
        q0 = TW.gaussian_blob(cfg, x0=np.pi, y0=np.pi, sigma=0.5, device="cpu")
        u = torch.ones_like(q0)
        v = torch.zeros_like(q0)
        qT, nsteps = solver.run(q0, u, v, t_final=2 * np.pi)
        err = float(torch.sqrt(torch.mean((qT - q0) ** 2)))
        assert err < 2e-3, (err, nsteps)

    def test_rotation_preserves_extrema(self):
        # WENO should be essentially non-oscillatory: no big over/undershoot
        cfg = TW.AdvectionConfig(nx=96, ny=96, cfl=0.4, device="cpu")
        solver = TW.WenoAdvection2D(cfg)
        q0 = TW.gaussian_blob(cfg, x0=np.pi + 1.2, y0=np.pi, sigma=0.35,
                              device="cpu")
        u, v = TW.solid_body_rotation(cfg, device="cpu")
        qT, _ = solver.run(q0, u, v, t_final=np.pi / 2)  # quarter turn
        assert float(qT.min()) > -5e-3
        assert float(qT.max()) < 1.0 + 5e-3

    def test_upwind_direction_switch(self):
        # advecting a ramp: the derivative must be taken from the upwind side
        cfg = TW.AdvectionConfig(nx=64, ny=64, device="cpu")
        solver = TW.WenoAdvection2D(cfg)
        x = torch.as_tensor(np.linspace(0, 2 * np.pi, 64, endpoint=False))
        Y, X = torch.meshgrid(x, x, indexing="ij")
        q = torch.sin(X)
        u = torch.ones_like(q)
        rhs_pos = solver.rhs(q, u, torch.zeros_like(q))
        rhs_neg = solver.rhs(q, -u, torch.zeros_like(q))
        # for smooth fields both should approximate -u q_x = -+cos(x)
        np.testing.assert_allclose(_np(rhs_pos), _np(-torch.cos(X)), atol=2e-4)
        np.testing.assert_allclose(_np(rhs_neg), _np(torch.cos(X)), atol=2e-4)
