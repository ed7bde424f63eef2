"""repro_torch's 2D stencil held against the JAX reference on the CPU.

``repro_torch.kernels.ops.stencil_apply`` (the plain version, as a CPU
tensor selects it) against ``repro.kernels.ops.stencil_apply`` run both as
``backend='pallas', interpret=True`` and as ``backend='jnp'``: weighted and
cube function-pointer modes, periodic and ``np`` with ``out_init``, the
5x3, 3x5, 3x3 and 5x5 plans of the Cahn–Hilliard solver, on square and odd
extents.  Tolerance ``tolerance_for(float64, scale=10)``: one pass of at
most 25 products summed in the same window order, so the packages differ
only where XLA fuses a multiply-add.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cahn_hilliard import cube_laplacian_point_fn as ref_cube
from repro.core.cahn_hilliard import CahnHilliardADI as RefSolver
from repro.core.cahn_hilliard import CHConfig as RefConfig
from repro.kernels import ops as RO
from repro.kernels.ref import weighted_point_fn as ref_weighted
from repro_torch import convert
from repro_torch.core.cahn_hilliard import cube_laplacian_point_fn
from repro_torch.kernels import ops
from repro_torch.kernels.ref import weighted_point_fn
from repro_torch.kernels.stencil2d import device_point_fn_id
from repro_torch.util import tolerance_for

TOL = tolerance_for("float64", scale=10)

# (left, right, top, bottom) of the solver's plans
PLANS = {
    "5x3": (1, 1, 2, 2),  # plan_init_a: 5 rows (y) x 3 columns (x)
    "3x5": (2, 2, 1, 1),  # plan_init_b
    "3x3": (1, 1, 1, 1),  # plan_lap_cube
    "5x5": (2, 2, 2, 2),  # plan_bih
}
SHAPES = [(16, 16), (13, 11)]


def _case(plan, shape, seed):
    left, right, top, bottom = PLANS[plan]
    rng = np.random.default_rng(seed)
    data = rng.uniform(-1.0, 1.0, shape)
    coeffs = rng.standard_normal((left + right + 1) * (top + bottom + 1))
    out_init = rng.standard_normal(shape)
    return dict(left=left, right=right, top=top, bottom=bottom), data, coeffs, out_init


def _check(plan, shape, bc, point_fns, seed):
    ext, data, coeffs, out_init = _case(plan, shape, seed)
    init = out_init if bc == "np" else None
    port_fn, ref_fn = point_fns
    got = ops.stencil_apply(
        torch.as_tensor(data), torch.as_tensor(coeffs),
        None if init is None else torch.as_tensor(init),
        point_fn=port_fn, bc=bc, **ext,
    )
    assert got.shape == shape and got.dtype == torch.float64
    for backend, extra in (("jnp", {}), ("pallas", {"interpret": True})):
        want = RO.stencil_apply(
            jnp.asarray(data), jnp.asarray(coeffs),
            None if init is None else jnp.asarray(init),
            point_fn=ref_fn, bc=bc, backend=backend, **ext, **extra,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL,
                                   err_msg=backend)
    if bc == "np":  # the boundary passes out_init through untouched
        ref_mask = np.ones(shape, bool)
        ref_mask[ext["top"]: shape[0] - ext["bottom"],
                 ext["left"]: shape[1] - ext["right"]] = False
        np.testing.assert_array_equal(got.numpy()[ref_mask], out_init[ref_mask])


@pytest.mark.parametrize("shape", SHAPES, ids=["16x16", "13x11"])
@pytest.mark.parametrize("bc", ["periodic", "np"])
@pytest.mark.parametrize("plan", list(PLANS))
def test_weighted_matches_reference(plan, bc, shape):
    _check(plan, shape, bc, (weighted_point_fn, ref_weighted), seed=1)


@pytest.mark.parametrize("shape", SHAPES, ids=["16x16", "13x11"])
@pytest.mark.parametrize("bc", ["periodic", "np"])
@pytest.mark.parametrize("plan", ["3x3", "5x3"])
def test_cube_function_pointer_matches_reference(plan, bc, shape):
    _check(plan, shape, bc, (cube_laplacian_point_fn, ref_cube), seed=2)


@pytest.fixture(scope="module")
def ref_solver():
    return RefSolver(RefConfig(nx=16, ny=16, backend="jnp"))


def test_solver_plans_match_reference(ref_solver):
    """The solver's four plans (built through the facade on both sides)
    applied to one field agree."""
    n, ref = 16, ref_solver
    from repro_torch.core.cahn_hilliard import CahnHilliardADI, CHConfig

    port = CahnHilliardADI(CHConfig(nx=n, ny=n, device="cpu"))
    c = np.random.default_rng(3).uniform(-0.1, 0.1, (n, n))
    for name in ("plan_init_a", "plan_init_b", "plan_lap_cube", "plan_bih"):
        p, r = getattr(port, name), getattr(ref, name)
        assert p.halo == r.halo
        np.testing.assert_allclose(
            p.apply(torch.as_tensor(c)).numpy(), np.asarray(r.apply(jnp.asarray(c))),
            **TOL, err_msg=name,
        )


def test_convert_stencil_round_trip(ref_solver):
    """A reference plan's coeffs and extents, carried over by convert.py."""
    ref = ref_solver.plan_init_a
    plan = convert.stencil2d(
        np.asarray(ref.coeffs), left=ref.left, right=ref.right, top=ref.top,
        bottom=ref.bottom, device="cpu",
    )
    assert plan.direction == "xy" and plan.num_sten == 15
    c = np.random.default_rng(4).standard_normal((16, 16))
    np.testing.assert_allclose(
        plan.apply(torch.as_tensor(c)).numpy(), np.asarray(ref.apply(jnp.asarray(c))),
        **TOL,
    )
    with pytest.raises(ValueError, match="one weight per window"):
        convert.stencil2d(np.ones(3), left=1, right=1, top=1, bottom=1, device="cpu")


def test_device_point_functions():
    assert device_point_fn_id(weighted_point_fn) == 0
    assert device_point_fn_id(cube_laplacian_point_fn) == 1
    with pytest.raises(NotImplementedError, match="no CUDA counterpart"):
        device_point_fn_id(lambda windows, coeffs: windows[0])
