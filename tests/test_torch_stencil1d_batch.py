"""repro_torch's batched-1D stencil family held against the JAX reference on
the CPU.

The port's plain path (as a CPU tensor selects it) against the reference's
Pallas kernel in interpret mode (``backend='pallas', interpret=True``, as
``tests/test_stencil1d_batch.py`` runs it), against its jnp path and
against both packages' ``stencil1d_batch_ref``: weighted and cube
function-pointer modes, periodic and ``np`` with ``out_init``, symmetric
and asymmetric extents, even and ragged stacks, along x and along y of a
2D field, and through the facade (``create(mode='batch')``).  Tolerance
``tolerance_for(dtype, scale=10)``: one pass of at most 5 products summed in
the same window order, so the packages differ only where XLA contracts a
multiply-add.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core.adi import apply_along_x as ref_along_x
from repro.core.adi import apply_along_y as ref_along_y
from repro.core.cahn_hilliard import cube_laplacian_point_fn as ref_cube
from repro.kernels import ops as RO
from repro.kernels import ref as RR
import repro_torch as rt
from repro_torch import convert
from repro_torch.core.adi import apply_along_x, apply_along_y
from repro_torch.core.cahn_hilliard import cube_laplacian_point_fn
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.util import tolerance_for

# name -> (left, right, function mode?)
PLANS = {
    "d4": (2, 2, False),  # delta^2 of the paper's eq. 4b
    "d2": (1, 1, False),  # delta of eq. 4a
    "cube": (1, 1, True),  # the per-direction Laplacian of (C^3 - C)
    "asym": (3, 1, False),
}
STACKS = [(8, 64), (13, 37)]


def _case(plan, shape, dtype, seed):
    left, right, fn = PLANS[plan]
    rng = np.random.default_rng(seed)
    data = np.asarray(rng.uniform(-1.0, 1.0, shape), dtype)
    coeffs = np.asarray(rng.standard_normal(left + right + 1), dtype)
    out_init = np.asarray(rng.standard_normal(shape), dtype)
    fns = (cube_laplacian_point_fn, ref_cube) if fn else (
        TR.weighted_point_fn, RR.weighted_point_fn)
    return dict(left=left, right=right), data, coeffs, out_init, fns


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("shape", STACKS, ids=["8x64", "13x37"])
@pytest.mark.parametrize("bc", ["periodic", "np"])
@pytest.mark.parametrize("plan", list(PLANS))
def test_matches_reference(plan, bc, shape, dtype):
    ext, data, coeffs, out_init, (port_fn, ref_fn) = _case(plan, shape, dtype, 1)
    init = out_init if bc == "np" else None
    got = ops.stencil_apply_batch1d(
        torch.as_tensor(data), torch.as_tensor(coeffs),
        None if init is None else torch.as_tensor(init),
        point_fn=port_fn, bc=bc, **ext,
    )
    assert got.shape == shape and got.dtype == getattr(torch, dtype)
    tol = tolerance_for(dtype, scale=10)
    jargs = (jnp.asarray(data), jnp.asarray(coeffs),
             None if init is None else jnp.asarray(init))
    for backend, extra in (("pallas", {"interpret": True}), ("jnp", {})):
        want = RO.stencil_apply_batch1d(*jargs, point_fn=ref_fn, bc=bc,
                                        backend=backend, **ext, **extra)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol,
                                   err_msg=backend)
    want = RR.stencil1d_batch_ref(jargs[0], bc=bc, point_fn=ref_fn,
                                  coeffs=jargs[1], out_init=jargs[2], **ext)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    if bc == "np":  # the edge columns pass out_init through untouched
        edge = np.ones(shape[1], bool)
        edge[ext["left"]: shape[1] - ext["right"]] = False
        np.testing.assert_array_equal(got.numpy()[:, edge], out_init[:, edge])


@pytest.mark.parametrize("bc", ["periodic", "np"])
@pytest.mark.parametrize("plan", ["d4", "d2", "cube"])
@pytest.mark.parametrize("axis", ["x", "y"])
def test_along_axes_match_reference(axis, plan, bc):
    """``apply_along_x/y`` on a ragged (11, 14) field: along y the plan runs
    on the transposed view, as in the reference."""
    shape = (11, 14)
    ext, data, coeffs, out_init, (port_fn, ref_fn) = _case(plan, shape, "float64", 2)
    init = out_init if bc == "np" else None
    fn_mode = PLANS[plan][2]
    kw = dict(coeffs=coeffs, extents=ext) if fn_mode else {}
    port_plan = rt.create(port_fn if fn_mode else coeffs, shape, mode="batch",
                          bc=bc, device="cpu", **kw)
    ref_plan = repro.create(ref_fn if fn_mode else coeffs, shape, mode="batch",
                            bc=bc, backend="pallas", interpret=True, lint="off",
                            **kw)
    port_apply, ref_apply = (apply_along_x, ref_along_x) if axis == "x" else (
        apply_along_y, ref_along_y)
    t_init = None if init is None else torch.as_tensor(init)
    got = port_apply(port_plan, torch.as_tensor(data), t_init)
    want = ref_apply(ref_plan, jnp.asarray(data),
                     None if init is None else jnp.asarray(init))
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **tolerance_for("float64", scale=10))
    if axis == "y":  # along y is along x of the transposed copy
        other = apply_along_x(port_plan, torch.as_tensor(data.T.copy()),
                              None if init is None else torch.as_tensor(init.T.copy()))
        np.testing.assert_array_equal(got.numpy(), other.numpy().T)


@pytest.mark.parametrize("operator", ["laplacian", "biharmonic"])
def test_facade_matches_reference(operator):
    shape = (9, 30)
    c = np.random.default_rng(3).standard_normal(shape)
    plan = rt.create(operator, shape, mode="batch", h=0.25, device="cpu")
    ref = repro.create(operator, shape, mode="batch", h=0.25, backend="jnp",
                       lint="off")
    assert type(plan).__name__ == "StencilBatch1D"
    assert plan.halo == ref.halo and plan.num_sten == ref.num_sten
    np.testing.assert_allclose(
        rt.compute(plan, torch.as_tensor(c)).numpy(),
        np.asarray(repro.compute(ref, jnp.asarray(c))),
        **tolerance_for("float64", scale=10),
    )
    # explicit weights, asymmetric split, np with out_init, float32 plan
    w, init = np.arange(1.0, 5.0), np.full(shape, 2.5)
    kw = dict(mode="batch", bc="np", extents=dict(left=1, right=2),
              dtype="float32")
    plan = rt.create(w, shape, device="cpu", **kw)
    ref = repro.create(w, shape, backend="jnp", lint="off", **kw)
    assert plan.coeffs.dtype == torch.float32
    got = rt.compute(plan, torch.as_tensor(c, dtype=torch.float32),
                     torch.as_tensor(init, dtype=torch.float32))
    want = repro.compute(ref, jnp.asarray(c, jnp.float32),
                         jnp.asarray(init, jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **tolerance_for("float32", scale=10))


def test_convert_round_trip():
    """A reference plan's coeffs and extents, carried over by convert.py."""
    shape = (6, 17)
    ref = repro.create(np.array([0.5, -1.0, 2.0, 0.25]), shape, mode="batch",
                       extents=dict(left=2, right=1), backend="jnp", lint="off")
    plan = convert.stencil_batch1d(np.asarray(ref.coeffs), left=ref.left,
                                   right=ref.right, device="cpu")
    c = np.random.default_rng(4).standard_normal(shape)
    np.testing.assert_allclose(
        plan.apply(torch.as_tensor(c)).numpy(),
        np.asarray(ref.apply(jnp.asarray(c))), **tolerance_for("float64", scale=10))
    with pytest.raises(ValueError, match="one weight per window"):
        convert.stencil_batch1d(np.ones(2), left=1, right=1, device="cpu")


def test_validation():
    with pytest.raises(ValueError, match="rank-2"):
        rt.create("laplacian", (4, 8, 8), mode="batch", device="cpu")
    with pytest.raises(ValueError, match="must be 1D"):
        rt.create(np.ones((3, 3)), (8, 8), mode="batch", device="cpu")
    with pytest.raises(ValueError, match="unknown extents"):
        rt.create(lambda w, c: w[0], (8, 8), mode="batch",
                  extents=dict(top=1), device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.stencil_apply_batch1d(torch.zeros((4, 8), dtype=torch.float64),
                                  torch.ones(3, dtype=torch.float64), left=1,
                                  right=1, backend="cuda")
