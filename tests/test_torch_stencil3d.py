"""repro_torch's 3D stencil family held against the JAX reference on the CPU.

The port's plain path (as a CPU tensor selects it) against the reference's
Pallas kernel in interpret mode (``stencil3d_pallas(interpret=True)`` on a
tiled box, as ``tests/test_stencil3d.py`` runs it, and the alignment-padded
``ops.stencil_apply_3d(backend='pallas', interpret=True)`` on a ragged box),
against its jnp path and against both packages' ``stencil3d_ref``:
weighted and cube function-pointer modes, periodic and ``np`` with
``out_init``, several halo sets, and through the facade (rank-3
``create``).  Tolerance ``tolerance_for(dtype, scale=10)``: one pass of at
most 27 products summed in the same window order, so the packages differ
only where XLA contracts a multiply-add.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.core.cahn_hilliard import cube_laplacian_point_fn as ref_cube
from repro.core.stencil import laplacian3d_weights as ref_lap3d
from repro.kernels import ops as RO
from repro.kernels import ref as RR
from repro.kernels.stencil3d import stencil3d_pallas
import repro_torch as rt
from repro_torch import convert
from repro_torch.core.cahn_hilliard import cube_laplacian_point_fn
from repro_torch.core.stencil import laplacian3d_weights
from repro_torch.kernels import ops
from repro_torch.kernels import ref as TR
from repro_torch.util import tolerance_for

HALOS = {
    "box1": (1, 1, 1, 1, 1, 1),
    "skew": (0, 2, 1, 0, 2, 1),
    "zx": (2, 0, 0, 0, 1, 0),
}


def _n_sten(halos):
    fr, bk, tp, bt, lf, rt_ = halos
    return (fr + bk + 1) * (tp + bt + 1) * (lf + rt_ + 1)


def _case(halos, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    data = np.asarray(rng.uniform(-1.0, 1.0, shape), dtype)
    coeffs = np.asarray(rng.standard_normal(_n_sten(halos)), dtype)
    out_init = np.asarray(rng.standard_normal(shape), dtype)
    return data, coeffs, out_init


def _check(got, wants, shape, dtype):
    assert tuple(got.shape) == shape and got.dtype == getattr(torch, dtype)
    for name, want in wants.items():
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **tolerance_for(dtype, scale=10), err_msg=name)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("bc", ["periodic", "np"])
@pytest.mark.parametrize("halos", list(HALOS))
def test_matches_pallas_tiled(halos, bc, dtype):
    """(8, 16, 24) on (4, 8) tiles: the raw Pallas kernel."""
    halos, shape = HALOS[halos], (8, 16, 24)
    data, coeffs, out_init = _case(halos, shape, dtype, 1)
    init = out_init if bc == "np" else None
    got = ops.stencil_apply_3d(torch.as_tensor(data), torch.as_tensor(coeffs),
                               None if init is None else torch.as_tensor(init),
                               halos=halos, bc=bc)
    jargs = (jnp.asarray(data), jnp.asarray(coeffs),
             None if init is None else jnp.asarray(init))
    _check(got, {
        "pallas": stencil3d_pallas(*jargs, halos=halos, bc=bc, tz=4, ty=8,
                                   interpret=True),
        "ref": RR.stencil3d_ref(jargs[0], bc=bc, halos=halos, coeffs=jargs[1],
                                out_init=jargs[2]),
    }, shape, dtype)
    if bc == "np":  # cells outside the interior pass out_init through
        fr, bk, tp, bt, lf, rt_ = halos
        edge = np.ones(shape, bool)
        edge[fr: shape[0] - bk, tp: shape[1] - bt, lf: shape[2] - rt_] = False
        np.testing.assert_array_equal(got.numpy()[edge], out_init[edge])


@pytest.mark.parametrize("point_fn", ["weighted", "cube"])
@pytest.mark.parametrize("bc", ["periodic", "np"])
def test_matches_reference_ragged(bc, point_fn):
    """A ragged (5, 7, 9) box through the reference's alignment-padded
    Pallas dispatch and its jnp path, in both point-function modes."""
    halos, shape = HALOS["box1"], (5, 7, 9)
    data, coeffs, out_init = _case(halos, shape, "float64", 2)
    init = out_init if bc == "np" else None
    fns = (cube_laplacian_point_fn, ref_cube) if point_fn == "cube" else (
        TR.weighted_point_fn, RR.weighted_point_fn)
    got = ops.stencil_apply_3d(torch.as_tensor(data), torch.as_tensor(coeffs),
                               None if init is None else torch.as_tensor(init),
                               point_fn=fns[0], halos=halos, bc=bc)
    jargs = (jnp.asarray(data), jnp.asarray(coeffs),
             None if init is None else jnp.asarray(init))
    _check(got, {
        backend: RO.stencil_apply_3d(*jargs, point_fn=fns[1], halos=halos,
                                     bc=bc, backend=backend, **extra)
        for backend, extra in (("pallas", {"interpret": True}), ("jnp", {}))
    }, shape, "float64")


def test_laplacian3d_weights_match_reference():
    for h in (1.0, 0.3):
        np.testing.assert_array_equal(laplacian3d_weights(h), ref_lap3d(h))


@pytest.mark.parametrize("mode", ["xyz", "x", "y", "z"])
def test_facade_matches_reference(mode):
    shape = (6, 7, 8)
    c = np.random.default_rng(3).standard_normal(shape)
    plan = rt.create("laplacian", shape, mode=mode, h=0.5, device="cpu")
    ref = repro.create("laplacian", shape, mode=mode, h=0.5, backend="jnp",
                       lint="off")
    assert type(plan).__name__ == "Stencil3D"
    assert plan.direction == ref.direction and plan.halos == ref.halos
    tol = tolerance_for("float64", scale=10)
    np.testing.assert_allclose(
        rt.compute(plan, torch.as_tensor(c)).numpy(),
        np.asarray(repro.compute(ref, jnp.asarray(c))), **tol)
    # explicit weights with an explicit split, np boundary with out_init
    w = np.arange(1.0, 4.0) if mode != "xyz" else np.arange(18.0).reshape(2, 3, 3)
    keys = {"x": ("left", "right"), "y": ("top", "bottom"), "z": ("front", "back"),
            "xyz": ("front", "back")}[mode]
    ext = dict(zip(keys, (0, 1) if mode == "xyz" else (2, 0)))
    init = np.full(shape, -1.5)
    kw = dict(mode=mode, bc="np", extents=ext)
    plan = rt.create(w, shape, device="cpu", **kw)
    ref = repro.create(w, shape, backend="jnp", lint="off", **kw)
    assert plan.halos == ref.halos
    np.testing.assert_allclose(
        rt.compute(plan, torch.as_tensor(c), torch.as_tensor(init)).numpy(),
        np.asarray(repro.compute(ref, jnp.asarray(c), jnp.asarray(init))), **tol)


def test_function_plan_and_convert_round_trip():
    shape = (4, 5, 6)
    c = np.random.default_rng(4).uniform(-0.5, 0.5, shape)
    ext = dict(front=1, back=1, top=1, bottom=1, left=1, right=1)
    coeffs = laplacian3d_weights().ravel()
    plan = rt.create(cube_laplacian_point_fn, shape, coeffs=coeffs, extents=ext,
                     device="cpu")
    ref = repro.create(ref_cube, shape, coeffs=coeffs, extents=ext,
                       backend="jnp", lint="off")
    tol = tolerance_for("float64", scale=10)
    np.testing.assert_allclose(
        rt.compute(plan, torch.as_tensor(c)).numpy(),
        np.asarray(repro.compute(ref, jnp.asarray(c))), **tol)
    lap = repro.create("laplacian", shape, backend="jnp", lint="off")
    conv = convert.stencil3d(np.asarray(lap.coeffs), halos=lap.halos, device="cpu")
    assert conv.direction == "xyz" and conv.num_sten == 27
    np.testing.assert_allclose(
        conv.apply(torch.as_tensor(c)).numpy(),
        np.asarray(lap.apply(jnp.asarray(c))), **tol)
    assert convert.stencil3d(np.ones(3), halos=(1, 1, 0, 0, 0, 0),
                             device="cpu").direction == "z"
    with pytest.raises(ValueError, match="one weight per window"):
        convert.stencil3d(np.ones(3), halos=(1, 1, 1, 1, 0, 0), device="cpu")


def test_validation():
    with pytest.raises(ValueError, match="ambiguous"):
        rt.create(np.ones(3), (4, 5, 6), device="cpu")
    with pytest.raises(ValueError, match="mode for a rank-3"):
        rt.create("laplacian", (4, 5, 6), mode="xy", device="cpu")
    with pytest.raises(ValueError, match="off-axis"):
        rt.create(lambda w, c: w[0], (4, 5, 6), mode="x",
                  extents=dict(top=1), device="cpu")
    with pytest.raises(ValueError, match="rank 2 or 3"):
        rt.create("laplacian", (4, 5, 6, 7), device="cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ops.stencil_apply_3d(torch.zeros((3, 4, 5), dtype=torch.float64),
                             torch.ones(27, dtype=torch.float64),
                             halos=(1,) * 6, backend="cuda")
