"""repro_torch's public surface against the JAX reference's.

``repro_torch.__all__`` is snapshot-checked like ``tests/test_api_surface.py``
checks ``repro.__all__``: the reference's 31 names plus the port's four
Cahn–Hilliard names.  Each deprecated shim warns with the reference's text
(the package named as this one) and returns what ``create`` returns;
``plan_key`` gives the reference's string; ``central_difference_weights``
the reference's weights; the one-shot ``ops.penta_solve`` the dense
solution (``tolerance_for(float64, scale=10)``: one factor-and-substitute
pass of at most 16 rows, as ``tests/test_torch_penta.py`` holds it).
"""

import json
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro.kernels import ops as RO
import repro_torch as rt
from repro_torch.kernels import ops
from repro_torch.kernels import penta as TP
from repro_torch.kernels import ref as TR
from repro_torch.util import tolerance_for

CH_NAMES = ["CHConfig", "CahnHilliardADI", "ch_evolve", "deep_quench_ic"]

# The committed surface: the reference's, plus the solver's four names.
EXPECTED_SURFACE = sorted(
    [
        # the four-function facade + operator registry
        "create",
        "compute",
        "swap",
        "destroy",
        "register_operator",
        "get_operator",
        "operator_names",
        "plan_key",
        "OperatorDef",
        # plan classes
        "PlanCore",
        "Stencil2D",
        "StencilBatch1D",
        "Stencil3D",
        "ADIOperator",
        "ADIOperator3D",
        "DoubleBuffer",
        # the spectral (fft) backend's named Create-time refusal
        "SpectralBackendError",
        # engine-level destroy + weight helpers
        "plan_destroy",
        "central_difference_weights",
        "laplacian3d_weights",
        # deprecated pre-facade entry points (one release)
        "stencil_create_2d",
        "stencil_compute_2d",
        "stencil_destroy_2d",
        "stencil_create_1d_batch",
        "stencil_compute_1d_batch",
        "stencil_destroy_1d_batch",
        "stencil_create_3d",
        "stencil_compute_3d",
        "stencil_destroy_3d",
        "make_adi_operator",
        "make_adi_operator_3d",
    ]
    + CH_NAMES
)


def test_all_matches_committed_snapshot():
    assert sorted(rt.__all__) == EXPECTED_SURFACE


def test_surface_is_the_references_plus_the_solver():
    assert len(repro.__all__) == 31
    assert sorted(rt.__all__) == sorted(list(repro.__all__) + CH_NAMES)
    assert len(rt.__all__) == len(set(rt.__all__)) == 35


def test_every_name_importable_and_documented():
    for name in rt.__all__:
        obj = getattr(rt, name)
        assert obj is not None, name
        assert (obj.__doc__ or "").strip(), f"repro_torch.{name} has no docstring"


def test_star_import_matches_all():
    ns = {}
    exec("from repro_torch import *", ns)  # noqa: S102 — the point of the test
    assert {k for k in ns if not k.startswith("_")} == set(rt.__all__)


def test_spectral_error_is_a_value_error():
    assert issubclass(rt.SpectralBackendError, ValueError)


def _port_text(ref_text: str) -> str:
    """The reference's warning text, naming this package."""
    return ref_text.replace("repro.", "repro_torch.")


def _warning_of(fn, *args, **kwargs):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn(*args, **kwargs)
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1, [str(w.message) for w in caught]
    return out, str(dep[0].message)


def _same_plan(a, b):
    assert type(a) is type(b)
    assert a.halo == b.halo and a.bc == b.bc and a.backend == b.backend
    np.testing.assert_array_equal(a.coeffs.numpy(), b.coeffs.numpy())


W2 = np.arange(15.0).reshape(5, 3) - 7.0
W3 = np.arange(27.0).reshape(3, 3, 3) - 13.0
W1 = np.array([1.0, -2.0, 1.0])

SHIMS = {
    "2d": ("stencil_create_2d", "stencil_compute_2d", "stencil_destroy_2d",
           ("xy", "periodic"), dict(weights=W2), (W2, (9, 8)), {}),
    "1d_batch": ("stencil_create_1d_batch", "stencil_compute_1d_batch",
                 "stencil_destroy_1d_batch", ("periodic",), dict(weights=W1),
                 (W1, (4, 9)), dict(mode="batch")),
    "3d": ("stencil_create_3d", "stencil_compute_3d", "stencil_destroy_3d",
           ("xyz", "periodic"), dict(weights=W3), (W3, (5, 6, 7)), {}),
}


@pytest.mark.parametrize("family", sorted(SHIMS))
def test_stencil_shims_warn_and_match_create(family):
    c_name, p_name, d_name, args, kw, (w, shape), ckw = SHIMS[family]
    ref_plan, ref_text = _warning_of(getattr(repro, c_name), *args, **kw)
    plan, text = _warning_of(getattr(rt, c_name), *args, device="cpu", **kw)
    assert text == _port_text(ref_text)
    assert getattr(rt, c_name).__name__ == c_name
    want = rt.create(w, shape, device="cpu", **ckw)
    _same_plan(plan, want)
    x = np.random.default_rng(3).standard_normal(shape)
    out, text = _warning_of(getattr(rt, p_name), plan, torch.as_tensor(x))
    _, ref_text = _warning_of(getattr(repro, p_name), ref_plan, jnp.asarray(x))
    assert text == _port_text(ref_text)
    assert torch.equal(out, rt.compute(want, torch.as_tensor(x)))
    np.testing.assert_allclose(out.numpy(), np.asarray(repro.compute(ref_plan,
                                                                     jnp.asarray(x))),
                               **tolerance_for("float64", scale=10))
    _, text = _warning_of(getattr(rt, d_name), plan)
    _, ref_text = _warning_of(getattr(repro, d_name), ref_plan)
    assert text == _port_text(ref_text)
    assert plan.destroyed
    with pytest.raises(ValueError, match="destroyed"):
        rt.compute(plan, torch.as_tensor(x))


@pytest.mark.parametrize("rank", [2, 3])
def test_adi_shims_warn_and_match_create(rank):
    name = "make_adi_operator" if rank == 2 else "make_adi_operator_3d"
    shape = (10, 12) if rank == 2 else (6, 10, 12)
    _, ref_text = _warning_of(getattr(repro, name), *shape, 0.2)
    op, text = _warning_of(getattr(rt, name), *shape, 0.2, device="cpu")
    assert text == _port_text(ref_text)
    want = rt.create("hyperdiffusion", shape, mode="adi", alpha=0.2, device="cpu")
    assert type(op) is type(want) and op.cyclic and op.operator == want.operator
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(shape))
    assert torch.equal(rt.compute(op, x), rt.compute(want, x))


KEY_GRID = [
    ("laplacian", (64, 64), "float32", "periodic", None, None, None),
    ("laplacian", [64, 64], "float64", "np", "x", None, None),
    ("biharmonic", (31, 37), "float64", "periodic", "xy", None,
     {"backend": "fft"}),
    ("hyperdiffusion", (8, 16, 32), "float32", "periodic", "adi", 0.25, None),
    ("diffusion", (128, 128), "float64", "np", "adi", 1e-3,
     {"bucket": 4, "backend": "auto"}),
    ("laplacian", (4, 1024), "float16", "periodic", "batch", None, {"b": [1, 2]}),
]


@pytest.mark.parametrize("case", range(len(KEY_GRID)))
def test_plan_key_matches_reference(case):
    op, shape, dtype, bc, mode, alpha, extra = KEY_GRID[case]
    kw = dict(bc=bc, mode=mode, alpha=alpha, extra=extra)
    want = repro.plan_key(op, shape, dtype=dtype, **kw)
    assert rt.plan_key(op, shape, dtype=dtype, **kw) == want
    assert rt.plan_key(op, shape, dtype=getattr(torch, dtype), **kw) == want
    assert rt.plan_key(op, shape, dtype=np.dtype(dtype), **kw) == want
    assert json.loads(want)["dtype"] == dtype


def test_plan_key_discriminates():
    key = rt.plan_key("laplacian", (64, 64), dtype="float32")
    assert key != rt.plan_key("laplacian", (64, 64), dtype="float32", bc="np")
    assert key != rt.plan_key("laplacian", (64, 64), dtype="float64")
    assert key == rt.plan_key("laplacian", [64, 64], dtype=torch.float32)
    assert (rt.plan_key("x", (8, 8), dtype="bfloat16")
            == repro.plan_key("x", (8, 8), dtype=jnp.bfloat16))


@pytest.mark.parametrize("order, derivative", [(2, 1), (4, 1), (8, 1), (2, 2),
                                               (4, 2), (8, 2)])
def test_central_difference_weights_match_reference(order, derivative):
    got = rt.central_difference_weights(order, derivative, h=0.1)
    want = repro.central_difference_weights(order, derivative, h=0.1)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    with pytest.raises(ValueError, match="even"):
        rt.central_difference_weights(3, 1)


def test_laplacian3d_weights_match_reference():
    np.testing.assert_array_equal(rt.laplacian3d_weights(0.5),
                                  repro.laplacian3d_weights(0.5))


@pytest.mark.parametrize("cyclic", [False, True], ids=["plain", "cyclic"])
@pytest.mark.parametrize("rhs_shape", [(16,), (16, 5)], ids=["vector", "matrix"])
def test_penta_solve_matches_dense(cyclic, rhs_shape):
    rng = np.random.default_rng(5)
    l2, l1, u1, u2 = (rng.uniform(-1.0, 1.0, 16) for _ in range(4))
    d = 6.0 + rng.uniform(0.0, 1.0, 16)
    rhs = rng.standard_normal(rhs_shape)
    got = ops.penta_solve(l2, l1, d, u1, u2, torch.as_tensor(rhs), cyclic=cyclic)
    want = TR.penta_solve_ref(*(torch.as_tensor(b) for b in (l2, l1, d, u1, u2)),
                              torch.as_tensor(rhs), cyclic=cyclic)
    tol = tolerance_for("float64", scale=10)
    assert tuple(got.shape) == rhs_shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    ref = RO.penta_solve(*(jnp.asarray(b) for b in (l2, l1, d, u1, u2)),
                         jnp.asarray(rhs), cyclic=cyclic, backend="jnp")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
    with pytest.raises(ValueError, match="reached a kernel wrapper"):
        ops.penta_solve(l2, l1, d, u1, u2, torch.as_tensor(rhs), cyclic=cyclic,
                        backend="fft")


def test_penta_solve_float32_and_tensor_bands():
    bands = TP.hyperdiffusion_diagonals(12, 0.3, torch.float32)
    rhs = torch.as_tensor(np.random.default_rng(6).standard_normal((12, 3)),
                          dtype=torch.float32)
    got = ops.penta_solve(*(torch.as_tensor(b) for b in bands), rhs, cyclic=True)
    assert got.dtype == torch.float32
    dense = TR.penta_dense_cyclic(*(torch.as_tensor(b, dtype=torch.float64)
                                    for b in bands))
    np.testing.assert_allclose((dense @ got.double()).numpy(), rhs.double().numpy(),
                               **tolerance_for("float32", scale=10))
