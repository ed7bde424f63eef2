"""repro_torch's spectral (fft) backend held against the JAX reference on
the CPU.

The same numpy inputs, drawn from a seed, go through the reference's
``backend='fft'`` and ``backend='jnp'`` paths and the port's
``backend='fft'`` and direct (``device='cpu'``: the plain versions) paths,
mirroring ``tests/test_spectral.py``: stencil applies of every family and
registry operator (odd and prime extents, float64 and float32), the 2D and
3D ADI sweeps against the penta path and against the dense cyclic matrix,
20 Cahn–Hilliard steps with spectral sweeps against the penta sweeps, and
the symbol layer.  Each Create-time symbol is checked against the
reference's, and each ``SpectralBackendError`` against the reference's
reason.

Tolerances, ``tolerance_for(dtype, scale)``: scale 50 for one apply or one
solve (the operators sum up to 25 unit-scale taps, and the transforms'
rounding is spread over every output, a few ulp each); scale 2000 for 20
Cahn–Hilliard steps, where the per-step differences compound (the
reference's own bound); symbols, computed from the same float64 numbers by
two FFT libraries, to 1e-12 absolute.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro import api as RA
from repro.core import adi as RADI
from repro.core import cahn_hilliard as RCH
from repro.core import stencil as RS
from repro.kernels import penta as RP
from repro.kernels import spectral as RSP
import repro_torch as rt
from repro_torch import convert
from repro_torch.core import adi as TADI
from repro_torch.core import cahn_hilliard as TCH
from repro_torch.core import stencil as TS
from repro_torch.kernels import _build, ops
from repro_torch.kernels import penta as TP
from repro_torch.kernels import spectral as TSP
from repro_torch.launch import stream as TSTREAM
from repro_torch.util import tolerance_for

OPERATORS = ("laplacian", "biharmonic", "hyperdiffusion", "diffusion")
ADI_OPERATORS = ("hyperdiffusion", "diffusion")
# odd, prime and mixed-parity extents: the inverse lengths must be pinned
SHAPES_2D = ((32, 32), (31, 37), (32, 33))
SHAPES_3D = ((8, 8, 8), (7, 11, 13))
SYMBOL_ATOL = 1e-12


def _rand(shape, dtype="float64", seed=0):
    return np.asarray(np.random.default_rng(seed).standard_normal(shape), dtype)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, dtype, scale):
    np.testing.assert_allclose(_np(got), _np(want), **tolerance_for(dtype, scale=scale))


def _pair(weights_or_fn, shape, *, dtype=None, **kw):
    """The reference's fft and jnp plans and the port's fft and direct
    plans for one request."""
    rkw = dict(kw, lint="off", **({} if dtype is None else dict(dtype=dtype)))
    tkw = dict(kw, device="cpu", **({} if dtype is None else dict(dtype=dtype)))
    return dict(
        ref_fft=RA.create(weights_or_fn, shape, backend="fft", **rkw),
        ref_jnp=RA.create(weights_or_fn, shape, backend="jnp", **rkw),
        fft=rt.create(weights_or_fn, shape, backend="fft", **tkw),
        direct=rt.create(weights_or_fn, shape, **tkw),
    )


def _check_all(plans, x, dtype, scale=50):
    """The port's fft apply against the reference's fft and jnp applies and
    the port's direct path; its dtype is the input's."""
    got = rt.compute(plans["fft"], torch.as_tensor(x))
    assert got.dtype == torch.as_tensor(x).dtype
    assert tuple(got.shape) == x.shape
    _close(got, RA.compute(plans["ref_fft"], jnp.asarray(x)), dtype, scale)
    _close(got, RA.compute(plans["ref_jnp"], jnp.asarray(x)), dtype, scale)
    _close(got, rt.compute(plans["direct"], torch.as_tensor(x)), dtype, scale)
    return got


class TestStencilApply:
    """fft apply == the reference's fft and jnp applies, every family."""

    @pytest.mark.parametrize("opname", OPERATORS)
    @pytest.mark.parametrize("shape", SHAPES_2D)
    def test_2d_fp64(self, opname, shape):
        _check_all(_pair(opname, shape), _rand(shape), "float64")

    @pytest.mark.parametrize("opname", OPERATORS)
    def test_2d_fp32(self, opname):
        shape = (31, 37)
        got = _check_all(_pair(opname, shape, dtype="float32"),
                         _rand(shape, "float32"), "float32")
        assert got.dtype == torch.float32  # the dtype-preservation contract

    @pytest.mark.parametrize("mode, weights", [
        ("x", np.array([1.0, -4.0, 6.0, -4.0, 1.0])),
        ("y", np.array([0.5, -2.0, 1.0, 0.25])),
        ("xy", np.arange(15.0).reshape(5, 3) - 7.0),
    ], ids=["x", "y", "xy"])
    def test_2d_directions(self, mode, weights):
        """A rank-2 plan along x or y has a box with one singleton axis;
        the even-length y stencil needs an explicit split."""
        ext = dict(top=2, bottom=1) if weights.size == 4 else None
        plans = _pair(weights, (13, 17), mode=mode, extents=ext)
        _check_all(plans, _rand((13, 17), seed=5), "float64")

    @pytest.mark.parametrize("opname", OPERATORS)
    def test_batch1d(self, opname):
        _check_all(_pair(opname, (5, 31), mode="batch"), _rand((5, 31)),
                   "float64")

    def test_batch1d_fp32(self):
        got = _check_all(_pair("biharmonic", (6, 29), mode="batch",
                               dtype="float32"),
                         _rand((6, 29), "float32"), "float32")
        assert got.dtype == torch.float32

    @pytest.mark.parametrize("opname", ("laplacian", "diffusion"))
    @pytest.mark.parametrize("shape", SHAPES_3D)
    def test_3d(self, opname, shape):
        _check_all(_pair(opname, shape), _rand(shape), "float64")

    @pytest.mark.parametrize("mode", ["x", "y", "z", "xyz"])
    def test_3d_directions_fp32(self, mode):
        weights = (np.arange(27.0).reshape(3, 3, 3) - 13.0 if mode == "xyz"
                   else np.array([1.0, -2.0, 3.0]))
        got = _check_all(_pair(weights, (7, 6, 9), mode=mode, dtype="float32"),
                         _rand((7, 6, 9), "float32", seed=6), "float32")
        assert got.dtype == torch.float32

    def test_streaming_knobs_never_stream_fft(self, monkeypatch):
        """The fft path needs the whole periodic extent: a plan created
        with streams/max_tile_bytes still applies in one multiply."""
        called = []
        monkeypatch.setattr(TSTREAM, "stream_stencil_apply",
                            lambda *a, **k: called.append(1))
        x = _rand((32, 32), seed=7)
        plan = rt.create("biharmonic", (32, 32), backend="fft", streams=4,
                         max_tile_bytes=1024, device="cpu")
        mono = rt.create("biharmonic", (32, 32), backend="fft", device="cpu")
        got = rt.compute(plan, torch.as_tensor(x))
        assert called == []
        assert torch.equal(got, rt.compute(mono, torch.as_tensor(x)))


class TestSymbols:
    """The Create-time symbols against the reference's, and the symbol
    layer's properties."""

    CASES = {
        "2d-xy": (lambda lib, **k: lib.create("biharmonic", (12, 15), **k)),
        "2d-x": (lambda lib, **k: lib.create(np.array([1.0, 2.0, -3.0]),
                                             (12, 15), mode="x", **k)),
        "2d-y": (lambda lib, **k: lib.create(np.array([1.0, 2.0, -3.0, 4.0, 5.0]),
                                             (12, 15), mode="y", **k)),
        "batch": (lambda lib, **k: lib.create("hyperdiffusion", (4, 15),
                                              mode="batch", **k)),
        "3d-xyz": (lambda lib, **k: lib.create("laplacian", (5, 6, 7), **k)),
        "3d-z": (lambda lib, **k: lib.create(np.array([1.0, -2.0, 1.0]),
                                             (5, 6, 7), mode="z", **k)),
    }

    @pytest.mark.parametrize("dtype", ["float64", "float32"])
    @pytest.mark.parametrize("case", sorted(CASES))
    def test_plan_symbol_matches_reference(self, case, dtype):
        ref = self.CASES[case](repro, backend="fft", lint="off", dtype=dtype)
        got = self.CASES[case](rt, backend="fft", device="cpu", dtype=dtype)
        want = np.asarray(ref.symbol)
        assert got.symbol.dtype == TSP.complex_dtype_for(dtype)
        assert want.dtype == RSP.complex_dtype_for(dtype)
        assert tuple(got.symbol.shape) == want.shape
        atol = SYMBOL_ATOL if dtype == "float64" else 1e-5
        np.testing.assert_allclose(_np(got.symbol), want, atol=atol, rtol=0)

    @pytest.mark.parametrize("case", ["2d", "batch", "3d"])
    def test_converted_symbol_drives_the_transform(self, case):
        """The reference's own symbol, carried across by convert.py, gives
        the reference's apply: the transforms alone, apart from the
        symbols."""
        if case == "2d":
            ref = RA.create("biharmonic", (13, 11), backend="fft", lint="off")
            plan = convert.stencil2d(
                np.asarray(ref.coeffs), left=ref.left, right=ref.right,
                top=ref.top, bottom=ref.bottom, backend="fft",
                symbol=np.asarray(ref.symbol), device="cpu")
            x = _rand((13, 11), seed=8)
        elif case == "batch":
            ref = RA.create("hyperdiffusion", (3, 17), mode="batch",
                            backend="fft", lint="off")
            plan = convert.stencil_batch1d(
                np.asarray(ref.coeffs), left=ref.left, right=ref.right,
                backend="fft", symbol=np.asarray(ref.symbol), device="cpu")
            x = _rand((3, 17), seed=9)
        else:
            ref = RA.create("laplacian", (5, 7, 9), backend="fft", lint="off")
            plan = convert.stencil3d(
                np.asarray(ref.coeffs), halos=ref.halos, backend="fft",
                symbol=np.asarray(ref.symbol), device="cpu")
            x = _rand((5, 7, 9), seed=10)
        _close(rt.compute(plan, torch.as_tensor(x)),
               RA.compute(ref, jnp.asarray(x)), "float64", 50)

    @pytest.mark.parametrize("rank", [2, 3])
    @pytest.mark.parametrize("backend", ["auto", "fft"])
    def test_adi_symbols_match_reference(self, backend, rank):
        """Band symbols are computed at Create whenever cyclic, whatever the
        backend, as the reference computes them."""
        shape = (9, 10, 11)[3 - rank:]
        ref = RA.create("hyperdiffusion", shape, mode="adi", alpha=0.3,
                        alpha_y=0.2, backend="jnp" if backend == "auto" else "fft",
                        lint="off")
        got = rt.create("hyperdiffusion", shape, mode="adi", alpha=0.3,
                        alpha_y=0.2, backend=backend, device="cpu")
        names = ("sym_x", "sym_y", "sym_z")[:rank]
        for name in names:
            np.testing.assert_allclose(_np(getattr(got, name)),
                                       np.asarray(getattr(ref, name)),
                                       atol=SYMBOL_ATOL, rtol=0)

    def test_non_cyclic_operators_carry_no_symbols(self):
        op = rt.create("diffusion", (8, 8), mode="adi", alpha=0.1, bc="np",
                       device="cpu")
        op3 = rt.create("diffusion", (6, 8, 8), mode="adi", alpha=0.1,
                        bc="np", device="cpu")
        assert op.sym_x is None and op.sym_y is None
        assert (op3.sym_x, op3.sym_y, op3.sym_z) == (None, None, None)
        with pytest.raises(TSP.SpectralBackendError, match="no band symbol"):
            dataclasses.replace(op, backend="fft").solve_x(
                torch.zeros((8, 8), dtype=torch.float64))

    def test_stencil_symbol_matches_reference_function(self):
        w = _rand((4, 3), seed=11)
        for los, shape in (((1, 2), (9, 8)), ((0, 0), (3, 2)), ((3, 1), (7, 5))):
            np.testing.assert_allclose(
                _np(TSP.stencil_symbol(w, los, shape, device="cpu")),
                np.asarray(RSP.stencil_symbol(w, los, shape)),
                atol=SYMBOL_ATOL, rtol=0)

    def test_band_symbol_matches_dense_eigenvalues(self):
        n, r = 13, 0.3
        diags = TP.diffusion_diagonals(n, r)
        sym = _np(TSP.band_symbol(*diags, device="cpu"))
        l2, l1, d, u1, u2 = diags
        col = np.zeros(n)
        col[0], col[1], col[2], col[-1], col[-2] = (
            d[0], l1[1], l2[2], u1[-1], u2[-2])
        np.testing.assert_allclose(sym, np.fft.rfft(col), atol=1e-14)
        np.testing.assert_allclose(
            sym, np.asarray(RSP.band_symbol(*RP.diffusion_diagonals(n, r))),
            atol=1e-14)

    def test_wraparound_collisions_accumulate(self):
        """A stencil wider than the domain wraps and sums, as the roll-based
        direct apply does, instead of overwriting."""
        w = np.ones(5)
        plans = _pair(w, (4, 3), mode="batch", bc="periodic")
        _check_all(plans, _rand((4, 3), seed=4), "float64")
        kern = TSP._wrapped_kernel(w, (2,), (3,))
        np.testing.assert_array_equal(kern, RSP._wrapped_kernel(w, (2,), (3,)))
        assert kern.sum() == 5.0

    def test_complex_dtype_pairing(self):
        assert TSP.complex_dtype_for(np.float32) == torch.complex64
        assert TSP.complex_dtype_for(np.float64) == torch.complex128
        assert TSP.complex_dtype_for(torch.float32) == torch.complex64
        assert TSP.complex_dtype_for("float64") == torch.complex128
        for real in (np.float32, np.float64):
            assert (str(TSP.complex_dtype_for(real)).removeprefix("torch.")
                    == np.dtype(RSP.complex_dtype_for(real)).name)

    def test_outputs_keep_the_input_layout(self):
        """As the kernels do: a contiguous field gives a contiguous result
        (an inverse transform along a leading axis returns a strided one),
        and a batch plan on a transposed view returns the view's layout,
        so ``apply_along_y``'s closing ``.T`` is contiguous again."""
        op = rt.create("hyperdiffusion", (6, 7, 8), mode="adi", alpha=0.2,
                       backend="fft", device="cpu")
        x = torch.as_tensor(_rand((6, 7, 8), seed=15))
        for sweep in ("solve_x", "solve_y", "solve_z"):
            assert getattr(op, sweep)(x).is_contiguous(), sweep
        op2 = rt.create("hyperdiffusion", (7, 8), mode="adi", alpha=0.2,
                        backend="fft", device="cpu")
        assert op2.solve_y(x[0]).is_contiguous()
        plan = rt.create("biharmonic", (8, 8), mode="batch", backend="fft",
                         device="cpu")
        f = torch.as_tensor(_rand((8, 8), seed=16))
        got = TADI.apply_along_y(plan, f)
        assert got.is_contiguous()
        direct = rt.create("biharmonic", (8, 8), mode="batch", device="cpu")
        _close(got, TADI.apply_along_y(direct, f), "float64", 50)

    def test_cast_symbol_narrows(self):
        """A complex128 symbol on a float32 field is narrowed, so the
        output stays float32 instead of widening to float64."""
        sym = TSP.stencil_symbol(np.array([1.0, -2.0, 1.0]), (1,), (10,),
                                 dtype="float64", device="cpu")
        assert sym.dtype == torch.complex128
        x = torch.as_tensor(_rand((3, 10), "float32"))
        assert TSP.apply_symbol(x, sym, (-1,)).dtype == torch.float32
        assert TSP.solve_symbol_axis(x, sym[:6], -1).dtype == torch.float32


class TestADISolve:
    """fft implicit sweep == the penta/Woodbury solve (and the dense
    matrix), against the reference's paths."""

    @pytest.mark.parametrize("opname", ADI_OPERATORS)
    @pytest.mark.parametrize("shape", SHAPES_2D)
    def test_2d_matches_penta(self, opname, shape):
        rhs = _rand(shape, seed=1)
        kw = dict(mode="adi", alpha=0.2)
        op_fft = rt.create(opname, shape, backend="fft", device="cpu", **kw)
        op_dir = rt.create(opname, shape, device="cpu", **kw)
        got = rt.compute(op_fft, torch.as_tensor(rhs))
        _close(got, rt.compute(op_dir, torch.as_tensor(rhs)), "float64", 50)
        ref = RA.create(opname, shape, backend="fft", lint="off", **kw)
        _close(got, RA.compute(ref, jnp.asarray(rhs)), "float64", 50)

    @pytest.mark.parametrize("opname", ADI_OPERATORS)
    @pytest.mark.parametrize("shape", SHAPES_3D)
    def test_3d_matches_penta(self, opname, shape):
        rhs = _rand(shape, seed=2)
        kw = dict(mode="adi", alpha=0.1)
        op_fft = rt.create(opname, shape, backend="fft", device="cpu", **kw)
        op_dir = rt.create(opname, shape, device="cpu", **kw)
        x = torch.as_tensor(rhs)
        for sweep in ("solve_x", "solve_y", "solve_z"):
            _close(getattr(op_fft, sweep)(x), getattr(op_dir, sweep)(x),
                   "float64", 50)
        got = rt.compute(op_fft, x)
        _close(got, rt.compute(op_dir, x), "float64", 50)
        ref = RA.create(opname, shape, backend="fft", lint="off", **kw)
        _close(got, RA.compute(ref, jnp.asarray(rhs)), "float64", 50)

    @pytest.mark.parametrize("rank", [2, 3])
    def test_sweeps_preserve_float32(self, rank):
        shape = (9, 10, 12)[3 - rank:]
        op = rt.create("hyperdiffusion", shape, mode="adi", alpha=0.2,
                       dtype="float32", backend="fft", device="cpu")
        direct = rt.create("hyperdiffusion", shape, mode="adi", alpha=0.2,
                           dtype="float32", device="cpu")
        x = torch.as_tensor(_rand(shape, "float32", seed=12))
        got = rt.compute(op, x)
        assert got.dtype == torch.float32
        _close(got, rt.compute(direct, x), "float32", 50)

    def test_x_sweep_solves_the_dense_cyclic_system(self):
        """Residual check independent of both solvers: A @ x == rhs for the
        dense cyclic pentadiagonal matrix."""
        n, alpha = 31, 0.27
        op = rt.create("hyperdiffusion", (8, n), mode="adi", alpha=alpha,
                       backend="fft", device="cpu")
        A = _dense_cyclic(TP.hyperdiffusion_diagonals(n, alpha))
        rhs = _rand((8, n), seed=3)
        x = _np(op.solve_x(torch.as_tensor(rhs)))
        _close(x @ A.T, rhs, "float64", 50)
        # the y-sweep solves down the columns of the (8, n) field
        y = _np(op.solve_y(torch.as_tensor(rhs)))
        _close(_dense_cyclic(TP.hyperdiffusion_diagonals(8, alpha)) @ y, rhs,
               "float64", 50)

    @pytest.mark.parametrize("rank", [2, 3])
    def test_replace_backend_runs_the_fft_sweeps(self, rank, monkeypatch):
        """``dataclasses.replace(op, backend='fft')`` works because cyclic
        operators carry their symbols whatever the backend, and the fft
        sweeps never reach a penta solve."""
        shape = (9, 10, 12)[3 - rank:]
        op = rt.create("hyperdiffusion", shape, mode="adi", alpha=0.2,
                       device="cpu")
        fft = dataclasses.replace(op, backend="fft")
        x = torch.as_tensor(_rand(shape, seed=13))
        want = rt.compute(op, x)
        for name in ("cyclic_penta_solve_factored",
                     "cyclic_penta_solve_factored_rows",
                     "cyclic_penta_solve_factored_mid"):
            monkeypatch.setattr(TADI, name, _forbidden)
        _close(rt.compute(fft, x), want, "float64", 50)

    def test_ch_evolve_drift_stays_at_rounding(self):
        """20 Cahn–Hilliard steps with spectral implicit sweeps track the
        penta path (the RHS stays on the stencil plans in both), and the
        reference's spectral run, at accumulated-rounding level; both
        conserve mass."""
        n = 32
        cfg = TCH.CHConfig(nx=n, ny=n, dt=1e-3, rhs_mode="stencil", device="cpu")
        direct = TCH.CahnHilliardADI(cfg)
        fft = TCH.CahnHilliardADI(cfg)
        fft.op_full = dataclasses.replace(fft.op_full, backend="fft")
        fft.op_half = dataclasses.replace(fft.op_half, backend="fft")
        rcfg = RCH.CHConfig(nx=n, ny=n, dt=1e-3, rhs_mode="stencil", backend="jnp")
        ref = RCH.CahnHilliardADI(rcfg)
        ref.op_full = dataclasses.replace(ref.op_full, backend="fft")
        ref.op_half = dataclasses.replace(ref.op_half, backend="fft")

        c0 = np.asarray(RCH.deep_quench_ic(n, n, seed=7))
        c0_t = TCH.deep_quench_ic(n, n, seed=7, device="cpu")
        np.testing.assert_array_equal(_np(c0_t), c0)
        a_n, a_nm1 = direct.initial_step(c0_t), c0_t
        b_n, b_nm1 = fft.initial_step(c0_t), c0_t
        r_n, r_nm1 = ref.initial_step(jnp.asarray(c0)), jnp.asarray(c0)
        for _ in range(20):
            a_n, a_nm1 = direct.step(a_n, a_nm1)
            b_n, b_nm1 = fft.step(b_n, b_nm1)
            r_n, r_nm1 = ref.step(r_n, r_nm1)
        _close(b_n, a_n, "float64", 2000)
        _close(b_n, r_n, "float64", 2000)
        np.testing.assert_allclose(float(b_n.mean()), float(c0.mean()), atol=1e-12)


def _forbidden(*args, **kwargs):
    raise AssertionError("an fft sweep reached a penta solve")


def _dense_cyclic(bands):
    l2, l1, d, u1, u2 = bands
    n = d.shape[0]
    A = np.zeros((n, n))
    for i in range(n):
        for off, b in ((-2, l2), (-1, l1), (0, d), (1, u1), (2, u2)):
            A[i, (i + off) % n] += b[i]
    return A


def _message(exc_info) -> str:
    return str(exc_info.value)


def _ref_message_for_port(msg: str) -> str:
    """The reference's message with its backend list in the port's names."""
    return msg.replace("auto, jnp, pallas, fft", "auto, cuda, torch, fft")


def _fn(windows, coeffs):
    return coeffs[0] * (windows[0] - windows[1])


REFUSALS = {
    "np-2d": (lambda lib, **k: lib.create("laplacian", (8, 8), bc="np", **k)),
    "np-batch": (lambda lib, **k: lib.create("laplacian", (4, 8), mode="batch",
                                             bc="np", **k)),
    "np-3d": (lambda lib, **k: lib.create("laplacian", (6, 6, 6), bc="np", **k)),
    "point-fn": (lambda lib, **k: lib.create(
        _fn, (8, 8), mode="x", coeffs=np.ones(1), extents=dict(left=1, right=0),
        **k)),
    "point-fn-3d": (lambda lib, **k: lib.create(
        _fn, (6, 6, 6), mode="z", coeffs=np.ones(1),
        extents=dict(front=1, back=0), **k)),
    "non-cyclic-adi": (lambda lib, **k: lib.create(
        "hyperdiffusion", (8, 8), mode="adi", alpha=0.1, bc="np", **k)),
    "non-cyclic-adi-3d": (lambda lib, **k: lib.create(
        "diffusion", (6, 8, 8), mode="adi", alpha=0.1, cyclic=False, **k)),
}


class TestRefusals:
    """Each SpectralBackendError at Create, with the reference's reason."""

    @pytest.mark.parametrize("case", sorted(REFUSALS))
    def test_create_refusal_matches_reference(self, case):
        with pytest.raises(RSP.SpectralBackendError) as ref:
            REFUSALS[case](RA, backend="fft", lint="off")
        with pytest.raises(TSP.SpectralBackendError) as got:
            REFUSALS[case](rt, backend="fft", device="cpu")
        assert _message(got) == _ref_message_for_port(_message(ref))
        assert isinstance(got.value, ValueError)

    @pytest.mark.parametrize("family", ["2d", "batch", "3d"])
    def test_missing_shape(self, family):
        make_ref, make_port, w = {
            "2d": (RS._create_2d, TS._create_2d, np.ones((3, 3))),
            "batch": (RS._create_1d_batch, TS._create_1d_batch, np.ones(3)),
            "3d": (RS._create_3d, TS._create_3d, np.ones((3, 3, 3))),
        }[family]
        lead = () if family == "batch" else (("xy" if family == "2d" else "xyz"),)
        with pytest.raises(RSP.SpectralBackendError) as ref:
            make_ref(*lead, "periodic", weights=w, backend="fft")
        with pytest.raises(TSP.SpectralBackendError, match="pass shape") as got:
            make_port(*lead, "periodic", weights=w, backend="fft", device="cpu")
        assert _message(got) == _ref_message_for_port(_message(ref))

    def test_ch_config_fft(self):
        """CHConfig(backend='fft') fails at the function-pointer Laplacian
        plan, as in the reference."""
        with pytest.raises(RSP.SpectralBackendError) as ref:
            RCH.CahnHilliardADI(RCH.CHConfig(nx=16, ny=16, backend="fft"))
        with pytest.raises(TSP.SpectralBackendError,
                           match="function-pointer") as got:
            TCH.CahnHilliardADI(TCH.CHConfig(nx=16, ny=16, backend="fft",
                                             device="cpu"))
        assert _message(got) == _ref_message_for_port(_message(ref))

    def test_adi_factory_refusal(self):
        with pytest.raises(RSP.SpectralBackendError) as ref:
            RADI._make_adi_operator(8, 8, 0.1, cyclic=False, backend="fft")
        with pytest.raises(TSP.SpectralBackendError) as got:
            TADI._make_adi_operator(8, 8, 0.1, cyclic=False, backend="fft",
                                    device="cpu")
        assert _message(got) == _ref_message_for_port(_message(ref))

    def test_auto_never_picks_fft(self):
        for plan in (rt.create("laplacian", (8, 8), device="cpu"),
                     rt.create("laplacian", (4, 8), mode="batch", device="cpu"),
                     rt.create("laplacian", (6, 6, 6), device="cpu")):
            assert plan.backend == "auto" and plan.symbol is None

    def test_kernel_wrappers_refuse_fft(self):
        x = torch.zeros((8, 8), dtype=torch.float64)
        with pytest.raises(ValueError, match="reached a kernel wrapper"):
            ops.stencil_apply(x, torch.ones(9, dtype=torch.float64), left=1,
                              right=1, top=1, bottom=1, backend="fft")
        with pytest.raises(ValueError, match="reached a kernel wrapper"):
            _build.resolve_backend("fft", x)
        with pytest.raises(ValueError, match="backend must be one of"):
            rt.create("laplacian", (8, 8), backend="jnp", device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
class TestOnCard:
    """On a CUDA tensor an fft plan stays on the card, matches the kernel
    path within scale 50 and launches none of the port's kernels."""

    @pytest.mark.parametrize("case", ["2d", "batch", "3d", "adi", "adi3d"])
    def test_fft_on_card(self, cuda, case):
        shape, kw = {
            "2d": ((64, 61), dict(weights_or_fn="biharmonic")),
            "batch": ((16, 61), dict(weights_or_fn="hyperdiffusion", mode="batch")),
            "3d": ((16, 17, 18), dict(weights_or_fn="laplacian")),
            "adi": ((64, 61), dict(weights_or_fn="hyperdiffusion", mode="adi",
                                   alpha=0.2)),
            "adi3d": ((16, 17, 18), dict(weights_or_fn="diffusion", mode="adi",
                                         alpha=0.3)),
        }[case]
        name = kw.pop("weights_or_fn")
        x = torch.as_tensor(_rand(shape, seed=14), device=cuda)
        fft = rt.create(name, shape, backend="fft", device=cuda, **kw)
        kernel = rt.create(name, shape, device=cuda, **kw)
        want = rt.compute(kernel, x)
        _build.reset_launches()
        got = rt.compute(fft, x)
        torch.cuda.synchronize()
        assert got.is_cuda and got.dtype == x.dtype
        assert sum(_build.LAUNCHES.values()) == 0, dict(_build.LAUNCHES)
        _close(got, want, "float64", 50)
