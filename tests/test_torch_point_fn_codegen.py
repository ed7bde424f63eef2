"""Plain PyTorch point functions translated for the stencil kernels
(``repro_torch.kernels.point_fn``), on the CPU.

The functions are the reference's own: quickstart's central difference
(``examples/quickstart.py``, also ``tests/test_api.py`` and the z
difference of ``tests/test_stencil3d.py``), the cube sums of
``tests/test_kernels_allclose.py``, ``tests/test_stencil1d_batch.py`` and
``tests/test_stream_exec.py``, ``c * w * w`` of ``tests/test_stencil3d.py``,
``cube_laplacian_point_fn``'s body without its tag, the non-separable
``w0 w1 - c0 w2``, and two that reach the rest of the translator's table
(``torch.where``, ``pow``, ``sin``, ``clamp``, a closure constant, ...),
each over the window counts of a batched-1D, a 2D and a 3D plan.

- ``eval_torch(trace(fn))`` is ``fn`` bit for bit, in float32 and
  float64: the translation keeps every op, operand and literal.
- The port's plain plan with each function is within
  ``tolerance_for(dtype)`` of the reference's ``backend='jnp'`` plan with
  its jnp twin: XLA and torch round the same operations, in the same
  order, each to its dtype (XLA may fuse a multiply-add).
- The CUDA text is held to golden text, and a launch of a CPU tensor
  through the card's wrapper (stubbed) builds the stencil libraries from
  the translation.  The kernels run in ``tests/test_torch_kernels_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro_torch.kernels import _build
from repro_torch.kernels import point_fn as PF
from repro_torch.kernels import stencil1d_batch as S1
from repro_torch.kernels import stencil2d as S2
from repro_torch.kernels import stencil3d as S3
from repro_torch.util import tolerance_for


def central_difference(windows, coe):
    return coe[0] * (windows[0] - 2.0 * windows[1] + windows[2])


def cube_sum(windows, coe):
    return sum(c * (w * w * w - w) for c, w in zip(coe, windows, strict=True))


def cube_loop(windows, coeffs):
    out = None
    for w, c in zip(windows, coeffs, strict=True):
        term = c * (w * w * w - w)
        out = term if out is None else out + term
    return out


def square_sum(windows, coe):
    return sum(c * w * w for c, w in zip(coe, windows, strict=True))


def cube_laplacian_body(windows, coeffs):
    """``cube_laplacian_point_fn`` without its ``device_point_fn`` tag."""
    out = None
    for w, c in zip(windows, coeffs, strict=True):
        term = c * (w * w * w - w)
        out = term if out is None else out + term
    return out


def mixed(windows, coeffs):
    return windows[0] * windows[1] - coeffs[0] * windows[2]


def where_pow_sin(windows, coe, np_=torch):
    w0, w1, w2 = windows[0], windows[1], windows[2]
    return (coe[0] * (w0 - 2.0 * w1 + w2) + np_.where(w1 > 0, w1 ** 3, -w1)
            + np_.sin(w0))


# a 0-d tensor the function closes over: a literal of the translation
HALF = torch.tensor(0.5, dtype=torch.float64)


def table(windows, coe, np_=torch):
    w0, w1, w2 = windows[0], windows[1], windows[2]
    t = torch if np_ is torch else None
    rsqrt = t.rsqrt if t else jax.lax.rsqrt
    clamp = t.clamp if t else jnp.clip
    half = HALF if t else 0.5
    a = (clamp(w0, -0.5, 0.5) + np_.maximum(w1, w2)
         - np_.minimum(w1, 0.25 * w2))
    b = (np_.sqrt(np_.abs(w1) + 1.0) + rsqrt(w2 * w2 + 1.0)
         + np_.exp(-w0) / 3.0 + 1.0 / (2.0 + w0))
    d = (np_.where(w0 >= w2, np_.tanh(w1), np_.cos(w2))
         + np_.log(1.0 + w1 ** 2) + (2.0 + w1) ** -2 + (w2 + 3.0) ** 0.5
         - (w2 + 3.0) ** -0.5 + (w0 + 2.0) ** -1 + (w1 + 2.0) ** 2.5)
    return coe[0] * a + half * b - d / coe[1]


# name -> (torch function, jnp twin, coefficients: 'window' (one a
# window) or a fixed count)
FNS = {
    "central_difference": (central_difference, central_difference, 1),
    "cube_sum": (cube_sum, cube_sum, "window"),
    "cube_loop": (cube_loop, cube_loop, "window"),
    "square_sum": (square_sum, square_sum, "window"),
    "cube_laplacian_body": (cube_laplacian_body, cube_laplacian_body,
                            "window"),
    "mixed": (mixed, mixed, 1),
    "where_pow_sin": (where_pow_sin,
                      lambda w, c: where_pow_sin(w, c, np_=jnp), 1),
    "table": (table, lambda w, c: table(w, c, np_=jnp), 2),
}

# family -> (shape, mode, extents, windows)
FAMILIES = {
    "1d": ((7, 19), "batch", dict(left=1, right=1), 3),
    "2d": ((13, 11), None, dict(left=1, right=1, top=1, bottom=1), 9),
    "3d": ((6, 7, 9), None, dict(front=1, back=1, top=1, bottom=1, left=1,
                                 right=1), 27),
}


def _ncoeffs(name, nwin):
    n = FNS[name][2]
    return nwin if n == "window" else n


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("name", list(FNS))
def test_eval_of_the_trace_is_the_function_bit_for_bit(name, family, dtype):
    fn = FNS[name][0]
    nwin = FAMILIES[family][3]
    ncoeffs = _ncoeffs(name, nwin)
    ir = PF.trace(fn, nwin, ncoeffs)
    assert (ir.nwin, ir.ncoeffs) == (nwin, ncoeffs)
    rng = np.random.default_rng(nwin + ncoeffs)
    windows = [torch.as_tensor(rng.uniform(-1.0, 1.0, (5, 7)), dtype=dtype)
               for _ in range(nwin)]
    coeffs = torch.as_tensor(rng.uniform(0.5, 1.5, ncoeffs), dtype=dtype)
    got = PF.eval_torch(ir, windows, coeffs)
    want = fn(windows, coeffs)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("bc", ["periodic", "np"])
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("name", list(FNS))
def test_plain_plan_matches_reference_jnp_plan(name, family, bc, dtype):
    fn, twin, _ = FNS[name]
    shape, mode, extents, nwin = FAMILIES[family]
    rng = np.random.default_rng(17)
    data = rng.uniform(-1.0, 1.0, shape).astype(dtype)
    init = rng.standard_normal(shape).astype(dtype)
    coeffs = rng.uniform(0.5, 1.5, _ncoeffs(name, nwin)).astype(dtype)
    kw = dict(bc=bc, mode=mode, coeffs=coeffs, extents=extents, dtype=dtype)
    plan = rt.create(fn, shape, device="cpu", **kw)
    ref = repro.create(twin, shape, backend="jnp", **kw)
    args = (torch.as_tensor(data),) + ((torch.as_tensor(init),)
                                       if bc == "np" else ())
    got = rt.compute(plan, *args)
    ref_args = (jnp.asarray(data),) + ((jnp.asarray(init),)
                                       if bc == "np" else ())
    want = np.asarray(repro.compute(ref, *ref_args))
    assert tuple(got.shape) == shape and str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_allclose(got.numpy(), want, **tolerance_for(dtype))


GOLDEN_POW = """\
// a point function translated from Python (repro_torch.kernels.point_fn)
#include "point_fn_ops.cuh"

template <typename T>
__device__ T point_fn(const T* w, const T* c) {
  const T t0 = pf_mul(pf_mul(w[1], w[1]), w[1]);
  const T t1 = pf_mul(c[0], t0);
  const T t2 = pf_mul(w[0], pf_div(T(1), T(2.0)));
  const T t3 = pf_sub(t1, t2);
  return t3;
}
"""

GOLDEN_WHERE = """\
// a point function translated from Python (repro_torch.kernels.point_fn)
#include "point_fn_ops.cuh"

template <typename T>
__device__ T point_fn(const T* w, const T* c) {
  const bool t0 = (w[0] > T(0.1));
  const T t1 = (-w[1]);
  const T t2 = (t0 ? w[0] : t1);
  const T t3 = pf_mul(T(0.5), t2);
  const T t4 = pf_add(t3, c[1]);
  return t4;
}
"""


def test_golden_cuda_text():
    """``pow`` 3 as two products, a division by a literal as the card's
    multiply by its reciprocal, a comparison as ``bool``, ``where`` as a
    select, a closure constant as its literal."""
    assert PF.emit_cuda(PF.trace(
        lambda w, c: c[0] * w[1] ** 3 - w[0] / 2.0, 3, 1)) == GOLDEN_POW
    assert PF.emit_cuda(PF.trace(
        lambda w, c: HALF * torch.where(w[0] > 0.1, w[0], -w[1]) + c[1],
        2, 2)) == GOLDEN_WHERE


def test_mixed_translates_to_the_hand_written_expression():
    text = PF.emit_cuda(PF.trace(mixed, 3, 1))
    assert ("const T t0 = pf_mul(w[0], w[1]);\n"
            "  const T t1 = pf_mul(c[0], w[2]);\n"
            "  const T t2 = pf_sub(t0, t1);\n  return t2;") in text


def _sum_of_window(w, c):
    return w[0].sum()


def _fft(w, c):
    return torch.fft.fft(w[0])


def _branch(w, c):
    if float(w[0]) > 0:
        return w[0]
    return w[1]


def _half(w, c):
    return w[0].to(torch.float16)


# function -> the op its refusal names
REFUSED = {
    "sum": (_sum_of_window, "aten.sum.default"),
    "fft": (_fft, "fft_fft"),
    "branch": (_branch, "__float__"),
    "cast": (_half, "aten._to_copy.default casts to torch.float16"),
    "window_write": (lambda w, c: w[0].mul_(2.0), "aten.mul_.Tensor"),
    "coeff_vector": (lambda w, c: (c * 2.0)[0] * w[0], "aten.mul.Tensor on "
                     "the coefficient vector"),
    "comparison": (lambda w, c: w[0] > w[1], "returns a comparison"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refusals_name_their_op(case):
    fn, what = REFUSED[case]
    for _ in range(2):  # the refusal is cached and raised again
        with pytest.raises(NotImplementedError) as err:
            PF.translated_source(fn, 3, 2)
        msg = str(err.value)
        assert what in msg and "no CUDA counterpart" in msg
        assert "cuda_point_fn" in msg


def test_source_is_made_once_per_function_and_counts():
    def fn(w, c):
        return c[0] * (w[0] + w[1])

    a = PF.translated_source(fn, 3, 1)
    assert PF.translated_source(fn, 3, 1) is a
    assert PF.translated_source(fn, 5, 1) is not a
    assert S2.user_point_source(fn, 3, 1) is a
    # the given source wins over the translation; a library tag over both
    fn.device_point_source = "template <typename T> __device__ T point_fn("
    assert S2.user_point_source(fn, 3, 1) == fn.device_point_source
    assert S2.user_point_source(rt.core.cahn_hilliard.cube_laplacian_point_fn,
                                9, 9) is None


class _Card:
    """The card's side of a launch stubbed for CPU tensors: the wrapper's
    checks pass, the device is an H100, builds and launches are
    recorded."""

    def __init__(self, monkeypatch):
        self.builds, self.launches = [], []
        monkeypatch.setattr(_build, "check_cuda", lambda *a, **k: None)
        monkeypatch.setattr(_build, "device_info", lambda d: (232448, 132))
        monkeypatch.setattr(_build, "point_fn_build", lambda source, nwin: (
            self.builds.append((source, nwin)) or {"libs": {"nwin": nwin}}))
        monkeypatch.setattr(_build, "launch", lambda name, dev, *a, libs=None:
                            self.launches.append((name, a[1], libs)))


def test_wrappers_launch_the_translation(monkeypatch):
    """Each stencil wrapper builds its libraries from the translated
    source and launches the user point function's id; a refused function
    raises before any build or launch."""
    card = _Card(monkeypatch)
    c = torch.tensor([0.5, 2.0], dtype=torch.float64)
    S2.stencil2d_cuda(torch.zeros((8, 8), dtype=torch.float64), c,
                      point_fn=table, left=1, right=1, top=1, bottom=1)
    S1.stencil1d_batch_cuda(torch.zeros((4, 8), dtype=torch.float64), c,
                            point_fn=table, left=2, right=2)
    S3.stencil3d_cuda(torch.zeros((4, 4, 4), dtype=torch.float64), c,
                      point_fn=table, halos=(1, 0, 0, 1, 1, 1))
    assert card.builds == [(PF.translated_source(table, n, 2), n)
                           for n in (9, 5, 12)]
    assert [(n, i) for n, i, _ in card.launches] == [
        ("stencil2d", _build.USER_POINT_FN),
        ("stencil1d_batch", _build.USER_POINT_FN),
        ("stencil3d", _build.USER_POINT_FN)]
    assert [libs["nwin"] for _, _, libs in card.launches] == [9, 5, 12]
    with pytest.raises(NotImplementedError, match="aten.sum.default"):
        S2.stencil2d_cuda(torch.zeros((8, 8), dtype=torch.float64), c,
                          point_fn=_sum_of_window, left=1, right=1)
    assert len(card.builds) == 3 and len(card.launches) == 3
