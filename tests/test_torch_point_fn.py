"""User point functions with CUDA source, and the 3D stencil's Create-time
tap reduction and launch geometry, on the CPU.

A point function decorated with ``cuda_point_fn`` keeps its Python body as
the plain version: through ``repro_torch.create(f, ...)`` on the CPU it is
held against the reference's ``repro.create(f, ...)`` (the same ``func=``)
on 2D, batched-1D and 3D plans, periodic and ``np`` with ``out_init``.
The function is not separable (``w[0] w[1] - c[0] w[2]``), so a wrong
window order shows.  Tolerance ``tolerance_for(float64, scale=10)``: the
same few products on the same windows.  What the card builds from the
source (the build key, the generated ``.cu`` text) is checked here as
text; the kernels themselves run in ``tests/test_torch_kernels_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
import repro_torch as rt
from repro_torch.core.cahn_hilliard import cube_laplacian_point_fn
from repro_torch.kernels import _build
from repro_torch.kernels import stencil3d as S3
from repro_torch.kernels import taps as TP
from repro_torch.kernels.ref import weighted_point_fn
from repro_torch.kernels.stencil2d import (
    cuda_point_fn,
    device_point_fn_id,
    user_point_source,
)
from repro_torch.util import tolerance_for

TOL = tolerance_for("float64", scale=10)

SOURCE = """
template <typename T>
__device__ T point_fn(const T* w, const T* c) {
  return w[0] * w[1] - c[0] * w[2];
}
"""


def mixed(windows, coeffs):
    """The plain version of SOURCE: a non-separable point function."""
    return windows[0] * windows[1] - coeffs[0] * windows[2]


mixed_cuda = cuda_point_fn(SOURCE)(
    lambda windows, coeffs: mixed(windows, coeffs))

# (shape, mode, extents) of each plan family
PLANS = {
    "2d": ((13, 11), None, dict(left=1, right=0, top=2, bottom=1)),
    "batch": ((7, 19), "batch", dict(left=2, right=1)),
    "3d": ((6, 7, 9), None, dict(front=1, back=0, top=0, bottom=1, left=1,
                                 right=1)),
}


@pytest.mark.parametrize("bc", ["periodic", "np"])
@pytest.mark.parametrize("family", list(PLANS))
def test_user_point_fn_plain_path_matches_reference(family, bc):
    shape, mode, extents = PLANS[family]
    rng = np.random.default_rng(5)
    data = rng.uniform(-1.0, 1.0, shape)
    init = rng.standard_normal(shape)
    coeffs = np.array([0.7, -1.3])
    kw = dict(bc=bc, mode=mode, coeffs=coeffs, extents=extents)
    plan = rt.create(mixed_cuda, shape, device="cpu", **kw)
    ref = repro.create(mixed, shape, **kw)
    args = (torch.as_tensor(data),) + ((torch.as_tensor(init),) if bc == "np" else ())
    got = rt.compute(plan, *args)
    ref_args = (jnp.asarray(data),) + ((jnp.asarray(init),) if bc == "np" else ())
    want = np.asarray(repro.compute(ref, *ref_args))
    assert tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the decorated function is its own plain version
    bare = rt.create(mixed, shape, device="cpu", **kw)
    assert torch.equal(rt.compute(bare, *args), got)


def test_point_fn_ids_and_refusal():
    assert device_point_fn_id(weighted_point_fn, 9, 9) == 0
    assert device_point_fn_id(cube_laplacian_point_fn, 9, 9) == 1
    assert device_point_fn_id(mixed_cuda, 3, 1) == _build.USER_POINT_FN == 2
    assert user_point_source(mixed_cuda, 3, 1) == SOURCE
    # a library tag wins over source; the library's own have none
    assert user_point_source(weighted_point_fn, 9, 9) is None
    # a plain Python point function is translated; one the translator
    # refuses (a reduction over a window) has no CUDA counterpart
    assert device_point_fn_id(mixed, 3, 1) == _build.USER_POINT_FN
    assert "point_fn(const T* w, const T* c)" in user_point_source(mixed, 3, 1)
    with pytest.raises(NotImplementedError,
                       match="no CUDA counterpart: aten.sum.default"):
        device_point_fn_id(lambda windows, coeffs: windows[0].sum(), 3, 1)
    with pytest.raises(ValueError, match="must define point_fn"):
        cuda_point_fn("template <typename T> __device__ T f(const T* w);")


def test_build_key_follows_source_and_windows():
    key = _build.point_fn_key(SOURCE, 9)
    assert key == _build.point_fn_key(SOURCE, 9)
    assert len(key) == 16 and key != _build._digest()
    assert _build.point_fn_key(SOURCE, 10) != key
    assert _build.point_fn_key(SOURCE.replace("c[0]", "c[1]"), 9) != key


@pytest.mark.parametrize("kernel", _build.POINT_FN_SOURCES)
def test_generated_source_holds_the_point_fn(kernel):
    text = _build.point_fn_source(kernel, SOURCE, 12)
    assert SOURCE in text
    assert "#define REPRO_NWIN 12\n" in text
    # the point function comes before the kernel that calls it
    assert text.index(SOURCE) < text.index("#define REPRO_USER_POINT_FN 1")
    assert text.rstrip().endswith(f'#include "{kernel}"')
    assert (_build.CSRC / kernel).is_file()


def test_cpu_plan_builds_nothing(monkeypatch):
    """Create compiles a user's source only for a plan on a card."""
    calls = []
    monkeypatch.setattr("repro_torch.core.stencil.point_fn_build",
                        lambda *a: calls.append(a))
    rt.create(mixed_cuda, (8, 8), device="cpu", coeffs=np.ones(1),
              extents=dict(left=1, right=1))
    assert calls == []


def test_taps_of_the_7_and_27_point_plans():
    h = 0.5
    lap = rt.create("laplacian", (8, 8, 8), h=h, device="cpu")
    want_offsets = ((-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1),
                    (0, 1, 0), (1, 0, 0))
    assert lap.taps.offsets == want_offsets
    assert lap.taps.weights == (4.0, 4.0, 4.0, -24.0, 4.0, 4.0, 4.0)
    box = np.arange(1.0, 28.0).reshape(3, 3, 3)
    full = rt.create(box, (8, 8, 8), device="cpu")
    assert len(full.taps.offsets) == 27
    assert full.taps.offsets[0] == (-1, -1, -1)
    assert full.taps.offsets[13] == (0, 0, 0)
    assert full.taps.offsets[-1] == (1, 1, 1)
    assert full.taps.weights == tuple(np.arange(1.0, 28.0))
    # zeros dropped, the window order kept, asymmetric halos
    skew = np.zeros((1, 3, 2))
    skew[0, 2, 0], skew[0, 0, 1] = 2.0, -3.0
    plan = rt.create(skew, (5, 6, 7), mode="xyz", device="cpu",
                     extents=dict(front=0, back=0, top=1, bottom=1, left=1,
                                  right=0))
    assert plan.taps == TP.Taps(((0, -1, 0), (0, 1, -1)), (-3.0, 2.0))
    # the cube mode reduces its coefficients too; more than 32 taps do not
    cube = rt.create(cube_laplacian_point_fn, (8, 8, 8), device="cpu",
                     coeffs=np.asarray(rt.create("laplacian", (4, 4, 4),
                                                 device="cpu").coeffs),
                     extents=dict(front=1, back=1, top=1, bottom=1, left=1,
                                  right=1))
    assert cube.taps.offsets == want_offsets
    assert rt.create(np.ones((3, 3, 5)), (8, 8, 8), device="cpu").taps is None
    assert rt.create(mixed_cuda, (6, 7, 9), device="cpu", coeffs=np.ones(2),
                     extents=PLANS["3d"][2]).taps is None


def test_stencil3d_geometry():
    smem, sms = 232448, 132
    # 256^3 float64, 7-point: a ring of 5 slots of 34 x 34, 4 blocks an SM
    # by shared memory, 16 chunks of 16 planes (1024 blocks, two resident
    # grids' worth); the 8 x 8 (x, y) tiles share grid.x
    geo = S3.stencil3d_geometry((256, 256, 256), (1,) * 6, 8, smem, sms)
    assert geo == S3.Stencil3DGeometry("tile", 16, (64, 16), 5 * 34 * 34 * 8)
    # ragged and small extents: a plane a chunk when the tiles are few
    assert S3.stencil3d_geometry((61, 67, 71), (1,) * 6, 8, smem, sms).grid == (
        9, 61)
    assert S3.stencil3d_geometry((7, 11, 13), (2, 0, 1, 1, 0, 2), 4, smem,
                                 sms)[:2] == ("tile", 1)
    # halos too wide for the ring: one point a thread
    assert S3.stencil3d_geometry((9, 9, 9), (12,) * 6, 8, smem,
                                 sms).route == "direct"


@pytest.mark.parametrize("halos", [(1,) * 6, (0, 2, 1, 0, 2, 1), (3, 3, 3, 3, 3, 3)])
def test_nonzero_taps_reproduce_the_weighted_sum(halos):
    """Summing the taps in order gives the plain version's weighted sum."""
    fr, bk, tp, bt, lf, rt_ = halos
    n = (fr + bk + 1) * (tp + bt + 1) * (lf + rt_ + 1)
    rng = np.random.default_rng(1)
    w = rng.standard_normal(n)
    w[rng.random(n) < 0.85] = 0.0
    w[0] = 1.5
    data = torch.as_tensor(rng.uniform(-1.0, 1.0, (5, 6, 7)))
    taps = TP.nonzero_taps(w, halos)
    if taps is None:
        assert np.count_nonzero(w) > TP.MAX_TAPS
        return
    got = sum(wt * torch.roll(data, shifts=(-dz, -dy, -dx), dims=(0, 1, 2))
              for (dz, dy, dx), wt in zip(taps.offsets, taps.weights))
    want = S3.stencil3d_torch(data, bc="periodic", halos=halos,
                              coeffs=torch.as_tensor(w))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
