"""repro_torch's streamed execution (``repro_torch.launch.stream``) on the
CPU, held against the reference's streamed path and the port's monolithic
path; mirrors ``tests/test_stream_exec.py`` (its 2D and batched-1D parts)
and the 3D executors of ``tests/test_adi3d.py`` (z-slab stencils and the
plane-chunk y-sweep).

On a CPU tensor every chunk runs the plain version on its window, with the
windows' values and reduction order those of the monolithic plain version,
so the port's streamed result equals its monolithic one bit for bit
(``assert_array_equal``).  Against the reference's streamed ``compute='jnp'``
path: ``tolerance_for(float64)`` element-wise for the stencils and the RHS
(the same products summed in the same order; XLA may contract them), and
``tolerance_for(float64, 100)`` for the sweeps and the CH steps, as the
port's other cross-package ADI checks (each package factors its own bands
unless ``convert`` carries the reference's across).  The card-only
``tests/test_torch_kernels_cuda.py::test_streamed_equals_monolithic_bit_for_bit``
checks the kernels' chunked launches.
"""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

import repro
import repro_torch as rt
from repro.core import cahn_hilliard as RCH
from repro.kernels import penta as RP
from repro.kernels.ref import ch_rhs_ref
from repro.launch import stream as RS
from repro_torch import convert
from repro_torch.core import cahn_hilliard as TCH
from repro_torch.core.adi import apply_along_y
from repro_torch.core.cahn_hilliard import cube_laplacian_point_fn
from repro_torch.kernels import ops
from repro_torch.kernels import penta as TP
from repro_torch.kernels.ref import stencil1d_batch_ref, stencil2d_ref
from repro_torch.launch import stream as TS
from repro_torch.util import tolerance_for

TOL = tolerance_for("float64")
TOL_ADI = tolerance_for("float64", scale=100)


def _rand(rng, shape):
    return rng.standard_normal(shape)


def _np(t):
    return t.detach().cpu().numpy()


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@contextlib.contextmanager
def _one_rank_world():
    """A gloo world of this process alone, and its (1, 1) mesh's
    decomposition (``tests/test_torch_domain.py`` runs the wider ones)."""
    from repro_torch.core.domain import DomainDecomposition
    from repro_torch.launch.mesh import make_mesh_for

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield DomainDecomposition(make_mesh_for())
    finally:
        dist.destroy_process_group()


def _dist_plan_and_field():
    plan = rt.create(np.arange(9.0).reshape(3, 3), (16, 16), mode="xy",
                     device="cpu")
    return plan, torch.as_tensor(np.random.default_rng(5).standard_normal((16, 16)))


def _streamed_dist_on_one_rank():
    plan, x = _dist_plan_and_field()
    with _one_rank_world() as dd:
        return TS.stream_stencil_apply_dist(plan, x, dd, chunk_rows=4)


def _equal(got, want):
    np.testing.assert_array_equal(_np(got), _np(want))


# -- the executor vs the monolithic path and the reference -------------------


class TestStreamedMatchesMonolithic:
    @pytest.mark.parametrize("bc", ["periodic", "np"])
    @pytest.mark.parametrize("chunk_rows", [8, 16])
    def test_xy_weighted(self, bc, chunk_rows):
        # 64 rows in chunks of 8 or 16: the domain is 4x one chunk or more
        rng = np.random.default_rng(0)
        data, w = _rand(rng, (64, 48)), _rand(rng, (25,))
        init = _rand(rng, (64, 48)) if bc == "np" else None
        kw = dict(left=2, right=2, top=2, bottom=2, bc=bc)
        out = TS.stream_stencil_apply(_t(data), _t(w), _t(init), chunk_rows=chunk_rows,
                                      streams=2, **kw)
        _equal(out, ops.stencil_apply(_t(data), _t(w), _t(init), **kw))
        ref = RS.stream_stencil_apply(_j(data), _j(w), _j(init), chunk_rows=chunk_rows,
                                      streams=2, **kw)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)

    @pytest.mark.parametrize("bc", ["periodic", "np"])
    def test_asymmetric_extents(self, bc):
        rng = np.random.default_rng(1)
        data, w = _rand(rng, (48, 40)), _rand(rng, (4 * 2,))
        init = _rand(rng, (48, 40)) if bc == "np" else None
        kw = dict(left=1, right=0, top=2, bottom=1, bc=bc)
        out = TS.stream_stencil_apply(_t(data), _t(w), _t(init), chunk_rows=6,
                                      streams=3, **kw)
        _equal(out, stencil2d_ref(_t(data), coeffs=_t(w), out_init=_t(init), **kw))
        ref = RS.stream_stencil_apply(_j(data), _j(w), _j(init), chunk_rows=6,
                                      streams=3, **kw)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)

    def test_function_pointer_mode(self):
        # the paper's Fun variant streams too: nonlinearity inside the sweep
        rng = np.random.default_rng(2)
        data, coeffs = _rand(rng, (32, 32)), _rand(rng, (9,))
        kw = dict(left=1, right=1, top=1, bottom=1, bc="periodic")
        out = TS.stream_stencil_apply(_t(data), _t(coeffs),
                                      point_fn=cube_laplacian_point_fn,
                                      chunk_rows=4, streams=4, **kw)
        _equal(out, ops.stencil_apply(_t(data), _t(coeffs),
                                      point_fn=cube_laplacian_point_fn, **kw))
        ref = RS.stream_stencil_apply(_j(data), _j(coeffs),
                                      point_fn=RCH.cube_laplacian_point_fn,
                                      chunk_rows=4, streams=4, **kw)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)

    def test_single_row_chunks(self):
        rng = np.random.default_rng(3)
        data, w = _rand(rng, (16, 24)), _rand(rng, (9,))
        kw = dict(left=1, right=1, top=1, bottom=1, bc="periodic")
        out = TS.stream_stencil_apply(_t(data), _t(w), chunk_rows=1, **kw)
        _equal(out, stencil2d_ref(_t(data), coeffs=_t(w), **kw))

    def test_halo_wider_than_the_chunk_and_the_field(self):
        # halo rows wrap round a field shorter than the stencil
        rng = np.random.default_rng(13)
        data, w = _rand(rng, (3, 10)), _rand(rng, (5 * 3,))
        kw = dict(left=1, right=1, top=2, bottom=2, bc="periodic")
        out = TS.stream_stencil_apply(_t(data), _t(w), chunk_rows=1, **kw)
        _equal(out, stencil2d_ref(_t(data), coeffs=_t(w), **kw))

    def test_np_boundary_passthrough(self):
        # global-boundary cells come from out_init even when they sit in
        # interior chunks (chunk edges are not domain edges)
        rng = np.random.default_rng(5)
        data, init, w = _rand(rng, (32, 32)), _rand(rng, (32, 32)), _rand(rng, (25,))
        out = _np(TS.stream_stencil_apply(
            _t(data), _t(w), _t(init), left=2, right=2, top=2, bottom=2,
            bc="np", chunk_rows=4))
        np.testing.assert_array_equal(out[:2, :], init[:2, :])
        np.testing.assert_array_equal(out[-2:, :], init[-2:, :])
        np.testing.assert_array_equal(out[:, :2], init[:, :2])
        np.testing.assert_array_equal(out[:, -2:], init[:, -2:])

    @pytest.mark.parametrize("bc", ["periodic", "np"])
    def test_batch1d(self, bc):
        rng = np.random.default_rng(6)
        data, w = _rand(rng, (64, 40)), _rand(rng, (5,))
        init = _rand(rng, (64, 40)) if bc == "np" else None
        kw = dict(left=2, right=2, bc=bc)
        out = TS.stream_batch1d_apply(_t(data), _t(w), _t(init), chunk_rows=8,
                                      streams=2, **kw)
        _equal(out, stencil1d_batch_ref(_t(data), coeffs=_t(w), out_init=_t(init),
                                        **kw))
        ref = RS.stream_batch1d_apply(_j(data), _j(w), _j(init), chunk_rows=8,
                                      streams=2, **kw)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)

    @pytest.mark.parametrize("bc", ["periodic", "np"])
    def test_batch1d_transposed_view(self, bc):
        """The y direction: the columns of a field as the lines, read through
        the transposed view; its chunks are groups of columns."""
        rng = np.random.default_rng(14)
        field, init = _rand(rng, (40, 64)), _rand(rng, (40, 64))
        w = _rand(rng, (3,))
        kw = dict(left=1, right=1, bc=bc)
        view, init_v = _t(field).T, _t(init).T if bc == "np" else None
        out = TS.stream_batch1d_apply(view, _t(w), init_v, chunk_rows=16, **kw)
        assert out.stride() == view.stride()
        _equal(out, stencil1d_batch_ref(view, coeffs=_t(w), out_init=init_v, **kw))
        ref = RS.stream_batch1d_apply(_j(field).T, _j(w),
                                      _j(init).T if bc == "np" else None,
                                      chunk_rows=16, **kw)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)

    def test_validation(self):
        data, w = torch.zeros((16, 16), dtype=torch.float64), torch.ones(9)
        with pytest.raises(ValueError, match="must divide"):
            TS.stream_stencil_apply(data, w, chunk_rows=5,
                                    left=1, right=1, top=1, bottom=1)
        with pytest.raises(ValueError, match="bc"):
            TS.stream_stencil_apply(data, w, bc="reflect")
        with pytest.raises(ValueError, match="backend"):
            TS.stream_stencil_apply(data, w, compute="pallas")
        with pytest.raises(ValueError, match="CUDA tensor"):
            TS.stream_stencil_apply(data, w, compute="cuda", chunk_rows=4)
        # the multi-device path runs (a one-rank world: the local wrap), and
        # validates its chunking as the single-device executor does
        plan = rt.create(np.ones((3, 3)), (16, 16), mode="xy", device="cpu")
        with _one_rank_world() as dd:
            out = TS.stream_stencil_apply_dist(plan, data, dd, chunk_rows=4)
            assert torch.equal(out.to_local(), plan.apply(data))
            with pytest.raises(ValueError, match="must divide"):
                TS.stream_stencil_apply_dist(plan, data, dd, chunk_rows=5)

    def test_launch_windows(self):
        """The kernels' windows: the whole extent by default; a window needs
        the output it writes a part of, and must lie in the extent."""
        from repro_torch.kernels._build import window

        out = torch.empty(4)
        assert window(None, 16, "row", None) == (0, 16)
        assert window((4, 8), 16, "row", out) == (4, 8)
        with pytest.raises(ValueError, match="given out"):
            window((4, 8), 16, "row", None)
        for bad in ((8, 4), (-1, 4), (12, 17), (3, 3)):
            with pytest.raises(ValueError, match="not within"):
                window(bad, 16, "column", out)


# -- chunk geometry ----------------------------------------------------------


class TestChunkGeometry:
    def test_budget_drives_chunks(self):
        # a budget of 1/4 the field must give >= 4 chunks
        ny, nx, itemsize = 512, 512, 8
        budget = ny * nx * itemsize // 4
        rows = TS.choose_chunk_rows(ny, nx, itemsize, top=2, bottom=2, left=2,
                                    right=2, max_tile_bytes=budget)
        assert ny % rows == 0
        assert TS.slab_bytes(rows, nx, itemsize, top=2, bottom=2, left=2,
                             right=2) <= budget
        assert ny // rows >= 4

    def test_streams_alignment_preferred(self):
        rows = TS.choose_chunk_rows(60, 64, 8, max_tile_bytes=60 * 64 * 8 // 3,
                                    streams=4)
        assert (60 // rows) % 4 == 0

    def test_tiny_budget_falls_back_to_single_rows(self):
        assert TS.choose_chunk_rows(64, 1 << 20, 8, max_tile_bytes=64) == 1

    def test_no_budget_means_one_chunk(self):
        assert TS.choose_chunk_rows(64, 64, 8) == 64
        assert TS.n_chunks_for(64, 64, 8) == 1
        assert TS.choose_chunk_cols(64, 48, 8, max_tile_bytes=None) == 48

    def test_effective_streams(self):
        assert TS._effective_streams(None, 8) == 1
        assert TS._effective_streams(1, 8) == 1
        assert TS._effective_streams(2, 8) == 2
        assert TS._effective_streams(3, 8) == 1  # gcd fallback, no ragged tail
        assert TS._effective_streams(16, 8) == 8

    def test_should_stream(self):
        assert not TS.should_stream((64, 64), 8, streams=None, max_tile_bytes=None)
        assert not TS.should_stream((64, 64), 8, streams=1, max_tile_bytes=None)
        assert TS.should_stream((64, 64), 8, streams=2, max_tile_bytes=None)
        assert TS.should_stream((64, 64), 8, streams=None,
                                max_tile_bytes=64 * 64 * 8 // 2)
        assert not TS.should_stream((64, 64), 8, streams=None,
                                    max_tile_bytes=64 * 64 * 8 + 1)

    @pytest.mark.parametrize("n", [1, 12, 60, 64, 97, 1024])
    def test_geometry_matches_reference(self, n):
        """The port keeps its own copy of the geometry; it must pick what
        the reference picks."""
        for budget in (None, 64, 8 * n * 3, 8 * n * n // 4, 10**9):
            for streams in (None, 1, 2, 3, 4):
                for halo in (0, 2):
                    kw = dict(top=halo, bottom=halo, left=halo, right=halo,
                              max_tile_bytes=budget, streams=streams)
                    assert TS.choose_chunk_rows(n, 48, 8, **kw) == \
                        RS.choose_chunk_rows(n, 48, 8, **kw)
                    h4 = (halo,) * 4
                    assert TS.n_chunks_for(n, 48, 8, halos=h4, max_tile_bytes=budget,
                                           streams=streams) == RS.n_chunks_for(
                        n, 48, 8, halos=h4, max_tile_bytes=budget, streams=streams)
                assert TS.choose_chunk_cols(48, n, 8, max_tile_bytes=budget) == \
                    RS.choose_chunk_cols(48, n, 8, max_tile_bytes=budget)
                assert TS._effective_streams(streams, n) == \
                    RS._effective_streams(streams, n)
                assert TS.should_stream((n, 48), 8, streams=streams,
                                        max_tile_bytes=budget) == \
                    RS.should_stream((n, 48), 8, streams=streams,
                                     max_tile_bytes=budget)


# -- plan-API routing --------------------------------------------------------


class TestPlanRouting:
    def _count_calls(self, monkeypatch, name):
        calls = []
        real = getattr(TS, name)

        def counted(*args, **kwargs):
            calls.append(kwargs)
            return real(*args, **kwargs)

        monkeypatch.setattr(TS, name, counted)
        return calls

    def test_2d_plan_streams_when_oversized(self, monkeypatch):
        rng = np.random.default_rng(7)
        data, w = _rand(rng, (64, 48)), _rand(rng, (5, 5))
        calls = self._count_calls(monkeypatch, "stream_stencil_apply")
        mono = rt.create(w, (64, 48), device="cpu")
        streamed = rt.create(w, (64, 48), streams=2,
                             max_tile_bytes=data.nbytes // 4, device="cpu")
        assert streamed.streams == 2 and streamed.stream_pool == ()
        got = rt.compute(streamed, _t(data))
        assert len(calls) == 1 and calls[0]["compute"] == "auto"
        _equal(got, rt.compute(mono, _t(data)))
        ref = repro.create(w, (64, 48), backend="jnp", streams=2,
                           max_tile_bytes=data.nbytes // 4)
        np.testing.assert_allclose(_np(got), np.asarray(repro.compute(ref, _j(data))),
                                   **TOL)

    def test_2d_plan_declines_when_it_fits(self, monkeypatch):
        # within budget on one stream: the monolithic path is kept
        rng = np.random.default_rng(8)
        data, w = _rand(rng, (32, 32)), _rand(rng, (5, 5))
        calls = self._count_calls(monkeypatch, "stream_stencil_apply")
        plan = rt.create(w, (32, 32), streams=1, max_tile_bytes=data.nbytes + 1,
                         device="cpu")
        mono = rt.create(w, (32, 32), device="cpu")
        _equal(rt.compute(plan, _t(data)), rt.compute(mono, _t(data)))
        assert calls == []

    def test_resolve_compute_mirrors_monolithic_dispatch(self):
        t = torch.zeros(2)
        assert TS.resolve_compute("auto", t) == "torch"  # the plain version on CPU
        assert TS.resolve_compute("torch", t) == "torch"
        assert TS.resolve_compute("cuda", t) == "cuda"  # forced: raises at launch
        with pytest.raises(ValueError, match="backend"):
            TS.resolve_compute("jnp", t)
        with pytest.raises(ValueError, match="backend='fft' reached a kernel"):
            TS.resolve_compute("fft", t)

    def test_batch1d_plan_streams(self, monkeypatch):
        rng = np.random.default_rng(9)
        data = _rand(rng, (64, 32))
        w = np.asarray([1.0, -2.0, 1.0])
        calls = self._count_calls(monkeypatch, "stream_batch1d_apply")
        plan = rt.create(w, (64, 32), mode="batch", bc="np", streams=4, device="cpu")
        got = rt.compute(plan, _t(data))
        assert len(calls) == 1
        _equal(got, stencil1d_batch_ref(_t(data), bc="np", left=1, right=1,
                                        coeffs=_t(w)))
        # along y: the plan streams the transposed view in column chunks
        _equal(apply_along_y(plan, _t(data)),
               stencil1d_batch_ref(_t(data).T, bc="np", left=1, right=1,
                                   coeffs=_t(w)).T)

    def test_no_streams_on_the_cpu(self):
        assert TS.make_stream_pool(4, "cpu") == ()
        assert TS.make_stream_pool(None, "cpu") == ()
        op = rt.create("hyperdiffusion", (16, 16), mode="adi", alpha=0.2,
                       streams=4, device="cpu")
        assert op.streams == 4 and op.stream_pool == ()

    def test_convert_carries_the_reference_knobs(self):
        n = 32
        knobs = dict(streams=2, max_tile_bytes=n * n * 8 // 4)
        rng = np.random.default_rng(16)
        data = _rand(rng, (n, n))
        ref2 = repro.create("laplacian", (n, n), backend="jnp", **knobs)
        p2 = convert.stencil2d(np.asarray(ref2.coeffs), **dict(zip(
            ("left", "right", "top", "bottom"), ref2.halo)),
            streams=ref2.streams, max_tile_bytes=ref2.max_tile_bytes, device="cpu")
        ref1 = repro.create("laplacian", (n, n), mode="batch", backend="jnp", **knobs)
        p1 = convert.stencil_batch1d(np.asarray(ref1.coeffs), left=ref1.left,
                                     right=ref1.right, streams=ref1.streams,
                                     max_tile_bytes=ref1.max_tile_bytes, device="cpu")
        for port, ref in ((p2, ref2), (p1, ref1)):
            assert (port.streams, port.max_tile_bytes) == (2, n * n * 8 // 4)
            np.testing.assert_allclose(_np(rt.compute(port, _t(data))),
                                       np.asarray(repro.compute(ref, _j(data))), **TOL)
        refop = repro.create("hyperdiffusion", (n, n), mode="adi", alpha=0.3,
                             backend="jnp", **knobs)
        op = convert.adi_operator(
            *(convert.cyclic_penta_factors([np.asarray(a) for a in f.band],
                                           np.asarray(f.z), np.asarray(f.s_inv),
                                           np.asarray(f.w), device="cpu")
              for f in (refop.fac_x, refop.fac_y)),
            streams=refop.streams, max_tile_bytes=refop.max_tile_bytes)
        assert (op.streams, op.max_tile_bytes) == (2, n * n * 8 // 4)
        np.testing.assert_allclose(_np(rt.compute(op, _t(data))),
                                   np.asarray(repro.compute(refop, _j(data))), **TOL)


# -- streamed implicit half + full ADI timestep ------------------------------


def _ref_factors_across(fac):
    """The reference's cyclic factors as the port's (the same numbers)."""
    return convert.cyclic_penta_factors(
        [np.asarray(a) for a in fac.band], np.asarray(fac.z),
        np.asarray(fac.s_inv), np.asarray(fac.w), device="cpu")


class TestStreamedADI:
    def test_penta_solve_streamed(self):
        rng = np.random.default_rng(10)
        diags = RP.hyperdiffusion_diagonals(96, 0.4)
        rhs = _rand(rng, (96, 64))
        fac_r = RP.cyclic_penta_factor(*diags)
        fac_t = _ref_factors_across(fac_r)
        out = TS.stream_penta_solve(fac_t, _t(rhs), cyclic=True, chunk_cols=16,
                                    streams=2)
        _equal(out, TP.cyclic_penta_solve_factored(fac_t, _t(rhs)))
        ref = RS.stream_penta_solve(fac_r, _j(rhs), cyclic=True, chunk_cols=16,
                                    streams=2)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)

        band_t = fac_t.band
        out = TS.stream_penta_solve(band_t, _t(rhs), cyclic=False,
                                    max_tile_bytes=rhs.nbytes // 4)
        _equal(out, TP.penta_solve_factored(band_t, _t(rhs)))
        ref = RS.stream_penta_solve(fac_r.band, _j(rhs), cyclic=False,
                                    max_tile_bytes=rhs.nbytes // 4)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)

    def test_penta_solve_rows_streamed(self):
        rng = np.random.default_rng(17)
        fac_r = RP.cyclic_penta_factor(*RP.hyperdiffusion_diagonals(48, 0.7))
        fac_t = _ref_factors_across(fac_r)
        rhs = _rand(rng, (64, 48))
        out = TS.stream_penta_solve_rows(fac_t, _t(rhs), cyclic=True,
                                         chunk_rows=8, streams=4)
        _equal(out, TP.cyclic_penta_solve_factored_rows(fac_t, _t(rhs)))
        ref = RS.stream_penta_solve_rows(fac_r, _j(rhs), cyclic=True,
                                         chunk_rows=8, streams=4)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)

    def test_adi_operator_streams(self, monkeypatch):
        rng = np.random.default_rng(11)
        rhs = _rand(rng, (64, 64))
        knobs = dict(streams=2, max_tile_bytes=rhs.nbytes // 4)
        mono = rt.create("hyperdiffusion", (64, 64), mode="adi", alpha=0.3,
                         device="cpu")
        streamed = rt.create("hyperdiffusion", (64, 64), mode="adi", alpha=0.3,
                             device="cpu", **knobs)
        ref = repro.create("hyperdiffusion", (64, 64), mode="adi", alpha=0.3,
                           backend="jnp", **knobs)
        calls = []
        for name in ("stream_penta_solve_rows", "stream_penta_solve"):
            real = getattr(TS, name)
            monkeypatch.setattr(TS, name, lambda *a, _r=real, _n=name, **k: (
                calls.append(_n), _r(*a, **k))[1])
        for sweep in ("solve_x", "solve_y"):
            got = getattr(streamed, sweep)(_t(rhs))
            _equal(got, getattr(mono, sweep)(_t(rhs)))
            np.testing.assert_allclose(
                _np(got), np.asarray(getattr(ref, sweep)(_j(rhs))), **TOL_ADI)
        assert calls == ["stream_penta_solve_rows", "stream_penta_solve"]

    @pytest.mark.parametrize("mode", ["fused", "stencil", "batch1d"])
    def test_full_ch_timestep_streamed(self, mode):
        # a full ADI Cahn-Hilliard timestep on a domain 4x larger than one
        # chunk: streamed vs monolithic, and vs the reference's streamed run
        n = 64
        budget = n * n * 8 // 4  # one chunk = 1/4 of the field
        assert TS.n_chunks_for(n, n, 8, halos=(2, 2, 2, 2),
                               max_tile_bytes=budget) >= 4
        knobs = dict(streams=2, max_tile_bytes=budget)
        c0 = np.array(RCH.deep_quench_ic(n, n, seed=3))
        t0 = TCH.CahnHilliardADI(TCH.CHConfig(nx=n, ny=n, rhs_mode=mode, device="cpu"))
        tS = TCH.CahnHilliardADI(TCH.CHConfig(nx=n, ny=n, rhs_mode=mode, device="cpu",
                                              **knobs))
        rS = RCH.CahnHilliardADI(RCH.CHConfig(nx=n, ny=n, rhs_mode=mode,
                                              backend="jnp", **knobs))
        state0 = (t0.initial_step(_t(c0)), _t(c0))
        stateS = (tS.initial_step(_t(c0)), _t(c0))
        ref = (rS.initial_step(_j(c0)), _j(c0))
        _equal(stateS[0], state0[0])
        np.testing.assert_allclose(_np(stateS[0]), np.asarray(ref[0]), **TOL_ADI)
        for _ in range(3):
            state0 = t0.step(*state0)
            stateS = tS.step(*stateS)
            ref = rS.step(*ref)
        _equal(stateS[0], state0[0])
        np.testing.assert_allclose(_np(stateS[0]), np.asarray(ref[0]), **TOL_ADI)
        _equal(tS.rhs(*stateS), t0.rhs(*stateS))

    def test_stream_ch_rhs_matches_ref(self):
        rng = np.random.default_rng(12)
        a, b = _rand(rng, (64, 64)), _rand(rng, (64, 64))
        kw = dict(dt=1e-3, D=0.6, gamma=0.01, inv_h2=4.1, inv_h4=16.81)
        out = TS.stream_ch_rhs(_t(a), _t(b), chunk_rows=8, streams=4, **kw)
        _equal(out, ops.ch_rhs(_t(a), _t(b), **kw))
        np.testing.assert_allclose(_np(out), np.asarray(ch_rhs_ref(_j(a), _j(b), **kw)),
                                   **TOL)
        ref = RS.stream_ch_rhs(_j(a), _j(b), chunk_rows=8, streams=4, **kw)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)

    def test_stream_ch_rhs_xsweep_matches_ref(self):
        rng = np.random.default_rng(18)
        a, b = _rand(rng, (64, 64)), _rand(rng, (64, 64))
        kw = dict(dt=1e-3, D=0.6, gamma=0.01, inv_h2=4.1, inv_h4=16.81)
        fac_r = RP.cyclic_penta_factor(*RP.hyperdiffusion_diagonals(64, 0.5))
        fac_t = _ref_factors_across(fac_r)
        out = TS.stream_ch_rhs_xsweep(_t(a), _t(b), fac_t, chunk_rows=8,
                                      streams=4, **kw)
        _equal(out, ops.ch_rhs_xsweep(_t(a), _t(b), fac_t, **kw))
        ref = RS.stream_ch_rhs_xsweep(_j(a), _j(b), fac_r, chunk_rows=8,
                                      streams=4, backend="jnp", **kw)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL_ADI)


# -- 3D: z-slab stencils and plane chunks -------------------------------------


SHAPE_3D = (8, 12, 10)


def _box(rng, halos):
    fr, bk, tp, bt, lf, rt_ = halos
    return _rand(rng, ((fr + bk + 1) * (tp + bt + 1) * (lf + rt_ + 1),))


class TestStreamed3D:
    @pytest.mark.parametrize("bc", ["periodic", "np"])
    def test_stencil3d_weighted_box(self, bc):
        # a full 3x3x3 box of weights; np with an out_init
        rng = np.random.default_rng(30)
        halos = (1,) * 6
        data, w = _rand(rng, SHAPE_3D), _box(rng, halos)
        init = _rand(rng, SHAPE_3D) if bc == "np" else None
        kw = dict(halos=halos, bc=bc)
        out = TS.stream_stencil3d_apply(_t(data), _t(w), _t(init),
                                        chunk_slabs=2, streams=2, **kw)
        _equal(out, ops.stencil_apply_3d(_t(data), _t(w), _t(init), **kw))
        ref = RS.stream_stencil3d_apply(_j(data), _j(w), _j(init),
                                        chunk_slabs=2, streams=2,
                                        compute="jnp", **kw)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)

    @pytest.mark.parametrize("bc", ["periodic", "np"])
    def test_stencil3d_asymmetric_xyz_box(self, bc):
        # front 2, back 1: the slab's halo planes differ on its two sides
        rng = np.random.default_rng(31)
        halos = (2, 1, 1, 0, 0, 1)
        data, w = _rand(rng, SHAPE_3D), _box(rng, halos)
        init = _rand(rng, SHAPE_3D) if bc == "np" else None
        kw = dict(halos=halos, bc=bc)
        out = TS.stream_stencil3d_apply(_t(data), _t(w), _t(init),
                                        chunk_slabs=2, streams=2, **kw)
        _equal(out, ops.stencil_apply_3d(_t(data), _t(w), _t(init), **kw))
        ref = RS.stream_stencil3d_apply(_j(data), _j(w), _j(init),
                                        chunk_slabs=2, streams=2,
                                        compute="jnp", **kw)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)

    def test_laplacian_plan_streams(self, monkeypatch):
        # the weighted 7-point plan through create/compute: routed through
        # the z-slab executor when the field exceeds the budget
        rng = np.random.default_rng(32)
        data = _rand(rng, SHAPE_3D)
        knobs = dict(streams=2, max_tile_bytes=data.nbytes // 2)
        calls = []
        real = TS.stream_stencil3d_apply
        monkeypatch.setattr(TS, "stream_stencil3d_apply", lambda *a, **k: (
            calls.append(k), real(*a, **k))[1])
        plan = rt.create("laplacian", SHAPE_3D, device="cpu", **knobs)
        mono = rt.create("laplacian", SHAPE_3D, device="cpu")
        assert plan.streams == 2 and plan.stream_pool == ()
        got = rt.compute(plan, _t(data))
        assert len(calls) == 1 and calls[0]["halos"] == (1,) * 6
        _equal(got, rt.compute(mono, _t(data)))
        ref = repro.create("laplacian", SHAPE_3D, backend="jnp", lint="off",
                           **knobs)
        np.testing.assert_allclose(_np(got),
                                   np.asarray(repro.compute(ref, _j(data))),
                                   **TOL)

    def test_function_mode_cube_plan(self):
        # the paper's Fun variant on a 3x3x3 cube: c (w^3 - w) summed
        rng = np.random.default_rng(33)
        data, coeffs = _rand(rng, SHAPE_3D), _rand(rng, (27,))
        ext = dict(front=1, back=1, top=1, bottom=1, left=1, right=1)
        kw = dict(mode="xyz", coeffs=coeffs, extents=ext)
        plan = rt.create(cube_laplacian_point_fn, SHAPE_3D, streams=4,
                         max_tile_bytes=data.nbytes // 4, device="cpu", **kw)
        mono = rt.create(cube_laplacian_point_fn, SHAPE_3D, device="cpu", **kw)
        got = rt.compute(plan, _t(data))
        _equal(got, rt.compute(mono, _t(data)))
        ref = RS.stream_stencil3d_apply(
            _j(data), _j(coeffs), point_fn=RCH.cube_laplacian_point_fn,
            halos=(1,) * 6, chunk_slabs=2, streams=4, compute="jnp")
        np.testing.assert_allclose(_np(got), np.asarray(ref), **TOL)

    @pytest.mark.parametrize("cyclic", [True, False], ids=["cyclic", "plain"])
    def test_penta_solve_mid_streamed(self, cyclic):
        rng = np.random.default_rng(34)
        fac_r = RP.cyclic_penta_factor(*RP.hyperdiffusion_diagonals(16, 0.5))
        fac_t = _ref_factors_across(fac_r)
        if not cyclic:
            fac_r, fac_t = fac_r.band, fac_t.band
        rhs = _rand(rng, (8, 16, 6))
        out = TS.stream_penta_solve_mid(fac_t, _t(rhs), cyclic=cyclic,
                                        chunk_planes=2, streams=2)
        solve = (TP.cyclic_penta_solve_factored_mid if cyclic
                 else TP.penta_solve_factored_mid)
        _equal(out, solve(fac_t, _t(rhs)))
        ref = RS.stream_penta_solve_mid(fac_r, _j(rhs), cyclic=cyclic,
                                        chunk_planes=2, streams=2)
        np.testing.assert_allclose(_np(out), np.asarray(ref), **TOL)

    def test_3d_geometry_matches_reference(self):
        # the path's geometry: 256^3 float64 under a 20 MB budget with four
        # streams gives 8 chunks in every 3D executor
        n, budget = 256, 20_000_000
        slab = TS.choose_chunk_rows(n, (n + 2) ** 2, 8, top=1, bottom=1,
                                    max_tile_bytes=budget, streams=4)
        assert slab == RS.choose_chunk_rows(n, (n + 2) ** 2, 8, top=1,
                                            bottom=1, max_tile_bytes=budget,
                                            streams=4) == 32
        assert TS.choose_chunk_rows(n, n * n, 8, max_tile_bytes=budget,
                                    streams=4) == 32
        assert TS.choose_chunk_rows(n * n, n, 8, max_tile_bytes=budget,
                                    streams=4) == 8192
        assert TS.choose_chunk_cols(n, n * n, 8, max_tile_bytes=budget) == 8192

    def test_validation(self):
        data = torch.zeros(SHAPE_3D, dtype=torch.float64)
        w = torch.ones(7, dtype=torch.float64)
        with pytest.raises(ValueError, match="chunk_slabs=3 must divide"):
            TS.stream_stencil3d_apply(data, w, halos=(1, 1, 0, 0, 0, 0),
                                      chunk_slabs=3)
        with pytest.raises(ValueError, match="bc"):
            TS.stream_stencil3d_apply(data, w, bc="reflect")
        with pytest.raises(ValueError, match="CUDA tensor"):
            TS.stream_stencil3d_apply(data, w, halos=(1, 1, 0, 0, 0, 0),
                                      chunk_slabs=2, compute="cuda")
        fac = TP.penta_factor(*TP.hyperdiffusion_diagonals(12, 0.5),
                              device="cpu")
        with pytest.raises(ValueError, match="chunk_planes=3 must divide"):
            TS.stream_penta_solve_mid(fac, data, cyclic=False, chunk_planes=3)
        with pytest.raises(ValueError, match=r"\(P, M, N\)"):
            TS.stream_penta_solve_mid(fac, data[0], cyclic=False)


# -- what stays refused, and the tuning that no longer is --------------------


@pytest.mark.parametrize("call, want", [
    (lambda: rt.create("laplacian", (8, 8), streams=2, tune="cached",
                       device="cpu"), rt.Stencil2D),
    (lambda: rt.create("hyperdiffusion", (8, 8), mode="adi", alpha=0.1,
                       max_tile_bytes=64, tune="force", device="cpu"),
     rt.ADIOperator),
    (lambda: TCH.CahnHilliardADI(TCH.CHConfig(nx=8, ny=8, streams=2,
                                              tune="cached", device="cpu")),
     TCH.CahnHilliardADI),
    (_streamed_dist_on_one_rank, DTensor),
], ids=["tune-2d", "tune-adi", "tune-ch", "dist"])
def test_unported_streaming_is_refused(call, want, tmp_path, monkeypatch):
    """No streamed path stays refused.  The multi-device path, refused
    until ``repro_torch.core.domain`` was ported, now runs: on a one-rank
    world its streamed chunks equal the plan's monolithic Compute bit for
    bit.  Tuning a streamed plan, operator or solver, refused until
    ``repro_torch.tune`` was ported, now runs (on a cache of its own): the
    tuner measures the monolithic Compute, and a streamed Compute of the
    tuned object equals its monolithic one bit for bit."""
    from repro_torch import tune as T

    monkeypatch.setenv(T.ENV_VAR, str(tmp_path))
    made = call()
    assert isinstance(made, want)
    if isinstance(made, DTensor):
        plan, x = _dist_plan_and_field()
        assert torch.equal(made.to_local(), plan.apply(x))
        return

    def monolithic(obj):
        return dataclasses.replace(obj, streams=None, max_tile_bytes=None,
                                   stream_pool=())

    if isinstance(made, TCH.CahnHilliardADI):
        # the same tuned operators, unstreamed
        mono = TCH.CahnHilliardADI(TCH.CHConfig(nx=8, ny=8, device="cpu"))
        mono.op_full = monolithic(made.op_full)
        mono.op_half = monolithic(made.op_half)
        c0 = torch.as_tensor(np.random.default_rng(3).uniform(-0.1, 0.1,
                                                               (8, 8)))
        assert torch.equal(TCH.ch_evolve(made, c0, 3)[0],
                           TCH.ch_evolve(mono, c0, 3)[0])
        return
    x = torch.as_tensor(np.random.default_rng(4).standard_normal((8, 8)))
    assert torch.equal(rt.compute(made, x), rt.compute(monolithic(made), x))
