"""The port's serving engine (``repro_torch.serve``) on the CPU: plan-LRU
semantics, batching correctness, engine behaviour, the stacked 2D Compute.

Mirrors ``tests/test_serve.py``.  The engine's contract is *bit-identity*
with sequential ``repro_torch.create``/``compute`` — every batching family
(the stacked batched-1D plan, one stacked 2D launch, member-by-member 3D
stencils and plan-multiplexed ADI) is held to ``torch.equal``.  Against
the reference's sequential results (``repro.serve.cli.sequential_reference``
on the same numpy fields) the port is held to ``tolerance_for(float64,
scale=100 * steps)``: a stencil apply sums up to 25 products in another
order (a few ulp, scale 10) and an ADI solve runs two banded recurrences
a step whose rounding the packages order differently (scale 100 a step,
as ``tests/test_torch_cahn_hilliard.py`` holds them).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch as rt
from repro.serve.cli import sequential_reference as ref_sequential
from repro.serve.request import SolveRequest as RefRequest
from repro_torch.kernels import ops
from repro_torch.kernels.ref import stencil2d_ref
from repro_torch.serve import (
    PlanLRU,
    ServeEngine,
    SolveRequest,
    bucket_key,
    classify,
    execute_bucket,
    validate_request,
)
from repro_torch.serve import batching as _batching
from repro_torch.serve.cli import main, sequential_reference
from repro_torch.serve.metrics import ServeMetrics, percentile
from repro_torch.util import tolerance_for

CPU = torch.device("cpu")
F64 = torch.float64


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.as_tensor(a)


def _sequential(plan, field, steps):
    """The eager per-request oracle: plain compute, step by step."""
    out = field
    for _ in range(steps):
        out = rt.compute(plan, out)
    return out


def _bucket(plan, kind, fields, steps, **kw):
    return execute_bucket(plan, kind, fields, steps, dtype=F64, device=CPU, **kw)


# ---------------------------------------------------------------------------
# PlanLRU
# ---------------------------------------------------------------------------


class TestPlanLRU:
    def test_hit_miss_counters(self):
        lru = PlanLRU(capacity=4)
        plan, hit = lru.get_or_create("a", lambda: object())
        assert not hit
        again, hit = lru.get_or_create("a", lambda: pytest.fail("factory ran on hit"))
        assert hit and again is plan
        stats = lru.stats()
        assert (stats["hits"], stats["misses"], stats["evictions"]) == (1, 1, 0)

    def test_eviction_is_least_recently_used(self):
        lru = PlanLRU(capacity=2, destroy_on_evict=False)
        lru.put("a", "A")
        lru.put("b", "B")
        assert lru.get("a") == "A"  # refresh "a" -> "b" is now LRU
        lru.put("c", "C")
        assert "b" not in lru
        assert "a" in lru and "c" in lru
        assert lru.stats()["evictions"] == 1

    def test_destroy_on_evict_frees_plan_state(self):
        lru = PlanLRU(capacity=1)
        plan = rt.create("laplacian", (8, 8), device="cpu")
        lru.put("old", plan)
        lru.put("new", rt.create("laplacian", (16, 16), device="cpu"))
        assert plan.destroyed
        with pytest.raises(ValueError, match="destroyed"):
            rt.compute(plan, torch.ones((8, 8), dtype=F64))
        lru.clear()

    def test_destroy_on_evict_false_keeps_plan_usable(self):
        lru = PlanLRU(capacity=1, destroy_on_evict=False)
        plan = rt.create("laplacian", (8, 8), device="cpu")
        lru.put("old", plan)
        lru.put("new", "whatever")
        assert not plan.destroyed
        out = rt.compute(plan, torch.ones((8, 8), dtype=F64))
        assert bool((out == 0.0).all())
        rt.destroy(plan)

    def test_capacity_one_thrash(self):
        lru = PlanLRU(capacity=1)
        makes = {"a": 0, "b": 0}

        def factory(key):
            makes[key] += 1
            return rt.create("laplacian", (8, 8), device="cpu")

        for _ in range(3):
            for key in ("a", "b"):
                plan, hit = lru.get_or_create(key, lambda k=key: factory(k))
                assert not hit
                assert not plan.destroyed  # the resident plan is live
        stats = lru.stats()
        assert stats["misses"] == 6 and stats["hits"] == 0
        assert stats["evictions"] == 5  # every insert but the last evicts
        assert makes == {"a": 3, "b": 3}
        lru.clear()

    def test_clear_destroys(self):
        lru = PlanLRU(capacity=4)
        plan = rt.create("laplacian", (8, 8), device="cpu")
        lru.put("a", plan)
        lru.clear()
        assert len(lru) == 0 and plan.destroyed

    def test_bad_capacity_rejected(self):
        with pytest.raises(ValueError):
            PlanLRU(capacity=0)


# ---------------------------------------------------------------------------
# The stacked 2D Compute (one stencil2d launch per bucket on the card)
# ---------------------------------------------------------------------------


class TestStackedStencil2D:
    @pytest.mark.parametrize("op", ["laplacian", "biharmonic"])
    @pytest.mark.parametrize("bc", ["periodic", "np"])
    def test_stack_equals_single_applies_bit_for_bit(self, op, bc):
        plan = rt.create(op, (20, 23), bc=bc, device="cpu")
        stack = _t(_rng(1).standard_normal((5, 20, 23)))
        got = plan.apply_stacked(stack)
        for b in range(5):
            assert torch.equal(got[b], plan.apply(stack[b]))
        # through the op, on a rank-3 tensor with the rank-2 plan's halos
        via_op = ops.stencil_apply(stack, plan.coeffs, bc=bc, taps=plan.taps,
                                   **plan._halo_kwargs())
        assert torch.equal(via_op, got)

    def test_np_with_out_init_per_member(self):
        plan = rt.create("biharmonic", (12, 10), bc="np", device="cpu")
        stack = _t(_rng(2).standard_normal((3, 12, 10)))
        init = _t(_rng(3).standard_normal((3, 12, 10)))
        got = plan.apply_stacked(stack, init)
        for b in range(3):
            assert torch.equal(got[b], plan.apply(stack[b], init[b]))
        # zeros outside the halo without out_init, as the reference's vmap
        zero = plan.apply_stacked(stack)
        assert bool((zero[:, :2] == 0).all() and (zero[:, :, -2:] == 0).all())

    def test_point_function_plan_stacks(self):
        from repro_torch.core.cahn_hilliard import cube_laplacian_point_fn

        plan = rt.create(cube_laplacian_point_fn, (9, 11), device="cpu",
                         coeffs=np.asarray(rt.get_operator("laplacian").weights(2)).ravel(),
                         extents=dict(left=1, right=1, top=1, bottom=1))
        stack = _t(_rng(4).standard_normal((4, 9, 11)))
        got = plan.apply_stacked(stack)
        for b in range(4):
            assert torch.equal(got[b], plan.apply(stack[b]))

    def test_plain_version_on_a_stack(self):
        data = _t(_rng(5).standard_normal((2, 7, 6)))
        coeffs = _t(np.arange(1.0, 16.0))
        got = stencil2d_ref(data, bc="periodic", left=1, right=1, top=2,
                            bottom=2, coeffs=coeffs)
        for b in range(2):
            assert torch.equal(got[b], stencil2d_ref(
                data[b], bc="periodic", left=1, right=1, top=2, bottom=2,
                coeffs=coeffs))

    def test_fft_plan_stacks(self):
        plan = rt.create("laplacian", (16, 16), device="cpu", backend="fft")
        stack = _t(_rng(6).standard_normal((3, 16, 16)))
        got = plan.apply_stacked(stack)
        for b in range(3):
            torch.testing.assert_close(got[b], plan.apply(stack[b]),
                                       **tolerance_for(F64))

    def test_shape_checked_against_the_plan(self):
        plan = rt.create("laplacian", (8, 8), device="cpu")
        with pytest.raises(ValueError, match="created for"):
            plan.apply_stacked(torch.zeros((2, 8, 9), dtype=F64))
        with pytest.raises(ValueError, match="stack"):
            plan.apply_stacked(torch.zeros((8, 8), dtype=F64))


# ---------------------------------------------------------------------------
# Batching correctness — bit-identity with sequential solves
# ---------------------------------------------------------------------------


class TestBatchingBitIdentity:
    @pytest.mark.parametrize("steps", [1, 3])
    def test_stencil_bucket_matches_sequential(self, steps):
        fields = [_t(_rng(i).standard_normal((24, 24))) for i in range(5)]
        plan = rt.create("laplacian", (24, 24), device="cpu")
        outs = _bucket(plan, _batching.STENCIL, fields, steps, max_batch=8)
        for field, out in zip(fields, outs):
            assert torch.equal(out, _sequential(plan, field, steps))
        rt.destroy(plan)

    @pytest.mark.parametrize("steps", [1, 2])
    def test_batch1d_bucket_matches_sequential(self, steps):
        fields = [_t(_rng(i).standard_normal(96)) for i in range(6)]
        plan = rt.create("laplacian", (1, 96), mode="batch", device="cpu")
        outs = _bucket(plan, _batching.BATCH1D, fields, steps, max_batch=8)
        for field, out in zip(fields, outs):
            ref = _sequential(plan, field[None, :], steps)[0]
            assert out.shape == field.shape
            assert torch.equal(out, ref)
        rt.destroy(plan)

    def test_adi_bucket_matches_sequential(self):
        fields = [_t(_rng(i).standard_normal((16, 16))) for i in range(4)]
        plan = rt.create("hyperdiffusion", (16, 16), mode="adi", alpha=0.1,
                         device="cpu")
        outs = _bucket(plan, _batching.ADI, fields, 2, max_batch=8)
        for field, out in zip(fields, outs):
            assert torch.equal(out, _sequential(plan, field, 2))
        rt.destroy(plan)

    def test_rank3_stencil_bucket_member_by_member(self):
        fields = [_t(_rng(i).standard_normal((6, 5, 7))) for i in range(3)]
        plan = rt.create("laplacian", (6, 5, 7), device="cpu")
        outs = _bucket(plan, _batching.STENCIL, fields, 2, max_batch=8)
        for field, out in zip(fields, outs):
            assert torch.equal(out, _sequential(plan, field, 2))

    def test_non_power_of_two_batch_padding_is_inert(self):
        fields = [_t(_rng(i).standard_normal((16, 16))) for i in range(5)]
        plan = rt.create("biharmonic", (16, 16), device="cpu")
        outs = _bucket(plan, _batching.STENCIL, fields, 1, max_batch=16)
        assert len(outs) == 5
        for field, out in zip(fields, outs):
            assert torch.equal(out, rt.compute(plan, field))
        rt.destroy(plan)

    def test_mixed_input_kinds_stack_alike(self):
        """numpy arrays, CPU tensors and float32 inputs cast to the bucket's
        dtype give the same stack."""
        base = _rng(7).standard_normal((3, 8, 8))
        plan = rt.create("laplacian", (8, 8), device="cpu")
        as_np = _bucket(plan, _batching.STENCIL, list(base), 1)
        as_t = _bucket(plan, _batching.STENCIL, list(_t(base)), 1)
        for a, b in zip(as_np, as_t):
            assert torch.equal(a, b)
        stack = _batching.stack_fields([base[0].astype(np.float32)], F64, CPU, 2)
        assert stack.dtype == F64 and stack.shape == (2, 8, 8)
        assert bool((stack[1] == 0).all())

    def test_quantize_batch(self):
        assert [_batching.quantize_batch(b, 16) for b in (1, 2, 3, 5, 9, 16, 20)] == [
            1, 2, 4, 8, 16, 16, 20,
        ]

    def test_classify_and_bucket_key(self):
        line = SolveRequest(field=np.ones(32), operator="laplacian")
        grid = SolveRequest(field=np.ones((8, 8)), operator="laplacian")
        adi = SolveRequest(field=np.ones((8, 8)), operator="hyperdiffusion",
                           mode="adi", alpha=0.1)
        assert classify(line) == _batching.BATCH1D
        assert classify(grid) == _batching.STENCIL
        assert classify(adi) == _batching.ADI
        assert bucket_key(grid) == bucket_key(
            SolveRequest(field=torch.zeros((8, 8), dtype=F64), operator="laplacian")
        )
        assert bucket_key(grid) != bucket_key(
            SolveRequest(field=np.ones((8, 8)), operator="laplacian", steps=2)
        )
        assert bucket_key(grid) != bucket_key(
            SolveRequest(field=np.ones((16, 8)), operator="laplacian")
        )
        assert bucket_key(grid) != bucket_key(
            SolveRequest(field=np.ones((8, 8), np.float32), operator="laplacian")
        )

    def test_plan_spec_keys_match_the_reference(self):
        from repro.serve.batching import plan_spec as ref_plan_spec

        for field, kw in ((np.ones(32), {}), (np.ones((8, 8)), {}),
                          (np.ones((8, 8)), dict(mode="adi", alpha=0.1,
                                                 operator="hyperdiffusion"))):
            kw = dict(dict(operator="laplacian"), **kw)
            kind, key, _ = _batching.plan_spec(SolveRequest(field=field, **kw),
                                               backend="auto")
            rkind, rkey, _ = ref_plan_spec(
                RefRequest(field=jnp.asarray(field), **kw), backend="auto")
            assert (kind, key) == (rkind, rkey)


# ---------------------------------------------------------------------------
# ServeEngine
# ---------------------------------------------------------------------------

CLASSES = [
    ("laplacian", (16, 16), None, None),
    ("biharmonic", (12, 12), None, None),
    ("laplacian", (48,), None, None),
    ("hyperdiffusion", (12, 12), "adi", 0.1),
]


def _mixed_fields(n, seed=0):
    rng = _rng(seed)
    return [(i, CLASSES[i % len(CLASSES)],
             rng.standard_normal(CLASSES[i % len(CLASSES)][1])) for i in range(n)]


def _mixed_requests(n, seed=0, steps=1, make=SolveRequest, wrap=_t):
    return [make(field=wrap(f), operator=op, mode=mode, alpha=alpha,
                 steps=steps, tag=i)
            for i, (op, _, mode, alpha), f in _mixed_fields(n, seed)]


class TestServeEngine:
    def test_mixed_stream_bit_identical_and_ordered(self):
        """A mixed stream over the four classes, bit-identical to the
        port's sequential facade calls, results in request order."""
        requests = _mixed_requests(12, steps=2)
        with ServeEngine(max_batch=8, device="cpu") as engine:
            results = engine.solve_many(requests)
        refs = sequential_reference(requests, device="cpu")
        assert [r.tag for r in results] == list(range(12))
        for res, ref in zip(results, refs):
            assert tuple(res.out.shape) == res.request.shape
            assert res.out.device.type == "cpu"
            assert torch.equal(res.out, ref), f"tag {res.tag} diverged"

    def test_mixed_stream_within_tolerance_of_the_reference(self):
        steps = 2
        requests = _mixed_requests(12, steps=steps)
        with ServeEngine(max_batch=8, device="cpu") as engine:
            results = engine.solve_many(requests)
        refs = ref_sequential(_mixed_requests(12, steps=steps, make=RefRequest,
                                              wrap=jnp.asarray))
        tol = tolerance_for(F64, scale=100 * steps)
        for res, ref in zip(results, refs):
            np.testing.assert_allclose(res.out.numpy(), np.asarray(ref), **tol)

    def test_stats_and_plan_reuse(self):
        requests = _mixed_requests(8)  # 4 classes x 2
        with ServeEngine(device="cpu") as engine:
            engine.solve_many(requests)
            second = engine.solve_many(_mixed_requests(4, seed=1))
            stats = engine.stats()
        assert stats["completed"] == 12 and stats["failed"] == 0
        assert stats["plan_lru"]["misses"] == 4  # one Create per class
        assert stats["plan_lru"]["hits"] >= 4
        assert stats["latency"]["count"] == 12
        assert all(r.plan_hit for r in second)

    def test_capacity_one_eviction_still_correct(self):
        requests = _mixed_requests(8)[:2] * 3  # alternate two classes
        with ServeEngine(plan_capacity=1, device="cpu") as engine:
            results = [engine.solve(r) for r in requests]
            stats = engine.stats()
        assert stats["plan_lru"]["evictions"] >= 4
        plan_a = rt.create("laplacian", (16, 16), device="cpu")
        plan_b = rt.create("biharmonic", (12, 12), device="cpu")
        for res in results:
            plan = plan_a if res.request.operator == "laplacian" else plan_b
            assert torch.equal(res.out, rt.compute(plan, res.request.field))

    def test_submit_rejects_malformed_requests(self):
        from repro_torch.kernels.penta import diffusion_diagonals

        rt.register_operator(  # band-only: no stencil weights
            "serve_test_band_only", diagonals=diffusion_diagonals,
            overwrite=True,
        )
        with ServeEngine(device="cpu") as engine:
            ones = np.ones((8, 8))
            for bad in [
                SolveRequest(field=ones, operator="no_such_op"),
                SolveRequest(field=ones, operator="laplacian", mode="adi"),
                SolveRequest(field=ones, operator="laplacian", alpha=0.1),
                SolveRequest(field=np.ones((2, 2, 2, 2)), operator="laplacian"),
                SolveRequest(field=ones, operator="laplacian", steps=0),
                SolveRequest(field=ones, operator="laplacian", bc="reflecting"),
                SolveRequest(field=np.ones(8), operator="laplacian",
                             mode="adi", alpha=0.1),
                SolveRequest(field=ones, operator="serve_test_band_only"),
                SolveRequest(field=np.ones((8, 8), np.int64), operator="laplacian"),
                SolveRequest(field=torch.ones((8, 8), dtype=torch.int32),
                             operator="laplacian"),
            ]:
                with pytest.raises(ValueError):
                    engine.submit(bad)
            assert engine.stats()["submitted"] == 0  # none reached the queue

    def test_bucket_failure_isolated(self, monkeypatch):
        req = _mixed_requests(1)[0]
        with ServeEngine(device="cpu") as engine:
            engine.solve(req)  # warm path works
            with monkeypatch.context() as mp:
                mp.setattr(
                    _batching, "execute_bucket",
                    lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")),
                )
                fut = engine.submit(_mixed_requests(1, seed=1)[0])
                with pytest.raises(RuntimeError, match="boom"):
                    fut.result(timeout=30)
            res = engine.solve(_mixed_requests(1, seed=2)[0])
            stats = engine.stats()
        assert stats["failed"] == 1 and stats["completed"] == 2
        assert tuple(res.out.shape) == req.shape

    def test_close_idempotent_and_destroys_plans(self):
        engine = ServeEngine(device="cpu")
        engine.solve(_mixed_requests(1)[0])
        resident = list(engine.plans._plans.values())
        engine.close()
        engine.close()  # idempotent
        assert all(p.destroyed for p in resident)
        with pytest.raises(RuntimeError, match="closed"):
            engine.submit(_mixed_requests(1)[0])
        with pytest.raises(RuntimeError, match="closed"):
            engine.start()

    def test_validate_request_standalone(self):
        validate_request(SolveRequest(field=np.ones((8, 8)), operator="laplacian"))
        with pytest.raises(ValueError, match="alpha"):
            validate_request(
                SolveRequest(field=np.ones((8, 8)), operator="hyperdiffusion",
                             mode="adi")
            )

    def test_default_device_is_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("this host has a card: the default is valid here")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ServeEngine()

    def test_unported_tune_refused(self):
        with pytest.raises(NotImplementedError, match="Tuning"):
            ServeEngine(tune="cached", device="cpu")


# ---------------------------------------------------------------------------
# Metrics + CLI
# ---------------------------------------------------------------------------


class TestMetrics:
    def test_percentile_nearest_rank(self):
        xs = [float(i) for i in range(1, 101)]
        assert percentile(xs, 50) == 50.0
        assert percentile(xs, 99) == 99.0
        assert percentile(xs, 100) == 100.0
        assert np.isnan(percentile([], 50))

    def test_reset(self):
        m = ServeMetrics()
        m.on_submit(3)
        m.on_batch(3)
        m.record_latency(0.5)
        m.reset()
        snap = m.snapshot()
        assert snap["submitted"] == 0 and snap["batches"] == 0
        assert snap["latency"] == {"count": 0}

    def test_snapshot_keys_match_the_reference(self):
        from repro.serve.metrics import ServeMetrics as RefMetrics

        assert set(ServeMetrics().snapshot()) == set(RefMetrics().snapshot())


class TestServeCLI:
    def test_main_verified_run(self, capsys):
        rc = main(["--requests", "12", "--device", "cpu", "--max-batch", "8"])
        out = capsys.readouterr().out
        assert rc == 0
        assert "bit-identical to sequential" in out
        assert "plan LRU" in out

    def test_main_json_stats(self, tmp_path):
        path = tmp_path / "stats.json"
        rc = main(["--requests", "8", "--device", "cpu", "--json", str(path)])
        assert rc == 0
        payload = json.loads(path.read_text())
        assert payload["requests"] == 8 and payload["verified"] is True
        assert payload["stats"]["plan_lru"]["capacity"] == 8
        assert payload["device"] == "cpu"

    def test_main_reports_a_mismatch(self, monkeypatch, capsys):
        import repro_torch.serve.cli as cli

        real = cli.sequential_reference
        monkeypatch.setattr(cli, "sequential_reference", lambda reqs, **kw: [
            r + 1.0 for r in real(reqs, **kw)])
        assert cli.main(["--requests", "4", "--device", "cpu"]) == 1
        assert "VERIFY FAIL" in capsys.readouterr().err
