"""The port's hardened serve path under injected faults, on the CPU.

Mirrors ``tests/test_serve_resilience.py``: a transient bucket fault
retries to success, a kernel failure degrades to ``backend='torch'``
visibly (SolveResult + stats), a deadline-exceeded request fails fast
without poisoning its bucket, ``backpressure='reject'`` sheds load, and a
dead worker thread restarts without losing submitted work.  Plus the
``'kernel.dispatch'`` site: an injected ``backend_error`` at a launch of
the port's kernel degrades the bucket's class, with the card's side of
the launch stubbed on this host.
"""

import time

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch.kernels.ref import stencil2d_ref
from repro_torch.runtime import chaos
from repro_torch.serve import (
    DeadlineExceeded,
    QueueFull,
    ServeEngine,
    SolveRequest,
)


def field(shape=(8, 8), seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape))


def sequential_reference(f):
    plan = rt.create("laplacian", tuple(f.shape), device="cpu")
    out = rt.compute(plan, f)
    rt.destroy(plan)
    return out


def engine(**kw):
    return ServeEngine(device="cpu", **dict(dict(backend="torch"), **kw))


class TestTransientRetry:
    def test_retries_to_success(self):
        f = field()
        plan = chaos.FaultPlan(seed=7).add(
            "serve.bucket_compute", "transient", at=(1, 2)
        )
        with chaos.injected(plan):
            with engine(max_retries=3, retry_backoff_s=0.001) as eng:
                res = eng.solve(SolveRequest(field=f, operator="laplacian"))
                stats = eng.stats()
        assert res.attempts == 3 and not res.degraded
        assert stats["retries"] == 2 and stats["completed"] == 1
        assert torch.equal(res.out, sequential_reference(f))

    def test_exhausted_retries_fail_the_bucket(self):
        plan = chaos.FaultPlan(seed=7).add(
            "serve.bucket_compute", "transient", rate=1.0
        )
        with chaos.injected(plan):
            with engine(max_retries=1, retry_backoff_s=0.001) as eng:
                fut = eng.submit(SolveRequest(field=field(), operator="laplacian"))
                with pytest.raises(chaos.TransientError):
                    fut.result(timeout=30)
                assert eng.stats()["failed"] == 1

    def test_failed_bucket_never_kills_the_engine(self):
        plan = chaos.FaultPlan(seed=7).add("serve.bucket_compute", "crash", at=1)
        with chaos.injected(plan):
            with engine() as eng:
                bad = eng.submit(SolveRequest(field=field(), operator="laplacian"))
                with pytest.raises(chaos.InjectedCrash):
                    bad.result(timeout=30)
                ok = eng.solve(SolveRequest(field=field(), operator="laplacian"))
        assert tuple(ok.out.shape) == (8, 8)


class TestDegradation:
    def test_backend_error_degrades_to_torch_visibly(self):
        f = field()
        plan = chaos.FaultPlan(seed=7).add(
            "serve.bucket_compute", "backend_error", at=1
        )
        with chaos.injected(plan):
            with engine() as eng:
                first = eng.solve(SolveRequest(field=f, operator="laplacian"))
                second = eng.solve(SolveRequest(field=f, operator="laplacian"))
                stats = eng.stats()
        assert first.degraded and first.attempts == 2
        # sticky: the plan class stays on torch, no second failure needed
        assert second.degraded and second.attempts == 1
        assert stats["degraded"] == 2
        assert stats["degraded_classes"] == 1
        assert torch.equal(first.out, sequential_reference(f))
        assert torch.equal(second.out, sequential_reference(f))

    def test_degradation_scoped_to_its_plan_class(self):
        plan = chaos.FaultPlan(seed=7).add(
            "serve.bucket_compute", "backend_error", at=1
        )
        with chaos.injected(plan):
            with engine() as eng:
                hit = eng.solve(SolveRequest(field=field((8, 8)), operator="laplacian"))
                other = eng.solve(
                    SolveRequest(field=field((12, 12)), operator="laplacian"))
        assert hit.degraded and not other.degraded

    def test_degrade_false_fails_instead(self):
        plan = chaos.FaultPlan(seed=7).add(
            "serve.bucket_compute", "backend_error", at=1
        )
        with chaos.injected(plan):
            with engine(degrade=False) as eng:
                fut = eng.submit(SolveRequest(field=field(), operator="laplacian"))
                with pytest.raises(chaos.BackendError):
                    fut.result(timeout=30)

    def test_kernel_dispatch_error_degrades_the_class(self, monkeypatch):
        """``backend='cuda'`` plans launch the kernel wrapper (stubbed here:
        each launch fires ``'kernel.dispatch'`` and records), so the
        injected ``backend_error`` at the first launch degrades that class
        to ``backend='torch'``; the other class keeps launching."""
        launched = []

        def fake_stencil2d(data, coeffs, out_init=None, **kw):
            chaos.fire("kernel.dispatch", kernel="stencil2d")
            launched.append(tuple(data.shape))
            return stencil2d_ref(
                data, bc=kw["bc"], left=kw["left"], right=kw["right"],
                top=kw["top"], bottom=kw["bottom"], point_fn=kw["point_fn"],
                coeffs=coeffs, out_init=out_init)

        from repro_torch.kernels import ops

        monkeypatch.setattr(ops, "stencil2d_cuda", fake_stencil2d)
        monkeypatch.setattr(ops, "resolve_backend",
                            lambda backend, t: "cuda" if backend == "cuda"
                            else "torch")
        plan = chaos.FaultPlan(seed=7).add(
            "kernel.dispatch", "backend_error", at=1)
        a, b = field((8, 8)), field((12, 12), seed=1)
        with chaos.injected(plan):
            with engine(backend="cuda") as eng:
                first = eng.solve_many([SolveRequest(field=a, operator="laplacian")
                                        for _ in range(3)])
                other = eng.solve(SolveRequest(field=b, operator="laplacian"))
                again = eng.solve(SolveRequest(field=a, operator="laplacian"))
                stats = eng.stats()
        assert all(r.degraded for r in first) and again.degraded
        assert not other.degraded
        assert stats["degraded"] == 4 and stats["degraded_classes"] == 1
        # the failed launch raised before the kernel ran; the other class
        # launched once, one stacked launch (its bucket of one, padded to 1)
        assert launched == [(1, 12, 12)]
        assert plan.fired() == [("kernel.dispatch", "backend_error", 1)]
        for r in first + [again]:
            assert torch.equal(r.out, sequential_reference(a))


class TestDeadlines:
    def test_expired_request_fails_fast_without_poisoning_bucket(self):
        stall = chaos.FaultPlan(seed=7).add(
            "serve.bucket_compute", "stall", at=1, duration=0.3
        )
        with chaos.injected(stall):
            with engine(max_retries=0) as eng:
                slow = eng.submit(SolveRequest(field=field((8, 8)), operator="laplacian"))
                time.sleep(0.05)  # let the worker enter the stalled bucket
                doomed = eng.submit(
                    SolveRequest(field=field((12, 12)), operator="laplacian",
                                 deadline_s=0.05))
                mate = eng.submit(
                    SolveRequest(field=field((12, 12)), operator="laplacian"))
                with pytest.raises(DeadlineExceeded):
                    doomed.result(timeout=30)
                assert tuple(mate.result(timeout=30).out.shape) == (12, 12)
                assert tuple(slow.result(timeout=30).out.shape) == (8, 8)
                stats = eng.stats()
        assert stats["deadline_exceeded"] == 1
        assert stats["completed"] == 2

    def test_deadline_validated_at_submit(self):
        with pytest.raises(ValueError, match="deadline_s"):
            with engine() as eng:
                eng.submit(SolveRequest(field=field(), operator="laplacian",
                                        deadline_s=-1.0))


class TestBackpressure:
    def test_reject_raises_queue_full(self):
        stall = chaos.FaultPlan(seed=7).add(
            "serve.bucket_compute", "stall", rate=1.0, duration=0.2
        )
        eng = engine(queue_depth=1, backpressure="reject")
        with chaos.injected(stall):
            eng.start()
            with pytest.raises(QueueFull):
                for _ in range(50):
                    eng.submit(SolveRequest(field=field(), operator="laplacian"))
        assert eng.stats()["rejected"] >= 1
        eng.close()

    def test_invalid_policy_rejected(self):
        with pytest.raises(ValueError, match="backpressure"):
            engine(backpressure="drop")


class TestWorkerRestart:
    def test_dead_worker_restarts_and_finishes_all_work(self):
        f = field()
        plan = chaos.FaultPlan(seed=7).add(
            "serve.bucket_compute", "worker_death", at=1
        )
        with chaos.injected(plan):
            with engine() as eng:
                futs = [eng.submit(SolveRequest(field=f, operator="laplacian"))
                        for _ in range(3)]
                results = [fut.result(timeout=30) for fut in futs]
                stats = eng.stats()
        assert stats["worker_restarts"] == 1
        assert stats["completed"] == 3
        for r in results:
            assert torch.equal(r.out, sequential_reference(f))

    def test_close_after_death_is_clean(self):
        plan = chaos.FaultPlan(seed=7).add(
            "serve.bucket_compute", "worker_death", at=1
        )
        with chaos.injected(plan):
            eng = engine()
            fut = eng.submit(SolveRequest(field=field(), operator="laplacian"))
            assert tuple(fut.result(timeout=30).out.shape) == (8, 8)
            eng.close()  # must terminate the respawned worker too
        assert eng.stats()["worker_restarts"] == 1
        assert eng._worker is None


class TestConcurrentSubmitters:
    def test_many_threads_many_requests(self):
        """More submitting threads than cores, a short switch interval: every
        request is served once, bit for bit, and the counters add up."""
        import sys
        import threading

        fields = [field((8, 8), seed=i) for i in range(6)]
        refs = [sequential_reference(f) for f in fields]
        out: dict = {}
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            with engine(max_batch=4) as eng:
                def submit(k):
                    futs = [(k, i, eng.submit(SolveRequest(
                        field=fields[i], operator="laplacian", tag=(k, i))))
                        for i in range(6)]
                    for kk, i, fut in futs:
                        out[(kk, i)] = fut.result(timeout=60)

                threads = [threading.Thread(target=submit, args=(k,))
                           for k in range(12)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in threads)
                stats = eng.stats()
        finally:
            sys.setswitchinterval(old)
        assert len(out) == 72 and stats["completed"] == 72
        assert stats["submitted"] == 72 and stats["failed"] == 0
        for (k, i), r in out.items():
            assert r.tag == (k, i) and torch.equal(r.out, refs[i])
