"""The port's chaos harness (``repro_torch.runtime.chaos``): deterministic
fault plans, crash-consistency sweeps over the checkpoint commit, the
``'kernel.dispatch'`` site, and parity with the reference's harness.

Mirrors ``tests/test_chaos.py``, the tune-cache sweeps included
(``repro_torch.tune.cache``).  The parity tests drive the reference's
``repro.runtime.chaos`` and the port's with the same seed, schedule and
site-hit sequence and require the same log, with the one site renamed
(``'pallas.dispatch'`` -> ``'kernel.dispatch'``).
"""

import time

import numpy as np
import pytest
import torch

from repro.runtime import chaos as ref_chaos
import repro_torch as rt
from repro_torch.checkpoint import (
    Checkpointer,
    latest_step,
    restore_pytree,
    save_pytree,
)
from repro_torch.kernels import _build
from repro_torch.runtime import chaos
from repro_torch.tune import TuneCache


class TestFaultPlan:
    def test_at_fires_on_exact_hits(self):
        plan = chaos.FaultPlan(seed=0).add("evolve.step", "crash", at=(2, 4))
        with chaos.injected(plan):
            assert chaos.fire("evolve.step") is None
            with pytest.raises(chaos.InjectedCrash):
                chaos.fire("evolve.step")
            assert chaos.fire("evolve.step") is None
            with pytest.raises(chaos.InjectedCrash):
                chaos.fire("evolve.step")
        assert plan.fired() == [
            ("evolve.step", "crash", 2),
            ("evolve.step", "crash", 4),
        ]

    def test_same_seed_same_sequence(self):
        runs = []
        for _ in range(2):
            plan = chaos.FaultPlan(seed=42).add(
                "serve.bucket_compute", "transient", rate=0.3
            )
            fired = []
            for hit in range(50):
                try:
                    plan.fire("serve.bucket_compute")
                except chaos.TransientError:
                    fired.append(hit)
            runs.append(fired)
        assert runs[0] == runs[1]
        assert 0 < len(runs[0]) < 50  # rate actually sampled both ways

    def test_different_seed_different_sequence(self):
        seqs = []
        for seed in (1, 2):
            plan = chaos.FaultPlan(seed=seed).add(
                "evolve.step", "transient", rate=0.3
            )
            fired = []
            for hit in range(60):
                try:
                    plan.fire("evolve.step")
                except chaos.TransientError:
                    fired.append(hit)
            seqs.append(fired)
        assert seqs[0] != seqs[1]

    def test_reset_replays_identically(self):
        plan = chaos.FaultPlan(seed=5).add("evolve.step", "crash", rate=0.4)

        def run():
            fired = []
            for hit in range(30):
                try:
                    plan.fire("evolve.step")
                except chaos.InjectedCrash:
                    fired.append(hit)
            return fired

        first = run()
        plan.reset()
        assert run() == first

    def test_rate_stream_position_independent_of_other_faults(self):
        def run(stall_at):
            plan = (
                chaos.FaultPlan(seed=9)
                .add("evolve.step", "stall", at=stall_at, duration=0.0)
                .add("evolve.step", "transient", rate=0.3)
            )
            fired = []
            for hit in range(40):
                try:
                    plan.fire("evolve.step")
                except chaos.TransientError:
                    fired.append(hit)
            return fired

        a = run(1)    # the stall masks whatever hit 0 would have done
        b = run(999)  # the stall never acts
        assert [h for h in a if h != 0] == [h for h in b if h != 0]

    def test_match_filters_on_context(self):
        plan = chaos.FaultPlan().add(
            "checkpoint.write", "crash", rate=1.0, match={"point": "rename"}
        )
        assert plan.fire("checkpoint.write", point="leaves") is None
        with pytest.raises(chaos.InjectedCrash):
            plan.fire("checkpoint.write", point="rename")

    def test_max_fires_caps(self):
        plan = chaos.FaultPlan().add(
            "evolve.step", "crash", rate=1.0, max_fires=2
        )
        for _ in range(2):
            with pytest.raises(chaos.InjectedCrash):
                plan.fire("evolve.step")
        assert plan.fire("evolve.step") is None

    def test_stall_sleeps(self):
        plan = chaos.FaultPlan().add(
            "serve.bucket_compute", "stall", at=1, duration=0.05
        )
        t0 = time.perf_counter()
        fault = plan.fire("serve.bucket_compute")
        assert time.perf_counter() - t0 >= 0.05
        assert fault.kind == "stall"

    def test_nan_returns_fault_for_site_to_apply(self):
        plan = chaos.FaultPlan().add("evolve.step", "nan", at=1, value=1e6)
        fault = plan.fire("evolve.step")
        assert fault.kind == "nan" and fault.value == 1e6

    def test_validation(self):
        with pytest.raises(ValueError, match="unknown site"):
            chaos.Fault("no.such.site", "crash", at=1)
        with pytest.raises(ValueError, match="unknown site"):
            chaos.Fault("pallas.dispatch", "crash", at=1)  # renamed here
        with pytest.raises(ValueError, match="unknown kind"):
            chaos.Fault("evolve.step", "meteor", at=1)
        with pytest.raises(ValueError, match="at= .*or rate="):
            chaos.Fault("evolve.step", "crash")
        with pytest.raises(ValueError, match="unknown site"):
            chaos.FaultPlan().fire("no.such.site")

    def test_no_plan_fire_is_inert(self):
        assert chaos.active() is None
        assert chaos.fire("evolve.step", step=1) is None

    def test_install_is_exclusive_and_injected_cleans_up(self):
        plan = chaos.FaultPlan()
        with chaos.injected(plan):
            assert chaos.active() is plan
            with pytest.raises(RuntimeError, match="already installed"):
                chaos.install(chaos.FaultPlan())
        assert chaos.active() is None


class TestParityWithReference:
    """The same seed, schedule and site hits give the same log in both
    packages, site for site under :data:`chaos.REFERENCE_SITES`."""

    def test_sites_and_kinds_map_one_to_one(self):
        assert set(chaos.REFERENCE_SITES) == set(ref_chaos.SITES)
        assert sorted(chaos.REFERENCE_SITES.values()) == sorted(chaos.SITES)
        assert chaos.KINDS == ref_chaos.KINDS

    @pytest.mark.parametrize("seed", [0, 7, 123])
    def test_same_plan_same_log(self, seed):
        def schedule(mod, site_of):
            plan = mod.FaultPlan(seed=seed)
            for i, site in enumerate(ref_chaos.SITES):
                plan.add(site_of(site), "transient", rate=0.2 + 0.1 * i)
                plan.add(site_of(site), "crash", at=(3, 9),
                         match={"point": "rename"} if i == 0 else None)
            return plan

        def drive(mod, plan, site_of):
            rng = np.random.default_rng(seed)
            for hit in range(200):
                site = ref_chaos.SITES[rng.integers(len(ref_chaos.SITES))]
                try:
                    plan.fire(site_of(site), point=("rename", "leaves")[hit % 2],
                              hit=hit)
                except (mod.TransientError, mod.InjectedCrash):
                    pass
            return plan.log

        ref_log = drive(ref_chaos, schedule(ref_chaos, lambda s: s),
                        lambda s: s)
        port_log = drive(chaos, schedule(chaos, chaos.REFERENCE_SITES.get),
                         chaos.REFERENCE_SITES.get)
        assert len(ref_log) > 20
        assert port_log == [(chaos.REFERENCE_SITES[s], k, h, ctx)
                            for s, k, h, ctx in ref_log]

    def test_doc_example_reproduces(self):
        for mod in (ref_chaos, chaos):
            plan = mod.FaultPlan(seed=7).add("evolve.step", "crash", at=2)
            with mod.injected(plan):
                mod.fire("evolve.step", step=1)
                with pytest.raises(mod.InjectedCrash):
                    mod.fire("evolve.step", step=2)
            assert plan.fired() == [("evolve.step", "crash", 2)]


class TestCheckpointCrashConsistency:
    """Kill-at-every-fsync-point sweep over the atomic commit sequence."""

    @pytest.mark.parametrize("point", ["leaves", "rename", "latest"])
    def test_kill_at_point_leaves_committed_view(self, tmp_path, point):
        d = str(tmp_path)
        old = {"w": torch.arange(4.0)}
        new = {"w": torch.arange(4.0) * 2}
        save_pytree(old, d, 1)
        plan = chaos.FaultPlan().add(
            "checkpoint.write", "crash",
            rate=1.0, match={"point": point}, max_fires=1,
        )
        with chaos.injected(plan):
            with pytest.raises(chaos.InjectedCrash):
                save_pytree(new, d, 2)
        # the reader's view is a fully committed checkpoint: before the
        # final rename that is the old one; after it, the new one
        step = latest_step(d)
        assert step in (1, 2)
        restored, manifest = restore_pytree({"w": torch.zeros(4)}, d, step=step)
        assert manifest["step"] == step
        assert torch.equal(restored["w"], (old if step == 1 else new)["w"])
        # recovery: a clean retry of the same step commits normally
        save_pytree(new, d, 2)
        assert latest_step(d) == 2
        restored, _ = restore_pytree({"w": torch.zeros(4)}, d)
        assert torch.equal(restored["w"], new["w"])

    def test_injected_io_error_surfaces_on_wait(self, tmp_path):
        ckpt = Checkpointer(str(tmp_path), keep_last=2)
        plan = chaos.FaultPlan().add("checkpoint.write", "io_error", at=1)
        with chaos.injected(plan):
            ckpt.save_async({"w": torch.zeros(2)}, 1)
            with pytest.raises(OSError, match="injected io_error"):
                ckpt.wait()
        # the checkpointer stays usable after a failed write
        ckpt.save_async({"w": torch.zeros(2)}, 2)
        ckpt.close()
        assert latest_step(str(tmp_path)) == 2


class TestTuneCacheCrashConsistency:
    """A kill at either point of the tune cache's atomic write leaves the
    old entry; an injected I/O error degrades to the old entry (a miss at
    worst), never a failed Create."""

    @pytest.mark.parametrize("point", ["write", "replace"])
    def test_kill_at_point_readers_see_old_entry(self, tmp_path, point):
        cache = TuneCache(root=tmp_path)
        cache.put("k", {"cfg": 1})
        assert cache.get("k") == {"cfg": 1}
        plan = chaos.FaultPlan().add(
            "tune.cache_write", "crash",
            rate=1.0, match={"point": point}, max_fires=1,
        )
        with chaos.injected(plan):
            with pytest.raises(chaos.InjectedCrash):
                cache.put("k", {"cfg": 2})
        assert cache.get("k") == {"cfg": 1}  # old entry, never torn
        assert [f[:2] for f in plan.fired()] == [("tune.cache_write", "crash")]
        cache.put("k", {"cfg": 2})  # recovery
        assert cache.get("k") == {"cfg": 2}

    def test_io_error_degrades_to_miss_not_failure(self, tmp_path):
        cache = TuneCache(root=tmp_path)
        cache.put("k", {"cfg": 1})
        plan = chaos.FaultPlan().add("tune.cache_write", "io_error", at=1)
        with chaos.injected(plan):
            cache.put("k", {"cfg": 2})  # swallowed: degrade, don't break
        assert cache.get("k") == {"cfg": 1}
        assert list(tmp_path.glob("*.tmp")) == []


class TestKernelDispatchInjection:
    """``_build.launch`` fires ``'kernel.dispatch'`` before it looks up or
    calls a kernel, so an injected ``backend_error`` leaves nothing
    launched (the card's side is stubbed on this host)."""

    def test_backend_error_at_dispatch_before_the_call(self, monkeypatch):
        calls = []
        monkeypatch.setattr(_build, "build", lambda: calls.append("build"))
        plan = chaos.FaultPlan().add(
            "kernel.dispatch", "backend_error",
            rate=1.0, match={"kernel": "stencil2d"},
        )
        before = dict(_build.LAUNCHES)
        with chaos.injected(plan):
            with pytest.raises(chaos.BackendError):
                _build.launch("stencil2d", torch.device("cuda", 0), 1, 2)
        assert calls == [] and _build.LAUNCHES == before
        assert plan.fired() == [("kernel.dispatch", "backend_error", 1)]
        assert plan.log[0][3] == {"kernel": "stencil2d"}

    def test_plain_backend_never_hits_the_site(self):
        plan = chaos.FaultPlan().add("kernel.dispatch", "backend_error",
                                     rate=1.0)
        with chaos.injected(plan):
            p = rt.create("laplacian", (16, 16), device="cpu")
            out = rt.compute(p, torch.ones((16, 16), dtype=torch.float64))
        assert bool(torch.isfinite(out).all())
        assert plan.fired() == []
