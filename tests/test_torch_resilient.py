"""The port's self-healing long run (``repro_torch.runtime.resilient``).

Mirrors ``tests/test_resilient.py`` on the CPU: an injected mid-run crash
and an injected NaN blow-up each recover via rollback to the last healthy
checkpoint, and the healed run's final field is **bit-identical** to an
uninjected ``ch_evolve``.  32^2, ``backend='torch'``: the machinery under
test is the recovery loop, not the kernels.

Parity with the reference: the same numpy start field and the same fault
plan through ``repro.runtime.resilient`` (``backend='jnp'``) give the same
``restarts``/``rollbacks``/``failures`` and a final field within
``tolerance_for(float64, scale=400)``: 41 steps (the bootstrap and 40),
each within the ~10 ulp the two packages' differently ordered sums and
banded recurrences leave a step, carried without amplification (the
implicit operators are near the identity at 32^2, dt 1e-3), as
``tests/test_torch_cahn_hilliard.py`` holds 11 steps to scale 100.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cahn_hilliard import CahnHilliardADI as RefSolver
from repro.core.cahn_hilliard import CHConfig as RefConfig
from repro.runtime import chaos as ref_chaos
from repro.runtime.resilient import resilient_evolve as ref_resilient_evolve
from repro_torch.core.cahn_hilliard import CahnHilliardADI, CHConfig, ch_evolve
from repro_torch.runtime import chaos
from repro_torch.runtime.fault import read_heartbeat
from repro_torch.runtime.resilient import (
    HealthError,
    HealthGuard,
    resilient_evolve,
)
from repro_torch.util import tolerance_for

N_STEPS = 40
EVERY = 16
PARITY_TOL = tolerance_for("float64", scale=400)


@pytest.fixture(scope="module")
def solver():
    return CahnHilliardADI(CHConfig(nx=32, ny=32, dt=1e-3, backend="torch",
                                    device="cpu"))


@pytest.fixture(scope="module")
def c0_np():
    return np.random.default_rng(0).uniform(-0.1, 0.1, (32, 32))


@pytest.fixture(scope="module")
def c0(c0_np):
    return torch.as_tensor(c0_np)


@pytest.fixture(scope="module")
def reference(solver, c0):
    """The uninjected plain ch_evolve result every healed run must match."""
    c_final, _ = ch_evolve(solver, c0, N_STEPS)
    return c_final


class TestHealthGuard:
    def test_passes_healthy_field(self, c0):
        assert HealthGuard.for_field(c0).check(c0, step=0) == float(c0.mean())

    def test_flags_nonfinite(self, c0):
        guard = HealthGuard.for_field(c0)
        bad = c0.clone()
        bad[0, 0] = float("nan")
        with pytest.raises(HealthError, match="non-finite"):
            guard.check(bad, step=3)

    def test_flags_mass_drift(self, c0):
        guard = HealthGuard.for_field(c0, mass_tol=1e-8)
        with pytest.raises(HealthError, match="mass drift"):
            guard.check(c0 + 1e-3, step=3)


class TestResilientEvolve:
    def test_clean_run_bit_exact_vs_ch_evolve(self, solver, c0, reference,
                                              tmp_path):
        report = resilient_evolve(
            solver, c0, N_STEPS,
            directory=str(tmp_path), checkpoint_every=EVERY,
            metrics_fn=lambda c: float((c**2).mean()),
        )
        assert report.restarts == 0 and report.rollbacks == 0
        assert report.completed_steps == N_STEPS + 1  # ch_evolve accounting
        assert torch.equal(report.c_final, reference)
        assert report.history and report.history[-1][0] == N_STEPS + 1

    def test_injected_crash_heals_bit_exact(self, solver, c0, reference,
                                            tmp_path):
        plan = chaos.FaultPlan(seed=3).add("evolve.step", "crash", at=2)
        with chaos.injected(plan):
            report = resilient_evolve(
                solver, c0, N_STEPS,
                directory=str(tmp_path), checkpoint_every=EVERY,
            )
        assert report.restarts == 1 and report.rollbacks == 1
        assert any("InjectedCrash" in f for f in report.failures)
        assert plan.fired() == [("evolve.step", "crash", 2)]
        assert torch.equal(report.c_final, reference)

    def test_injected_nan_blowup_heals_bit_exact(self, solver, c0, reference,
                                                 tmp_path):
        plan = chaos.FaultPlan(seed=3).add(
            "evolve.step", "nan", at=2, value=float("nan")
        )
        with chaos.injected(plan):
            report = resilient_evolve(
                solver, c0, N_STEPS,
                directory=str(tmp_path), checkpoint_every=EVERY,
            )
        # the health guard catches the poisoned chunk before commit, the
        # supervisor rolls back, and the replay is bit-exact
        assert report.restarts == 1 and report.rollbacks == 1
        assert any("HealthError" in f for f in report.failures)
        assert torch.equal(report.c_final, reference)

    def test_mass_drift_poison_also_caught(self, solver, c0, reference,
                                           tmp_path):
        # a *finite* poison: only the conservation check can see this one
        plan = chaos.FaultPlan(seed=3).add(
            "evolve.step", "nan", at=2, value=1e6
        )
        with chaos.injected(plan):
            report = resilient_evolve(
                solver, c0, N_STEPS,
                directory=str(tmp_path), checkpoint_every=EVERY,
            )
        assert report.rollbacks == 1
        assert any(
            "HealthError" in f and "drift" in f for f in report.failures
        ) or any("non-finite" in f for f in report.failures)
        assert torch.equal(report.c_final, reference)

    def test_crash_then_nan_heals_bit_exact(self, solver, c0, reference,
                                            tmp_path):
        """The card run's plan (chip_smoke.py, phase 4j) at 32^2."""
        plan = (chaos.FaultPlan(seed=3).add("evolve.step", "crash", at=2)
                .add("evolve.step", "nan", at=3))
        with chaos.injected(plan):
            report = resilient_evolve(
                solver, c0, N_STEPS,
                directory=str(tmp_path), checkpoint_every=EVERY,
            )
        assert report.restarts == 2 and report.rollbacks == 2
        assert [f.split(":")[0] for f in report.failures] == [
            "InjectedCrash", "HealthError"]
        assert torch.equal(report.c_final, reference)

    def test_same_seed_reproduces_same_fault_sequence(self, solver, c0,
                                                      tmp_path):
        fired = []
        for i in range(2):
            plan = chaos.FaultPlan(seed=9).add(
                "evolve.step", "crash", rate=0.3, max_fires=2
            )
            with chaos.injected(plan):
                resilient_evolve(
                    solver, c0, N_STEPS,
                    directory=str(tmp_path / str(i)),
                    checkpoint_every=8, max_restarts=5,
                )
            fired.append(plan.fired())
        assert fired[0] == fired[1] and fired[0]

    def test_max_restarts_exhaustion(self, solver, c0, tmp_path):
        plan = chaos.FaultPlan().add("evolve.step", "crash", rate=1.0)
        with chaos.injected(plan):
            with pytest.raises(RuntimeError, match="exceeded 1 restarts"):
                resilient_evolve(
                    solver, c0, N_STEPS,
                    directory=str(tmp_path), checkpoint_every=EVERY,
                    max_restarts=1,
                )

    def test_cross_invocation_resume_bit_exact(self, solver, c0, reference,
                                               tmp_path):
        # a run killed outright (max_restarts=0) resumes in a fresh
        # invocation against the same directory — the process-kill story
        plan = chaos.FaultPlan().add("evolve.step", "crash", at=2)
        with chaos.injected(plan):
            with pytest.raises(RuntimeError, match="exceeded 0 restarts"):
                resilient_evolve(
                    solver, c0, N_STEPS,
                    directory=str(tmp_path), checkpoint_every=EVERY,
                    max_restarts=0,
                )
        report = resilient_evolve(
            solver, c0, N_STEPS,
            directory=str(tmp_path), checkpoint_every=EVERY,
        )
        assert report.completed_steps == N_STEPS + 1
        assert torch.equal(report.c_final, reference)

    def test_heartbeat_written_and_readable(self, solver, c0, tmp_path):
        hb = str(tmp_path / "hb")
        resilient_evolve(
            solver, c0, N_STEPS,
            directory=str(tmp_path / "ck"), checkpoint_every=EVERY,
            heartbeat_path=hb, heartbeat_interval=0.0,
        )
        status = read_heartbeat(hb, stale_after=60.0)
        assert status.step == N_STEPS + 1
        assert not status.stale

    def test_checkpoint_every_validated(self, solver, c0, tmp_path):
        with pytest.raises(ValueError, match="checkpoint_every"):
            resilient_evolve(
                solver, c0, 4, directory=str(tmp_path), checkpoint_every=0
            )

    def test_caller_field_and_checkpoints_survive(self, solver, c0, tmp_path):
        """The driver steps private buffers: the caller's field is left as
        it was, and the last checkpoint holds the final pair."""
        before = c0.clone()
        report = resilient_evolve(solver, c0, N_STEPS, directory=str(tmp_path),
                                  checkpoint_every=EVERY)
        assert torch.equal(c0, before)
        from repro_torch.checkpoint import restore_pytree

        got, m = restore_pytree({"c": c0, "c_prev": c0}, str(tmp_path))
        assert m["step"] == N_STEPS + 1
        assert torch.equal(got["c"], report.c_final)


class TestParityWithReference:
    @pytest.mark.parametrize("faults", [
        (),
        (("crash", 2),),
        (("crash", 2), ("nan", 3)),
    ])
    def test_same_plan_same_recovery(self, c0_np, tmp_path, faults):
        def plan_of(mod):
            plan = mod.FaultPlan(seed=3)
            for kind, at in faults:
                plan.add("evolve.step", kind, at=at)
            return plan

        ref_plan, port_plan = plan_of(ref_chaos), plan_of(chaos)
        ref = RefSolver(RefConfig(nx=32, ny=32, dt=1e-3, backend="jnp"))
        with ref_chaos.injected(ref_plan):
            want = ref_resilient_evolve(ref, jnp.asarray(c0_np), N_STEPS,
                                        directory=str(tmp_path / "ref"),
                                        checkpoint_every=EVERY)
        port = CahnHilliardADI(CHConfig(nx=32, ny=32, dt=1e-3, backend="torch",
                                        device="cpu"))
        with chaos.injected(port_plan):
            got = resilient_evolve(port, torch.as_tensor(c0_np), N_STEPS,
                                   directory=str(tmp_path / "port"),
                                   checkpoint_every=EVERY)
        assert port_plan.fired() == ref_plan.fired()
        assert (got.completed_steps, got.restarts, got.rollbacks) == (
            want.completed_steps, want.restarts, want.rollbacks)
        assert got.failures == want.failures
        np.testing.assert_allclose(got.c_final.numpy(),
                                   np.asarray(want.c_final), **PARITY_TOL)
