"""Self-healing long-run driver: checkpointed Cahn–Hilliard integration
that survives crashes and blow-ups (counterpart of
``repro.runtime.resilient``).

The paper's flagship workload is a long ADI integration (hundreds of
thousands of steps in the coarsening figure); at that scale the
interesting failures are *mid-run*: a host dies between checkpoints, a
too-aggressive ``dt`` blows the field up into NaNs, a flaky filesystem
eats a write.  :func:`resilient_evolve` wraps the chunked evolve driver
with the three recovery mechanisms the rest of the runtime provides:

- **checkpoint/restart** — after every chunk the ``(c_n, c_nm1)`` carry
  pair is committed through :class:`repro_torch.checkpoint.Checkpointer`
  (atomic rename commit, retention, the reference's on-disk layout); a
  crash anywhere re-enters from the last committed pair and replays
  *bit-exactly* — the scheme is deterministic, so a healed run equals an
  uninjected one to the bit;
- **solution-health guard** — after every chunk the field must be
  finite and the Cahn–Hilliard invariant must hold: under periodic BCs
  the scheme conserves mass (``∫C``) to roundoff, so mean drift beyond
  ``mass_tol`` means the integration has gone numerically wrong even if
  no value is NaN yet.  An unhealthy chunk **never reaches the
  checkpoint directory**: the guard raises before the save, the
  supervisor restarts, and the driver rolls back to the last *healthy*
  checkpoint;
- **supervision + liveness** — restarts run under
  :func:`repro_torch.runtime.fault.supervise` (bounded ``max_restarts``),
  and an optional :class:`~repro_torch.runtime.fault.Heartbeat` file lets
  an external watchdog (:func:`~repro_torch.runtime.fault.read_heartbeat`)
  distinguish a slow run from a hung one.

The solver's ``make_evolve`` updates its two carry buffers in place, so
the driver never lets a buffer it steps alias anything it must keep: the
start field and the bootstrap pair are private copies, a checkpoint
copies the pair to the host before the next chunk runs
(``save_async``), and a rollback restores into fresh tensors on the
solver's device.  Faults are injected (deterministically) through the
``'evolve.step'`` chaos site at each chunk boundary
(:func:`repro_torch.core.cahn_hilliard.poison_at_chunk`).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import api as _api
from repro_torch.checkpoint import Checkpointer, latest_step, restore_pytree
from repro_torch.core.cahn_hilliard import poison_at_chunk
from repro_torch.runtime.fault import Heartbeat, supervise


class HealthError(RuntimeError):
    """The solution failed the health guard (non-finite values, or the
    conserved mass drifted) — recoverable by rollback, not by retry of
    the same state."""


@dataclasses.dataclass(frozen=True)
class HealthGuard:
    """Finiteness + mass-conservation check for one CH field.

    ``mass_tol`` bounds ``|mean(c) - mean(c0)|`` — mean rather than the
    integral so the tolerance is resolution-independent, and absolute
    rather than relative because the paper's deep-quench initial
    condition has mean ≈ 0.
    """

    mean0: float
    mass_tol: float = 1e-8

    @classmethod
    def for_field(cls, c0, *, mass_tol: float = 1e-8) -> "HealthGuard":
        return cls(mean0=float(torch.as_tensor(c0).mean()), mass_tol=mass_tol)

    def check(self, c: torch.Tensor, *, step: int) -> float:
        """Raise :class:`HealthError` if ``c`` is blown up or drifting;
        return its mean.  One device-to-host read for both tests."""
        finite, mean = torch.stack(
            [torch.isfinite(c).all().to(c.dtype), c.mean()]).tolist()
        if not finite:
            raise HealthError(f"non-finite field at step {step}")
        drift = abs(mean - self.mean0)
        if drift > self.mass_tol:
            raise HealthError(
                f"mass drift {drift:.3e} > {self.mass_tol:.1e} at step {step}"
            )
        return mean


@dataclasses.dataclass
class ResilientReport:
    """What a healed run did: the final field plus the recovery story."""

    c_final: object
    completed_steps: int
    restarts: int
    rollbacks: int
    failures: list[str]
    history: list


def resilient_evolve(
    solver,
    c0,
    n_steps: int,
    *,
    directory: str,
    checkpoint_every: int = 16,
    keep_last: int = 3,
    max_restarts: int = 3,
    mass_tol: float = 1e-8,
    heartbeat_path: str | None = None,
    heartbeat_interval: float = 0.0,
    metrics_fn=None,
) -> ResilientReport:
    """Integrate ``n_steps`` like :func:`repro_torch.core.cahn_hilliard.ch_evolve`,
    but checkpointed, health-guarded, and supervised, on the solver's
    device.

    ``solver`` is a :class:`~repro_torch.core.cahn_hilliard.CahnHilliardADI`;
    ``directory`` receives the checkpoints (the run resumes from it if
    it already holds one — re-invoking after a process kill continues
    the same run).  Chunks are ``checkpoint_every`` steps; the step
    accounting matches ``ch_evolve`` (the bootstrap counts as step 1,
    then ``n_steps`` full-scheme steps).  ``metrics_fn`` is evaluated on
    the field after each *healthy* chunk.

    Bit-exactness: chunk boundaries are derived from the committed step
    alone, so a rollback replays exactly the chunks the uninjected run
    executes, on exactly the carry the uninjected run had — the healed
    result is bit-identical to ``ch_evolve(solver, c0, n_steps,
    save_every=checkpoint_every)``, and the report's ``rollbacks`` count
    makes that auditable.
    """
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    # private copy on the solver's device: the carry buffers are updated
    # in place downstream
    c0 = torch.as_tensor(c0, dtype=solver.dtype, device=solver.device).clone()
    guard = HealthGuard.for_field(c0, mass_tol=mass_tol)
    ckpt = Checkpointer(directory, keep_last=keep_last)
    hb = (
        Heartbeat(heartbeat_path, heartbeat_interval)
        if heartbeat_path
        else None
    )
    template = {"c": c0, "c_prev": c0}
    state: dict = {"carry": None, "history": [], "rollbacks": 0, "resumed": False}
    total = n_steps + 1  # ch_evolve accounting: bootstrap is step 1

    def _commit(carry, step: int, mean: float) -> None:
        ckpt.save_async(
            {"c": carry[0], "c_prev": carry[1]}, step,
            metadata={"mean": mean},
        )
        ckpt.wait()  # durable before the next chunk may fault
        if hb is not None:
            hb.beat(step)

    def run_fn(_start: int) -> int:
        done = latest_step(directory)
        if done is None:
            c1 = solver.initial_step(c0)
            carry = _api.swap((c0.clone(), c1))
            done = 1
            _commit(carry, done, guard.check(carry[0], step=done))
        else:
            # rollback / resume: the last committed pair is healthy by
            # construction (the guard runs before every commit)
            restored, _manifest = restore_pytree(template, directory)
            carry = (restored["c"], restored["c_prev"])
            if state["carry"] is not None:
                state["rollbacks"] += 1
            state["resumed"] = True
        state["carry"] = carry
        while done < total:
            todo = min(checkpoint_every, total - done)
            carry = poison_at_chunk(carry, done)
            carry = solver.make_evolve(todo)(*carry)
            mean = guard.check(carry[0], step=done + todo)
            done += todo
            _commit(carry, done, mean)
            state["carry"] = carry
            if metrics_fn is not None:
                state["history"].append((done, metrics_fn(carry[0])))
        return done

    try:
        report = supervise(run_fn, max_restarts=max_restarts)
    finally:
        ckpt.close()
    return ResilientReport(
        c_final=state["carry"][0],
        completed_steps=report.completed_steps,
        restarts=report.restarts,
        rollbacks=state["rollbacks"],
        failures=report.failures,
        history=state["history"],
    )
