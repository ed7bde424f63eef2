"""Fault tolerance: failure supervision, straggler detection, heartbeats
(counterpart of ``repro.runtime.fault``; pure Python, as the reference's).

At scale the dominant events are (a) hardware failures — handled by
checkpoint/restart through the supervisor loop, (b) stragglers — detected by
the step-time monitor, (c) hangs — detected externally via the heartbeat
file.  All three are deliberately simple, deterministic mechanisms that
compose with checkpointed, deterministic drivers for bit-exact resume.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from collections.abc import Callable


class StragglerMonitor:
    """EWMA step-time monitor.  In a synchronous group the slowest
    participant sets the step time, so a persistent multiplier over the EWMA
    indicates a straggling host or card; the policy hook decides (log,
    re-shard, evict).

    ``max_events`` bounds the retained event records — a week-long run on
    a flaky host must not grow an unbounded list; the newest events win
    (``on_straggler`` still sees every flagged step as it happens)."""

    def __init__(
        self,
        *,
        alpha: float = 0.1,
        threshold: float = 2.0,
        warmup_steps: int = 5,
        max_events: int = 256,
        on_straggler: Callable[[int, float, float], None] | None = None,
    ):
        self.alpha = alpha
        self.threshold = threshold
        self.warmup_steps = warmup_steps
        self.on_straggler = on_straggler
        self.ewma: float | None = None
        self.count = 0
        self.events: collections.deque[dict] = collections.deque(
            maxlen=max_events
        )

    def record(self, step: int, dt: float) -> bool:
        """Returns True if this step is flagged as a straggler event."""
        self.count += 1
        if self.ewma is None:
            self.ewma = dt
            return False
        flagged = (
            self.count > self.warmup_steps and dt > self.threshold * self.ewma
        )
        if flagged:
            self.events.append({"step": step, "dt": dt, "ewma": self.ewma})
            if self.on_straggler:
                self.on_straggler(step, dt, self.ewma)
            # don't poison the EWMA with the outlier
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * dt
        return flagged


class Heartbeat:
    """Liveness file for an external watchdog (touch every ``interval`` s).

    Writes are fsync'd before the atomic replace, so a watchdog on the
    other side of a crash reads either the previous beat or the new one
    — never a truncated line (which would look like a *fresh* corrupt
    beat and mask a real hang)."""

    def __init__(self, path: str, interval: float = 30.0):
        self.path = path
        self.interval = interval
        self._last = 0.0

    def beat(self, step: int):
        now = time.time()
        if now - self._last >= self.interval:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{step} {now}\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
            self._last = now


@dataclasses.dataclass(frozen=True)
class HeartbeatStatus:
    """What a watchdog learns from one read: the last beaten step, how
    old the beat is, and whether that age exceeds the staleness bound."""

    step: int | None
    age_s: float
    stale: bool


def read_heartbeat(path: str, stale_after: float) -> HeartbeatStatus:
    """Watchdog-side read of a :class:`Heartbeat` file.

    Returns ``(step, age_s, stale)``; a missing or unparsable file reads
    as ``step=None, age_s=inf, stale=True`` — fail-stale, so a watchdog
    that races file creation or meets corruption escalates rather than
    assuming liveness.
    """
    try:
        with open(path) as f:
            step_s, ts_s = f.read().split()
        step, ts = int(step_s), float(ts_s)
    except (OSError, ValueError):
        return HeartbeatStatus(step=None, age_s=float("inf"), stale=True)
    age = time.time() - ts
    return HeartbeatStatus(step=step, age_s=age, stale=age > stale_after)


@dataclasses.dataclass
class SupervisorReport:
    restarts: int
    completed_steps: int
    failures: list[str]


def supervise(
    run_fn: Callable[[int], int],
    *,
    max_restarts: int = 3,
    on_restart: Callable[[int, BaseException], None] | None = None,
) -> SupervisorReport:
    """Run ``run_fn(start_step) -> final_step`` under restart-on-failure.

    ``run_fn`` must itself restore from the latest checkpoint when invoked
    (:func:`repro_torch.runtime.resilient.resilient_evolve`'s does).  Any exception triggers a restart from
    the last committed checkpoint, up to ``max_restarts`` times — the
    single-process analogue of a cluster controller rescheduling dead hosts.
    """
    restarts = 0
    failures: list[str] = []
    step = 0
    while True:
        try:
            step = run_fn(step)
            return SupervisorReport(
                restarts=restarts, completed_steps=step, failures=failures
            )
        except KeyboardInterrupt:
            raise
        except BaseException as e:  # noqa: BLE001 — supervisor catches all
            failures.append(f"{type(e).__name__}: {e}")
            restarts += 1
            if on_restart:
                on_restart(restarts, e)
            if restarts > max_restarts:
                raise RuntimeError(
                    f"exceeded {max_restarts} restarts; failures: {failures}"
                ) from e
