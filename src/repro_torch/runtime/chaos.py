"""Deterministic, seeded fault injection — the chaos harness (counterpart of
``repro.runtime.chaos``; pure Python, as the reference's).

Long runs and serving fleets die in boring, reproducible ways: a kill
mid-checkpoint-commit, a worker thread that stops draining its queue, a
blown-up step poisoning the field with NaNs, a flaky filesystem, a
kernel that refuses to build or launch on one host.  This module makes
those failures *injectable on demand and reproducible by seed*, so the
self-healing layers (:mod:`repro_torch.runtime.resilient`, the hardened
:class:`repro_torch.serve.ServeEngine`) are exercised under real faults
in CI instead of trusted on faith.

Design:

- **Named sites.**  Production code calls :func:`fire` at a handful of
  named points (:data:`SITES`): the checkpoint commit sequence
  (``checkpoint.write``, with a ``point=`` context naming each fsync
  point), the tune-cache write (``tune.cache_write``), the serve
  engine's bucket compute (``serve.bucket_compute``), the long-run
  driver's chunk boundary (``evolve.step``), and the CUDA kernel
  dispatch (``kernel.dispatch``, fired by
  ``repro_torch.kernels._build.launch`` with ``kernel=<name>`` before
  the C call, so an injected fault leaves no partial output).
- **Site mapping.**  The sites are the reference's five, with one
  rename: the reference's ``'pallas.dispatch'`` (fired when a Pallas
  path is traced) is this package's ``'kernel.dispatch'`` (fired at
  each launch of a hand-written CUDA kernel); :data:`REFERENCE_SITES`
  maps each reference site to its counterpart here.  A
  :class:`BackendError` here means a failure of one of the port's CUDA
  kernels.
- **Zero overhead when idle.**  With no plan installed :func:`fire` is
  one global load and a ``None`` check — no allocation, no locking —
  so the hooks stay in production code permanently.
- **Deterministic.**  A :class:`FaultPlan` is a seed plus a schedule of
  :class:`Fault` entries matched by site hit-count (``at=``) or by a
  seeded per-fault Bernoulli ``rate=``.  The same seed and the same
  sequence of site hits fire the same faults in the same order (and the
  same as the reference's plan, site for site); the plan's
  :attr:`FaultPlan.log` records every firing so a test can assert the
  sequence reproduces exactly.

>>> plan = FaultPlan(seed=7).add("evolve.step", "crash", at=2)
>>> with injected(plan):
...     fire("evolve.step", step=1)     # hit 1: no fault
...     try:
...         fire("evolve.step", step=2) # hit 2: the scheduled crash
...     except InjectedCrash:
...         print("crashed")
crashed
>>> [(site, kind, hit) for site, kind, hit, _ in plan.log]
[('evolve.step', 'crash', 2)]
>>> fire("evolve.step", step=3) is None   # uninstalled again: inert
True
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
from typing import Any

#: The named injection sites threaded through the library.  ``fire`` on
#: an unlisted site is an error — a typo'd site would otherwise silently
#: never fault.
SITES = (
    "checkpoint.write",
    "tune.cache_write",
    "serve.bucket_compute",
    "evolve.step",
    "kernel.dispatch",
)

#: Each site of the reference (``repro.runtime.chaos.SITES``) and its
#: counterpart here: the same name, but for the Pallas dispatch, which is
#: a CUDA kernel launch in this package.
REFERENCE_SITES = {
    "checkpoint.write": "checkpoint.write",
    "tune.cache_write": "tune.cache_write",
    "serve.bucket_compute": "serve.bucket_compute",
    "evolve.step": "evolve.step",
    "pallas.dispatch": "kernel.dispatch",
}
_REFERENCE_NAME = {port: ref for ref, port in REFERENCE_SITES.items()}

#: Fault kinds and what :func:`fire` does for each:
#: raising kinds raise, ``stall`` sleeps, ``nan`` returns the fault for
#: the call site to apply (poison a value it owns).
KINDS = (
    "crash",          # raises InjectedCrash (a kill / hard failure)
    "io_error",       # raises InjectedIOError (an OSError: flaky IO)
    "transient",      # raises TransientError (retryable service fault)
    "backend_error",  # raises BackendError (CUDA kernel failure)
    "worker_death",   # raises WorkerDeath (kills a worker thread)
    "stall",          # sleeps `duration` seconds, then proceeds
    "nan",            # returned to the site: poison a step with `value`
)


class InjectedFault(RuntimeError):
    """Base class of every raising injected fault."""


class InjectedCrash(InjectedFault):
    """A simulated process kill / hard crash at the injection point."""


class InjectedIOError(OSError):
    """A simulated IO failure (an ``OSError``, so code that already
    degrades gracefully on real IO errors treats it identically)."""


class TransientError(RuntimeError):
    """A retryable service fault — the serve engine's bounded-retry
    path treats these (and ``OSError``/``TimeoutError``) as transient."""


class BackendError(RuntimeError):
    """A failure of one of the port's CUDA kernels — the serve engine's
    degradation path recreates the plan with ``backend='torch'``."""


class WorkerDeath(BaseException):
    """Kills a worker thread: a ``BaseException`` so it escapes the
    per-bucket ``except Exception`` fault isolation and unwinds the
    thread itself (the supervised-restart path then takes over)."""


@dataclasses.dataclass
class Fault:
    """One schedule entry: *which* site, *what* kind, *when*.

    ``at`` fires on exact 1-based site hit numbers (an int or a
    sequence); ``rate`` fires Bernoulli per hit from the plan's seeded
    stream; ``match`` restricts firing to hits whose ``fire(**ctx)``
    context contains the given key/value pairs (e.g.
    ``match={'point': 'rename'}`` for one fsync point of the checkpoint
    commit).  ``duration`` is the stall length for ``kind='stall'``;
    ``value`` the poison for ``kind='nan'``; ``max_fires`` caps total
    firings (default: ``at`` entries fire once per listed hit, ``rate``
    entries fire unboundedly).
    """

    site: str
    kind: str
    at: int | tuple[int, ...] | None = None
    rate: float = 0.0
    duration: float = 0.0
    value: float = float("nan")
    match: dict | None = None
    max_fires: int | None = None

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown site {self.site!r}; sites: {SITES}")
        if self.kind not in KINDS:
            raise ValueError(f"unknown kind {self.kind!r}; kinds: {KINDS}")
        if isinstance(self.at, int):
            self.at = (self.at,)
        if self.at is None and self.rate <= 0.0:
            raise ValueError("fault needs at= (hit numbers) or rate= > 0")


class FaultPlan:
    """A seed plus a schedule of :class:`Fault` entries.

    Thread-safe (the serve worker fires from its own thread).  The
    per-fault random streams are seeded from ``(seed, index, site, kind)``
    as a string, the site by its reference name — :class:`random.Random`
    hashes strings deterministically (SHA-512 seeding), so the same plan
    reproduces the same decisions across processes regardless of
    ``PYTHONHASHSEED``, and the same decisions as the reference's plan.
    """

    def __init__(self, seed: int = 0, faults: tuple[Fault, ...] = ()):
        self.seed = int(seed)
        self.faults: list[Fault] = list(faults)
        self._lock = threading.Lock()
        self.reset()

    def add(self, site: str, kind: str, **kw: Any) -> "FaultPlan":
        """Append a fault to the schedule (chainable)."""
        with self._lock:
            self.faults.append(Fault(site, kind, **kw))
            self._rngs = None  # lazily rebuilt: streams depend on index
        return self

    def reset(self) -> "FaultPlan":
        """Zero the hit counters, firing counts, and log; reseed the
        per-fault random streams — replaying the same site-hit sequence
        after ``reset`` fires the identical fault sequence."""
        with self._lock:
            self.hits: dict[str, int] = {}
            self._fires: dict[int, int] = {}
            self._rngs: list[random.Random] | None = None
            self.log: list[tuple[str, str, int, dict]] = []
        return self

    def _streams(self) -> list[random.Random]:
        # lock-held helper: every caller (fire) already owns self._lock
        if self._rngs is None:
            self._rngs = [  # concurrency: ok — caller holds self._lock
                random.Random(
                    f"{self.seed}:{i}:{_REFERENCE_NAME[f.site]}:{f.kind}")
                for i, f in enumerate(self.faults)
            ]
        return self._rngs

    # -- the hook ----------------------------------------------------------
    def fire(self, site: str, **ctx: Any):
        """Register one hit of ``site`` and act on the first matching
        scheduled fault: raising kinds raise, ``stall`` sleeps, ``nan``
        returns the :class:`Fault` for the site to apply.  Returns
        ``None`` when nothing fires."""
        if site not in SITES:
            raise ValueError(f"unknown site {site!r}; sites: {SITES}")
        with self._lock:
            hit = self.hits.get(site, 0) + 1
            self.hits[site] = hit
            chosen: Fault | None = None
            streams = self._streams()
            for i, f in enumerate(self.faults):
                if f.site != site:
                    continue
                # draw *every* hit for rate faults, even after one was
                # chosen — the stream position must depend only on the
                # hit sequence, never on which fault acted
                p = streams[i].random() if f.rate > 0.0 else 1.0
                if chosen is not None:
                    continue
                if f.match and any(
                    ctx.get(k) != v for k, v in f.match.items()
                ):
                    continue
                fired = self._fires.get(i, 0)
                if f.max_fires is not None and fired >= f.max_fires:
                    continue
                want = (f.at is not None and hit in f.at) or (
                    f.rate > 0.0 and p < f.rate
                )
                if want:
                    chosen = f
                    self._fires[i] = fired + 1
                    self.log.append((site, f.kind, hit, dict(ctx)))
        if chosen is None:
            return None
        return _act(chosen, site, hit)

    def fired(self) -> list[tuple[str, str, int]]:
        """The fault sequence so far, without the contexts — the
        compact form for same-seed reproducibility assertions."""
        with self._lock:
            return [(s, k, h) for s, k, h, _ in self.log]


def _act(fault: Fault, site: str, hit: int):
    msg = f"injected {fault.kind} at {site} (hit {hit})"
    if fault.kind == "crash":
        raise InjectedCrash(msg)
    if fault.kind == "io_error":
        raise InjectedIOError(msg)
    if fault.kind == "transient":
        raise TransientError(msg)
    if fault.kind == "backend_error":
        raise BackendError(msg)
    if fault.kind == "worker_death":
        raise WorkerDeath(msg)
    if fault.kind == "stall":
        time.sleep(fault.duration)
        return fault
    return fault  # 'nan': the site applies fault.value itself


# ---------------------------------------------------------------------------
# global installation — the zero-overhead production hook
# ---------------------------------------------------------------------------

_ACTIVE: FaultPlan | None = None
_INSTALL_LOCK = threading.Lock()


def install(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` as the process-wide active fault plan."""
    global _ACTIVE
    with _INSTALL_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError("a FaultPlan is already installed")
        _ACTIVE = plan
    return plan


def uninstall() -> None:
    """Remove the active fault plan (idempotent)."""
    global _ACTIVE
    with _INSTALL_LOCK:
        _ACTIVE = None


def active() -> FaultPlan | None:
    """The installed plan, or None."""
    return _ACTIVE


@contextlib.contextmanager
def injected(plan: FaultPlan):
    """``with injected(plan):`` — install for the block, always remove."""
    install(plan)
    try:
        yield plan
    finally:
        uninstall()


def fire(site: str, **ctx: Any):
    """The production hook: no-op (one global load) without a plan.

    With a plan installed, delegates to :meth:`FaultPlan.fire` — which
    may raise, stall, or return a ``nan`` :class:`Fault` for the call
    site to apply.
    """
    plan = _ACTIVE
    if plan is None:
        return None
    return plan.fire(site, **ctx)
