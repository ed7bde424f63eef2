"""The solve-serving engine: bounded queue + background compute thread,
hardened against the failures a serving fleet actually meets (counterpart
of ``repro.serve.engine``).

The shape is the ``OfflineInference`` pattern from MaxText's MLPerf
harness: callers enqueue work onto a *bounded* queue from their own
threads (ingestion), while one background worker drains the queue in
batches and drives the card (compute) — so host-side request handling
overlaps device execution instead of serialising with it.  Here the unit
of device work is a *bucket* (requests sharing shape/dtype/operator/
bc/mode/alpha/steps — see :mod:`repro_torch.serve.batching`) and the
expensive per-class state is a plan held warm in a destroy-on-evict LRU
(:class:`repro_torch.serve.PlanLRU`).

The engine runs on ``device`` (the card unless the caller asks for the
CPU).  Its worker thread enters ``torch.cuda.device(device)`` before its
first bucket and works on that device's current stream; a CUDA field
handed in from a caller's thread is ordered after the caller's stream by
an event recorded at submit.

On top of fault isolation (a poisoned bucket fails its own futures,
never the engine), the resilient serve path adds:

- **per-request deadlines** — ``SolveRequest.deadline_s``; an expired
  request fails fast with :class:`~repro_torch.serve.errors.DeadlineExceeded`
  and never occupies a batch slot, without touching its bucket-mates;
- **bounded retry** — transient bucket failures (``OSError`` /
  ``TimeoutError`` / :class:`~repro_torch.runtime.chaos.TransientError`)
  are retried up to ``max_retries`` times with exponential backoff;
- **kernel→torch graceful degradation** — a kernel failure
  (:class:`~repro_torch.runtime.chaos.BackendError`, injected at the
  ``'kernel.dispatch'`` or ``'serve.bucket_compute'`` chaos site or
  raised for real) recreates the bucket's plan with ``backend='torch'``
  and re-executes; the downgrade is sticky per plan class, recorded on
  every affected :class:`~repro_torch.serve.request.SolveResult`
  (``degraded=True``) and in ``stats()['degraded']``.  Nothing else
  falls back: a failed build or launch outside this path raises;
- **backpressure policy** — ``backpressure='block'`` (default: a full
  queue blocks submitters, the MaxText idiom) or ``'reject'`` (a full
  queue raises :class:`~repro_torch.serve.errors.QueueFull` immediately —
  shed load instead of propagating latency);
- **supervised worker restart** — a dying worker thread requeues its
  unfinished work and spawns its own replacement; nothing submitted is
  lost, and ``stats()['worker_restarts']`` counts the deaths.

Lifecycle::

    engine = ServeEngine(plan_capacity=8, max_batch=32)   # on the card
    futs = [engine.submit(req) for req in requests]      # caller thread(s)
    results = [f.result() for f in futs]                 # SolveResult each
    engine.close()                                       # drain, join, destroy

or, as a context manager / one call::

    with ServeEngine(device="cpu") as engine:
        results = engine.solve_many(requests)

>>> import numpy as np
>>> from repro_torch.serve import ServeEngine, SolveRequest
>>> with ServeEngine(device="cpu") as engine:
...     reqs = [SolveRequest(field=np.ones((8, 8)), operator="laplacian")
...             for _ in range(4)]
...     results = engine.solve_many(reqs)
...     stats = engine.stats()
>>> [tuple(r.out.shape) for r in results] == [(8, 8)] * 4
True
>>> stats["completed"], stats["plan_lru"]["misses"]
(4, 1)
>>> stats["retries"], stats["degraded"], stats["worker_restarts"]
(0, 0, 0)
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future

import torch

from repro_torch.runtime import chaos as _chaos
from repro_torch.serve import batching as _batching
from repro_torch.serve.errors import (
    TRANSIENT,
    BackendError,
    DeadlineExceeded,
    QueueFull,
    WorkerDeath,
)
from repro_torch.serve.lru import PlanLRU
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.request import SolveRequest, SolveResult, validate_request
from repro_torch.util import refuse_unported, resolve_device

_SENTINEL = None  # queue poison pill; FIFO order guarantees full drain first

_BACKPRESSURE = ("block", "reject")


class ServeEngine:
    """Batched solve-request engine with plan-LRU multiplexing.

    ``plan_capacity`` bounds the warm-plan LRU; ``max_batch`` bounds how
    many queued requests one drain may fuse; ``queue_depth`` bounds the
    ingestion queue; ``batch_window_s`` optionally lingers after the
    first request of a drain to let a sparse stream accumulate into
    fuller batches; ``backend`` (``'auto'|'cuda'|'torch'``) and ``tune``
    pass through to the Create of every plan the LRU misses on, on
    ``device`` (the card unless the caller asks for the CPU).

    Resilience knobs: ``backpressure`` picks what a full queue does to
    submitters (``'block'`` or ``'reject'``); ``max_retries`` bounds the
    transient-failure retries per bucket attempt sequence;
    ``retry_backoff_s`` is the initial backoff (doubled per retry);
    ``degrade=False`` disables the kernel→torch degradation on a
    :class:`BackendError` (fail instead).
    """

    def __init__(
        self,
        *,
        plan_capacity: int = 8,
        max_batch: int = 32,
        queue_depth: int = 256,
        batch_window_s: float = 0.0,
        backend: str = "auto",
        tune: str = "off",
        backpressure: str = "block",
        max_retries: int = 2,
        retry_backoff_s: float = 0.01,
        degrade: bool = True,
        device="cuda",
    ):
        refuse_unported(tune=tune)
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if backpressure not in _BACKPRESSURE:
            raise ValueError(
                f"backpressure must be one of {_BACKPRESSURE}, "
                f"got {backpressure!r}"
            )
        if max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {max_retries}")
        self.max_batch = max_batch
        self.batch_window_s = float(batch_window_s)
        self.backend = backend
        self.tune = tune
        self.backpressure = backpressure
        self.max_retries = max_retries
        self.retry_backoff_s = float(retry_backoff_s)
        self.degrade = degrade
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.plans = PlanLRU(plan_capacity)
        self.metrics = ServeMetrics()
        self._queue: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._worker: threading.Thread | None = None
        self._closed = False
        self._lock = threading.Lock()
        # plan classes (by non-degraded LRU key) that hit a kernel
        # failure: sticky — subsequent buckets go straight to torch
        self._degraded_keys: set[str] = set()

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "ServeEngine":
        """Start the background compute thread (idempotent; ``submit``
        auto-starts)."""
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed; create a new one")
            if self._worker is None:
                self._worker = self._spawn_worker()
        return self

    def _spawn_worker(self) -> threading.Thread:
        t = threading.Thread(
            target=self._run, name="repro-torch-serve-worker", daemon=True
        )
        t.start()
        return t

    def close(self) -> None:
        """Drain every queued request, join the worker, destroy the warm
        plans.  Idempotent; the engine is unusable afterwards.  Robust
        to worker deaths racing the close: each live worker generation
        gets its own sentinel until none survives."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        while True:
            with self._lock:
                worker = self._worker
            if worker is None:
                break
            if worker.is_alive():
                self._queue.put(_SENTINEL)
                worker.join()
            with self._lock:
                # a death during the join respawned a replacement; loop
                # and drain that generation too
                if self._worker is worker:
                    self._worker = None
        self.plans.clear(destroy=True)

    def __enter__(self) -> "ServeEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- ingestion (caller threads) ---------------------------------------

    def submit(self, request: SolveRequest) -> Future:
        """Validate and enqueue one request; returns a Future resolving
        to a :class:`SolveResult`.

        Malformed requests raise ``ValueError`` here, on the caller's
        thread — they never occupy queue space.  A full queue blocks
        under ``backpressure='block'`` (the MaxText idiom) and raises
        :class:`QueueFull` under ``'reject'`` (shed load at the edge
        instead of growing caller latency).  A CUDA field is ordered after
        the work the caller's current stream has queued (an event the
        worker's stream waits on)."""
        if self._closed:
            raise RuntimeError("engine is closed; create a new one")
        validate_request(request)
        self.start()
        fut: Future = Future()
        ready = None
        field = request.field
        if isinstance(field, torch.Tensor) and field.is_cuda:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(field.device))
        item = (request, fut, time.perf_counter(), ready)
        if self.backpressure == "reject":
            try:
                self._queue.put_nowait(item)
            except queue.Full:
                self.metrics.on_reject()
                raise QueueFull(
                    f"queue full ({self._queue.maxsize} pending) under "
                    "backpressure='reject'"
                ) from None
        else:
            self._queue.put(item)
        self.metrics.on_submit()
        return fut

    def solve(self, request: SolveRequest) -> SolveResult:
        """Submit one request and wait for its result."""
        return self.submit(request).result()

    def solve_many(self, requests) -> list[SolveResult]:
        """Submit a whole stream and wait; results in request order.

        Submission overlaps compute: the worker starts batching as soon
        as the first request lands, while this thread is still feeding
        the queue."""
        futures = [self.submit(r) for r in requests]
        return [f.result() for f in futures]

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        """Engine counters + latency percentiles + plan-LRU stats."""
        snap = self.metrics.snapshot()
        snap["plan_lru"] = self.plans.stats()
        snap["degraded_classes"] = len(self._degraded_keys)
        return snap

    # -- the worker (background thread) ------------------------------------

    def _run(self) -> None:
        ctx = (torch.cuda.device(self.device) if self.device.type == "cuda"
               else contextlib.nullcontext())
        with ctx:
            self._serve()

    def _serve(self) -> None:
        while True:
            item = self._queue.get()
            if item is _SENTINEL:
                return
            batch = [item]
            deadline = time.perf_counter() + self.batch_window_s
            stop = False
            while len(batch) < self.max_batch:
                try:
                    if self.batch_window_s > 0.0:
                        remaining = deadline - time.perf_counter()
                        nxt = self._queue.get(timeout=max(remaining, 0.0))
                    else:
                        nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is _SENTINEL:
                    stop = True
                    break
                batch.append(nxt)
            try:
                self._process(batch)
            except WorkerDeath:
                self._on_worker_death(batch, stop)
                return
            if stop:
                return

    def _on_worker_death(self, batch, stop: bool) -> None:
        """Supervised restart: the dying worker hands over.

        Spawn the replacement *first* (so requeued work has a consumer
        even if the queue is at capacity), then requeue every request of
        the current batch whose future is still unresolved, preserving a
        pending close()'s sentinel if this worker had consumed it."""
        with self._lock:
            self.metrics.on_worker_restart()
            self._worker = self._spawn_worker()
        for it in batch:
            if not it[1].done():
                self._queue.put(it)
        if stop:
            self._queue.put(_SENTINEL)

    def _process(self, batch) -> None:
        for key, items in _batching.bucketize(batch).items():
            del key
            self._process_bucket(items)

    def _expire(self, items, now: float) -> list:
        """Fail the deadline-expired items fast; return the live rest."""
        live = []
        for it in items:
            req, fut, t0, _ = it
            if (
                req.deadline_s is not None
                and now - t0 > req.deadline_s
                and not fut.done()
            ):
                fut.set_exception(
                    DeadlineExceeded(
                        f"deadline_s={req.deadline_s} elapsed after "
                        f"{now - t0:.3f}s in queue (tag={req.tag!r})"
                    )
                )
                self.metrics.on_deadline()
            else:
                live.append(it)
        return live

    def _process_bucket(self, items) -> None:
        attempts = 0
        retries = 0
        degraded = False
        while True:
            # deadline cull per attempt: backoff sleeps must not let an
            # expired request consume a batch slot on the retry
            items = self._expire(items, time.perf_counter())
            if not items:
                return
            reqs = [it[0] for it in items]
            futs = [it[1] for it in items]
            attempts += 1
            try:
                kind, base_key, _ = _batching.plan_spec(
                    reqs[0], backend=self.backend
                )
                degraded = degraded or base_key in self._degraded_keys
                backend = "torch" if degraded else self.backend
                _, plan_key, _ = _batching.plan_spec(reqs[0], backend=backend)
                # the chaos hook: injected transient/io faults exercise
                # the retry path, backend_error the degradation path,
                # worker_death the supervised-restart path, stall the
                # latency/deadline path
                _chaos.fire(
                    "serve.bucket_compute",
                    operator=reqs[0].operator,
                    kind=kind,
                    attempt=attempts,
                    degraded=degraded,
                )
                plan, hit = self.plans.get_or_create(
                    plan_key,
                    lambda r=reqs[0], b=backend: _batching.create_plan(
                        r, backend=b, tune=self.tune, device=self.device
                    ),
                )
                self._after_callers(items)
                outs = _batching.execute_bucket(
                    plan,
                    kind,
                    [r.field for r in reqs],
                    reqs[0].steps,
                    dtype=reqs[0].resolved_dtype(),
                    device=self.device,
                    max_batch=self.max_batch,
                )
                break
            except WorkerDeath:
                raise  # not a bucket failure: unwind the thread itself
            except BackendError:
                if degraded or not self.degrade:
                    self._fail_bucket(futs, BackendError(
                        "kernel failure persisted after torch degradation"
                        if degraded else "kernel failure (degrade=False)"
                    ))
                    return
                # the plan that failed is suspect: drop it so nothing
                # serves from it again, then go straight to torch — and
                # stay there for this plan class (sticky degradation)
                self.plans.drop(plan_key)
                self._degraded_keys.add(base_key)
                degraded = True
                continue
            except TRANSIENT as exc:
                if retries >= self.max_retries:
                    self._fail_bucket(futs, exc)
                    return
                retries += 1
                self.metrics.on_retry()
                time.sleep(self.retry_backoff_s * (2 ** (retries - 1)))
                continue
            except Exception as exc:  # noqa: BLE001 — fault isolation:
                # one poisoned bucket fails its own futures, never the
                # engine thread (subsequent buckets keep serving)
                self._fail_bucket(futs, exc)
                return

        if degraded:
            self.metrics.on_degrade(len(items))
        self.metrics.on_batch(len(items))
        now = time.perf_counter()
        for (req, fut, t0, _), out in zip(items, outs, strict=True):
            latency = now - t0
            self.metrics.record_latency(latency)
            fut.set_result(
                SolveResult(
                    out=out,
                    request=req,
                    latency_s=latency,
                    batch_size=len(items),
                    plan_hit=hit,
                    attempts=attempts,
                    degraded=degraded,
                )
            )
        self.metrics.on_complete(len(items))

    def _after_callers(self, items) -> None:
        """Order the worker's stream after each CUDA field's submit."""
        for it in items:
            if it[3] is not None:
                torch.cuda.current_stream(self.device).wait_event(it[3])

    def _fail_bucket(self, futs, exc: BaseException) -> None:
        for fut in futs:
            fut.set_exception(exc)
        self.metrics.on_fail(len(futs))
