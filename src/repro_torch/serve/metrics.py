"""Serving metrics: counters + a latency recorder with percentiles
(counterpart of ``repro.serve.metrics``; the same ``snapshot()`` keys).

Deliberately dependency-free (no numpy import on the hot path): the
worker thread records a float per completed request and a handful of
integer counters per batch; percentile math happens only when a snapshot
is asked for.

>>> m = ServeMetrics()
>>> for ms in (1.0, 2.0, 3.0, 4.0):
...     m.record_latency(ms / 1e3)
>>> snap = m.latency_summary()
>>> snap["count"], round(snap["p50_s"] * 1e3, 1)
(4, 2.0)
"""

from __future__ import annotations

import threading

_MAX_SAMPLES = 100_000  # bound memory under sustained traffic


def percentile(sorted_samples, p: float) -> float:
    """Nearest-rank percentile of an already-sorted list (p in [0, 100]).

    >>> percentile([1.0, 2.0, 3.0, 4.0], 50)
    2.0
    >>> percentile([1.0, 2.0, 3.0, 4.0], 99)
    4.0
    """
    if not sorted_samples:
        return float("nan")
    rank = max(0, min(len(sorted_samples) - 1, int(p / 100.0 * len(sorted_samples) + 0.5) - 1))
    return sorted_samples[rank]


class ServeMetrics:
    """Thread-safe counters + latency samples for one engine."""

    def __init__(self):
        self._lock = threading.Lock()
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        self.batches = 0
        self.batched_requests = 0
        self.largest_batch = 0
        # resilience counters (the hardened-engine observability)
        self.retries = 0
        self.degraded = 0
        self.deadline_exceeded = 0
        self.rejected = 0
        self.worker_restarts = 0
        self._latencies: list[float] = []

    def reset(self) -> None:
        """Zero every counter and drop the latency samples (e.g. after a
        warm-up pass, so reports reflect steady-state serving)."""
        with self._lock:
            self.submitted = self.completed = self.failed = 0
            self.batches = self.batched_requests = self.largest_batch = 0
            self.retries = self.degraded = self.deadline_exceeded = 0
            self.rejected = self.worker_restarts = 0
            self._latencies.clear()

    def on_submit(self, n: int = 1) -> None:
        with self._lock:
            self.submitted += n

    def on_batch(self, size: int) -> None:
        with self._lock:
            self.batches += 1
            self.batched_requests += size
            self.largest_batch = max(self.largest_batch, size)

    def on_complete(self, n: int = 1) -> None:
        with self._lock:
            self.completed += n

    def on_fail(self, n: int = 1) -> None:
        with self._lock:
            self.failed += n

    def on_retry(self, n: int = 1) -> None:
        with self._lock:
            self.retries += n

    def on_degrade(self, n: int = 1) -> None:
        """``n`` requests served on the torch-degraded plan."""
        with self._lock:
            self.degraded += n

    def on_deadline(self, n: int = 1) -> None:
        with self._lock:
            self.deadline_exceeded += n
            self.failed += n

    def on_reject(self, n: int = 1) -> None:
        with self._lock:
            self.rejected += n

    def on_worker_restart(self) -> None:
        with self._lock:
            self.worker_restarts += 1

    def record_latency(self, seconds: float) -> None:
        with self._lock:
            if len(self._latencies) < _MAX_SAMPLES:
                self._latencies.append(float(seconds))

    def latency_summary(self) -> dict:
        """count / mean / p50 / p90 / p99 over the recorded latencies."""
        with self._lock:
            samples = sorted(self._latencies)
        if not samples:
            return {"count": 0}
        return {
            "count": len(samples),
            "mean_s": sum(samples) / len(samples),
            "p50_s": percentile(samples, 50),
            "p90_s": percentile(samples, 90),
            "p99_s": percentile(samples, 99),
            "max_s": samples[-1],
        }

    def snapshot(self) -> dict:
        """Every counter plus the latency summary, one dict."""
        with self._lock:
            counters = {
                "submitted": self.submitted,
                "completed": self.completed,
                "failed": self.failed,
                "batches": self.batches,
                "batched_requests": self.batched_requests,
                "largest_batch": self.largest_batch,
                "retries": self.retries,
                "degraded": self.degraded,
                "deadline_exceeded": self.deadline_exceeded,
                "rejected": self.rejected,
                "worker_restarts": self.worker_restarts,
            }
        counters["latency"] = self.latency_summary()
        return counters
