"""Serving-path error taxonomy — what the hardened engine does per class
(counterpart of ``repro.serve.errors``).

The engine's recovery policy is typed, not heuristic: each exception
class coming out of a bucket compute maps to exactly one behaviour.

=====================  ====================================================
class                  engine behaviour
=====================  ====================================================
``TRANSIENT`` types    bounded retry with exponential backoff
                       (``OSError`` / ``TimeoutError`` /
                       :class:`repro_torch.runtime.chaos.TransientError`)
``BackendError``       kernel→torch graceful degradation: the plan is
                       recreated with ``backend='torch'`` and the bucket
                       re-executed once; the result is marked
                       ``degraded=True``
``WorkerDeath``        escapes the per-bucket isolation (it is a
                       ``BaseException``), unwinds the worker thread;
                       the dying worker requeues its unfinished work and
                       spawns its own supervised replacement
``DeadlineExceeded``   set on a request's future when its ``deadline_s``
                       elapsed before compute started — fail fast, the
                       rest of the bucket is unaffected
``QueueFull``          raised to the *submitter* under the ``'reject'``
                       backpressure policy when the bounded queue is full
anything else          permanent: fails the bucket's futures, never the
                       engine (fault isolation)
=====================  ====================================================
"""

from __future__ import annotations

from repro_torch.runtime.chaos import BackendError, TransientError, WorkerDeath


class DeadlineExceeded(TimeoutError):
    """The request's ``deadline_s`` elapsed before its bucket ran."""


class QueueFull(RuntimeError):
    """Bounded-queue backpressure under ``backpressure='reject'``."""


#: Exception classes the bounded-retry path treats as transient.  Note
#: :class:`DeadlineExceeded` is a ``TimeoutError`` but is raised onto
#: futures, never out of a bucket compute, so it cannot re-enter here.
TRANSIENT = (TransientError, OSError, TimeoutError)

__all__ = [
    "TRANSIENT",
    "BackendError",
    "DeadlineExceeded",
    "QueueFull",
    "TransientError",
    "WorkerDeath",
]
