"""Solver-as-a-service: batched solve requests over warm plans (counterpart
of ``repro.serve``), on the card unless the caller asks for the CPU.

- :class:`SolveRequest` / :class:`SolveResult` — the request model
  (:mod:`repro_torch.serve.request`); fields are numpy arrays or torch
  tensors, results host tensors.
- :class:`PlanLRU` — warm-plan cache with destroy-on-evict, keyed by
  :func:`repro_torch.api.plan_key` (:mod:`repro_torch.serve.lru`).
- :mod:`repro_torch.serve.batching` — the bucketing policy: rank-1
  requests stack into batched-1D plans, rank-2 stencils stack into one
  ``stencil2d`` launch, rank-3 stencils and ADI multiplex warm plans.
- :class:`ServeEngine` — bounded ingestion queue + background compute
  thread (:mod:`repro_torch.serve.engine`).
- ``python -m repro_torch.serve`` — the CLI (:mod:`repro_torch.serve.cli`).
"""

from repro_torch.serve.batching import bucket_key, classify, execute_bucket
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.errors import (
    TRANSIENT,
    BackendError,
    DeadlineExceeded,
    QueueFull,
    TransientError,
    WorkerDeath,
)
from repro_torch.serve.lru import PlanLRU
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.request import SolveRequest, SolveResult, validate_request

__all__ = [
    "TRANSIENT",
    "BackendError",
    "DeadlineExceeded",
    "PlanLRU",
    "QueueFull",
    "ServeEngine",
    "ServeMetrics",
    "SolveRequest",
    "SolveResult",
    "TransientError",
    "WorkerDeath",
    "bucket_key",
    "classify",
    "execute_bucket",
    "validate_request",
]
