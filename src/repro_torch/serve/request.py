"""Solve request / result types of the serving engine (counterpart of
``repro.serve.request``).

A :class:`SolveRequest` is one independent solve: a field, a registered
operator name, boundary condition, an optional implicit-``'adi'`` mode
with its ``alpha``, a step count, and a dtype.  Requests carry everything
the engine needs to (a) key the warm-plan LRU
(:func:`repro_torch.api.plan_key`) and (b) decide which batching family
the request rides (:mod:`repro_torch.serve.batching`): rank-1 fields stack
into the batched-1D plans (the cuPentBatch model), rank-2 stencil requests
stack into one ``stencil2d`` launch, rank-3 stencil and ADI requests
multiplex a warm plan.

The field may be a numpy array or a torch tensor, on the host or on a
card; the engine moves it to its own device.

>>> import numpy as np
>>> req = SolveRequest(field=np.ones((16, 16)), operator="laplacian")
>>> req.shape
(16, 16)
>>> req.steps
1
>>> req.resolved_dtype()
torch.float64
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import api as _api
from repro_torch.util import torch_dtype

_BCS = ("periodic", "np")


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One independent solve: ``(field, operator, bc, alpha, steps, dtype)``.

    ``field`` is the input — rank 1 (a line, ridden on the batched-1D
    family), rank 2, or rank 3; a numpy array or a torch tensor (CPU or
    CUDA).  ``operator`` is a registered operator name
    (:func:`repro_torch.get_operator`).  ``mode=None`` requests the
    explicit stencil apply; ``mode='adi'`` the implicit ADI solve
    (``alpha`` required).  ``steps`` repeats the Compute that many times,
    feeding each output back in (the double-buffer time loop).  ``dtype``
    defaults to the field's own dtype.  ``tag`` is an opaque caller
    correlation id, returned untouched on the result.  ``deadline_s``
    (optional) bounds submit-to-compute wall time: a request still
    queued when its deadline elapses fails fast with
    :class:`repro_torch.serve.errors.DeadlineExceeded` instead of
    occupying a batch slot — without affecting the rest of its bucket.
    """

    field: Any
    operator: str
    bc: str = "periodic"
    mode: str | None = None
    alpha: float | None = None
    steps: int = 1
    dtype: Any = None
    tag: Any = None
    deadline_s: float | None = None

    @property
    def shape(self) -> tuple[int, ...]:
        """The logical per-request field shape."""
        shape = getattr(self.field, "shape", None)
        if shape is None:
            shape = np.shape(self.field)
        return tuple(int(s) for s in shape)

    def resolved_dtype(self) -> torch.dtype:
        """The request's torch dtype: explicit ``dtype=`` or the field's own
        (float32, float64, bfloat16 or float16; anything else raises
        ``ValueError``)."""
        dtype = self.dtype
        if dtype is None:
            dtype = getattr(self.field, "dtype", None)  # fast path: arrays
        if dtype is None:
            dtype = np.result_type(np.asarray(self.field))
        dt = torch_dtype(dtype)
        if not dt.is_floating_point:
            raise ValueError(f"a request's dtype is a float type, got {dt}")
        return dt


@dataclasses.dataclass
class SolveResult:
    """The engine's answer to one :class:`SolveRequest`.

    ``out`` is the solved field (same shape as the request's), delivered
    as a **host** tensor — results cross the serving boundary, and one
    download of a bucket's stacked output beats one per request (see
    :func:`repro_torch.serve.batching.execute_bucket`); ``latency_s`` is
    submit-to-result wall time, ``batch_size`` the number of requests that
    shared the bucket, ``plan_hit`` whether the plan came warm out of the
    LRU.

    Resilience metadata: ``attempts`` counts compute attempts for the
    request's bucket (>1 means the transient-retry path fired);
    ``degraded`` is True when a kernel failure (a
    :class:`~repro_torch.runtime.chaos.BackendError`, injected or real)
    forced the bucket onto a freshly created ``backend='torch'`` plan —
    the answer is still correct, it just did not run on the port's CUDA
    kernels, and the engine's ``stats()['degraded']`` counts how often
    that happened.
    """

    out: Any
    request: SolveRequest
    latency_s: float = 0.0
    batch_size: int = 1
    plan_hit: bool = False
    attempts: int = 1
    degraded: bool = False

    @property
    def tag(self):
        return self.request.tag


def validate_request(req: SolveRequest) -> None:
    """Reject malformed requests *at submit time*, on the caller's thread.

    A bad request must never poison a batch: unknown operators, bad
    ranks, unsupported dtypes, mode/operator mismatches, and missing
    ``alpha`` all raise ``ValueError`` here, before the request reaches
    the queue.

    >>> validate_request(SolveRequest(field=np.ones((8, 8)), operator="laplacian"))
    >>> validate_request(SolveRequest(field=np.ones((8, 8)), operator="laplacian", mode="adi"))
    Traceback (most recent call last):
        ...
    ValueError: mode='adi' needs alpha= ...
    """
    opdef = _api.get_operator(req.operator)  # raises on unknown names
    if req.bc not in _BCS:
        raise ValueError(f"bc must be one of {_BCS}, got {req.bc!r}")
    rank = len(req.shape)
    if rank not in (1, 2, 3):
        raise ValueError(
            f"request field must be rank 1, 2 or 3, got shape {req.shape}"
        )
    req.resolved_dtype()  # raises on a dtype the plans do not take
    if not isinstance(req.steps, int) or req.steps < 1:
        raise ValueError(f"steps must be a positive int, got {req.steps!r}")
    if req.deadline_s is not None and not req.deadline_s > 0:
        raise ValueError(
            f"deadline_s must be positive (seconds), got {req.deadline_s!r}"
        )
    if req.mode not in (None, "adi"):
        raise ValueError(
            f"request mode must be None (stencil) or 'adi', got {req.mode!r}"
        )
    if req.mode == "adi":
        if req.alpha is None:
            raise ValueError(
                "mode='adi' needs alpha= (the implicit band coefficient)"
            )
        if rank == 1:
            raise ValueError(
                "mode='adi' needs a rank-2 or rank-3 field (the ADI solve "
                "sweeps at least two directions)"
            )
        if opdef.diagonals is None:
            raise ValueError(
                f"operator {req.operator!r} defines no implicit bands; "
                "registered band-building operators: "
                f"{[n for n in _api.operator_names() if _api.get_operator(n).diagonals]}"
            )
    else:
        if req.alpha is not None:
            raise ValueError("alpha= only applies to mode='adi' requests")
        if opdef.weights is None:
            raise ValueError(
                f"operator {req.operator!r} defines no stencil weights "
                "(band-only); request mode='adi' with alpha="
            )
