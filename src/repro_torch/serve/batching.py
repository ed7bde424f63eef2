"""Bucketing policy: which requests share one kernel launch, and how
(counterpart of ``repro.serve.batching``).

Batching many independent solves into one launch is the cuPentBatch
thesis (PAPERS.md, arXiv 1807.07382).  This module is the policy layer
that maps a drained batch of :class:`~repro_torch.serve.request.SolveRequest`
onto the port's kernels:

- **bucket key** — requests sharing ``(shape, dtype, operator, bc,
  mode, alpha, steps)`` land in one bucket; a bucket is the unit of
  dispatch.
- **rank-1 requests** (``kind='batch1d'``) stack into a ``(B, M)`` field
  and ride one :class:`~repro_torch.core.stencil.StencilBatch1D` plan —
  one ``stencil1d_batch`` launch a step, bit-identical per row to a
  sequential ``(1, M)`` solve (the kernel never mixes rows).
- **rank-2 stencil requests** (``kind='stencil'``) stack into one
  contiguous ``(B, ny, nx)`` tensor and run
  :meth:`~repro_torch.core.stencil.Stencil2D.apply_stacked`: one
  ``stencil2d`` launch a step for the whole bucket, the counterpart of
  the reference's ``jax.vmap`` of Compute, bit-identical per member (the
  kernel's tile geometry does not depend on the stack).
- **rank-3 stencil requests** run member by member, one ``stencil3d``
  launch each a step (the 3D kernel has no batch extent yet:
  ROADMAP.md, Open items: Rank-3 serve buckets).
- **ADI requests** (``kind='adi'``) are *plan-multiplexed, not stacked*,
  as in the reference: they reuse one warm LRU plan (skipping the
  per-request factorisation) and run member by member, exactly the
  sequential arithmetic (``penta_rows`` and ``penta_cols`` a member a
  step in 2D).

Stacking happens once per bucket: on the card when every field already
lies there (device to device, on the worker's stream), else on the host
with one upload.  Results come back as host tensors: one download of the
bucket's stacked output, then views.

Batch-shape quantisation: stacked buckets are zero-padded up to the next
power of two (capped at the engine's ``max_batch``), as the reference's
are; padding rows are dropped after the launch, and because every
batching family treats members independently, padding cannot perturb
real rows.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from repro_torch import api as _api
from repro_torch.serve.request import SolveRequest

BATCH1D = "batch1d"
STENCIL = "stencil"
ADI = "adi"


def classify(req: SolveRequest) -> str:
    """The batching family a request rides: batch1d | stencil | adi."""
    if req.mode == "adi":
        return ADI
    if len(req.shape) == 1:
        return BATCH1D
    return STENCIL


def bucket_key(req: SolveRequest) -> tuple:
    """Requests with equal keys share one plan *and* one dispatch."""
    return (
        req.operator,
        req.shape,
        str(req.resolved_dtype()),
        req.bc,
        req.mode or "stencil",
        None if req.alpha is None else float(req.alpha),
        int(req.steps),
    )


def bucketize(requests) -> "OrderedDict[tuple, list]":
    """Group a drained batch into buckets, preserving arrival order both
    across buckets (first-seen order) and within each bucket."""
    buckets: OrderedDict[tuple, list] = OrderedDict()
    for item in requests:
        req = item[0] if isinstance(item, tuple) else item
        buckets.setdefault(bucket_key(req), []).append(item)
    return buckets


def plan_spec(req: SolveRequest, *, backend: str = "auto") -> tuple[str, str, dict]:
    """``(kind, key, create_kwargs)`` — how to key and build the plan.

    ``key`` is :func:`repro_torch.api.plan_key` over the *logical* request
    shape (the reference's key); ``create_kwargs`` are the arguments a
    cache miss passes to :func:`repro_torch.create` (the engine adds its
    device).  Rank-1 requests create their :class:`StencilBatch1D` plan
    with a ``(1, M)`` placeholder shape — batched-1D plans are
    batch-size-agnostic, so one plan serves every stacked ``(B, M)``.
    """
    kind = classify(req)
    dtype = req.resolved_dtype()
    mode: str | None
    if kind == BATCH1D:
        shape: tuple = (1,) + req.shape
        mode = "batch"
    else:
        shape = req.shape
        mode = req.mode
    key = _api.plan_key(
        req.operator,
        req.shape,
        dtype=dtype,
        bc=req.bc,
        mode=mode,
        alpha=req.alpha,
        extra={"backend": backend},
    )
    kwargs = dict(shape=shape, bc=req.bc, dtype=dtype, backend=backend)
    if kind == ADI:
        kwargs.update(mode="adi", alpha=req.alpha)
    elif kind == BATCH1D:
        kwargs.update(mode="batch")
    return kind, key, kwargs


def create_plan(req: SolveRequest, *, backend: str = "auto", tune: str = "off",
                device="cuda"):
    """Create the plan for one request class on ``device`` (the LRU-miss
    factory)."""
    _, _, kwargs = plan_spec(req, backend=backend)
    shape = kwargs.pop("shape")
    return _api.create(req.operator, shape, tune=tune, device=device, **kwargs)


def quantize_batch(b: int, max_batch: int) -> int:
    """Round a bucket size up to the next power of two, capped at
    ``max_batch`` — the batch-shape quantisation of the reference, which
    bounds how many stacked shapes ragged traffic produces.

    >>> [quantize_batch(b, 16) for b in (1, 2, 3, 5, 9, 16)]
    [1, 2, 4, 8, 16, 16]
    """
    p = 1
    while p < b:
        p *= 2
    return min(p, max_batch) if b <= max_batch else b


def stack_fields(fields, dtype: torch.dtype, device: torch.device,
                 padded: int) -> torch.Tensor:
    """The ``(padded, *shape)`` stack of ``fields`` on ``device`` in
    ``dtype``, zero rows after the last field: built on the card, device
    to device, when every field already lies on ``device``; else on the
    host and uploaded once."""
    b = len(fields)
    if all(isinstance(f, torch.Tensor) and f.device == device for f in fields):
        stack = torch.stack([f.to(dtype) for f in fields])
        if padded > b:
            stack = torch.cat(
                [stack, stack.new_zeros((padded - b,) + stack.shape[1:])])
        return stack
    first = torch.as_tensor(fields[0])
    host = torch.zeros((padded,) + tuple(first.shape), dtype=dtype)
    for i, f in enumerate(fields):
        host[i].copy_(torch.as_tensor(f))
    return host.to(device)


def execute_bucket(plan, kind: str, fields, steps: int, *, dtype, device,
                   max_batch: int = 64) -> list[torch.Tensor]:
    """Solve one bucket on ``device`` in ``dtype``; returns per-request
    outputs in input order, as **host** tensors (views of one download of
    the bucket's stacked output).

    Rank-1 and rank-2 stencil buckets run stacked (zero-padded to
    :func:`quantize_batch`): one launch a step for the whole bucket.
    Rank-3 stencil and ADI buckets run member by member on the shared
    warm plan (see the module docstring).
    """
    device = torch.device(device)
    b = len(fields)
    rank = fields[0].ndim if hasattr(fields[0], "ndim") else np.ndim(fields[0])
    stacked = kind == BATCH1D or (kind == STENCIL and rank == 2)
    stack = stack_fields(fields, dtype, device,
                         quantize_batch(b, max_batch) if stacked else b)
    if stacked:
        run = plan.apply if kind == BATCH1D else plan.apply_stacked
        for _ in range(steps):
            stack = run(stack)
    else:
        outs = []
        for i in range(b):
            out = stack[i]
            for _ in range(steps):
                out = _api.compute(plan, out)
            outs.append(out)
        stack = torch.stack(outs)
    return list(stack[:b].cpu().unbind(0))
