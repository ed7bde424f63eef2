"""Spans at the port's layer boundaries: where the host spends its time
inside the program, off by default.

A span is one pass of the host through one layer boundary: a chunk of
the Cahn–Hilliard driver, its RHS and its in-place update, an ADI sweep,
a plan's Compute, ``api.compute``, the diagnostics, a kernel launch, and
the distributed solver's step, bootstrap, halo exchanges, reshards and
diagnostics.  The
sites sit beside the chaos hooks (:mod:`repro_torch.runtime.chaos`) and
carry ``repro.*`` names:

===========================  ==========================================
``repro.ch.chunk``           ``make_evolve``'s chunk (field ``steps``)
``repro.ch.rhs``             the RHS: the fused x-sweep in fused mode,
                             ``CahnHilliardADI.rhs`` otherwise (``mode``)
``repro.ch.update``          the in-place update ``2 c_n - c_{n-1} + v``
``repro.adi.solve_x/_y/_z``  one sweep of an ADI operator (2D or 3D)
``repro.plan.apply``         a stencil plan's Compute (``plan``: class)
``repro.compute``            ``api.compute`` (``plan``: class)
``repro.ch.diagnostics``     ``coarsening_metrics``' function
``repro.launch``             ``kernels._build.launch``, from the chaos
                             hook to the launch counter (``kernel``)
``repro.dist.step``          one step of ``DistributedCahnHilliard``
                             (``step`` or each of ``multi_step``'s): the
                             root of a distributed step
``repro.dist.bootstrap``     ``DistributedCahnHilliard.initial_step``
``repro.dist.halo``          ``core.domain.halo_pad``: a halo exchange
``repro.dist.reshard``       one all-to-all between two layouts of the
                             distributed solver (``src``, ``dst``,
                             ``bytes_sent``: the bytes this rank sends
                             off itself)
``repro.dist.diagnostics``   the function ``DistributedCahnHilliard.
                             metrics`` returns
===========================  ==========================================

- **Off** (the default), each site costs one test of :data:`ON`: it
  allocates nothing and creates no context manager.
- **On** (:func:`enable`), each span is recorded when its block ends,
  also when the block raises: name, id, the id of this thread's enclosing
  span (``parent``), the id of the outermost one (``root``: every span of
  one chunk or one ``compute`` call shares it), start and end by
  ``time.perf_counter_ns()``, the thread and the site's fields.  Records
  stay in memory until :func:`take`; nothing goes to disk.
- **Under ``torch.profiler``**, each span also opens a profiler range of
  its name while the profiler records (``_RecordFunctionFast`` where
  this torch has it, which the trace lists as a ``cpu_op``; else
  ``record_function``, a ``user_annotation``).  The spans then sit in the
  trace on its own clock, and each device activity lies under the span
  whose host call launched it (the runtime call of the same correlation
  id).

The recorder is safe to use from several threads (the serve engine's
worker among them): each thread nests its own spans.

>>> from repro_torch.runtime import spans
>>> spans.enable()
>>> with spans.span("repro.compute", plan="Stencil2D"):
...     with spans.span("repro.plan.apply", plan="Stencil2D"):
...         pass
>>> spans.disable()
>>> [(s.name, s.parent is None) for s in spans.take()]
[('repro.plan.apply', False), ('repro.compute', True)]
>>> spans.take()
[]
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

#: The flag every site tests: True between :func:`enable` and
#: :func:`disable`.
ON = False

_lock = threading.Lock()
_records: list[Span] = []
_next_id = 1
_local = threading.local()  # .stack: this thread's open spans
_NOOP = contextlib.nullcontext()
_profiling = _range_type = None  # bound by enable(): torch loads lazily


class Span(NamedTuple):
    """One recorded span; times in ns of ``time.perf_counter_ns()``.
    ``error`` is the type name of the exception its block raised."""

    name: str
    id: int
    parent: int | None
    root: int
    start_ns: int
    end_ns: int
    thread: int
    fields: dict
    error: str | None = None

    @property
    def dur_ns(self) -> int:
        return self.end_ns - self.start_ns


def enable() -> None:
    """Record spans from now on (and mirror them into the profiler's
    trace while it records)."""
    global ON, _profiling, _range_type
    import torch

    _profiling = torch._C._autograd._profiler_enabled
    _range_type = getattr(torch._C._profiler, "_RecordFunctionFast",
                          torch.autograd.profiler.record_function)
    ON = True


def disable() -> None:
    """Stop recording: the sites go back to one flag test.  Spans still
    open close as usual and are recorded."""
    global ON
    ON = False


def take() -> list[Span]:
    """The spans recorded since the last call, in the order they ended;
    clears them."""
    global _records
    with _lock:
        out, _records = _records, []
    return out


def span(name: str, **fields):
    """A context manager that records ``name`` around its block (a no-op
    while the recorder is off).  A site tests :data:`ON` before it calls
    this, so an off site builds nothing."""
    if not ON:
        return _NOOP
    return _Open(name, fields)


def _profiler_range(name: str):
    """An entered profiler range named ``name`` while ``torch.profiler``
    records, else None."""
    if not _profiling():
        return None
    rng = _range_type(name)
    rng.__enter__()
    return rng


class _Open:
    __slots__ = ("name", "fields", "id", "parent", "root", "start", "range")

    def __init__(self, name: str, fields: dict):
        self.name = name
        self.fields = fields

    def __enter__(self):
        global _next_id
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        with _lock:
            self.id = _next_id
            _next_id += 1
        if stack:
            self.parent, self.root = stack[-1].id, stack[-1].root
        else:
            self.parent, self.root = None, self.id
        stack.append(self)
        self.range = _profiler_range(self.name)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        _local.stack.pop()
        rec = Span(self.name, self.id, self.parent, self.root, self.start, end,
                   threading.get_ident(), self.fields,
                   None if exc_type is None else exc_type.__name__)
        with _lock:
            _records.append(rec)
        return False
