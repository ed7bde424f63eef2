"""The declarative invariant rule engine over op traces, plans, callables
and measured costs (counterpart of ``repro.analysis.rules``).

cuSten's Create/Compute split means the expensive guarantees — transpose-
free ADI sweeps, fp64-stable hot paths, an evolve driver that updates its
buffers in place, launchable kernel geometries — are *Create-time
properties* of a plan.  Each rule here checks one such property on a
concrete artifact and returns structured
:class:`~repro_torch.analysis.findings.Finding` records naming the
offending op and where it sits:

============================ ======== ====================================
rule (reference's)           kind     violated when
============================ ======== ====================================
``no_transpose``             trace    the call materialises a permuted
(``no_transpose``, jaxpr)             copy (a copy, clone or ``_to_copy``
                                      of a transposed view); a view
                                      transpose is none.  With the card's
                                      profiler kernel list in the context
                                      (``kernels``), also a copy or
                                      transpose kernel there, or a list
                                      that was not read (``None``)
``no_dtype_upcast``          trace    an op outputs a wider float than one
(``no_dtype_upcast``, jaxpr)          of its floating array inputs (fp32 ->
                                      fp64 creep, or promotion by a wider
                                      operand; fp32 <-> complex64 and fp64
                                      <-> complex128 are one width)
``no_host_sync``             trace    the call synchronises with the host
(``no_host_callback``, jaxpr)         (``.item()``, ``nonzero`` on a card,
                                      a copy to the host); on a card also
                                      what ``torch.cuda.set_sync_debug_mode
                                      ("error")`` raised (``sync_error``)
``in_place_evolve``          callable the k-step driver's two buffers are
(``donation_applied``, hlo)           not the ones it returns, or it
                                      allocates field-sized memory per
                                      step beyond its increments' own
``rebuild_budget``           callable structurally identical Creates and
(``retrace_budget``)                  Computes build or load a kernel
                                      library, or race a tune key, more
                                      than ``budget`` times
``launch_geometry_feasible`` plan     the plan's halo is wider than the
(``pallas_grid_feasible``)            field, an ADI operator's bands do
                                      not match the shape, or its tuned
                                      launch geometry is one the card
                                      cannot launch for that shape
``flops_budget``             cost     measured flops exceed the family's
                                      analytic floor × calibrated factor
``bytes_budget``             cost     measured bytes exceed the floor ×
                                      factor (a transpose/copy round-trip)
``peak_memory_budget``       cost     peak live memory exceeds budget (a
                                      leaked double buffer)
``no_remat``                 cost     a ≥2-trip driver loop's *per-trip*
                                      traffic exceeds the per-step budget
                                      (a rematerialised history)
``device_time_budget``       cost     the call's device time on the card
(none: the card's reading             exceeds the floor's time on the
of the two budgets above)             H100's peaks × factor
============================ ======== ====================================

The reference's ``hlo`` kind (``check_hlo``, and ``analyze_hlo`` in its
cost module) has no counterpart: eager PyTorch compiles no HLO.

``check_trace`` / ``check_plan`` / ``check_cost`` run the rules of the
matching kind; a callable rule runs through ``RULES[name].check(fn,
context)``.  :func:`repro_torch.analysis.audit.run_audit` and
:func:`repro_torch.analysis.audit.run_cost_audit` drive all of them over
the full operator × plan-family matrix.  The cost rules read the measured
:class:`~repro_torch.analysis.cost.CostVector` and the analytic
:class:`~repro_torch.analysis.cost.Expected` floor from their context.
"""

from __future__ import annotations

import dataclasses
import re
from collections.abc import Callable

import torch

from repro_torch.analysis.findings import ERROR, Finding

__all__ = [
    "BUDGET_FACTORS",
    "RULES",
    "Rule",
    "check_cost",
    "check_plan",
    "check_trace",
    "rebuild_count",
    "rule",
]


@dataclasses.dataclass(frozen=True)
class Rule:
    """One declarative invariant.

    ``kind`` picks the artifact the rule inspects: ``'trace'`` (an op
    trace of one call, :class:`~repro_torch.analysis.trace.Trace`),
    ``'plan'`` (a plan object), ``'callable'`` (a function the check may
    call) or ``'cost'`` (a measured cost vector).  ``check`` takes
    ``(target, context_dict)`` and returns a list of findings."""

    name: str
    kind: str
    doc: str
    check: Callable


RULES: dict[str, Rule] = {}


def rule(name: str, kind: str, doc: str = ""):
    """Register a rule (decorator).  User rules compose with the built-ins:
    anything registered here takes part in ``check_*`` and the audit."""

    def deco(fn):
        RULES[name] = Rule(name=name, kind=kind, doc=doc, check=fn)
        return fn

    return deco


def _resolve(names, kind: str) -> list[Rule]:
    if names is None:
        return [r for r in RULES.values() if r.kind == kind]
    out = []
    for n in names:
        try:
            r = RULES[n]
        except KeyError:
            raise ValueError(
                f"unknown rule {n!r}; registered: {sorted(RULES)}"
            ) from None
        if r.kind != kind:
            raise ValueError(f"rule {n!r} has kind {r.kind!r}, not {kind!r}")
        out.append(r)
    return out


def _run(target, rules, kind: str, ctx: dict) -> list[Finding]:
    findings = []
    for r in _resolve(rules, kind):
        findings.extend(r.check(target, ctx))
    return findings


def check_trace(tr, rules=None, *, context=None) -> list[Finding]:
    """Run trace-kind rules (all of them by default) on an op trace."""
    return _run(tr, rules, "trace", dict(context or {}))


def check_cost(cost, rules=None, *, context=None) -> list[Finding]:
    """Run cost-kind rules on a measured
    :class:`~repro_torch.analysis.cost.CostVector`.

    ``context`` must carry ``expected`` (the family's analytical
    :class:`~repro_torch.analysis.cost.Expected` floor) and may override the
    per-metric ``factors`` and name the audited ``cell``."""
    return _run(cost, rules, "cost", dict(context or {}))


def check_plan(plan, shape, rules=None, *, context=None) -> list[Finding]:
    """Run plan-kind rules (all of them by default) on a plan object for
    fields of ``shape``."""
    ctx = dict(context or {})
    ctx.setdefault("shape", tuple(shape))
    return _run(plan, rules, "plan", ctx)


def _where(path) -> str:
    return "/".join(path) if path else "<top>"


# ---------------------------------------------------------------------------
# trace rules
# ---------------------------------------------------------------------------

# a kernel of the card's profiler list that moves a layout: torch's copy
# kernels (direct_copy_kernel_cuda and the strided copies) and any transpose
_LAYOUT_KERNEL = re.compile(r"copy|transpose", re.IGNORECASE)


@rule(
    "no_transpose",
    "trace",
    "hot paths must stay transpose-free (the ADI layout contract)",
)
def _no_transpose(tr, ctx) -> list[Finding]:
    from repro_torch.analysis.trace import iter_ops

    out = [
        Finding(
            rule="no_transpose",
            severity=ERROR,
            message=(
                f"{op.name} materialises a permuted input "
                f"{op.inputs[-1].shape if op.inputs else ()} in a path "
                "promised transpose-free"
            ),
            primitive=op.name,
            computation=_where(path),
        )
        for path, op in iter_ops(tr)
        if op.permuted_copy
    ]
    out += [
        Finding(
            rule="no_transpose",
            severity=ERROR,
            message=(
                f"device kernel {name!r} in a path promised transpose-free "
                "(the card's profiler kernel list)"
            ),
            primitive=name,
            computation="<device>",
        )
        for name in ctx.get("kernels") or ()
        if _LAYOUT_KERNEL.search(name)
    ]
    if "kernels" in ctx and ctx["kernels"] is None:
        out.append(Finding(
            rule="no_transpose",
            severity=ERROR,
            message=(
                "the card's kernel list of a path promised transpose-free "
                "was not read (no profiler window recorded its device "
                "activity): the rule cannot pass unchecked"
            ),
            primitive="torch.profiler",
            computation="<device>",
        ))
    return out


def _width(dtype: torch.dtype) -> int | None:
    """Bytes of a floating dtype's real component (complex64 is one width
    with float32); None for a non-floating dtype."""
    if dtype.is_complex:
        return dtype.itemsize // 2
    if dtype.is_floating_point:
        return dtype.itemsize
    return None


@rule(
    "no_dtype_upcast",
    "trace",
    "no op widens floating data (fp32->fp64 creep)",
)
def _no_dtype_upcast(tr, ctx) -> list[Finding]:
    """An op whose floating output is wider than one of its floating array
    inputs converts that input up, explicitly (``_to_copy``) or by type
    promotion (a complex64 spectrum times a complex128 symbol).  0-dim
    inputs, which torch's promotion treats as scalars, widen nothing."""
    from repro_torch.analysis.trace import iter_ops

    out = []
    for path, op in iter_ops(tr):
        if op.kind != "aten":
            continue
        arrays = [m for m in op.inputs
                  if m.shape and _width(m.dtype) is not None]
        if not arrays:
            continue
        old = min(arrays, key=lambda m: _width(m.dtype))
        new = max((m for m in op.outputs if _width(m.dtype) is not None),
                  key=lambda m: _width(m.dtype), default=None)
        if new is None or _width(new.dtype) <= _width(old.dtype):
            continue
        out.append(
            Finding(
                rule="no_dtype_upcast",
                severity=ERROR,
                message=(
                    f"{op.name} widens {str(old.dtype).removeprefix('torch.')}"
                    f" -> {str(new.dtype).removeprefix('torch.')} "
                    f"(shape {new.shape})"
                ),
                primitive=op.name,
                computation=_where(path),
            )
        )
    return out


@rule(
    "no_host_sync",
    "trace",
    "no host synchronisation inside a hot path",
)
def _no_host_sync(tr, ctx) -> list[Finding]:
    from repro_torch.analysis.trace import iter_ops

    out = [
        Finding(
            rule="no_host_sync",
            severity=ERROR,
            message=f"host synchronisation {op.name!r} in a hot path",
            primitive=op.name,
            computation=_where(path),
        )
        for path, op in iter_ops(tr)
        if op.host_sync
    ]
    if ctx.get("sync_error"):
        out.append(
            Finding(
                rule="no_host_sync",
                severity=ERROR,
                message=(
                    "torch.cuda.set_sync_debug_mode('error') raised: "
                    f"{ctx['sync_error']}"
                ),
                primitive="cuda_sync",
                computation="<device>",
            )
        )
    return out


# ---------------------------------------------------------------------------
# callable rules: the in-place evolve driver and the rebuild budget
# ---------------------------------------------------------------------------


def _allocated(fn, args) -> int:
    """Bytes ``fn(*args)`` allocates: on a card the allocator's cumulative
    ``allocated_bytes.all.allocated`` (it counts a reused cached block too,
    which ``memory_allocated`` does not), on the CPU the new storages of
    the call's trace.  Returns ``(bytes, result)``."""
    from repro_torch.analysis.trace import trace

    if any(isinstance(a, torch.Tensor) and a.is_cuda for a in args):
        key = "allocated_bytes.all.allocated"
        torch.cuda.synchronize()
        before = torch.cuda.memory_stats()[key]
        result = fn(*args)
        torch.cuda.synchronize()
        return torch.cuda.memory_stats()[key] - before, result
    tr = trace(fn, *args)
    return sum(op.alloc for op in tr.ops), tr.result


@rule(
    "in_place_evolve",
    "callable",
    "the multi-step driver must update its two field buffers in place",
)
def _in_place_evolve(make_evolve, ctx) -> list[Finding]:
    """``make_evolve`` is the solver's driver factory; the context holds
    the pair ``args``, the step count ``steps`` (>= 2) and the per-step
    work ``increment`` (a callable of the pair) whose own allocations the
    driver may make each step and no more."""
    steps = int(ctx.get("steps", 4))
    pair = tuple(a.clone() for a in ctx["args"])
    ptrs = {a.data_ptr() for a in pair}
    field = pair[0].numel() * pair[0].element_size()
    inc, _ = _allocated(ctx["increment"], tuple(a.clone() for a in pair))
    got, result = _allocated(make_evolve(steps), pair)
    out = []
    if {r.data_ptr() for r in result} != ptrs:
        out.append(
            Finding(
                rule="in_place_evolve",
                severity=ERROR,
                message=(
                    f"the {steps}-step driver returned buffers other than "
                    "the two it was given (the swap copies)"
                ),
                primitive="data_ptr",
                computation="make_evolve",
            )
        )
    extra = got - steps * inc
    if extra >= field:
        out.append(
            Finding(
                rule="in_place_evolve",
                severity=ERROR,
                message=(
                    f"the {steps}-step driver allocated {got} bytes, "
                    f"{extra} beyond its increments' {steps} x {inc}: "
                    f"{extra / field / steps:.2f} field(s) a step (the carry "
                    "is not updated in place)"
                ),
                primitive="allocation",
                computation="make_evolve",
            )
        )
    return out


def rebuild_count(fn, argsets) -> int:
    """How many times the most-rebuilt artifact is built across the
    ``fn(*args)`` calls of ``argsets``: kernel library loads (per build
    directory, ``kernels._build.LOADS``) and tune races (per kernel and
    shape, ``tune.autotuner.stats``).  The counterpart of
    ``retrace_count``: structurally identical Creates and Computes must
    reuse one build and one measurement."""
    from repro_torch.kernels import _build
    from repro_torch.tune.autotuner import stats

    loads = dict(_build.LOADS)
    races = len(stats.races)
    for args in argsets:
        fn(*args)
    counts = [n - loads.get(d, 0) for d, n in _build.LOADS.items()]
    per_key: dict = {}
    for race in stats.races[races:]:
        key = (race["kernel"], tuple(race["shape"]))
        per_key[key] = per_key.get(key, 0) + 1
    return max(counts + list(per_key.values()) + [0])


@rule(
    "rebuild_budget",
    "callable",
    "identical Creates and Computes must not rebuild kernels or re-measure",
)
def _rebuild_budget(fn, ctx) -> list[Finding]:
    argsets = ctx["argsets"]
    budget = int(ctx.get("budget", 1))
    n = rebuild_count(fn, argsets)
    if n <= budget:
        return []
    return [
        Finding(
            rule="rebuild_budget",
            severity=ERROR,
            message=(
                f"{n} builds of one artifact across {len(argsets)} calls with "
                f"structurally identical plans (budget {budget}); a kernel "
                "library or a tune race is not reused"
            ),
            primitive="build",
            computation="<build cache>",
        )
    ]


# ---------------------------------------------------------------------------
# plan rule: launch geometry feasibility
# ---------------------------------------------------------------------------


@rule(
    "launch_geometry_feasible",
    "plan",
    "halo within the field, bands matching the shape, and a tuned launch "
    "geometry the card can launch",
)
def _launch_geometry_feasible(plan, ctx) -> list[Finding]:
    """The counterpart of the reference's ``pallas_grid_feasible``: reads
    the plan's ``grid_problems(shape)``.  The card's kernels take any
    extent, so no tile-divisibility rule applies; what the card cannot
    launch is a tuned geometry whose shared memory, grid or route does not
    fit the shape (``kernels/*.py``'s geometry functions)."""
    shape = tuple(ctx["shape"])
    probe = getattr(plan, "grid_problems", None)
    if probe is None:
        return []
    return [
        Finding(
            rule="launch_geometry_feasible",
            severity=ERROR,
            message=msg,
            primitive=getattr(plan, "kernel_name", None),
            computation=type(plan).__name__,
        )
        for msg in probe(shape)
    ]


# ---------------------------------------------------------------------------
# cost rules: fail-closed perf budgets over measured CostVectors
# ---------------------------------------------------------------------------

# Budget = analytic floor x factor: the reference's defaults, which a
# family's calibrated factors override (audit.py).  A clean build clears
# every cell with headroom, while the canonical regressions — a
# reintroduced transpose round-trip, a leaked double buffer, a
# rematerialised history — overshoot them.  The *tight* net is the
# committed ANALYSIS_costs_torch.json baseline diff (>10%); these absolute
# budgets are the backstop that works without a baseline.  device_time is
# the card's: the call's device time over the floor's time on the H100's
# peaks.
BUDGET_FACTORS = {
    "flops": 12.0,
    "bytes": 8.0,
    "peak_memory": 6.0,
    "step_bytes": 8.0,
    "device_time": 8.0,
}
_NO_REMAT_MIN_TRIPS = 2  # single-trip "loops" carry no growth signal


def _budget(ctx, metric: str):
    exp = ctx["expected"]
    factors = {**BUDGET_FACTORS, **ctx.get("factors", {})}
    if metric == "device_time":
        from repro_torch.analysis.cost import floor_ms

        floor = floor_ms(exp)
    else:
        floor = getattr(exp, metric)
    return floor * factors[metric], factors[metric], floor


def _over_budget(ctx, metric: str, measured: float, primitive: str):
    budget, factor, floor = _budget(ctx, metric)
    if budget <= 0 or measured <= budget:
        return []
    return [
        Finding(
            rule=f"{metric}_budget",
            severity=ERROR,
            message=(
                f"measured {metric} {measured:.4g} exceeds budget "
                f"{budget:.4g} ({factor:g}x the analytic floor "
                f"{floor:.4g}; bloat {measured / floor:.2f}x)"
            ),
            primitive=primitive,
            computation=ctx.get("cell", "<cost>"),
        )
    ]


@rule(
    "flops_budget",
    "cost",
    "measured FLOPs must stay within a factor of the analytic floor",
)
def _flops_budget(cost, ctx) -> list[Finding]:
    return _over_budget(ctx, "flops", cost.flops, "flops")


@rule(
    "bytes_budget",
    "cost",
    "bytes moved must stay within a factor of the ~2-fields-plus-halo floor",
)
def _bytes_budget(cost, ctx) -> list[Finding]:
    return _over_budget(ctx, "bytes", cost.bytes, "bytes_accessed")


@rule(
    "peak_memory_budget",
    "cost",
    "peak live memory must stay within a factor of the live-field floor",
)
def _peak_memory_budget(cost, ctx) -> list[Finding]:
    return _over_budget(ctx, "peak_memory", cost.peak_memory, "live_storage")


@rule(
    "no_remat",
    "cost",
    "driver-loop traffic must stay trip-count-linear (no rematerialised "
    "history: per-trip bytes bounded by the per-step floor)",
)
def _no_remat(cost, ctx) -> list[Finding]:
    exp = ctx["expected"]
    if exp.step_bytes <= 0:
        return []
    budget, factor, _ = _budget(ctx, "step_bytes")
    out = []
    for lp in cost.loops:
        if lp.trips < _NO_REMAT_MIN_TRIPS or lp.per_trip_bytes <= budget:
            continue
        out.append(
            Finding(
                rule="no_remat",
                severity=ERROR,
                message=(
                    f"loop {lp.body!r} ({lp.trips} trips) moves "
                    f"{lp.per_trip_bytes:.4g} bytes per trip, over the "
                    f"per-step budget {budget:.4g} ({factor:g}x the "
                    f"analytic step floor {exp.step_bytes:.4g}): total "
                    "loop traffic grows super-linearly in the trip count "
                    "(rematerialised history / stacked carry)"
                ),
                primitive="loop",
                computation=lp.body,
            )
        )
    return out


@rule(
    "device_time_budget",
    "cost",
    "the card's device time must stay within a factor of the floor's time "
    "on the H100's peaks",
)
def _device_time_budget(cost, ctx) -> list[Finding]:
    if cost.device_ms is None:
        return []
    return _over_budget(ctx, "device_time", cost.device_ms, "device_time")
