"""The audit matrix: every registry operator × plan family × backend
(counterpart of ``repro.analysis.audit``).

For each combination that the operator supports, the auditor Creates a
small plan, traces its Compute (:mod:`repro_torch.analysis.trace`), and
runs the invariant rules (:mod:`repro_torch.analysis.rules`) plus the
operator lint (:mod:`repro_torch.analysis.stencil_lint`):

- trace rules (``no_dtype_upcast``, ``no_host_sync`` everywhere —
  including the fft backend, whose dtype contract is that fp32 fields
  ride complex64 through the transforms; ``no_transpose`` on the
  families that promise it — the ADI sweeps and the fused Cahn–Hilliard
  step — on the plain and kernel backends (the fft path transforms along
  every axis, so transpose-freedom is deliberately *not* part of its
  contract));
- the ``launch_geometry_feasible`` plan rule;
- a per-family ``rebuild_budget`` probe (three structurally identical
  Creates, tuned through one fresh cache, and Computes must build each
  kernel library and race each tune key at most once);
- the ``in_place_evolve`` rule on the evolve driver of the fused
  Cahn–Hilliard step (the reference's ``donation_applied``).

On a card (``device='cuda'``) the same cells also run under
``torch.cuda.set_sync_debug_mode('error')`` in a call of their own (a
raise is a ``no_host_sync`` finding), and a ``cuda`` cell of a
transpose-free family hands ``no_transpose`` the profiler's kernel list of
its Compute, which must hold no copy or transpose kernel; a list that no
profiler window recorded, in this process or in a fresh one, is an error
of the rule, not a pass.  The plain path
(``torch``) is made of torch's copy kernels (a slice written is a copy),
so its list is not read; its trace is.

The backends are the reference's under the port's names: ``jnp`` ->
``torch`` (the plain path), ``pallas`` -> ``cuda`` (the hand-written
kernels), ``fft`` -> ``fft``.  On the CPU a ``cuda`` cell that the
reference would run skips, "needs a CUDA device"; every other skip is the
reference's, in its words.  **One difference:** the reference audits the
fused CH cell on ``jnp`` only, and skips its other backends ("fused CH
audited on the jnp backend").  The port keeps that skip for ``fft`` and,
on the CPU, for ``cuda``; on a card ``fused_ch/hyperdiffusion/cuda``
runs, because there the kernel path (``ch_rhs_xsweep`` and
``penta_cols`` under ``make_evolve``) is the hot path.

``seed_violation=`` deliberately injects a defect (``'transpose'`` or
``'upcast'``) into one hot path — the fail-closed proof that a violated
invariant actually trips the gate, with the offending op named in the
JSON report.

:func:`run_cost_audit` is the second pass over the same matrix: each
cell's hot path is measured (through the shared :class:`CellArtifacts`
cache, so plans and measurements are made once across both audits) into
its flops / bytes / peak-memory vector (:func:`repro_torch.analysis.cost.
measure`), gated against the family's closed-form floor by the
``*_budget`` / ``no_remat`` rules, then diffed against the committed
``ANALYSIS_costs_torch.json`` baseline (:func:`diff_baseline`, >10% drift
fails).  The cost seeds (``'transpose_copy'``, ``'flops_waste'``,
``'double_buffer'``, ``'remat'``) are the fail-closed proofs for the
budget rules.  On a card, at each family's path shape
(:data:`CARD_SHAPES`), the ``cuda`` cells also measure their device time,
which ``device_time_budget`` holds to the floor's time on the H100's
peaks; at the tiny default shapes launch latency swamps that floor, so
there the card gates the counted vector only.

Shapes are deliberately tiny by default (the invariants checked are
shape-generic structural properties of the traced program).
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.analysis import cost as _cost
from repro_torch.analysis import rules as _rules
from repro_torch.analysis import stencil_lint as _lint
from repro_torch.analysis import trace as _trace
from repro_torch.analysis.findings import Finding, errors

FAMILIES = (
    "stencil2d", "batch1d", "stencil3d", "adi2d", "adi3d", "fused_ch",
)
BACKENDS = ("torch", "cuda", "fft")
SEED_VIOLATIONS = ("transpose", "upcast")
# cost-audit seeds: each is the canonical regression its budget rule
# exists for (bytes_budget / flops_budget / peak_memory_budget / no_remat)
COST_SEEDS = ("transpose_copy", "flops_waste", "double_buffer", "remat")

# each seed: the rule it trips (the one the reference's seed trips) and its
# designated cell (family, operator) on the torch backend
SEED_RULES = {
    "transpose": ("no_transpose", "adi2d", "hyperdiffusion"),
    "upcast": ("no_dtype_upcast", "adi2d", "hyperdiffusion"),
    "transpose_copy": ("bytes_budget", "stencil2d", "laplacian"),
    "flops_waste": ("flops_budget", "stencil2d", "laplacian"),
    "double_buffer": ("peak_memory_budget", "stencil2d", "laplacian"),
    "remat": ("no_remat", "fused_ch", "hyperdiffusion"),
}

# the families whose Compute promises a transpose-free trace (the ADI
# layout contract)
TRANSPOSE_FREE = ("adi2d", "adi3d", "fused_ch")

DEFAULT_SHAPES = {
    "stencil2d": (32, 32),
    "batch1d": (8, 64),
    "stencil3d": (8, 12, 16),
    "adi2d": (32, 32),  # square: the seeded-transpose wrapper stays valid
    "adi3d": (8, 12, 16),
    "fused_ch": (32, 32),
}
# the main paths' shapes (float64), where the card's device-time factors
# were fitted: the 1024^2 solver's plans and sweeps, its (1024, 1024)
# batched-1D lines, and the 256^3 LOD step's plan and sweeps
CARD_SHAPES = {
    "stencil2d": (1024, 1024),
    "batch1d": (1024, 1024),
    "stencil3d": (256, 256, 256),
    "adi2d": (1024, 1024),
    "adi3d": (256, 256, 256),
    "fused_ch": (1024, 1024),
}
_ADI_ALPHA = 0.2
_NDIM = {"batch1d": 1, "stencil3d": 3}
_NEEDS_CARD = "needs a CUDA device"


class _Skip(Exception):
    """This operator/family/backend combination does not apply."""


class CellArtifacts:
    """Per-cell plan/trace/measurement memo shared across rules and audits.

    Every audit pass that needs an artifact of cell *(family, operator,
    backend, shape, seed)* fetches it through one instance of this class,
    so the expensive steps — plan Create (penta factorisation), tracing,
    measuring — happen once per cell per process instead of once per
    rule.  ``python -m repro_torch.analysis --cost`` threads a single cache
    through both the invariant audit and the cost audit."""

    def __init__(self):
        self._memo: dict = {}
        self.builds = 0  # cache misses

    def get(self, key, build):
        if key not in self._memo:
            self.builds += 1
            self._memo[key] = build()
        return self._memo[key]


@dataclasses.dataclass
class AuditResult:
    """One audited cell of the operator × family × backend matrix."""

    family: str
    operator: str
    backend: str
    rules: tuple
    findings: list
    skipped: str | None = None
    seeded: str | None = None

    @property
    def ok(self) -> bool:
        return not errors(self.findings)

    def to_dict(self) -> dict:
        return {
            "family": self.family,
            "operator": self.operator,
            "backend": self.backend,
            "rules": list(self.rules),
            "findings": [f.to_dict() for f in self.findings],
            "skipped": self.skipped,
            "seeded": self.seeded,
            "ok": self.ok,
        }


@dataclasses.dataclass
class Report:
    """The whole audit run: results + provenance."""

    results: list
    meta: dict

    @property
    def violations(self) -> list:
        return [r for r in self.results if not r.ok]

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {
            "meta": self.meta,
            "ok": self.ok,
            "violations": len(self.violations),
            "results": [r.to_dict() for r in self.results],
        }


# ---------------------------------------------------------------------------
# Plan construction per family
# ---------------------------------------------------------------------------


def _device(device) -> torch.device:
    """The audit's device: ``'cuda'`` needs a card (no fallback to the
    CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the audit runs on the card by default and no CUDA device is "
            "available; pass device='cpu' (--device cpu) to audit the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


def _need_card(backend: str, device: torch.device) -> None:
    if backend == "cuda" and device.type != "cuda":
        raise _Skip(_NEEDS_CARD)


def _make_plan(family: str, opname: str, backend: str, shape, device,
               **tune):
    from repro_torch import api

    opdef = api.get_operator(opname)
    if family in ("adi2d", "adi3d"):
        if opdef.diagonals is None:
            raise _Skip("operator defines no ADI bands")
        _need_card(backend, device)
        return api.create(
            opname, shape, mode="adi", alpha=_ADI_ALPHA, backend=backend,
            lint="off", device=device, **tune,
        )
    if opdef.weights is None:
        raise _Skip("operator defines no stencil weights")
    try:
        opdef.weights(_NDIM.get(family, 2))
    except ValueError as e:
        # weights builder refuses this dimensionality (e.g. 3D biharmonic)
        raise _Skip(str(e)) from None
    _need_card(backend, device)
    mode = "batch" if family == "batch1d" else None
    return api.create(
        opname, shape, bc="periodic", mode=mode, backend=backend,
        lint="off", device=device, **tune,
    )


def _make_ch_solver(shape, backend: str, device):
    from repro_torch.core.cahn_hilliard import CahnHilliardADI, CHConfig

    ny, nx = shape
    return CahnHilliardADI(
        CHConfig(nx=nx, ny=ny, dt=1e-3, rhs_mode="fused", backend=backend,
                 device=str(device))
    )


def _seeded_fn(fn, seed: str | None, shape, device):
    """Wrap a hot-path callable with a deliberately injected defect.  The
    field is uniform noise drawn with numpy from a fixed seed (not zeros,
    so a device time reads the kernels on real data)."""
    def field(dtype=torch.float64):
        values = np.random.default_rng(0).uniform(-0.5, 0.5, shape)
        return torch.as_tensor(values, dtype=dtype, device=device)

    if seed is None:
        return fn, (field(),)
    if seed == "transpose":
        return (lambda v: fn(v.mT.contiguous()).mT.contiguous()), (field(),)
    if seed == "upcast":
        return (lambda v: fn(v.to(torch.float64))), (field(torch.float32),)
    # --- cost-audit seeds: measurable regressions of the counted vector ---
    if seed == "transpose_copy":
        # a layout round-trip around the apply: two materialised copies
        # of the field around one apply each way
        return (lambda v: fn(fn(v.mT.contiguous()).mT.contiguous())), (field(),)
    if seed == "flops_waste":
        # redundant recomputation: apply the operator 32x and keep one

        def wasteful(v):
            r = v
            for _ in range(32):
                r = fn(r)
            return r

        return wasteful, (field(),)
    if seed == "double_buffer":
        # a leak of live buffers: eight extra full-size fields returned
        # with the result (a swap() that stopped reusing its buffers)

        def leaky(v):
            extras = tuple(torch.sin(v * (i + 1.0)) for i in range(8))
            return (fn(v), *extras)

        return leaky, (field(),)
    raise ValueError(
        f"seed must be one of {SEED_VIOLATIONS + COST_SEEDS}, got {seed!r}"
    )


def _trace_rules_for(family: str, backend: str) -> list:
    names = ["no_dtype_upcast", "no_host_sync"]
    if family in TRANSPOSE_FREE and backend in ("torch", "cuda"):
        names.insert(0, "no_transpose")
    return names


# ---------------------------------------------------------------------------
# Cached per-cell artifacts (plans, callables, traces, measurements)
# ---------------------------------------------------------------------------

_EVOLVE_STEPS = 4  # clean evolve cost cell: a small multi-step driver
_REMAT_TRIPS = 64  # seeded-remat loop length (history = 64 live fields)


def _cell_plan(family, opname, backend, shape, device, cache: CellArtifacts):
    return cache.get(
        ("plan", family, opname, backend, tuple(shape), str(device)),
        lambda: _make_plan(family, opname, backend, shape, device),
    )


def _cell_callable(family, opname, backend, shape, seed, device, cache):
    """(fn, args) for the cell's hot path, seeded if requested."""
    from repro_torch import api

    def build():
        plan = _cell_plan(family, opname, backend, shape, device, cache)
        return _seeded_fn(lambda v: api.compute(plan, v), seed, shape, device)

    return cache.get(
        ("callable", family, opname, backend, tuple(shape), seed, str(device)),
        build,
    )


def _cell_solver(shape, backend, device, cache):
    def build():
        from repro_torch.core.cahn_hilliard import deep_quench_ic

        solver = _make_ch_solver(shape, backend, device)
        c0 = deep_quench_ic(shape[0], shape[1], seed=0, device=device)
        c1 = solver.initial_step(c0)
        return solver, c0, c1

    return cache.get(("solver", tuple(shape), backend, str(device)), build)


def _fused_callable(shape, backend, seed, device, cache):
    """(fn, args) of the fused CH cell: one step, or a seeded apply of its
    new field."""
    solver, c0, c1 = _cell_solver(shape, backend, device, cache)
    if seed is None:
        return solver.step, (c1, c0)
    return _seeded_fn(lambda v: solver.step(v, c0)[0], seed, shape, device)


def _cell_evolve(shape, backend, seed, device, cache):
    """(fn, args, steps) of the multi-step CH driver: ``make_evolve``'s
    in-place steps, one marked trip each, clean; or, seeded ``'remat'``, a
    loop of out-of-place steps that carries a rematerialised history."""
    solver, c0, c1 = _cell_solver(shape, backend, device, cache)
    if seed == "remat":
        trips = _REMAT_TRIPS

        def evolve(a, b):
            hist = torch.zeros((trips, *shape), dtype=a.dtype, device=a.device)
            for _ in range(trips):
                with _trace.trip("evolve"):
                    an, bn = solver.step(a, b)
                    # the regression no_remat exists for: the body touches
                    # an O(trips)-sized history every trip, so total loop
                    # traffic grows quadratically in the step count
                    hist = hist * 0.999 + 1e-9 * an[None]
                    a, b = an, bn
            return a, b, hist

        return evolve, (c1, c0), trips
    step = solver.make_evolve(1)  # k of these are make_evolve(k)'s k steps

    def evolve(a, b):
        for _ in range(_EVOLVE_STEPS):
            with _trace.trip("evolve"):
                a, b = step(a, b)
        return a, b

    return evolve, (c1.clone(), c0.clone()), _EVOLVE_STEPS


# ---------------------------------------------------------------------------
# The audit driver
# ---------------------------------------------------------------------------


def _cell_fn(family, opname, backend, shape, seed, device, cache):
    """(fn, args) of one cell's hot path (a fused CH step, or a plan's
    Compute), seeded if requested."""
    if family == "fused_ch":
        return _fused_callable(shape, backend, seed, device, cache)
    return _cell_callable(family, opname, backend, shape, seed, device, cache)


def _kernel_names(fn, args) -> list | None:
    """The names of the profiler's kernel list of one call of ``fn(*args)``
    on the card; None where no window recorded the call's device
    activity."""
    rows = _cost.device_kernels(fn, *args)
    return [k for k, _, _ in rows] if rows else None


def _cell_kernel_names(family, opname, backend, shape, seed) -> list | None:
    """:func:`_kernel_names` of one cell, made anew in this process."""
    device = _device("cuda")
    fn, args = _cell_fn(family, opname, backend, tuple(shape), seed, device,
                        CellArtifacts())
    fn(*args)  # warm up outside the window (first-use builds)
    torch.cuda.synchronize()
    return _kernel_names(fn, args)


def _fresh_kernel_names(family, opname, backend, shape, seed) -> list | None:
    """:func:`_cell_kernel_names` in a process of its own: a profiler
    window late in a process that has run many can lose all its records.
    None where that process read none either, or failed."""
    src = str(Path(__file__).resolve().parents[2])
    code = ("import json, sys; from repro_torch.analysis import audit; "
            "print(json.dumps(audit._cell_kernel_names("
            "*json.loads(sys.argv[1]))))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p))
    cell = json.dumps([family, opname, backend, list(shape), seed])
    try:
        proc = subprocess.run([sys.executable, "-c", code, cell],
                              capture_output=True, text=True, timeout=900,
                              env=env, check=True)
        return json.loads(proc.stdout.strip().splitlines()[-1])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _card_context(fn, args, rule_names, cell) -> dict:
    """On a card: what ``set_sync_debug_mode('error')`` raised over one
    call (a call of its own, outside any profiler window, which
    synchronises when it stops), and for a ``cuda`` cell that promises
    transpose-freedom, its Compute's profiler kernel list, read in a fresh
    process where this one's windows recorded nothing (None, an error of
    ``no_transpose``, where that one's did not either).  ``cell`` is
    (family, operator, backend, shape, seed)."""
    ctx = {}
    fn(*args)  # warm up outside the checked call (first-use builds sync)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(*args)
    except RuntimeError as e:
        ctx["sync_error"] = str(e).splitlines()[0]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    if "no_transpose" in rule_names and cell[2] == "cuda":
        names = _kernel_names(fn, args)
        ctx["kernels"] = names if names is not None else (
            _fresh_kernel_names(*cell))
    return ctx


def _audit_cell(
    family: str, opname: str, backend: str, shape, seed: str | None,
    device, cache: CellArtifacts,
):
    from repro_torch import api

    opdef = api.get_operator(opname)
    rule_names = list(_trace_rules_for(family, backend))
    on_card = device.type == "cuda"
    try:
        if family == "fused_ch":
            if opname != "hyperdiffusion":
                raise _Skip("the CH scheme is the hyperdiffusion operator")
            if backend == "fft" or (backend == "cuda" and not on_card):
                raise _Skip("fused CH audited on the jnp backend")
        else:
            plan = _cell_plan(family, opname, backend, shape, device, cache)
        fn, args = _cell_fn(family, opname, backend, shape, seed, device,
                            cache)
        ctx = (_card_context(fn, args, rule_names,
                             (family, opname, backend, shape, seed))
               if on_card else {})
        findings = _rules.check_trace(_trace.trace(fn, *args), rule_names,
                                      context=ctx)
        if family == "fused_ch":
            # the evolve driver must update its two buffers in place
            solver, c0, c1 = _cell_solver(shape, backend, device, cache)
            rule_names.append("in_place_evolve")
            findings += _rules.RULES["in_place_evolve"].check(
                solver.make_evolve,
                {"args": (c1, c0), "steps": _EVOLVE_STEPS,
                 "increment": solver._increment},
            )
        else:
            rule_names.append("launch_geometry_feasible")
            findings += _rules.check_plan(plan, shape)
        # operator lint rides along once per cell (cheap, numpy-only)
        if family in ("adi2d", "adi3d"):
            findings += _lint.lint_adi(
                opdef, shape[-1], _ADI_ALPHA, bc="periodic", cyclic=True,
            )
        else:
            findings += _lint.lint_operator(opdef, ndim=_NDIM.get(family, 2))
        return AuditResult(
            family=family, operator=opname, backend=backend,
            rules=tuple(rule_names), findings=findings, seeded=seed,
        )
    except _Skip as s:
        return AuditResult(
            family=family, operator=opname, backend=backend,
            rules=(), findings=[], skipped=str(s),
        )


def _rebuild_cell(family: str, opname: str, shape, device):
    """The per-family rebuild probe: three structurally identical Creates
    (``tune='cached'`` through one fresh cache) and Computes must build
    each kernel library and race each tune key at most once."""
    from repro_torch import api
    from repro_torch.tune import TuneCache

    backend = "cuda" if device.type == "cuda" else "torch"
    try:
        _make_plan(family, opname, backend, shape, device)
    except _Skip as s:
        return AuditResult(
            family=family, operator=opname, backend=backend,
            rules=("rebuild_budget",), findings=[], skipped=str(s),
        )
    x = torch.zeros(shape, dtype=torch.float64, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        tune_cache = TuneCache(tmp)

        def create_and_compute(v):
            plan = _make_plan(family, opname, "auto", shape, device,
                              tune="cached", tune_cache=tune_cache)
            return api.compute(plan, v)

        ctx = {"argsets": [(x,)] * 3, "budget": 1}
        findings = _rules.RULES["rebuild_budget"].check(create_and_compute,
                                                        ctx)
    return AuditResult(
        family=family, operator=opname, backend=backend,
        rules=("rebuild_budget",), findings=findings,
    )


def _card_meta(device) -> dict:
    """The run's device: its name and power limit as ``nvidia-smi`` gives
    them on a card (None where it cannot say), and the host fingerprint of
    the tune cache."""
    from repro_torch.tune.cache import host_fingerprint

    dev = torch.device(device)
    meta = {"device": dev.type, "card": None, "power_limit": None,
            "host": host_fingerprint(str(dev))}
    if dev.type == "cuda":
        meta["card"] = torch.cuda.get_device_name(dev)
        try:
            res = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader"],
                capture_output=True, text=True, check=True, timeout=60)
            meta["power_limit"] = res.stdout.strip().splitlines()[0]
        except (OSError, subprocess.SubprocessError, IndexError):
            pass
    return meta


def _meta(operators, families, backends, device) -> dict:
    return {
        "schema_version": _cost.SCHEMA_VERSION,
        "torch": torch.__version__,
        **_card_meta(device),
        "operators": list(operators),
        "families": list(families),
        "backends": list(backends),
    }


def _seed_cell(seed, families, operators, backends):
    """The cell ``seed`` goes in: its designated one on the torch backend
    (:data:`SEED_RULES`), else the first cell audited."""
    if seed is None:
        return None
    cells = [(f, o, b) for f in families for o in operators for b in backends]
    preferred = (*SEED_RULES[seed][1:], "torch")
    return preferred if preferred in cells else cells[0]


def run_audit(
    *,
    operators=None,
    families=None,
    backends=None,
    shapes=None,
    seed_violation: str | None = None,
    retrace: bool = True,
    cache: CellArtifacts | None = None,
    device="cuda",
) -> Report:
    """Audit the operator × plan-family × backend matrix on ``device``
    (the card by default; ``'cpu'`` audits the plain and fft paths, and
    the ``cuda`` cells skip).

    ``seed_violation`` injects the named defect into its designated cell
    (:data:`SEED_RULES`) on the torch backend (falling back to the first audited cell when
    that one is filtered out) — the gate must then report it and exit
    nonzero.  ``retrace`` runs the per-family rebuild probes (the
    reference's retrace probes).  Returns a :class:`Report`; serialise
    with ``to_dict()``."""
    from repro_torch import api

    if seed_violation is not None and seed_violation not in SEED_VIOLATIONS:
        raise ValueError(
            f"seed_violation must be one of {SEED_VIOLATIONS}, "
            f"got {seed_violation!r}"
        )
    device = _device(device)
    operators = tuple(operators or api.operator_names())
    families = tuple(families or FAMILIES)
    backends = tuple(backends or BACKENDS)
    shapes = {**DEFAULT_SHAPES, **(shapes or {})}
    cache = cache if cache is not None else CellArtifacts()

    seed_cell = _seed_cell(seed_violation, families, operators, backends)
    results = []
    for family in families:
        for opname in operators:
            for backend in backends:
                seed = (
                    seed_violation
                    if seed_cell == (family, opname, backend)
                    else None
                )
                results.append(
                    _audit_cell(
                        family, opname, backend, shapes[family], seed, device,
                        cache,
                    )
                )
        if retrace and family != "fused_ch":
            # fused_ch has no plan of its own: its plans are probed above
            for opname in operators:
                cell = _rebuild_cell(family, opname, shapes[family], device)
                results.append(cell)
                if cell.skipped is None:
                    break  # one rebuild probe per family is the budget

    meta = {
        **_meta(operators, families, backends, device),
        "seed_violation": seed_violation,
        "rules": sorted(_rules.RULES),
    }
    return Report(results=results, meta=meta)


# ---------------------------------------------------------------------------
# The cost audit: measured CostVector vs analytic Expected per cell
# ---------------------------------------------------------------------------

_ADI_SWEEPS = {"adi2d": 2, "adi3d": 3}

# Calibrated budget factors per (family, backend) on the counted vectors,
# each set 1.5-2x above the *clean* measured/analytic ratio of the worst
# operator of its group, so a clean build clears every cell with headroom
# while the canonical seeds (transpose round-trip, 32x recompute, leaked
# live buffers, a history carried through the loop) breach.
#
# torch: fitted on the CPU (torch 2.13.0) at DEFAULT_SHAPES.  The plain
# path is eager torch: each stencil window is a rolled field, multiplied
# and added, and each step of a penta recurrence a handful of line-sized
# ops, so its byte ratios sit well above the two-field floor.  A plain
# stencil's bytes grow with its weights' window count (zero windows
# included), which the floor does not see: the clean ratios are
# 2.95-3.24x the count (8.86 for 3 windows, 15.52 for 5, 29.10 for 9,
# 80.95 for 25, 87.54 for 27).  So the plain stencil families' bytes
# factor is _PLAIN_BYTES_PER_WINDOW times the count: one budget for every
# operator of a shape, whatever its name.
# cuda: a kernel launch counts its tensor arguments and the floor's flops
# (cost.launch_flops), so these cells sit at the closed forms (flops
# 0.97-1.00, bytes 0.95-0.99 and 0.35-0.38 for the sweeps, which move two
# field passes where the floor counts six, peak 0.67-0.75); fitted on the
# H100 at DEFAULT_SHAPES.  The tight net for every group is the committed
# baseline diff.
_FACTOR_TABLE: dict[tuple, dict[str, float]] = {
    ("stencil2d", "torch"): {
        "flops": 3.5, "peak_memory": 3.0, "step_bytes": 8.0,
    },
    ("batch1d", "torch"): {
        "flops": 1.5, "peak_memory": 3.0, "step_bytes": 4.0,
    },
    ("stencil3d", "torch"): {
        "flops": 6.0, "peak_memory": 3.5, "step_bytes": 8.0,
    },
    ("adi2d", "torch"): {
        "flops": 2.0, "bytes": 12.0, "peak_memory": 2.5, "step_bytes": 2.0,
    },
    ("adi3d", "torch"): {
        "flops": 2.0, "bytes": 12.0, "peak_memory": 2.5, "step_bytes": 2.0,
    },
    ("fused_ch", "torch"): {
        "flops": 1.2, "bytes": 25.0, "peak_memory": 4.0, "step_bytes": 25.0,
    },
    ("stencil2d", "cuda"): {
        "flops": 1.5, "bytes": 1.5, "peak_memory": 1.2, "step_bytes": 8.0,
    },
    ("batch1d", "cuda"): {
        "flops": 1.5, "bytes": 1.5, "peak_memory": 1.2, "step_bytes": 4.0,
    },
    ("stencil3d", "cuda"): {
        "flops": 1.5, "bytes": 1.5, "peak_memory": 1.2, "step_bytes": 8.0,
    },
    ("adi2d", "cuda"): {
        "flops": 1.5, "bytes": 0.7, "peak_memory": 1.2, "step_bytes": 2.0,
    },
    ("adi3d", "cuda"): {
        "flops": 1.5, "bytes": 0.7, "peak_memory": 1.2, "step_bytes": 2.0,
    },
    ("fused_ch", "cuda"): {
        "flops": 1.5, "bytes": 1.5, "peak_memory": 1.2, "step_bytes": 1.5,
    },
}
_PLAIN_BYTES_PER_WINDOW = 5.5
_STENCIL_FAMILIES = ("stencil2d", "batch1d", "stencil3d")
# the reference's fft factors but the peak: the card's allocator peak of
# an fft cell holds cuFFT's work area (1.47x the floor at adi3d's default
# shape against 0.92x on the CPU)
_FFT_FACTORS = {
    "flops": 2.0, "bytes": 2.0, "peak_memory": 2.2, "step_bytes": 4.0,
}
# Device-time factors of the cuda cells at CARD_SHAPES, fitted on an
# NVIDIA H100 80GB HBM3 (700 W): 1.5-2x above the worst clean ratio of
# the family's device time to the floor's time on the H100's peaks, as
# chip_smoke.py's phase 4m prints them (PERF.md, the audit: stencil2d 1.89,
# batch1d 1.34, stencil3d 1.50, adi2d 1.08, adi3d 0.81, fused_ch 2.34).
CARD_FACTORS: dict[str, float] = {
    "stencil2d": 3.0,
    "batch1d": 2.2,
    "stencil3d": 2.4,
    "adi2d": 1.8,
    "adi3d": 1.5,
    "fused_ch": 4.0,
}


def _weights(family: str, opname: str) -> np.ndarray:
    from repro_torch import api

    return np.asarray(api.get_operator(opname).weights(_NDIM.get(family, 2)))


def _cost_factors(family: str, opname: str, backend: str,
                  timed: bool) -> dict[str, float]:
    if backend == "fft":
        factors = dict(_FFT_FACTORS)
    else:
        factors = dict(_FACTOR_TABLE.get((family, backend), {}))
    if backend == "torch" and family in _STENCIL_FAMILIES:
        factors["bytes"] = (_PLAIN_BYTES_PER_WINDOW
                            * _weights(family, opname).size)
    if timed:
        factors["device_time"] = CARD_FACTORS[family]
    return factors


def _expected_for(family, opname, backend, shape) -> _cost.Expected:
    """The closed-form analytic floor for one audit cell (fp64 fields)."""
    itemsize = 8
    if backend == "fft":
        return _cost.expected_fft(
            shape, itemsize, transforms=_ADI_SWEEPS.get(family, 1)
        )
    if family in _ADI_SWEEPS:
        return _cost.expected_penta(
            shape, itemsize, sweeps=_ADI_SWEEPS[family]
        )
    w = _weights(family, opname)
    return _cost.expected_stencil(
        shape,
        taps=max(int(np.count_nonzero(w)), 1),
        itemsize=itemsize,
        halo=max((d // 2 for d in w.shape), default=0),
    )


def _scale_steps(e: _cost.Expected, k: int) -> _cost.Expected:
    """A k-step driver costs k x one step in flops/bytes; the peak and the
    per-trip floor are step properties and do not scale."""
    return _cost.Expected(
        flops=e.flops * k, bytes=e.bytes * k,
        peak_memory=e.peak_memory, step_bytes=e.step_bytes,
    )


@dataclasses.dataclass
class CostResult:
    """One measured cell of the cost matrix."""

    family: str
    operator: str
    backend: str
    measured: object = None  # CostVector
    expected: object = None  # Expected
    findings: list = dataclasses.field(default_factory=list)
    skipped: str | None = None
    seeded: str | None = None

    @property
    def cell(self) -> str:
        return f"{self.family}/{self.operator}/{self.backend}"

    @property
    def ok(self) -> bool:
        return not errors(self.findings)

    def to_dict(self) -> dict:
        d = {
            "family": self.family,
            "operator": self.operator,
            "backend": self.backend,
            "findings": [f.to_dict() for f in self.findings],
            "skipped": self.skipped,
            "seeded": self.seeded,
            "ok": self.ok,
        }
        if self.measured is not None and self.expected is not None:
            d["measured"] = self.measured.to_dict()
            d["expected"] = self.expected.to_dict()
            d["flops_bloat"] = (
                self.measured.flops / self.expected.flops
                if self.expected.flops else None
            )
            d["bytes_bloat"] = (
                self.measured.bytes / self.expected.bytes
                if self.expected.bytes else None
            )
            if self.measured.device_ms is not None:
                floor = _cost.floor_ms(self.expected)
                d["floor_ms"] = floor
                d["device_time_bloat"] = self.measured.device_ms / floor
        return d


@dataclasses.dataclass
class CostReport:
    """The whole cost-audit run: per-cell vectors + provenance."""

    results: list
    meta: dict

    @property
    def violations(self) -> list:
        return [r for r in self.results if not r.ok]

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_dict(self) -> dict:
        return {
            "meta": self.meta,
            "ok": self.ok,
            "violations": len(self.violations),
            "cells": {
                r.cell: r.to_dict()
                for r in self.results
            },
        }


def _cost_cell(family, opname, backend, shape, seed, device, cache):
    timed = (device.type == "cuda" and backend == "cuda"
             and tuple(shape) == CARD_SHAPES[family])
    try:
        if family == "fused_ch":
            if opname != "hyperdiffusion":
                raise _Skip("the CH scheme is the hyperdiffusion operator")
            if backend == "fft" or (backend == "cuda" and device.type != "cuda"):
                raise _Skip("fused CH audited on the jnp backend")
            fn, args, steps = _cell_evolve(shape, backend, seed, device, cache)
            expected = _scale_steps(_cost.expected_ch_step(shape, 8), steps)
        else:
            # probe plan construction first so unsupported combinations
            # skip identically to the invariant audit
            _cell_plan(family, opname, backend, shape, device, cache)
            fn, args = _cell_callable(family, opname, backend, shape, seed,
                                      device, cache)
            expected = _expected_for(family, opname, backend, shape)
        measured = cache.get(
            ("measured", family, opname, backend, tuple(shape), seed,
             str(device)),
            lambda: _cost.measure(fn, *args, timed=timed))
        findings = _rules.check_cost(
            measured,
            context={
                "expected": expected,
                "cell": f"{family}/{opname}/{backend}",
                "factors": _cost_factors(family, opname, backend, timed),
            },
        )
        return CostResult(
            family=family, operator=opname, backend=backend,
            measured=measured, expected=expected, findings=findings,
            seeded=seed,
        )
    except _Skip as s:
        return CostResult(
            family=family, operator=opname, backend=backend, skipped=str(s),
        )


def run_cost_audit(
    *,
    operators=None,
    families=None,
    backends=None,
    shapes=None,
    seed_violation: str | None = None,
    cache: CellArtifacts | None = None,
    device="cuda",
) -> CostReport:
    """Measure the cost vector of every audit cell and gate on budgets.

    Each supported cell measures its hot path once (through the shared
    :class:`CellArtifacts` cache): the flops / bytes / peak-memory vector
    of its trace, compared against the family's closed-form floor by the
    ``*_budget`` / ``no_remat`` rules, and on a card, for the ``cuda``
    cells at :data:`CARD_SHAPES`, its device time against the floor's
    time (``device_time_budget``).  ``seed_violation`` (one of
    :data:`COST_SEEDS`) injects the canonical regression for one budget
    rule into its designated cell."""
    from repro_torch import api

    if seed_violation is not None and seed_violation not in COST_SEEDS:
        raise ValueError(
            f"cost seed_violation must be one of {COST_SEEDS}, "
            f"got {seed_violation!r}"
        )
    device = _device(device)
    operators = tuple(operators or api.operator_names())
    families = tuple(families or FAMILIES)
    backends = tuple(backends or BACKENDS)
    shapes = {**DEFAULT_SHAPES, **(shapes or {})}
    cache = cache if cache is not None else CellArtifacts()

    seed_cell = _seed_cell(seed_violation, families, operators, backends)
    results = []
    for family in families:
        for opname in operators:
            for backend in backends:
                seed = (
                    seed_violation
                    if seed_cell == (family, opname, backend)
                    else None
                )
                results.append(
                    _cost_cell(
                        family, opname, backend, shapes[family], seed, device,
                        cache,
                    )
                )

    meta = {
        **_meta(operators, families, backends, device),
        "shapes": {k: list(v) for k, v in shapes.items()},
        "seed_violation": seed_violation,
        "factors": {
            "default": dict(_rules.BUDGET_FACTORS),
            "fft": dict(_FFT_FACTORS),
            **{"/".join(key): dict(v) for key, v in sorted(_FACTOR_TABLE.items())},
            "torch/bytes_per_window": _PLAIN_BYTES_PER_WINDOW,
            **{f"{fam}/cuda/device_time": v
               for fam, v in sorted(CARD_FACTORS.items())},
        },
        "evolve_steps": _EVOLVE_STEPS,
    }
    return CostReport(results=results, meta=meta)


# ---------------------------------------------------------------------------
# Baseline diff: the tight (>10%) regression net over committed costs
# ---------------------------------------------------------------------------

BASELINE_METRICS = ("flops", "bytes", "peak_memory")
BASELINE_THRESHOLD = 0.10


def diff_baseline(
    report: dict, baseline: dict, *, threshold: float = BASELINE_THRESHOLD
) -> tuple[list[str], list[str]]:
    """Compare a cost report against the committed baseline.

    Returns ``(regressions, notes)``.  Fail-closed semantics: a metric
    more than ``threshold`` *above* baseline, a cell missing from the
    run, a cell absent from the baseline (stale baseline), or a baseline
    measured on another device (the CPU's live-storage peak and the card's
    allocator peak are different measurements) are all regressions;
    improvements beyond the threshold are notes nudging an
    ``--update-baseline``.  A *subset* run (``--families`` & co) is
    diffed only over the matrix slice it declared in ``meta`` — cells
    the run never selected are not "missing"; full runs still catch a
    silently vanished cell."""
    regressions: list[str] = []
    notes: list[str] = []
    base_cells = baseline.get("cells", {})
    new_cells = report.get("cells", {})
    bmeta, nmeta = baseline.get("meta", {}), report.get("meta", {})
    if bmeta.get("device", "cpu") != nmeta.get("device", "cpu"):
        return [
            f"baseline measured on {bmeta.get('device', 'cpu')}, this run on "
            f"{nmeta.get('device', 'cpu')}: no cell is comparable"
        ], notes
    fams = set(nmeta.get("families") or ())
    ops = set(nmeta.get("operators") or ())
    bks = set(nmeta.get("backends") or ())
    if fams and ops and bks:
        base_cells = {
            cell: d
            for cell, d in base_cells.items()
            if (lambda f, o, b: f in fams and o in ops and b in bks)(
                *cell.split("/")
            )
        }
    if bmeta.get("torch") != nmeta.get("torch"):
        notes.append(
            f"torch version changed ({bmeta.get('torch')} -> "
            f"{nmeta.get('torch')}): cost shifts may be library-driven"
        )
    for cell, bdata in sorted(base_cells.items()):
        ndata = new_cells.get(cell)
        if ndata is None:
            regressions.append(f"{cell}: cell missing from this run")
            continue
        if bool(bdata.get("skipped")) != bool(ndata.get("skipped")):
            regressions.append(
                f"{cell}: skip status changed "
                f"({bdata.get('skipped')!r} -> {ndata.get('skipped')!r})"
            )
            continue
        if bdata.get("skipped"):
            continue
        bm, nm = bdata.get("measured", {}), ndata.get("measured", {})
        for metric in BASELINE_METRICS:
            old, new = float(bm.get(metric, 0)), float(nm.get(metric, 0))
            if old <= 0:
                continue
            ratio = new / old
            if ratio > 1.0 + threshold:
                regressions.append(
                    f"{cell}: {metric} regressed {ratio:.2f}x "
                    f"({old:.4g} -> {new:.4g})"
                )
            elif ratio < 1.0 - threshold:
                notes.append(
                    f"{cell}: {metric} improved {ratio:.2f}x "
                    f"({old:.4g} -> {new:.4g}) — consider --update-baseline"
                )
    for cell in sorted(set(new_cells) - set(base_cells)):
        regressions.append(
            f"{cell}: not in baseline (stale baseline — run --update-baseline)"
        )
    return regressions, notes


__all__ = [
    "BACKENDS",
    "BASELINE_METRICS",
    "BASELINE_THRESHOLD",
    "CARD_FACTORS",
    "CARD_SHAPES",
    "COST_SEEDS",
    "FAMILIES",
    "AuditResult",
    "CellArtifacts",
    "CostReport",
    "CostResult",
    "Finding",
    "Report",
    "SEED_RULES",
    "diff_baseline",
    "run_audit",
    "run_cost_audit",
]
