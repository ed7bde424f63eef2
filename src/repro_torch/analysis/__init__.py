"""Static analysis for plans and operators (counterpart of
``repro.analysis``): invariant rules over op traces, plans, callables and
measured costs, stencil lint, the audit matrix and the concurrency lint.

- :mod:`repro_torch.analysis.trace` — the op trace of one call (every aten
  op and kernel launch): the counterpart of the jaxpr walker.
- :mod:`repro_torch.analysis.rules` — the declarative invariant engine
  over traces, plans, callables and cost vectors (``no_transpose``,
  ``no_dtype_upcast``, ``no_host_sync``, ``in_place_evolve``,
  ``rebuild_budget``, ``launch_geometry_feasible``, the budgets).
- :mod:`repro_torch.analysis.cost` — the closed-form floors and the
  measured cost vector of one call.
- :mod:`repro_torch.analysis.stencil_lint` — Create/register-time operator
  checks (moment/Taylor conditions, symmetry, zero row sum, ADI band
  topology and conditioning), surfaced via the ``lint=`` knob on
  :func:`repro_torch.create` / :func:`repro_torch.register_operator`.
- :mod:`repro_torch.analysis.audit` — the operator × plan-family × backend
  matrix behind ``python -m repro_torch.analysis``, the fail-closed gate.
- :mod:`repro_torch.analysis.concurrency` — the stdlib ``ast`` lint of the
  serving and runtime classes' locking (``python -m
  repro_torch.analysis.concurrency PATH...``).

The reference's names that read jaxprs, compiled HLO or XLA's cost
analysis, and what stands for each here:

===================== ===================== ==============================
reference             port                  why
===================== ===================== ==============================
``run_audit``         ``run_audit``         same driver, ``device=``
``run_cost_audit``    ``run_cost_audit``    same driver, ``device=``
``diff_baseline``     ``diff_baseline``     same semantics
``measure_compiled``  ``measure``           reads an op trace, not HLO
``memory_stats``      ``memory_stats``      the trace's live storages
``LoopCost``          ``LoopCost``          a driver loop's trips
``CostVector``        ``CostVector``        adds ``device_ms``
``check_jaxpr``       ``check_trace``       an op trace, not a jaxpr
``iter_eqns``         ``iter_ops``          walks the trace's ops
``all_primitives``    ``all_ops``           the trace's op names
``retrace_count``     ``rebuild_count``     library loads and tune races
``check_cost``        ``check_cost``        same rules, plus device time
``BUDGET_FACTORS``    ``BUDGET_FACTORS``    plus ``device_time``
``analyze_hlo``       N/A                   eager PyTorch compiles no HLO
``check_hlo``         N/A                   no HLO to read; donation is
                                            the callable rule
                                            ``in_place_evolve``
===================== ===================== ==============================
"""

from __future__ import annotations

from repro_torch.analysis.audit import (
    BACKENDS,
    COST_SEEDS,
    FAMILIES,
    AuditResult,
    CellArtifacts,
    CostReport,
    CostResult,
    Report,
    diff_baseline,
    run_audit,
    run_cost_audit,
)
from repro_torch.analysis.cost import (
    CostVector,
    Expected,
    LoopCost,
    expected_ch_step,
    expected_fft,
    expected_penta,
    expected_stencil,
    measure,
    memory_stats,
)
from repro_torch.analysis.findings import (
    ERROR,
    LINT_MODES,
    SEVERITIES,
    WARNING,
    Finding,
    LintError,
    StencilLintWarning,
    check_lint_mode,
    errors,
    surface,
)
from repro_torch.analysis.rules import (
    BUDGET_FACTORS,
    RULES,
    Rule,
    check_cost,
    check_plan,
    check_trace,
    rebuild_count,
    rule,
)
from repro_torch.analysis.stencil_lint import (
    check_moments,
    check_symmetry,
    check_zero_sum,
    lint_adi,
    lint_operator,
)
from repro_torch.analysis.trace import all_ops, iter_ops

__all__ = [
    "BACKENDS",
    "BUDGET_FACTORS",
    "COST_SEEDS",
    "ERROR",
    "FAMILIES",
    "LINT_MODES",
    "RULES",
    "SEVERITIES",
    "WARNING",
    "AuditResult",
    "CellArtifacts",
    "CostReport",
    "CostResult",
    "CostVector",
    "Expected",
    "Finding",
    "LintError",
    "LoopCost",
    "Report",
    "Rule",
    "StencilLintWarning",
    "all_ops",
    "check_cost",
    "check_lint_mode",
    "check_moments",
    "check_plan",
    "check_symmetry",
    "check_trace",
    "check_zero_sum",
    "diff_baseline",
    "errors",
    "expected_ch_step",
    "expected_fft",
    "expected_penta",
    "expected_stencil",
    "iter_ops",
    "lint_adi",
    "lint_operator",
    "measure",
    "memory_stats",
    "rebuild_count",
    "rule",
    "run_audit",
    "run_cost_audit",
    "surface",
]
