"""Static analysis for plans and operators (counterpart of the host-only half
of ``repro.analysis``): findings, stencil lint, the plan rule, the analytic
cost floors and the concurrency lint.

- :mod:`repro_torch.analysis.findings` — :class:`Finding`, the ``lint=``
  modes and how findings surface (warnings or :class:`LintError`).
- :mod:`repro_torch.analysis.stencil_lint` — Create/register-time operator
  checks (moment/Taylor conditions, symmetry, zero row sum, ADI band
  topology and conditioning), surfaced via the ``lint=`` knob on
  :func:`repro_torch.create` / :func:`repro_torch.register_operator`.
- :mod:`repro_torch.analysis.rules` — the plan rule
  ``launch_geometry_feasible`` (the reference's ``pallas_grid_feasible``)
  and the registry it lives in.
- :mod:`repro_torch.analysis.cost` — the closed-form floors
  (:func:`expected_stencil`, :func:`expected_fft`, :func:`expected_penta`,
  :func:`expected_ch_step`) that :mod:`repro_torch.tune.prior` scores
  with.
- :mod:`repro_torch.analysis.concurrency` — the stdlib ``ast`` lint of the
  serving and runtime classes' locking (``python -m
  repro_torch.analysis.concurrency PATH...``).

The reference's audit matrix, its jaxpr/HLO/cost rules and its HLO cost
parser are not ported (ROADMAP.md, Open items: Audit and HLO rules).
"""

from __future__ import annotations

from repro_torch.analysis.cost import (
    Expected,
    expected_ch_step,
    expected_fft,
    expected_penta,
    expected_stencil,
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
from repro_torch.analysis.rules import RULES, Rule, check_plan, rule
from repro_torch.analysis.stencil_lint import (
    check_moments,
    check_symmetry,
    check_zero_sum,
    lint_adi,
    lint_operator,
)

__all__ = [
    "ERROR",
    "LINT_MODES",
    "RULES",
    "SEVERITIES",
    "WARNING",
    "Expected",
    "Finding",
    "LintError",
    "Rule",
    "StencilLintWarning",
    "check_lint_mode",
    "check_moments",
    "check_plan",
    "check_symmetry",
    "check_zero_sum",
    "errors",
    "expected_ch_step",
    "expected_fft",
    "expected_penta",
    "expected_stencil",
    "lint_adi",
    "lint_operator",
    "rule",
    "surface",
]
