"""Structured findings — the common currency of every analysis pass
(counterpart of ``repro.analysis.findings``, of which it is a copy).

Each plan rule (:mod:`repro_torch.analysis.rules`) and each stencil-lint
check (:mod:`repro_torch.analysis.stencil_lint`) reports :class:`Finding`
records: the rule name, a severity, a human-readable message and, where
the rule has one, the offending construct (for the plan rule, the kernel
whose launch it checks) and where it sits.  The ``lint=`` knob on
:func:`repro_torch.create` / :func:`repro_torch.register_operator`
surfaces them as Python warnings (:class:`StencilLintWarning`) or raises
:class:`LintError`.
"""

from __future__ import annotations

import dataclasses
import warnings

ERROR = "error"
WARNING = "warning"
SEVERITIES = (ERROR, WARNING)

LINT_MODES = ("off", "warn", "error")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One violated rule (or lint check) on one target.

    ``primitive`` names the offending construct when the rule has one (the
    plan rule: the kernel whose launch it checks); ``computation`` is
    where it sits (the plan rule: the plan's class)."""

    rule: str
    severity: str
    message: str
    primitive: str | None = None
    computation: str | None = None

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {self.severity!r}"
            )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        where = ""
        if self.primitive:
            where += f" [primitive={self.primitive}"
            if self.computation:
                where += f" in {self.computation}"
            where += "]"
        return f"{self.rule} ({self.severity}): {self.message}{where}"


def errors(findings) -> list[Finding]:
    """The error-severity subset of ``findings``."""
    return [f for f in findings if f.severity == ERROR]


class StencilLintWarning(UserWarning):
    """Category of every ``lint='warn'`` diagnostic, so callers can filter
    them independently of other warnings."""


class LintError(ValueError):
    """Raised by ``lint='error'`` when any error-severity finding exists.

    Carries the findings on ``.findings`` for programmatic inspection."""

    def __init__(self, findings):
        self.findings = list(findings)
        lines = "\n  ".join(str(f) for f in self.findings)
        super().__init__(
            f"{len(self.findings)} lint error(s):\n  {lines}"
        )


def check_lint_mode(lint: str) -> str:
    if lint not in LINT_MODES:
        raise ValueError(
            f"lint must be one of {LINT_MODES}, got {lint!r}"
        )
    return lint


def surface(findings, lint: str, *, stacklevel: int = 3) -> None:
    """Deliver findings per the ``lint=`` knob.

    ``'off'`` drops them, ``'warn'`` emits each as a
    :class:`StencilLintWarning`, ``'error'`` raises :class:`LintError` on
    any error-severity finding (warning-severity ones still warn)."""
    check_lint_mode(lint)
    if lint == "off" or not findings:
        return
    errs = errors(findings)
    if lint == "error" and errs:
        raise LintError(errs)
    for f in findings:
        warnings.warn(str(f), StencilLintWarning, stacklevel=stacklevel)
