"""The declarative rule engine over plans (counterpart of the plan kind of
``repro.analysis.rules``).

cuSten's Create/Compute split makes a plan's launchability a Create-time
property: each rule checks one such property of a plan for a field shape
and returns structured :class:`~repro_torch.analysis.findings.Finding`
records.

============================ ====== ======================================
rule                         kind   violated when
============================ ====== ======================================
``launch_geometry_feasible`` plan   the plan's halo is wider than the
                                    field, an ADI operator's bands do not
                                    match the shape, or its tuned launch
                                    geometry is one the card cannot launch
                                    for that shape
============================ ====== ======================================

:func:`rule` registers more rules (anything registered here takes part in
:func:`check_plan`).  The reference's jaxpr, HLO, callable and cost kinds
read jaxprs, compiled HLO and XLA's cost analysis, and are not here
(ROADMAP.md, Open items: Audit and HLO rules).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

from repro_torch.analysis.findings import ERROR, Finding

__all__ = ["RULES", "Rule", "check_plan", "rule"]


@dataclasses.dataclass(frozen=True)
class Rule:
    """One declarative invariant: ``kind`` picks the artifact the rule
    inspects (``'plan'``, a plan object); ``check`` takes ``(target,
    context_dict)`` and returns a list of findings."""

    name: str
    kind: str
    doc: str
    check: Callable


RULES: dict[str, Rule] = {}


def rule(name: str, kind: str, doc: str = ""):
    """Register a rule (decorator).  User rules compose with the built-in
    one: anything registered here takes part in ``check_plan``."""

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


def check_plan(plan, shape, rules=None, *, context=None) -> list[Finding]:
    """Run plan-kind rules (all of them by default) on a plan object for
    fields of ``shape``."""
    ctx = dict(context or {})
    ctx.setdefault("shape", tuple(shape))
    findings = []
    for r in _resolve(rules, "plan"):
        findings.extend(r.check(plan, ctx))
    return findings


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
