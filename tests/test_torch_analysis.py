"""repro_torch.analysis against repro.analysis on the CPU: stencil lint, the
``lint=`` knobs of ``register_operator`` and ``create``, the findings
plumbing and the plan probes (``grid_problems`` and the
``launch_geometry_feasible`` rule).

Parity: the same numpy weights and bands go through both packages' checks,
which must report the same rules with the same severities, as many times.
The reference's tile case (``create(tile=...)``) becomes the port's
launch geometry, which a tuned plan carries in ``plan.geometry``; the port
has no ``create(tile=)``.  Off the card a plan launches no kernel, so any
geometry it carries is a problem here; one the card cannot launch is
checked against the card's own limits in ``tests/test_torch_kernels_cuda.py``.
"""

import dataclasses
import re
import warnings
from pathlib import Path

import numpy as np
import pytest

import repro
import repro.analysis as ran
from repro import api as rapi
import repro_torch as rt
import repro_torch.analysis as an
from repro_torch import api
from repro_torch.api import _REGISTRY

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def scratch_op():
    """Unique operator names, registered in the port and unregistered on
    exit."""
    created = []

    def _register(name, **kw):
        created.append(name)
        return api.register_operator(name, **kw)

    yield _register
    for name in created:
        _REGISTRY.pop(name, None)


def _summary(findings):
    return sorted((f.rule, f.severity) for f in findings)


# ---------------------------------------------------------------------------
# stencil lint
# ---------------------------------------------------------------------------


class TestStencilLint:
    def test_builtin_weights_pass_moments(self):
        for name, ndim in (
            ("laplacian", 1), ("laplacian", 2), ("laplacian", 3),
            ("biharmonic", 1), ("biharmonic", 2),
        ):
            opdef = api.get_operator(name)
            assert an.lint_operator(opdef, ndim=ndim) == [], (name, ndim)

    def test_builtins_declare_the_reference_properties(self):
        for name in ("laplacian", "biharmonic", "hyperdiffusion", "diffusion"):
            mine, ref = api.get_operator(name), rapi.get_operator(name)
            assert (mine.derivative, mine.symmetric, mine.zero_sum) == (
                ref.derivative, ref.symmetric, ref.zero_sum), name

    def test_corrupted_weights_fail_moments(self):
        w = np.array([1.0, -2.0, 1.0]) * 1.01  # wrong second moment
        findings = an.check_moments(w, 2, name="broken")
        assert findings and findings[0].rule == "stencil_moments"
        assert all(f.severity == an.ERROR for f in findings)

    def test_moment_check_respects_h_scaling(self):
        h = 0.25
        assert an.check_moments(np.array([1.0, -2.0, 1.0]) / h**2, 2, h=h) == []

    def test_odd_derivative_in_2d_warns_and_skips(self):
        (f,) = an.check_moments(np.zeros((3, 3)), 1, name="ddx")
        assert f.severity == an.WARNING and "skipped" in f.message

    def test_asymmetric_weights_fail_symmetry(self):
        findings = an.check_symmetry(np.array([1.0, -2.0, 1.5]))
        assert findings and findings[0].rule == "stencil_symmetry"

    def test_nonzero_sum_fails_zero_sum(self):
        findings = an.check_zero_sum(np.array([1.0, -1.9, 1.0]))
        assert findings and findings[0].rule == "stencil_zero_sum"

    def test_adi_topology_mismatches(self):
        opdef = api.get_operator("hyperdiffusion")
        warn = an.lint_adi(opdef, 32, 0.2, bc="periodic", cyclic=False)
        assert any(f.rule == "adi_topology" and f.severity == an.WARNING
                   for f in warn)
        err = an.lint_adi(opdef, 32, 0.2, bc="np", cyclic=True)
        assert any(f.rule == "adi_topology" and f.severity == an.ERROR
                   for f in err)
        clean = an.lint_adi(opdef, 32, 0.2, bc="periodic", cyclic=True)
        assert an.errors(clean) == []

    def test_adi_negative_alpha_warns(self):
        opdef = api.get_operator("hyperdiffusion")
        findings = an.lint_adi(opdef, 32, -0.1, bc="periodic", cyclic=True)
        assert any(f.rule == "adi_alpha_sign" for f in findings)

    def test_adi_singular_bands_error(self, scratch_op):
        def null_bands(n, alpha, dtype=np.float64):
            z = np.zeros(n, dtype)
            return z, z, z.copy(), z, z

        opdef = scratch_op("_lint_null_band", diagonals=null_bands)
        findings = an.lint_adi(opdef, 32, 0.2, bc="periodic", cyclic=True)
        assert any(f.rule == "adi_band_singular" and f.severity == an.ERROR
                   for f in findings)


# the same weights through both packages' checks: seeded random
# perturbations of the built-in stencils and a few hand-broken ones
_RNG = np.random.default_rng(21)
_WEIGHT_CASES = {
    "d2 ok": (np.array([1.0, -2.0, 1.0]), 2),
    "d2 scaled": (np.array([1.0, -2.0, 1.0]) * 1.01, 2),
    "d4 ok": (np.array([1.0, -4.0, 6.0, -4.0, 1.0]), 4),
    "d4 noisy": (np.array([1.0, -4.0, 6.0, -4.0, 1.0])
                 + 1e-3 * _RNG.standard_normal(5), 4),
    "lap2 noisy": (np.array([[0.0, 1, 0], [1, -4, 1], [0, 1, 0]])
                   + 1e-4 * _RNG.standard_normal((3, 3)), 2),
    "bih2 ok": (np.asarray(rapi.get_operator("biharmonic").weights(2)), 4),
    "lap3 random": (_RNG.standard_normal((3, 3, 3)), 2),
    "odd 2d": (_RNG.standard_normal((3, 3)), 1),
    "odd 1d": (np.array([-0.5, 0.0, 0.5]), 1),
}


@pytest.mark.parametrize("case", sorted(_WEIGHT_CASES))
def test_weight_findings_match_reference(case):
    w, d = _WEIGHT_CASES[case]
    for check in ("check_moments", "check_symmetry", "check_zero_sum"):
        args = (w, d) if check == "check_moments" else (w,)
        mine = getattr(an, check)(*args)
        ref = getattr(ran, check)(*args)
        assert _summary(mine) == _summary(ref), (case, check)
        assert [str(f) for f in mine] == [str(f) for f in ref], (case, check)


_BAND_CASES = [
    # operator, n, alpha, bc, cyclic
    ("hyperdiffusion", 32, 0.2, "periodic", True),
    ("hyperdiffusion", 32, 0.2, "periodic", False),
    ("hyperdiffusion", 32, 0.2, "np", True),
    ("hyperdiffusion", 32, -0.1, "periodic", True),
    ("hyperdiffusion", 64, -0.0625, "periodic", True),  # singular symbol
    ("diffusion", 48, 0.3, "periodic", True),
    ("diffusion", 48, -0.25, "periodic", True),  # singular at theta = pi
    ("diffusion", 5, 0.3, "np", False),
    # the 1024^2 Cahn-Hilliard solver's full-step operator: near-singular
    # relative to its largest coefficient in both packages' band lint
    ("hyperdiffusion", 1024,
     (2.0 / 3.0) * 0.6 * 0.01 * 1e-3 / (2.0 * np.pi / 1024) ** 4,
     "periodic", True),
]


@pytest.mark.parametrize("case", range(len(_BAND_CASES)))
def test_band_findings_match_reference(case):
    name, n, alpha, bc, cyclic = _BAND_CASES[case]
    mine = an.lint_adi(api.get_operator(name), n, alpha, bc=bc,
                       cyclic=cyclic, direction="x")
    ref = ran.lint_adi(rapi.get_operator(name), n, alpha, bc=bc,
                       cyclic=cyclic, direction="x")
    assert _summary(mine) == _summary(ref)
    assert [str(f) for f in mine] == [str(f) for f in ref]


# ---------------------------------------------------------------------------
# the lint= knobs
# ---------------------------------------------------------------------------


class TestLintKnobs:
    BAD = staticmethod(lambda ndim=1, h=1.0: np.array([1.0, -2.0, 1.5]))

    def test_register_error_raises_with_findings(self, scratch_op):
        with pytest.raises(an.LintError) as exc:
            scratch_op(
                "_lint_bad_err", weights=self.BAD, symmetric=True,
                zero_sum=True, lint="error",
            )
        assert any(f.rule == "stencil_symmetry" for f in exc.value.findings)
        assert "_lint_bad_err" not in _REGISTRY

    def test_register_warn_and_off(self, scratch_op):
        with pytest.warns(an.StencilLintWarning):
            scratch_op(
                "_lint_bad_warn", weights=self.BAD, symmetric=True,
                lint="warn",
            )
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            scratch_op(
                "_lint_bad_off", weights=self.BAD, symmetric=True,
                lint="off",
            )

    def test_register_wrong_derivative_matches_reference(self, scratch_op):
        """A declared derivative the weights do not have: the same findings
        in both registries (the reference's entry is removed again)."""
        kw = dict(weights=lambda ndim=1, h=1.0: np.array([1.0, -2.0, 1.0]),
                  derivative=4)
        with pytest.raises(an.LintError) as mine:
            scratch_op("_lint_bad_deriv", lint="error", **kw)
        try:
            with pytest.raises(ran.LintError) as ref:
                rapi.register_operator("_lint_bad_deriv", lint="error", **kw)
        finally:
            rapi._REGISTRY.pop("_lint_bad_deriv", None)
        assert _summary(mine.value.findings) == _summary(ref.value.findings)

    def test_create_flags_infeasible_geometry(self):
        """The reference's infeasible ``tile``: a plan carrying a launch
        geometry it cannot launch (here, any geometry on a plan off the
        card) is flagged by the plan rule at the lint knob's severity."""
        plan = rt.create(np.ones((1, 9)), (8, 1024), device="cpu",
                         lint="off")
        bad = dataclasses.replace(plan, geometry={"route": "direct"})
        findings = an.check_plan(bad, (8, 1024))
        assert [f.rule for f in findings] == ["launch_geometry_feasible"]
        assert findings[0].primitive == "stencil2d"
        assert "off the card" in findings[0].message
        with pytest.warns(an.StencilLintWarning, match="geometry"):
            an.surface(findings, "warn")
        with pytest.raises(an.LintError):
            an.surface(findings, "error")
        assert an.check_plan(plan, (8, 1024)) == []

    def test_create_flags_halo_wider_than_field(self):
        with pytest.warns(an.StencilLintWarning, match="wider than the domain"):
            rt.create("biharmonic", (1, 1), device="cpu")
        with pytest.raises(an.LintError):
            rt.create("biharmonic", (1, 1), lint="error", device="cpu")
        rt.create("biharmonic", (1, 1), lint="off", device="cpu")

    def test_create_adi_topology_lint(self):
        with pytest.warns(an.StencilLintWarning, match="topology|wrap"):
            rt.create(
                "hyperdiffusion", (32, 32), mode="adi", alpha=0.2,
                bc="periodic", cyclic=False, device="cpu",
            )

    def test_default_solver_lint_matches_reference(self):
        """A default solver at the main path's 1024^2 warns what the
        reference's warns: ``adi_band_singular`` on both sweeps of both
        operators and no plan finding (the set ``chip_smoke.py`` asserts
        on the card)."""
        import repro.core.cahn_hilliard as rch

        from repro_torch.core.cahn_hilliard import CahnHilliardADI, CHConfig

        def rules(make):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                make()
            return sorted(
                re.match(r"(\w+) \((\w+)\):", str(w.message)).groups()
                for w in caught
                if issubclass(w.category, (an.StencilLintWarning,
                                           ran.StencilLintWarning)))

        mine = rules(lambda: CahnHilliardADI(CHConfig(nx=1024, ny=1024,
                                                      device="cpu")))
        ref = rules(lambda: rch.CahnHilliardADI(rch.CHConfig(nx=1024,
                                                             ny=1024)))
        assert mine == ref == [("adi_band_singular", "warning")] * 4

    def test_create_lint_is_clean_on_the_main_path(self):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            rt.create("biharmonic", (32, 32), device="cpu")
            rt.create("laplacian", (8, 12, 16), device="cpu")
            rt.create("laplacian", (16, 32), mode="batch", device="cpu")
            rt.create("hyperdiffusion", (32, 32), mode="adi", alpha=0.2,
                      device="cpu")

    def test_invalid_lint_mode_rejected(self):
        with pytest.raises(ValueError, match="lint"):
            rt.create("laplacian", (16, 16), lint="loud", device="cpu")
        with pytest.raises(ValueError, match="lint"):
            rt.register_operator("_never", weights=self.BAD, lint="loud")
        assert "_never" not in _REGISTRY

    def test_lint_defaults_match_reference(self):
        import inspect

        for fn in ("create", "register_operator"):
            mine = inspect.signature(getattr(rt, fn)).parameters["lint"]
            ref = inspect.signature(getattr(repro, fn)).parameters["lint"]
            assert mine.default == ref.default == "warn"


# ---------------------------------------------------------------------------
# findings plumbing
# ---------------------------------------------------------------------------


class TestFindings:
    def test_severity_validated(self):
        with pytest.raises(ValueError):
            an.Finding(rule="r", severity="fatal", message="m")

    def test_str_and_dict(self):
        f = an.Finding(
            rule="launch_geometry_feasible", severity=an.ERROR, message="m",
            primitive="stencil2d", computation="Stencil2D",
        )
        assert "stencil2d" in str(f) and "Stencil2D" in str(f)
        assert f.to_dict()["primitive"] == "stencil2d"
        ref = ran.Finding(rule="launch_geometry_feasible", severity=ran.ERROR,
                          message="m", primitive="stencil2d",
                          computation="Stencil2D")
        assert str(f) == str(ref) and f.to_dict() == ref.to_dict()

    def test_surface_modes(self):
        f = an.Finding(rule="r", severity=an.ERROR, message="m")
        an.surface([f], "off")
        with pytest.warns(an.StencilLintWarning):
            an.surface([f], "warn")
        with pytest.raises(an.LintError):
            an.surface([f], "error")

    def test_unknown_rule_and_kind_mismatch_raise(self):
        plan = rt.create("laplacian", (8, 8), device="cpu")
        with pytest.raises(ValueError, match="unknown rule"):
            an.check_plan(plan, (8, 8), ("no_such_rule",))

        @an.rule("_test_other_kind", "jaxpr")
        def _other(target, ctx):
            return []

        try:
            with pytest.raises(ValueError, match="kind"):
                an.check_plan(plan, (8, 8), ("_test_other_kind",))
        finally:
            an.RULES.pop("_test_other_kind")


# ---------------------------------------------------------------------------
# plan probes
# ---------------------------------------------------------------------------


class TestGridProblems:
    def test_halo_wider_than_domain(self):
        plan = rt.create("biharmonic", (32, 32), lint="off", device="cpu")
        assert plan.grid_problems((1, 1))
        assert plan.grid_problems((32, 32)) == []
        ref = repro.create("biharmonic", (32, 32), lint="off")
        assert len(plan.grid_problems((1, 1))) == len(ref.grid_problems((1, 1)))

    def test_batch_and_3d_halo(self):
        b = rt.create("biharmonic", (4, 16), mode="batch", device="cpu")
        assert b.grid_problems((4, 1)) and b.grid_problems((4, 16)) == []
        p3 = rt.create("laplacian", (8, 8, 8), device="cpu")
        assert p3.grid_problems((8, 8, 8)) == []
        assert p3.grid_problems((1, 8, 8)) == [] and p3.grid_problems((0, 8, 8))

    def test_adi_shape_mismatch(self):
        op = rt.create(
            "hyperdiffusion", (32, 48), mode="adi", alpha=0.2, lint="off",
            device="cpu",
        )
        assert op.grid_problems((32, 48)) == []
        assert op.grid_problems((48, 32))
        op3 = rt.create("diffusion", (8, 12, 16), mode="adi", alpha=0.2,
                        device="cpu")
        assert op3.grid_problems((8, 12, 16)) == []
        assert op3.grid_problems((16, 12, 8))

    @pytest.mark.parametrize("family", ["2d", "batch", "3d", "adi", "adi3d"])
    def test_infeasible_tuned_geometry_is_reported(self, family):
        """A launch geometry on a plan or operator off the card, on each
        family, is reported on the host: the CPU launches no kernel (the
        geometries the card cannot launch are the card tests')."""
        if family == "2d":
            plan = rt.create(np.ones((1, 9)), (8, 1024), device="cpu")
            bad = dataclasses.replace(plan, geometry={"route": "tile"})
            shape = (8, 1024)
        elif family == "batch":
            plan = rt.create(np.ones(5), (4, 512), mode="batch",
                             device="cpu")
            bad = dataclasses.replace(plan, geometry={"route": "y",
                                                      "param": 16})
            shape = (4, 512)
        elif family == "3d":
            plan = rt.create("laplacian", (8, 8, 8), device="cpu")
            bad = dataclasses.replace(plan, geometry={"route": "tile",
                                                      "zc": 8})
            shape = (8, 8, 8)
        elif family == "adi":
            plan = rt.create("hyperdiffusion", (32, 64), mode="adi",
                             alpha=0.2, device="cpu")
            bad = dataclasses.replace(plan, x_cfg={
                "backend": "auto", "geometry": {"rows": 1, "depth": 1}})
            shape = (32, 64)
        else:
            plan = rt.create("diffusion", (8, 12, 16), mode="adi", alpha=0.2,
                             device="cpu")
            bad = dataclasses.replace(plan, y_cfg={
                "backend": "auto", "geometry": {"cols": 8}})
            shape = (8, 12, 16)
        assert plan.grid_problems(shape) == []
        problems = bad.grid_problems(shape)
        assert len(problems) == 1 and "tuned geometry" in problems[0]
        assert "off the card" in problems[0]


# ---------------------------------------------------------------------------
# the surface: what the port has and what waits for its ROADMAP.md item
# ---------------------------------------------------------------------------

# the reference's names that read jaxprs, HLO or XLA's cost analysis
_AUDIT_AND_HLO = (
    "run_audit", "run_cost_audit", "diff_baseline",
    "analyze_hlo", "measure_compiled", "memory_stats",
    "check_jaxpr", "check_hlo", "check_cost",
    "iter_eqns", "retrace_count", "all_primitives", "BUDGET_FACTORS",
    "LoopCost", "CostVector",
)


def test_analysis_surface_against_reference():
    """Every name of the reference's ``repro.analysis`` is exported by the
    port, but for the Audit and HLO names, which are absent and listed
    under that ROADMAP.md item."""
    mine, ref = set(an.__all__), set(ran.__all__)
    audit_only = {"BACKENDS", "COST_SEEDS", "FAMILIES", "AuditResult",
                  "CellArtifacts", "CostReport", "CostResult", "Report"}
    assert ref - mine == set(_AUDIT_AND_HLO) | audit_only
    assert mine <= ref
    for name in _AUDIT_AND_HLO:
        assert not hasattr(an, name), name
    roadmap = (ROOT / "ROADMAP.md").read_text()
    item = re.search(r"\d+\. \*\*Audit and HLO rules\.\*\*(.+?)\n\d+\. \*\*",
                     roadmap, re.S)
    assert item, "ROADMAP.md has no 'Audit and HLO rules' item"
    for name in _AUDIT_AND_HLO:
        assert f"`{name}`" in item.group(1), name
