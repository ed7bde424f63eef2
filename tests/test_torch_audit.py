"""The port's audit gate on the CPU (counterpart of the reference's
``tests/test_analysis.py``: ``TestWalker``, ``TestJaxprRules``,
``TestDonationRule``, ``TestRetraceBudget``, ``TestAudit``,
``TestSpectralAudit`` and ``TestCostCli``).

The jaxpr walker becomes the op trace (:mod:`repro_torch.analysis.trace`),
the jaxpr rules trace rules, donation the ``in_place_evolve`` callable
rule and the retrace budget the ``rebuild_budget`` callable rule.  Each
rule is checked in both directions: a clean artifact passes, and a seeded
defect (a transposed copy, an fp64 upcast, a complex128 symbol, a host
sync, a driver that reallocates its carry, a re-measuring Create) is
reported with its rule and op named.  The audit runs with
``device='cpu'``: its ``cuda`` cells skip, and ``tests/test_torch_kernels_cuda.py``
audits them on the card.
"""

import json

import numpy as np
import pytest
import torch

import repro_torch.analysis as an
from repro_torch import api
from repro_torch.analysis import trace as T
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.core.cahn_hilliard import CahnHilliardADI, CHConfig, deep_quench_ic

# the four built-in operators: other test files register more in a shared
# worker process, which must not widen the audited matrix
BUILTINS = ("biharmonic", "diffusion", "hyperdiffusion", "laplacian")


# ---------------------------------------------------------------------------
# The trace (the walker)
# ---------------------------------------------------------------------------


class TestTrace:
    def test_records_ops_in_loop_trips(self):
        def f(x):
            for _ in range(2):
                with T.trip("evolve"):
                    x = (x.T @ x.T.T).contiguous()
            return x

        tr = T.trace(f, torch.eye(4, dtype=torch.float64))
        ops = an.all_ops(tr)
        assert "aten.mm.default" in ops
        assert "aten.permute.default" in ops or "aten.t.default" in ops
        trips = {op.trip for _, op in an.iter_ops(tr) if op.trip is not None}
        assert trips == {0, 1}

    def test_paths_name_enclosing_loops(self):
        def f(x):
            with T.trip("outer"):
                x = x + 1.0
            return x * 2.0

        paths = {op.name: path for path, op in an.iter_ops(
            T.trace(f, torch.zeros(4, dtype=torch.float64)))}
        assert paths["aten.add.Tensor"] == ("outer",)
        assert paths["aten.mul.Tensor"] == ()

    def test_view_copy_and_host_sync_flags(self):
        x = torch.zeros((8, 4), dtype=torch.float64)
        tr = T.trace(lambda v: v.T.contiguous().sum().item(), x)
        by = {op.name: op for op in tr.ops}
        assert by["aten.permute.default"].view
        assert by["aten.clone.default"].permuted_copy
        assert by["aten._local_scalar_dense.default"].host_sync
        # a slice is not a transpose: copying it materialises no permutation
        tr = T.trace(lambda v: v[:, 1:].contiguous(), x)
        assert not any(op.permuted_copy for op in tr.ops)

    def test_peak_counts_arguments_and_live_temporaries(self):
        x = torch.zeros(1024, dtype=torch.float64)
        tr = T.trace(lambda v: (v + 1.0) * 2.0, x)
        field = 1024 * 8
        # the argument, the add's result and the mul's result are live
        # together; the add's dies with the expression
        assert tr.argument_bytes == field
        assert tr.peak_bytes == 3 * field
        assert tr.output_bytes == field and tr.alias_bytes == 0

    def test_traces_do_not_nest(self):
        with pytest.raises(RuntimeError, match="already running"):
            T.trace(lambda v: T.trace(lambda w: w, v), torch.zeros(2))


# ---------------------------------------------------------------------------
# trace rules (the jaxpr rules)
# ---------------------------------------------------------------------------


class TestTraceRules:
    def test_no_transpose_clean(self):
        tr = T.trace(lambda x: x + 1.0, torch.zeros((4, 4)))
        assert an.check_trace(tr, ("no_transpose",)) == []

    def test_view_transpose_is_no_violation(self):
        """core/adi.py's apply_along_y applies a plan to field.T and takes
        .T back: both views, no copy."""
        tr = T.trace(lambda x: (x.T * 2.0).T, torch.zeros((4, 8)))
        assert an.check_trace(tr, ("no_transpose",)) == []

    def test_no_transpose_reports_op(self):
        tr = T.trace(lambda x: x.T.contiguous() + 1.0, torch.zeros((4, 8)))
        (f,) = an.check_trace(tr, ("no_transpose",))
        assert f.rule == "no_transpose"
        assert f.severity == an.ERROR
        assert f.primitive == "aten.clone.default"

    def test_device_kernel_list_is_read(self):
        tr = T.trace(lambda x: x + 1.0, torch.zeros((4, 4)))
        ctx = {"kernels": ["penta_rows_tile_kernel",
                           "void at::native::direct_copy_kernel_cuda"]}
        (f,) = an.check_trace(tr, ("no_transpose",), context=ctx)
        assert "direct_copy_kernel_cuda" in f.primitive

    def test_an_unread_kernel_list_fails_closed(self):
        """On the card a list that no profiler window recorded is an
        error, not a pass: the rule cannot say the device ran no copy."""
        tr = T.trace(lambda x: x + 1.0, torch.zeros((4, 4)))
        (f,) = an.check_trace(tr, ("no_transpose",),
                              context={"kernels": None})
        assert f.severity == an.ERROR and f.primitive == "torch.profiler"

    def test_upcast_flagged(self):
        tr = T.trace(lambda x: x.to(torch.float64) * 2.0,
                    torch.zeros(4, dtype=torch.float32))
        (f,) = an.check_trace(tr, ("no_dtype_upcast",))
        assert f.primitive == "aten._to_copy.default"
        assert "float32" in f.message and "float64" in f.message

    def test_downcast_and_python_scalars_ok(self):
        tr = T.trace(lambda x: x.to(torch.float32) + 1.5,
                    torch.zeros(4, dtype=torch.float64))
        assert an.check_trace(tr, ("no_dtype_upcast",)) == []

    def test_host_sync_flagged(self):
        tr = T.trace(lambda x: x.sum().item(), torch.zeros(4))
        findings = an.check_trace(tr, ("no_host_sync",))
        assert findings
        assert findings[0].primitive == "aten._local_scalar_dense.default"

    def test_sync_error_from_the_card_is_a_finding(self):
        tr = T.trace(lambda x: x + 1.0, torch.zeros(4))
        (f,) = an.check_trace(tr, ("no_host_sync",),
                              context={"sync_error": "called a synchronizing "
                                                     "CUDA operation"})
        assert f.rule == "no_host_sync" and "synchronizing" in f.message

    def test_unknown_rule_and_kind_mismatch_raise(self):
        tr = T.trace(lambda x: x, torch.zeros(2))
        with pytest.raises(ValueError, match="unknown rule"):
            an.check_trace(tr, ("no_such_rule",))
        with pytest.raises(ValueError, match="kind"):
            an.check_trace(tr, ("in_place_evolve",))


# ---------------------------------------------------------------------------
# callable rule: the in-place evolve driver (donation)
# ---------------------------------------------------------------------------


def _solver(n=32):
    solver = CahnHilliardADI(CHConfig(nx=n, ny=n, dt=1e-3, device="cpu"))
    c0 = deep_quench_ic(n, n, seed=0, device="cpu")
    return solver, c0, solver.initial_step(c0)


class TestInPlaceEvolve:
    def test_make_evolve_updates_in_place(self):
        solver, c0, c1 = _solver()
        ctx = {"args": (c1, c0), "steps": 4, "increment": solver._increment}
        assert an.RULES["in_place_evolve"].check(solver.make_evolve, ctx) == []

    def test_out_of_place_driver_fails(self):
        solver, c0, c1 = _solver()

        def make_copying(k):
            def evolve(a, b):
                for _ in range(k):
                    a, b = solver.step(a, b)
                return a, b
            return evolve

        ctx = {"args": (c1, c0), "steps": 4, "increment": solver._increment}
        findings = an.RULES["in_place_evolve"].check(make_copying, ctx)
        rules = {f.primitive for f in findings}
        assert {f.rule for f in findings} == {"in_place_evolve"}
        assert rules == {"data_ptr", "allocation"}


# ---------------------------------------------------------------------------
# callable rule: the rebuild budget (the retrace budget)
# ---------------------------------------------------------------------------


class TestRebuildBudget:
    def _creates(self, tmp_path, tune):
        from repro_torch.tune import TuneCache

        cache = TuneCache(tmp_path)
        x = torch.zeros((32, 32), dtype=torch.float64)

        # an ADI operator races each sweep's plain path against fft on the
        # CPU (a tiny stencil's race is pruned by the prior: no measurement)
        def create_and_compute(v):
            plan = api.create("hyperdiffusion", (32, 32), mode="adi",
                              alpha=0.2, lint="off", device="cpu", tune=tune,
                              tune_cache=cache)
            return api.compute(plan, v)

        return create_and_compute, [(x,)] * 3

    def test_identical_creates_measure_once(self, tmp_path):
        fn, argsets = self._creates(tmp_path, "cached")
        assert an.rebuild_count(fn, argsets) == 1

    def test_remeasuring_creates_trip_the_rule(self, tmp_path):
        fn, argsets = self._creates(tmp_path, "force")
        findings = an.RULES["rebuild_budget"].check(
            fn, {"argsets": argsets, "budget": 1})
        assert findings and findings[0].rule == "rebuild_budget"
        assert "3 builds" in findings[0].message


# ---------------------------------------------------------------------------
# the audit matrix + CLI (the fail-closed acceptance criteria)
# ---------------------------------------------------------------------------

_SUBSET = ["-q", "--device", "cpu", "--operators", "laplacian",
           "--families", "stencil2d", "--backends", "torch"]


class TestAudit:
    def test_subset_audit_is_clean(self):
        report = an.run_audit(
            operators=("laplacian",), families=("stencil2d",),
            backends=("torch",), retrace=False, device="cpu",
        )
        audited = [r for r in report.results if r.skipped is None]
        assert audited and report.ok

    def test_transpose_free_families_are_audited_for_it(self):
        report = an.run_audit(
            operators=("hyperdiffusion",), families=("adi2d", "fused_ch"),
            backends=("torch",), retrace=False, device="cpu",
        )
        audited = [r for r in report.results if r.skipped is None]
        assert len(audited) == 2 and report.ok
        for r in audited:
            assert "no_transpose" in r.rules
        fused = next(r for r in audited if r.family == "fused_ch")
        assert "in_place_evolve" in fused.rules

    def test_rebuild_probes_are_clean(self):
        report = an.run_audit(
            operators=BUILTINS, families=("stencil2d", "adi2d"),
            backends=("torch",), device="cpu",
        )
        probes = [r for r in report.results
                  if r.rules == ("rebuild_budget",) and r.skipped is None]
        assert [r.family for r in probes] == ["stencil2d", "adi2d"]
        assert report.ok

    def test_cuda_cells_need_a_card(self):
        report = an.run_audit(
            operators=("laplacian",), families=("stencil2d",),
            backends=("cuda",), retrace=False, device="cpu",
        )
        (cell,) = report.results
        assert cell.skipped == "needs a CUDA device"

    def test_device_defaults_to_the_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default runs")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            an.run_audit(operators=("laplacian",), families=("stencil2d",))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            an.run_cost_audit(operators=("laplacian",),
                              families=("stencil2d",))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            analysis_main(["-q", "--operators", "laplacian",
                           "--families", "stencil2d"])

    def test_cli_clean_subset_exits_zero(self, tmp_path):
        out = tmp_path / "report.json"
        rc = analysis_main(_SUBSET + ["--no-retrace", "--out", str(out)])
        assert rc == 0
        rep = json.loads(out.read_text())
        assert rep["ok"] and rep["violations"] == 0
        assert rep["meta"]["device"] == "cpu"
        assert rep["meta"]["torch"] == torch.__version__

    @pytest.mark.parametrize(
        "seed,primitive",
        [("transpose", "aten.clone.default"),
         ("upcast", "aten._to_copy.default")],
    )
    def test_cli_seeded_violation_fails_closed(self, tmp_path, seed, primitive):
        # the acceptance property: reintroduce the regression, the gate
        # must exit nonzero and name the offending op in its report
        out = tmp_path / f"seed_{seed}.json"
        rc = analysis_main([
            "-q", "--device", "cpu", "--families", "adi2d", "--operators",
            "hyperdiffusion", "--backends", "torch", "--no-retrace",
            "--seed-violation", seed, "--out", str(out),
        ])
        assert rc == 1
        rep = json.loads(out.read_text())
        assert not rep["ok"]
        named = [
            f["primitive"]
            for r in rep["results"] if not r["ok"]
            for f in r["findings"]
        ]
        assert primitive in named

    def test_cli_list_rules(self, capsys):
        assert analysis_main(["--list-rules"]) == 0
        out = capsys.readouterr().out
        for name in ("no_transpose", "in_place_evolve", "rebuild_budget",
                     "device_time_budget", "launch_geometry_feasible"):
            assert name in out


class TestSpectralAudit:
    """The fft backend column of the audit matrix."""

    def test_fft_backend_cells_are_clean(self):
        report = an.run_audit(
            operators=("laplacian", "hyperdiffusion"),
            families=("stencil2d", "adi2d"),
            backends=("fft",), retrace=False, device="cpu",
        )
        audited = [r for r in report.results if r.skipped is None]
        assert audited and report.ok
        # the fft dtype contract is audited on every cell
        assert all("no_dtype_upcast" in r.rules for r in audited)

    def test_fft_cells_do_not_claim_transpose_freedom(self):
        report = an.run_audit(
            operators=("hyperdiffusion",), families=("adi2d",),
            backends=("fft",), retrace=False, device="cpu",
        )
        (cell,) = [r for r in report.results if r.skipped is None]
        assert "no_transpose" not in cell.rules and cell.ok

    def test_seeded_complex128_promotion_is_caught_and_named(self):
        """The fp32 rfft path rides complex64; a buggy symbol multiply
        that lets a complex128 symbol promote the pipeline must trip
        no_dtype_upcast with the widening named."""
        from repro_torch.kernels import spectral

        x32 = torch.zeros((16, 16), dtype=torch.float32)
        sym128 = torch.as_tensor(np.fft.rfftn(np.ones((16, 16))),
                                 dtype=torch.complex128)

        def buggy(v):  # skips spectral._cast_symbol — the seeded defect
            f = torch.fft.rfftn(v, dim=(-2, -1))
            return torch.fft.irfftn(f * sym128, s=(16, 16),
                                    dim=(-2, -1)).to(v.dtype)

        findings = an.check_trace(T.trace(buggy, x32), ("no_dtype_upcast",))
        assert findings, "the seeded complex128 promotion went unflagged"
        assert "complex128" in findings[0].message

        # and the shipped path is clean: apply_symbol narrows the symbol
        # to the field's complex counterpart instead of promoting
        clean = an.check_trace(
            T.trace(lambda v: spectral.apply_symbol(v, sym128, (-2, -1)), x32),
            ("no_dtype_upcast",),
        )
        assert clean == []


# ---------------------------------------------------------------------------
# The cost audit CLI (--cost / baselines)
# ---------------------------------------------------------------------------

_COST_CLI = _SUBSET + ["--no-retrace", "--cost"]


class TestCostCli:
    def test_clean_cost_subset_exits_zero(self, tmp_path):
        out = tmp_path / "cost.json"
        rc = analysis_main(_COST_CLI + ["--cost-out", str(out)])
        assert rc == 0
        rep = json.loads(out.read_text())
        assert rep["ok"] and rep["violations"] == 0
        cell = rep["cells"]["stencil2d/laplacian/torch"]
        assert cell["measured"]["flops"] > 0
        assert cell["measured"]["bytes"] > 0
        assert cell["measured"]["peak_memory"] > 0
        assert cell["measured"]["device_ms"] is None
        assert cell["flops_bloat"] >= 1.0

    def test_report_meta_fingerprinted(self, tmp_path):
        out = tmp_path / "cost.json"
        assert analysis_main(_COST_CLI + ["--cost-out", str(out)]) == 0
        meta = json.loads(out.read_text())["meta"]
        assert meta["schema_version"] >= 2
        assert meta["torch"] == torch.__version__
        assert meta["device"] == "cpu" and meta["card"] is None
        assert meta["host"]

    @pytest.mark.parametrize(
        "seed,rule",
        [
            ("transpose_copy", "bytes_budget"),
            ("double_buffer", "peak_memory_budget"),
        ],
    )
    def test_cost_seeded_violation_fails_closed(self, tmp_path, seed, rule):
        out = tmp_path / f"cost_{seed}.json"
        rc = analysis_main(
            _COST_CLI + ["--seed-violation", seed, "--cost-out", str(out)]
        )
        assert rc == 1
        rep = json.loads(out.read_text())
        assert not rep["ok"]
        named = [
            f["rule"]
            for c in rep["cells"].values() if not c["ok"]
            for f in c["findings"]
        ]
        assert rule in named

    def test_cost_seed_requires_cost_mode(self):
        with pytest.raises(SystemExit):
            analysis_main(_SUBSET + ["--seed-violation", "transpose_copy"])

    def test_baseline_roundtrip_then_tamper_regresses(
        self, tmp_path, monkeypatch
    ):
        monkeypatch.chdir(tmp_path)  # keep ANALYSIS_costs_torch.json scratch
        baseline = tmp_path / "ANALYSIS_costs_torch.json"
        assert analysis_main(_COST_CLI + ["--update-baseline"]) == 0
        assert baseline.exists()
        # unchanged code vs its own baseline: no regression, exit 0
        assert analysis_main(_COST_CLI) == 0
        # pretend history claimed half the bytes: >10% drift must fail
        doc = json.loads(baseline.read_text())
        cell = doc["cells"]["stencil2d/laplacian/torch"]
        cell["measured"]["bytes"] /= 2.0
        baseline.write_text(json.dumps(doc))
        assert analysis_main(_COST_CLI) == 1

    def test_a_card_run_does_not_overwrite_the_cpu_baseline(
        self, tmp_path, monkeypatch, capsys
    ):
        """On the card (the default device) ``--update-baseline`` needs
        ``--baseline``: the default file holds the CPU's vectors."""
        monkeypatch.chdir(tmp_path)
        argv = [a for a in _COST_CLI if a not in ("--device", "cpu")]
        with pytest.raises(SystemExit):
            analysis_main(argv + ["--update-baseline"])
        assert "needs --baseline" in capsys.readouterr().err
        assert not (tmp_path / "ANALYSIS_costs_torch.json").exists()

    def test_committed_baseline_matches_current_code(self, repo_baseline):
        # the fail-closed gate: the checked-in ANALYSIS_costs_torch.json
        # still describes this tree for the smoke cell
        rep = an.run_cost_audit(
            operators=("laplacian",), families=("stencil2d",),
            backends=("torch",), device="cpu",
        )
        regs, _ = an.diff_baseline(rep.to_dict(), repo_baseline)
        assert regs == [], regs

    def test_a_card_run_is_not_diffed_against_the_cpu_baseline(
            self, repo_baseline):
        rep = an.run_cost_audit(
            operators=("laplacian",), families=("stencil2d",),
            backends=("torch",), device="cpu",
        ).to_dict()
        rep["meta"]["device"] = "cuda"
        regs, _ = an.diff_baseline(rep, repo_baseline)
        assert regs and "baseline measured on cpu" in regs[0]


@pytest.fixture
def repo_baseline():
    import pathlib

    path = (pathlib.Path(__file__).resolve().parents[1]
            / "ANALYSIS_costs_torch.json")
    assert path.exists(), "committed cost baseline is part of the gate"
    return json.loads(path.read_text())
