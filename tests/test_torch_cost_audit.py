"""The port's measured cost and cost audit on the CPU (counterpart of the
reference's ``tests/test_cost.py``: ``TestParserVsXla``,
``TestLoopWeighting``, ``TestMemoryStats``, ``TestCostRules``,
``TestSeededCostAudit`` and ``TestBaselineDiff``), and the gate's verdicts
held against the reference's.

The HLO parser becomes the op trace's counter: its matmul and convolution
flops equal ``torch.utils.flop_counter.FlopCounterMode``'s exactly.
Parity is of verdicts, not numbers (the two packages run different
programs): the full CPU matrix has the 72 cells of the reference's
committed ``ANALYSIS_costs.json`` under the backend map (``jnp`` ->
``torch``, ``pallas`` -> ``cuda``, ``fft`` -> ``fft``), skips each cell
the reference skips with its words, needs a card for each ``pallas`` cell
the reference ran, carries each cell's reference lint findings, and each
of the six seeds trips the rule the reference's seed trips.
"""

import ctypes
import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import repro.analysis.stencil_lint as rlint
import repro.api as rapi
import repro_torch.analysis as an
from repro_torch.analysis import audit as A
from repro_torch.analysis import cost as C
from repro_torch.analysis import rules as R
from repro_torch.analysis import trace as T
from repro_torch.analysis.__main__ import main as analysis_main
from repro_torch.core.cahn_hilliard import CahnHilliardADI, CHConfig

ROOT = Path(__file__).resolve().parents[1]
BUILTINS = ("biharmonic", "diffusion", "hyperdiffusion", "laplacian")
BACKEND_MAP = {"jnp": "torch", "pallas": "cuda", "fft": "fft"}


# ---------------------------------------------------------------------------
# The counter against torch's own flop counter (TestParserVsXla)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "fn,shapes",
    [
        (lambda a, b: a @ b, ((8, 16), (16, 4))),
        (lambda a, b: torch.bmm(a, b), ((3, 8, 16), (3, 16, 4))),
        (lambda a, b: torch.addmm(b[0], a, b), ((16, 16), (16, 16))),
        (lambda x, w: torch.nn.functional.conv2d(x, w, padding=1),
         ((2, 3, 16, 16), (4, 3, 3, 3))),
    ],
    ids=["mm", "bmm", "addmm", "conv2d"],
)
def test_matmul_and_conv_flops_equal_flop_counter(fn, shapes):
    args = [torch.ones(s, dtype=torch.float64) for s in shapes]
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    mm = sum(op.flops for op in T.trace(fn, *args).ops
             if op.name.split(".")[1] in ("mm", "bmm", "addmm", "convolution"))
    assert mm == counter.get_total_flops() > 0


def test_matmul_flops_exact():
    v = C.measure(lambda a, b: a @ b, torch.ones((8, 16)), torch.ones((16, 4)))
    assert v.flops == 2 * 8 * 16 * 4


def test_elementwise_flops_and_bytes_follow_the_reference_table():
    n = 64
    v = C.measure(lambda x: torch.sin(x) * 2.0 + x,
                  torch.ones(n, dtype=torch.float64))
    # three elementwise ops of n outputs; sin reads one field and writes
    # one, mul the same, add reads two and writes one
    assert v.flops == 3 * n
    assert v.bytes == (2 + 2 + 3) * n * 8


def test_a_kernel_launch_counts_its_tensors_and_the_floor():
    """Off the card no kernel launches, so the launch record is driven
    directly: a launch's bytes are its tensor arguments', its flops the
    family floor's for the shape it ran on."""
    from repro_torch.kernels import _build

    data, coeffs = torch.ones((32, 32)), torch.ones(9)
    out = torch.empty_like(data)

    def fake_launch(v):
        args = (*(_build.ptr(t) for t in (v, coeffs, out)),
                (ctypes.c_int * 1)(5))
        _build.record_launch("stencil2d", args)
        return out

    tr = T.trace(fake_launch, data)
    (launch,) = [op for op in tr.ops if op.kind == "kernel"]
    assert launch.name == "stencil2d" and launch.taps == 5
    assert launch.bytes == (32 * 32 * 2 + 9) * 4
    assert launch.flops == C.expected_stencil((32, 32), 5, 8).flops
    # the record is off after the trace: ptr() is a plain pointer again
    assert type(_build.ptr(data)) is int


def test_a_launch_on_another_thread_is_not_recorded():
    """The launch record belongs to the tracing thread: a launch another
    thread makes meanwhile (a serving worker's) is not credited to the
    trace, and its pointers carry no tensor."""
    import threading

    from repro_torch.kernels import _build

    data = torch.ones((8, 8))
    seen = []

    def other():
        p = _build.ptr(data)
        seen.append(type(p))
        _build.record_launch("stencil2d", (p,))

    def call(v):
        t = threading.Thread(target=other)
        t.start()
        t.join()
        _build.record_launch("penta_cols", (_build.ptr(v),))
        return v + 1

    tr = T.trace(call, data)
    assert [op.name for op in tr.ops if op.kind == "kernel"] == ["penta_cols"]
    assert seen == [int]


# ---------------------------------------------------------------------------
# Loop weighting
# ---------------------------------------------------------------------------


def _looped(trips, body):
    def evolve(x):
        for _ in range(trips):
            with T.trip("evolve"):
                x = body(x)
        return x
    return evolve


class TestLoopWeighting:
    def test_trips_are_recorded_per_trip(self):
        n, trips = 64, 10
        v = C.measure(_looped(trips, lambda c: c * 2.0 + 1.0),
                      torch.ones(n, dtype=torch.float64))
        assert v.flops == trips * 2 * n
        (lp,) = v.loops
        assert lp.body == "evolve" and lp.trips == trips
        assert lp.per_trip_flops * lp.trips == v.flops

    def test_doubling_trips_doubles_cost(self):
        def make(trips):
            return C.measure(_looped(trips, lambda c: torch.roll(c, 1) + c),
                             torch.ones(128, dtype=torch.float64))

        r1, r2 = make(8), make(16)
        assert r2.flops == 2 * r1.flops
        assert r2.bytes == 2 * r1.bytes
        assert r2.loops[0].per_trip_bytes == r1.loops[0].per_trip_bytes

    def test_fused_ch_driver_scales_with_steps(self):
        solver = CahnHilliardADI(CHConfig(nx=32, ny=32, dt=1e-3,
                                          device="cpu"))
        step = solver.make_evolve(1)

        def rep(steps):
            a = torch.zeros((32, 32), dtype=torch.float64)

            def evolve(x, y):
                for _ in range(steps):
                    with T.trip("evolve"):
                        x, y = step(x, y)
                return x, y

            return C.measure(evolve, a, a.clone())

        r4, r8 = rep(4), rep(8)
        assert r8.flops == pytest.approx(2 * r4.flops, rel=1e-12)
        assert any(lp.trips == 8 for lp in r8.loops)


# ---------------------------------------------------------------------------
# memory_stats + CostVector
# ---------------------------------------------------------------------------


class TestMemoryStats:
    def test_peak_covers_args_and_output(self):
        n = 256
        tr = T.trace(lambda x: x * 2.0, torch.ones(n, dtype=torch.float64))
        mem = an.memory_stats(tr)
        assert mem["peak_bytes"] >= 2 * n * 8 - mem["alias_bytes"]
        assert mem["argument_bytes"] == n * 8
        assert mem["output_bytes"] == n * 8

    def test_in_place_result_aliases_its_argument(self):
        n = 256
        tr = T.trace(lambda x: x.mul_(2.0), torch.ones(n, dtype=torch.float64))
        mem = an.memory_stats(tr)
        assert mem["alias_bytes"] == mem["output_bytes"] == n * 8
        assert mem["peak_bytes"] == n * 8 and mem["temp_bytes"] == 0

    def test_measure_vector(self):
        v = an.measure(lambda x: torch.sin(x), torch.ones(64, dtype=torch.float64))
        assert v.flops > 0 and v.bytes > 0 and v.peak_memory > 0
        assert v.intensity == pytest.approx(v.flops / v.bytes)
        assert v.device_ms is None
        d = v.to_dict()
        assert set(d) >= {"flops", "bytes", "peak_memory", "intensity",
                          "device_ms"}

    def test_device_time_needs_a_card(self):
        with pytest.raises(ValueError, match="card"):
            an.measure(lambda x: x + 1.0, torch.ones(4), timed=True)


# ---------------------------------------------------------------------------
# Cost rules (check_cost)
# ---------------------------------------------------------------------------


def _ctx(expected, factors=None):
    return {"expected": expected, "factors": factors or {}, "cell": "t/t/t"}


class TestCostRules:
    def test_within_budget_is_clean(self):
        e = C.Expected(flops=100.0, bytes=100.0, peak_memory=100.0)
        v = C.CostVector(flops=150.0, bytes=150.0, peak_memory=150.0)
        assert R.check_cost(v, context=_ctx(e)) == []

    @pytest.mark.parametrize(
        "field,rule",
        [
            ("flops", "flops_budget"),
            ("bytes", "bytes_budget"),
            ("peak_memory", "peak_memory_budget"),
        ],
    )
    def test_budget_breach_names_its_rule(self, field, rule):
        e = C.Expected(flops=100.0, bytes=100.0, peak_memory=100.0)
        kw = {"flops": 100.0, "bytes": 100.0, "peak_memory": 100.0}
        kw[field] = 1e6  # way over any factor
        findings = R.check_cost(C.CostVector(**kw), context=_ctx(e))
        assert [f.rule for f in findings] == [rule]
        assert findings[0].severity == "error"
        assert "exceeds budget" in findings[0].message
        assert "x the analytic floor" in findings[0].message

    def test_no_remat_fires_on_fat_loop_body(self):
        e = C.Expected(
            flops=1e6, bytes=1e6, peak_memory=1e6, step_bytes=100.0
        )
        lp = C.LoopCost(
            body="body", trips=16, per_trip_flops=10.0,
            per_trip_bytes=1e5,  # >> step budget
        )
        v = C.CostVector(
            flops=1e6, bytes=1e6, peak_memory=1e6, loops=[lp]
        )
        names = [f.rule for f in R.check_cost(v, context=_ctx(e))]
        assert "no_remat" in names

    def test_single_trip_loop_exempt_from_no_remat(self):
        e = C.Expected(flops=1e6, bytes=1e6, peak_memory=1e6,
                       step_bytes=100.0)
        lp = C.LoopCost(body="b", trips=1, per_trip_flops=1.0,
                        per_trip_bytes=1e5)
        v = C.CostVector(flops=1e6, bytes=1e6, peak_memory=1e6, loops=[lp])
        assert "no_remat" not in [
            f.rule for f in R.check_cost(v, context=_ctx(e))
        ]

    def test_device_time_budget(self):
        # a floor of 3.35 GB on the H100's HBM: 1 ms
        e = C.Expected(flops=1.0, bytes=3.35e9, peak_memory=1.0)
        assert C.floor_ms(e) == pytest.approx(1.0)
        base = dict(flops=1.0, bytes=1.0, peak_memory=1.0)
        factors = {"device_time": 2.0}
        assert R.check_cost(C.CostVector(**base, device_ms=1.9),
                            context=_ctx(e, factors)) == []
        (f,) = R.check_cost(C.CostVector(**base, device_ms=2.5),
                            context=_ctx(e, factors))
        assert f.rule == "device_time_budget" and "1.25x" not in f.message
        assert "bloat 2.50x" in f.message
        # the CPU measures no device time: nothing to gate
        assert R.check_cost(C.CostVector(**base),
                            ("device_time_budget",), context=_ctx(e)) == []


# ---------------------------------------------------------------------------
# Seeded cost regressions through the real audit
# ---------------------------------------------------------------------------


_SEED_KW = dict(
    operators=("laplacian",), families=("stencil2d",), backends=("torch",),
    shapes={"stencil2d": (32, 32)}, device="cpu",
)


class TestSeededCostAudit:
    def test_clean_cell_passes(self):
        rep = an.run_cost_audit(**_SEED_KW)
        audited = [r for r in rep.results if r.skipped is None]
        assert audited and rep.ok
        (cell,) = audited
        assert cell.measured.flops > 0

    def test_transpose_copy_trips_bytes_budget(self):
        rep = an.run_cost_audit(**_SEED_KW, seed_violation="transpose_copy")
        bad = [r for r in rep.results if not r.ok]
        assert bad, "seeded transpose round-trip must breach a budget"
        assert any(f.rule == "bytes_budget" for r in bad for f in r.findings)

    def test_double_buffer_trips_peak_memory_budget(self):
        rep = an.run_cost_audit(**_SEED_KW, seed_violation="double_buffer")
        assert any(f.rule == "peak_memory_budget"
                   for r in rep.results for f in r.findings)

    def test_flops_waste_trips_flops_budget(self):
        rep = an.run_cost_audit(**_SEED_KW, seed_violation="flops_waste")
        assert any(f.rule == "flops_budget"
                   for r in rep.results for f in r.findings)

    def test_remat_seed_trips_no_remat(self):
        rep = an.run_cost_audit(
            operators=("hyperdiffusion",), families=("fused_ch",),
            backends=("torch",), shapes={"fused_ch": (16, 16)},
            seed_violation="remat", device="cpu",
        )
        assert any(f.rule == "no_remat"
                   for r in rep.results for f in r.findings)

    def test_budget_follows_the_window_count_not_the_name(self):
        """A 25-window operator registered under a new name gets the
        budget of the built-in 5x5 operators and audits clean: the plain
        path's bytes grow with the windows it rolls, whatever the
        operator is called."""
        from repro_torch import api

        box = api.get_operator("biharmonic").weights
        api.register_operator("_audit_box5",
                              weights=lambda nd, h=1.0: 0.5 * box(nd, h))
        try:
            rep = an.run_cost_audit(
                operators=("_audit_box5", "biharmonic", "laplacian"),
                families=("stencil2d",), backends=("torch",), device="cpu")
            factors = {op: A._cost_factors("stencil2d", op, "torch", False)
                       for op in ("_audit_box5", "biharmonic", "laplacian")}
        finally:
            api._REGISTRY.pop("_audit_box5", None)
        assert rep.ok, [f.message for r in rep.violations for f in r.findings]
        ratio = {r.operator: r.measured.bytes / r.expected.bytes
                 for r in rep.results}
        assert ratio["_audit_box5"] > 50.0  # past the 3x3 operators' budget
        assert factors["_audit_box5"] == factors["biharmonic"]
        assert factors["laplacian"]["bytes"] * 25 == (
            factors["biharmonic"]["bytes"] * 9)

    def test_report_meta_is_stamped(self):
        rep = an.run_cost_audit(**_SEED_KW)
        assert rep.meta["schema_version"] == C.SCHEMA_VERSION
        assert rep.meta["torch"] == torch.__version__
        assert rep.meta["host"] and rep.meta["device"] == "cpu"


# ---------------------------------------------------------------------------
# Baseline diff
# ---------------------------------------------------------------------------


def _fake_report(flops=100.0, nbytes=100.0, peak=100.0, *, torchv="2.13.0",
                 device="cpu"):
    return {
        "meta": {"torch": torchv, "device": device,
                 "schema_version": C.SCHEMA_VERSION},
        "cells": {
            "stencil2d/laplacian/torch": {
                "skipped": None,
                "measured": {
                    "flops": flops, "bytes": nbytes, "peak_memory": peak,
                },
            },
        },
    }


class TestBaselineDiff:
    def test_identical_reports_have_no_regressions(self):
        regs, _ = an.diff_baseline(_fake_report(), _fake_report())
        assert regs == []

    def test_cost_drift_over_threshold_regresses(self):
        regs, _ = an.diff_baseline(_fake_report(nbytes=150.0), _fake_report())
        assert regs and "bytes" in regs[0] and "1.50x" in regs[0]

    def test_drift_within_threshold_is_quiet(self):
        regs, _ = an.diff_baseline(_fake_report(nbytes=105.0), _fake_report())
        assert regs == []

    def test_missing_cell_regresses(self):
        cur = _fake_report()
        cur["cells"] = {}
        regs, _ = an.diff_baseline(cur, _fake_report())
        assert regs and "missing" in regs[0]

    def test_improvement_and_torch_change_are_notes(self):
        regs, notes = an.diff_baseline(
            _fake_report(nbytes=50.0, torchv="9.9.9"), _fake_report()
        )
        assert regs == []
        assert any("improved" in n for n in notes)
        assert any("torch" in n for n in notes)

    def test_another_device_regresses(self):
        regs, _ = an.diff_baseline(_fake_report(device="cuda"), _fake_report())
        assert regs and "no cell is comparable" in regs[0]


# ---------------------------------------------------------------------------
# Parity with the reference: the full CPU matrix and the six seeds
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def full_matrix():
    """The full CPU matrix, invariant and cost audits through one cache,
    on the four built-in operators."""
    cache = A.CellArtifacts()
    report = an.run_audit(operators=BUILTINS, cache=cache, device="cpu")
    cost = an.run_cost_audit(operators=BUILTINS, cache=cache, device="cpu")
    return report, cost


@pytest.fixture(scope="module")
def reference_cells():
    return json.loads((ROOT / "ANALYSIS_costs.json").read_text())["cells"]


def _port_cell(cell: str) -> str:
    family, op, backend = cell.split("/")
    return f"{family}/{op}/{BACKEND_MAP[backend]}"


def test_full_matrix_is_clean(full_matrix):
    report, cost = full_matrix
    assert report.ok, [r.to_dict() for r in report.violations]
    assert cost.ok, [r.to_dict() for r in cost.violations]


def test_matrix_cells_and_skips_match_the_reference(full_matrix,
                                                    reference_cells):
    _, cost = full_matrix
    mine = {r.cell: r for r in cost.results}
    assert len(reference_cells) == len(mine) == 72
    assert {_port_cell(c) for c in reference_cells} == set(mine)
    ran = {"torch": 0, "fft": 0, "cuda": 0}
    for cell, ref in reference_cells.items():
        port = mine[_port_cell(cell)]
        if ref["skipped"] is not None:
            assert port.skipped == ref["skipped"], cell
        elif cell.endswith("/pallas"):
            assert port.skipped == "needs a CUDA device", cell
            ran["cuda"] += 1
        else:
            assert port.skipped is None, cell
            ran[port.backend] += 1
    assert ran == {"torch": 15, "fft": 14, "cuda": 14}
    # and the invariant audit skips the same cells for the same reasons
    report, _ = full_matrix
    audit_skips = {f"{r.family}/{r.operator}/{r.backend}": r.skipped
                   for r in report.results if r.rules != ("rebuild_budget",)}
    assert audit_skips == {c: r.skipped for c, r in mine.items()}


def _summary(findings):
    return sorted((f.rule, f.severity, f.message) for f in findings)


def test_each_cell_carries_the_reference_lint(full_matrix):
    """lint_operator / lint_adi of the reference on the reference's
    operator give each audited cell's lint findings, as many and as
    worded."""
    report, _ = full_matrix
    lint_rules = ("stencil_", "adi_")
    cells = [r for r in report.results
             if r.skipped is None and r.rules != ("rebuild_budget",)]
    assert cells
    for r in cells:
        ropdef = rapi.get_operator(r.operator)
        if r.family in ("adi2d", "adi3d"):
            want = rlint.lint_adi(ropdef, A.DEFAULT_SHAPES[r.family][-1],
                                  A._ADI_ALPHA, bc="periodic", cyclic=True)
        else:
            want = rlint.lint_operator(ropdef, ndim=A._NDIM.get(r.family, 2))
        got = [f for f in r.findings if f.rule.startswith(lint_rules)]
        assert _summary(got) == _summary(want), (r.family, r.operator)


def test_committed_baseline_matches_the_full_matrix(full_matrix):
    baseline = json.loads((ROOT / "ANALYSIS_costs_torch.json").read_text())
    _, cost = full_matrix
    regs, _ = an.diff_baseline(cost.to_dict(), baseline)
    assert regs == [], regs


# each seed and the rule the reference's seed trips (the issue's table)
SEED_TABLE = [
    ("transpose", "no_transpose"),
    ("upcast", "no_dtype_upcast"),
    ("transpose_copy", "bytes_budget"),
    ("flops_waste", "flops_budget"),
    ("double_buffer", "peak_memory_budget"),
    ("remat", "no_remat"),
]


def test_the_seed_table_is_the_gates():
    assert {seed: rule for seed, (rule, _, _) in A.SEED_RULES.items()} == (
        dict(SEED_TABLE))
    assert set(A.SEED_RULES) == set(A.SEED_VIOLATIONS + A.COST_SEEDS)


@pytest.mark.parametrize("seed,rule", SEED_TABLE)
def test_each_seed_fails_closed_naming_its_rule(seed, rule, capsys):
    """Through the CLI, as ``python -m repro_torch.analysis --device cpu
    [--cost] --seed-violation SEED`` on the seed's designated cell: exit 1,
    and the rule named in the printed findings."""
    _, family, op = A.SEED_RULES[seed]
    argv = ["--device", "cpu", "--no-retrace", "--families", family,
            "--operators", op, "--backends", "torch", "--seed-violation",
            seed]
    if seed in A.COST_SEEDS:
        argv.append("--cost")
    assert analysis_main(argv) == 1
    out = capsys.readouterr().out
    failed = [line for line in out.splitlines() if line.startswith("[FAIL]")]
    assert failed and all("seeded: " + seed in line for line in failed)
    assert f"{rule} (error)" in out
