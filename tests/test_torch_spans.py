"""The port's spans (``repro_torch.runtime.spans``): off, they record and
allocate nothing; on, they nest per thread and record the layer
boundaries of a Cahn–Hilliard chunk and of a 3D ``compute``, and under
``torch.profiler`` the trace holds ranges of the same names and nesting.

The one test marked ``cuda`` runs on the card (``PYTHONPATH=src python -m
pytest -q --noconftest tests/test_torch_spans.py``): one ``repro.launch``
span for each launch the counter counts.  This file does not import jax.
"""

import itertools
import json
import threading
import tracemalloc

import pytest
import torch

import repro_torch as rt
from repro_torch.core.cahn_hilliard import (
    CahnHilliardADI,
    CHConfig,
    coarsening_metrics,
    deep_quench_ic,
)
from repro_torch.kernels import _build
from repro_torch.runtime import spans

N = 64  # the CH grid of the CPU tests

# the spans of one step, in the order they end, by RHS mode (a plan's
# Compute ends inside the RHS)
STEP_TREE = {
    "fused": ["repro.ch.rhs", "repro.adi.solve_y", "repro.ch.update"],
    "stencil": ["repro.plan.apply"] * 2
    + ["repro.ch.rhs", "repro.adi.solve_x", "repro.adi.solve_y", "repro.ch.update"],
    "batch1d": ["repro.plan.apply"] * 6
    + ["repro.ch.rhs", "repro.adi.solve_x", "repro.adi.solve_y", "repro.ch.update"],
}


@pytest.fixture(autouse=True)
def _spans_off():
    spans.disable()
    spans.take()
    yield
    spans.disable()
    spans.take()


def _solver(mode, n=N, device="cpu"):
    cfg = CHConfig(nx=n, ny=n, rhs_mode=mode, device=device)
    solver = CahnHilliardADI(cfg)
    c0 = deep_quench_ic(n, n, seed=1, device=device)
    return cfg, solver, (solver.initial_step(c0), c0)


def _lod3d(n=8):
    op = rt.create("diffusion", (n, n, n), mode="adi", alpha=0.1, cyclic=True,
                   dtype=torch.float64, device="cpu")
    return op, torch.rand(n, n, n, dtype=torch.float64,
                          generator=torch.Generator().manual_seed(3))


def _site_calls():
    """A zero-argument call of each kind of site, on the CPU."""
    cfg, solver, (c1, c0) = _solver("batch1d", n=16)
    evolve = solver.make_evolve(1)
    metrics = coarsening_metrics(cfg)
    op, c = _lod3d()
    return {
        "ch_chunk": lambda: evolve(c1, c0),
        "diagnostics": lambda: metrics(c1),
        "plan_apply": lambda: solver.plan_d4_1d.apply(c1),
        "adi_solve": lambda: solver.op_full.solve_x(c1),
        "compute": lambda: rt.compute(op, c),
    }


@pytest.mark.parametrize(
    "site", ["ch_chunk", "diagnostics", "plan_apply", "adi_solve", "compute"])
def test_off_site_records_nothing(site):
    call = _site_calls()[site]
    call()  # warm: first calls build caches
    before = spans._next_id
    tracemalloc.start(8)
    try:
        for _ in range(20):
            call()
        snap = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    assert spans.take() == []
    assert spans._next_id == before
    mine = snap.filter_traces([tracemalloc.Filter(True, spans.__file__)])
    assert mine.statistics("filename") == []


def test_off_launch_site_allocates_nothing(monkeypatch):
    """The launch site with the C call stubbed out: many calls, not a
    byte allocated even for a moment (the traced peak stays where it
    was)."""
    monkeypatch.setattr(_build, "_launch", lambda name, device, args, libs: None)
    _build.launch("penta_cols", None)
    calls = itertools.repeat(None, 10_000)
    tracemalloc.start()
    try:
        tracemalloc.reset_peak()
        base = tracemalloc.get_traced_memory()[0]
        for _ in calls:
            _build.launch("penta_cols", None)
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert (current - base, peak - base) == (0, 0)
    assert spans.take() == []


@pytest.mark.parametrize("raises", [False, True])
def test_nesting_ids(raises):
    spans.enable()
    with spans.span("repro.compute", plan="P"):
        with spans.span("repro.adi.solve_x"):
            pass
        try:
            with spans.span("repro.launch", kernel="k"):
                if raises:
                    raise ValueError("in the block")
        except ValueError:
            pass
    with spans.span("repro.ch.diagnostics"):
        pass
    spans.disable()
    got = {s.name: s for s in spans.take()}
    outer, sweep, launch, diag = (got[k] for k in (
        "repro.compute", "repro.adi.solve_x", "repro.launch",
        "repro.ch.diagnostics"))
    assert outer.parent is None and outer.root == outer.id
    assert sweep.parent == launch.parent == outer.id
    assert sweep.root == launch.root == outer.id
    assert diag.parent is None and diag.root == diag.id != outer.id
    assert launch.error == ("ValueError" if raises else None)
    assert launch.fields == {"kernel": "k"} and outer.fields == {"plan": "P"}
    for s in got.values():
        assert 0 <= s.dur_ns and s.thread == threading.get_ident()
    assert outer.start_ns <= sweep.start_ns <= sweep.end_ns <= launch.start_ns
    assert launch.end_ns <= outer.end_ns


def test_threads_nest_apart():
    spans.enable()
    go = threading.Barrier(2)

    def work():
        with spans.span("repro.compute"):
            go.wait()
            with spans.span("repro.plan.apply"):
                go.wait()

    threads = [threading.Thread(target=work) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans.disable()
    recs = spans.take()
    by_id = {s.id: s for s in recs}
    inner = [s for s in recs if s.name == "repro.plan.apply"]
    assert len(recs) == 4 and len(inner) == 2
    for s in inner:
        assert by_id[s.parent].thread == s.thread
        assert by_id[s.parent].name == "repro.compute"
    assert len({s.root for s in inner}) == 2


@pytest.mark.parametrize("mode", ["fused", "stencil", "batch1d"])
def test_ch_chunk_tree(mode):
    cfg, solver, carry = _solver(mode)
    steps = 3
    evolve = solver.make_evolve(steps)
    spans.enable()
    evolve(*carry)
    spans.disable()
    recs = spans.take()
    chunk = recs[-1]
    assert (chunk.name, chunk.parent, chunk.fields) == (
        "repro.ch.chunk", None, {"steps": steps})
    assert [s.name for s in recs[:-1]] == STEP_TREE[mode] * steps
    assert all(s.root == chunk.id for s in recs)
    for s in recs[:-1]:
        want = "repro.ch.rhs" if s.name == "repro.plan.apply" else "repro.ch.chunk"
        assert {x.id: x for x in recs}[s.parent].name == want
    assert {s.fields["mode"] for s in recs if s.name == "repro.ch.rhs"} == {mode}


def test_compute_3d_sweeps():
    op, c = _lod3d()
    spans.enable()
    rt.compute(op, c)
    spans.disable()
    recs = spans.take()
    assert [s.name for s in recs] == [
        "repro.adi.solve_x", "repro.adi.solve_y", "repro.adi.solve_z",
        "repro.compute"]
    assert recs[-1].fields == {"plan": "ADIOperator3D"}
    assert {s.parent for s in recs[:-1]} == {recs[-1].id}


def test_profiler_ranges_mirror_records(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    cfg, solver, carry = _solver("stencil", n=16)
    evolve, metrics = solver.make_evolve(2), coarsening_metrics(cfg)
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        c_n, _ = evolve(*carry)
        metrics(c_n)
    spans.disable()
    recs = sorted(spans.take(), key=lambda s: s.start_ns)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = sorted(
        (e for e in json.loads(path.read_text())["traceEvents"]
         if str(e.get("name", "")).startswith("repro.") and "dur" in e),
        key=lambda e: (float(e["ts"]), -float(e["dur"])))
    assert [e["name"] for e in events] == [s.name for s in recs]

    def enclosing(i):  # the innermost earlier event that holds event i
        a, b = float(events[i]["ts"]), float(events[i]["ts"]) + float(events[i]["dur"])
        held = [j for j in range(i) if float(events[j]["ts"]) <= a
                and b <= float(events[j]["ts"]) + float(events[j]["dur"])]
        return held[-1] if held else None

    index = {s.id: i for i, s in enumerate(recs)}
    for i, s in enumerate(recs):
        assert enclosing(i) == (None if s.parent is None else index[s.parent])


@pytest.mark.cuda
def test_launch_spans_match_launch_counter():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, solver, carry = _solver("fused", n=256, device="cuda")
    evolve = solver.make_evolve(1)
    evolve(*carry)  # warm: the build and the first launches
    torch.cuda.synchronize()
    before = dict(_build.LAUNCHES)
    spans.enable()
    evolve(*carry)
    spans.disable()
    torch.cuda.synchronize()
    counted = {k: v - before.get(k, 0) for k, v in _build.LAUNCHES.items()}
    counted = {k: v for k, v in counted.items() if v}
    launches = [s for s in spans.take() if s.name == "repro.launch"]
    by_kernel = {}
    for s in launches:
        by_kernel[s.fields["kernel"]] = by_kernel.get(s.fields["kernel"], 0) + 1
    assert by_kernel == counted and sum(counted.values()) >= 2
