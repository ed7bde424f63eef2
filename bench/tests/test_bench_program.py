"""The program's spans in the benchmark: the reduction of a trace by
program span, the five readers of ``bench/layers/`` that read it, and
``bench/trace_program.py`` on the CPU at small sizes, with the program's
spans module and without it (a checkout whose program has none)."""

import sys
from types import SimpleNamespace

import pytest

from bench.harness import manifest, program
from bench.harness.cell import run_cell
from bench.harness.profile import reduce_trace
from bench.harness.spans import Spans
from bench.trace_program import READERS, run

SMALL = {"ch2d": dict(grid=[64, 64], chunk=4, profiled_chunks=1),
         "lod3d": dict(grid=[32, 32, 32], chunk=4, profiled_chunks=1)}
CELLS = [w["name"] for w in manifest.load()["workloads"]]


def _launch(ts, corr):
    return dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=ts, dur=2,
                args=dict(correlation=corr))


def _kernel(name, ts, dur, corr=None):
    e = dict(cat="kernel", name=name, ts=ts, dur=dur)
    if corr is not None:
        e["args"] = dict(correlation=corr)
    return e


def _range(name, ts, dur, cat="cpu_op"):
    return dict(cat=cat, name=name, ts=ts, dur=dur)


# one chunk of one step and its diagnostics: the RHS (a plan's kernel and
# glue), the update, the diagnostics, then the driver's copy to the host.
# The device idles 30-40 (the host in the update), 60-104 (in the chunk
# until 65, in the caller, in the diagnostics from 101), 110-130 (in the
# diagnostics until 121) and 140-145 (in the caller).
TRACE = [
    _range("bench.steps", 2, 98, cat="user_annotation"),
    _range("bench.diag", 100, 50, cat="user_annotation"),
    _range("repro.ch.chunk", 1, 64),
    _range("repro.ch.rhs", 2, 20),
    _range("repro.plan.apply", 3, 5, cat="user_annotation"),
    _launch(4, 1), _kernel("void batch_x_kernel<double>(int)", 2, 10, 1),
    _launch(10, 2), _kernel("void at::native::add_kernel(int)", 12, 18, 2),
    _range("repro.ch.update", 30, 25),
    _launch(31, 3), _kernel("void at::native::neg_kernel(int)", 40, 20, 3),
    _range("repro.ch.diagnostics", 101, 20),
    _launch(102, 4), _kernel("void at::native::reduce_kernel(int)", 104, 6, 4),
    _launch(125, 5), _kernel("void at::native::copy_kernel(int)", 130, 10, 5),
    _launch(126, 6),
    dict(cat="gpu_memcpy", name="Memcpy DtoH", ts=145, dur=5,
         args=dict(correlation=6)),
]


def _ctx(events=TRACE, records=(), steps=1):
    pp = program.reduce_program(events, 1)
    return SimpleNamespace(ops=manifest.ops_modules(), steps_per_chunk=steps,
                           program_spans=list(records), program_profile=pp)


def _read(name, ctx):
    return manifest.load_module("layers", name).read(ctx)


def test_reduction_places_by_correlation():
    pp = program.reduce_program(TRACE, 1)
    chains = {d[0]: d[3] for d in pp.device}
    # launched at 4 us, inside the plan, though its device clock reads 2
    assert chains["batch_x_kernel<double>"] == (
        "repro.ch.chunk", "repro.ch.rhs", "repro.plan.apply")
    assert chains["at::native::add_kernel"] == ("repro.ch.chunk", "repro.ch.rhs")
    assert chains["at::native::neg_kernel"] == ("repro.ch.chunk", "repro.ch.update")
    assert chains["at::native::copy_kernel"] == chains["Memcpy DtoH"] == ()
    assert pp.unplaced == 0
    assert [g[0] for g in pp.gaps] == [
        "bench.steps:repro.ch.chunk", "bench.diag:repro.ch.diagnostics",
        "bench.steps:repro.ch.update", "bench.diag:caller"]
    assert [g[1] for g in pp.gaps] == pytest.approx([44e-6, 20e-6, 10e-6, 5e-6])
    # in a program span: 10 of the first gap, 5 + 3 of the split one, 11
    assert pp.idle_s == pytest.approx(79e-6)
    assert pp.idle_in_program_s == pytest.approx(29e-6)


def test_readers_on_a_made_up_trace():
    steps = 2
    ctx = _ctx(steps=steps)
    assert _read("rhs_glue_ms_per_step", ctx) == pytest.approx(18e-3 / steps)
    assert _read("update_glue_ms_per_step", ctx) == pytest.approx(20e-3 / steps)
    assert _read("diag_device_ms", ctx) == pytest.approx(6e-3)
    assert _read("idle_in_program_pct", ctx) == pytest.approx(100 * 29 / 79)
    recs = [SimpleNamespace(name="repro.launch", dur_ns=d) for d in (8000, 12000)]
    recs.append(SimpleNamespace(name="repro.ch.rhs", dur_ns=10**6))
    assert _read("launch_host_us", _ctx(records=recs)) == pytest.approx(10.0)


def test_readers_report_nothing_without_a_launching_call():
    lost = [e for e in TRACE if e.get("args", {}).get("correlation") != 3]
    lost.append(_kernel("void at::native::neg_kernel(int)", 40, 20))
    ctx = _ctx(lost)
    assert ctx.program_profile.unplaced == 1
    for name in READERS:
        assert _read(name, ctx) is None, name


def test_readers_report_nothing_without_the_program_spans():
    # a traced run's ctx as the benchmark builds it has no program_* keys
    bare = SimpleNamespace(ops=manifest.ops_modules(), steps_per_chunk=1)
    plain = [e for e in TRACE if not e["name"].startswith("repro.")]
    for name in READERS:
        assert _read(name, bare) is None, name
        assert _read(name, _ctx(plain)) is None, name


@pytest.mark.parametrize("events", [
    [e for e in TRACE if not e["name"].startswith("repro.")], TRACE])
def test_base_profile_is_the_benchmarks(events):
    pp = program.reduce_program(events, 1)
    assert pp.base == reduce_trace(events, 1)
    if pp.ranges:
        return
    assert {g[0].split(":")[1] for g in pp.gaps} == {"caller"}
    assert pp.idle_in_program_s == 0


@pytest.fixture
def no_spans(monkeypatch):
    """The program as a checkout without ``repro_torch.runtime.spans``
    has it: the import fails."""
    import repro_torch.runtime

    monkeypatch.setitem(sys.modules, "repro_torch.runtime.spans", None)
    monkeypatch.delattr(repro_torch.runtime, "spans")
    assert program.available() is None


@pytest.mark.parametrize("cell", CELLS)
def test_tool_on_the_cpu(cell):
    r = run(cell, 2**31 + 7, 3, device="cpu", traffic=SMALL[cell.split(".")[0]])
    assert min(r["enqueue_ms_per_step"]["on"]) > 0
    assert r["metrics"] == {}  # no launches, no device trace on the CPU
    assert "program_window" not in r


@pytest.mark.parametrize("cell", CELLS)
def test_without_the_spans_module(cell, no_spans):
    small = SMALL[cell.split(".")[0]]
    r = run(cell, 2**31 + 7, 3, device="cpu", traffic=small)
    assert r["enqueue_ms_per_step"]["on"] is None and r["metrics"] == {}
    traced = run_cell(cell, 2**31 + 7, 0.05, True, spans=Spans(), device="cpu",
                      traffic=small)
    names = {m["name"] for m in manifest.per_layer(manifest.load(), cell)}
    assert {"host_enqueue_ms", "launches_per_step", "diag_ms", "create_s",
            "step_roofline"} <= set(traced["metrics"]) <= names
    assert not set(traced["metrics"]) & set(READERS)
    assert traced["correct"] is True
