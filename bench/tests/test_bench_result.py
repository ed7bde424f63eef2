"""A run's result line, the control and planted faults, on the CPU at small
sizes (the harness's look for a card skipped), and one run of each cell on
the card.

The control (each configuration's reference in float32 in the program's
place) and every fault a cell can have must come out not correct: a step
that returns its state unchanged, half of the field left out of the step,
an answer altered where it is produced, and the first chunk (a warm-up
chunk, which no comparison reads by itself) left out.  The exchange
between chips does not exist on one chip."""

import json
import subprocess
import sys

import pytest
import torch

import repro_torch as rt
from bench.harness import manifest
from bench.harness.cell import run_cell
from bench.harness.profile import reduce_trace
from bench.harness.spans import Spans
from repro_torch.core.cahn_hilliard import CahnHilliardADI

CELLS = [w["name"] for w in manifest.load()["workloads"]]
SMALL = {"ch2d": dict(grid=[64, 64], chunk=4, profiled_chunks=1),
         "lod3d": dict(grid=[32, 32, 32], chunk=4, profiled_chunks=1)}
SEED = 2**31 + 12345


def small_run(cell, *, trace=False, control=False, seed=SEED):
    small = SMALL[cell.split(".")[0]]
    return run_cell(cell, seed, 0.05, trace, spans=Spans(), device="cpu",
                    control=control, traffic=small)


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    r = small_run(cell)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    man = manifest.load()
    assert set(r["metrics"]) == {m["name"] for m in manifest.end_to_end(man, cell)}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.loads(json.dumps(r, allow_nan=False))


@pytest.mark.parametrize("cell", CELLS)
def test_traced_result_line(cell):
    r = small_run(cell, trace=True)
    man = manifest.load()
    names = {m["name"] for m in manifest.per_layer(man, cell)}
    assert set(r["metrics"]) <= names
    # no profile on the CPU: the readers of spans and counters still read
    assert {"host_enqueue_ms", "launches_per_step", "diag_ms",
            "create_s", "step_roofline"} <= set(r["metrics"])
    assert r["metrics"]["launches_per_step"]["value"] == 0  # plain paths
    assert r["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    r = small_run(cell, control=True)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def _unchanged_ch2d(monkeypatch):
    monkeypatch.setattr(CahnHilliardADI, "make_evolve",
                        lambda self, chunk: lambda c_n, c_nm1: (c_n, c_nm1))


def _half_ch2d(monkeypatch):
    real = CahnHilliardADI.make_evolve

    def make_evolve(self, chunk):
        evolve = real(self, chunk)

        def half(c_n, c_nm1):
            keep = c_n[: c_n.shape[0] // 2].clone()
            out = evolve(c_n, c_nm1)
            out[0][: keep.shape[0]] = keep
            return out

        return half

    monkeypatch.setattr(CahnHilliardADI, "make_evolve", make_evolve)


def _answer_ch2d(monkeypatch):
    drivers = manifest.load_module("drivers", "ch2d")
    real = drivers.coarsening_metrics

    def metrics(cfg):
        fn = real(cfg)
        return lambda c: (fn(c)[0] * (1 + 1e-6),) + tuple(fn(c)[1:])

    monkeypatch.setattr(drivers, "coarsening_metrics", metrics)


def _first_chunk_ch2d(monkeypatch):
    real = CahnHilliardADI.make_evolve
    calls = []

    def make_evolve(self, chunk):
        evolve = real(self, chunk)

        def skip_first(c_n, c_nm1):
            calls.append(1)
            return (c_n, c_nm1) if len(calls) == 1 else evolve(c_n, c_nm1)

        return skip_first

    monkeypatch.setattr(CahnHilliardADI, "make_evolve", make_evolve)


def _patch_compute(monkeypatch, adi=None, lap=None):
    drivers = manifest.load_module("drivers", "lod3d")
    real = rt.compute

    def compute(plan, field, *extra):
        out = real(plan, field, *extra)
        if isinstance(plan, rt.ADIOperator3D) and adi:
            return adi(field, out)
        if not isinstance(plan, rt.ADIOperator3D) and lap:
            return lap(field, out)
        return out

    monkeypatch.setattr(drivers.rt, "compute", compute)


def _unchanged_lod3d(monkeypatch):
    _patch_compute(monkeypatch, adi=lambda field, out: field.clone())


def _half_lod3d(monkeypatch):
    def half(field, out):
        out[: out.shape[0] // 2] = field[: out.shape[0] // 2]
        return out

    _patch_compute(monkeypatch, adi=half)


def _answer_lod3d(monkeypatch):
    _patch_compute(monkeypatch, lap=lambda field, out: out * (1 + 1e-4))


def _first_chunk_lod3d(monkeypatch):
    calls = []

    def skip_first(field, out):
        calls.append(1)
        return field.clone() if len(calls) <= SMALL["lod3d"]["chunk"] else out

    _patch_compute(monkeypatch, adi=skip_first)


FAULTS = {"ch2d": [_unchanged_ch2d, _half_ch2d, _answer_ch2d,
                   _first_chunk_ch2d],
          "lod3d": [_unchanged_lod3d, _half_lod3d, _answer_lod3d,
                    _first_chunk_lod3d]}


@pytest.mark.parametrize("cell,fault", [
    (cell, i) for cell in CELLS for i in range(4)])
def test_a_planted_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[cell.split(".")[0]][fault](monkeypatch)
    r = small_run(cell)
    assert r["correct"] is False


def test_trace_reduction():
    ev = [
        dict(cat="user_annotation", name="bench.steps", ts=0, dur=100),
        dict(cat="user_annotation", name="bench.diag", ts=100, dur=50),
        dict(cat="cpu_op", name="aten::item", ts=110, dur=30),
        dict(cat="kernel", name="void penta_cols_tile_kernel<double>(int)",
             ts=10, dur=40),
        dict(cat="kernel", name="void at::elementwise_kernel<128>(int)",
             ts=60, dur=20),
        dict(cat="kernel", name="reduce_kernel", ts=120, dur=10),
        # launched in the diagnostics, its device timestamp 2 us early
        dict(cat="cuda_runtime", name="cudaLaunchKernel", ts=101, dur=3,
             args=dict(correlation=7)),
        dict(cat="kernel", name="abs_kernel", ts=98, dur=1,
             args=dict(correlation=7)),
    ]
    p = reduce_trace(ev, 1)
    assert p.window_s == pytest.approx(150e-6)
    assert p.busy_s == pytest.approx(71e-6)
    assert [d[3] for d in p.device] == ["bench.steps", "bench.steps",
                                        "bench.diag", "bench.diag"]
    assert p.gaps[0] == ["bench.steps:python", pytest.approx(21e-6)]
    assert p.top_ops(1) == [["penta_cols_tile_kernel<double>",
                             pytest.approx(40e-6)]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_one_run_on_the_card(cell, card):
    out = subprocess.run(
        [sys.executable, str(manifest.BENCH / "run.py"), "--workload", cell,
         "--seed", "987654321", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=manifest.ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert r["device"]["kind"] == torch.cuda.get_device_name(0)
