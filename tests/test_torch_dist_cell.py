"""The benchmark's distributed cell, ``ch2d.dist.8192x4``, on the CPU at
64^2: its driver (``bench/drivers/ch2d_dist.py``) starts three peer ranks
beside this process and joins them in a gloo world on a (2, 2) (data,
model) mesh, as it joins four cards in an NCCL world.

The plain run is ``correct``; the control (the plain reference in float32
in the program's place) and each planted fault are not: a step that
leaves its state unchanged, part of the field left out of the step, an
altered diagnostic, and the first (warm-up) chunk skipped.  Each fault is
planted on rank 0, in this process, after the real call, so every rank
still makes the same collectives.  A peer that dies makes rank 0's next
call raise, and no peer outlives the run; where rank 0 is held and makes
no call (on the card, blocked behind a collective that waits for the dead
peer), its watchdog ends the process.  This file does not import jax.
"""

import multiprocessing
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.harness import manifest  # noqa: E402
from bench.harness.cell import run_cell  # noqa: E402
from bench.harness.spans import Spans  # noqa: E402

CELL = "ch2d.dist.8192x4"
SMALL = dict(grid=[64, 64], chunk=4, profiled_chunks=1)
SEED = 2**31 + 4242


def _run(*, control=False):
    return run_cell(CELL, SEED, 0.05, False, spans=Spans(), device="cpu",
                    control=control, traffic=SMALL)


@pytest.fixture
def driver():
    return manifest.load_module("drivers", "ch2d_dist").Driver


def test_the_plain_run_is_correct():
    r = _run()
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert r["device"]["count"] == 4
    for key in ("boot_gap", "traj_gap", "chunk_gap", "diag_gap"):
        c = r["checks"][key]
        assert c["value"] <= c["limit"], (key, c)
    assert not multiprocessing.active_children()


def test_the_control_is_not_correct():
    r = _run(control=True)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


def _unchanged(monkeypatch, drv):
    real = drv.chunk

    def chunk(self):
        before = self.node.carry
        real(self)
        self.node.carry = before

    monkeypatch.setattr(drv, "chunk", chunk)


def _part_left_out(monkeypatch, drv):
    real = drv.chunk

    def chunk(self):
        block = self.node.carry[0].to_local()
        keep = block[: block.shape[0] // 2].clone()
        real(self)
        self.node.carry[0].to_local()[: keep.shape[0]] = keep

    monkeypatch.setattr(drv, "chunk", chunk)


def _answer_altered(monkeypatch, drv):
    real = drv.diagnostics

    def diagnostics(self):
        d = real(self)
        return [d[0] * (1 + 1e-6)] + d[1:]

    monkeypatch.setattr(drv, "diagnostics", diagnostics)


def _first_chunk_skipped(monkeypatch, drv):
    real = drv.chunk
    calls = []

    def chunk(self):
        before = self.node.carry
        real(self)
        calls.append(1)
        if len(calls) == 1:
            self.node.carry = before

    monkeypatch.setattr(drv, "chunk", chunk)


@pytest.mark.parametrize("fault", [_unchanged, _part_left_out,
                                   _answer_altered, _first_chunk_skipped])
def test_a_planted_fault_is_not_correct(fault, monkeypatch, driver):
    fault(monkeypatch, driver)
    r = _run()
    assert r["correct"] is False
    assert not multiprocessing.active_children()


def test_a_dead_peer_fails_the_next_call(monkeypatch, driver):
    real = driver.chunk

    def chunk(self):
        real(self)
        p = self.peers[0][0]
        p.kill()
        p.join()

    monkeypatch.setattr(driver, "chunk", chunk)
    with pytest.raises(RuntimeError, match="rank 1 exited"):
        _run()
    assert not multiprocessing.active_children()


_HELD = textwrap.dedent("""
    import sys, threading, time
    sys.path[:0] = [{root!r}, {src!r}]

    def main():
        import torch
        import torch.distributed as dist
        from bench.harness import manifest
        from bench.harness.spans import Spans

        mod = manifest.load_module("drivers", "ch2d_dist")
        mod.NOTICE_S, mod.GRACE_S = 1, 2
        traffic = dict(manifest.workload("ch2d.dist.8192x4")["traffic"],
                       grid=[64, 64], chunk=4)
        ic = 0.1 * torch.rand(64, 64, dtype=torch.float64)
        drv = mod.Driver(manifest.config("ch2d_dist"), traffic, ic,
                         torch.device("cpu"), Spans())
        drv.chunk()
        drv.diagnostics()
        # a group whose teardown blocks, as NCCL's can behind a held card
        dist.destroy_process_group = lambda *a, **k: time.sleep(3600)
        threading.Thread(target=drv._watch, daemon=True).start()
        drv.peers[0][0].kill()
        time.sleep(120)  # rank 0 held: it makes no call
        print("NOT ENDED", flush=True)

    if __name__ == "__main__":
        main()
""")


def test_a_held_rank_0_is_ended_by_its_watchdog(tmp_path):
    script = tmp_path / "held.py"
    script.write_text(_HELD.format(root=str(ROOT), src=str(ROOT / "src")))
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=90, cwd=tmp_path)
    assert out.returncode == 1, out.stderr[-3000:]
    assert "NOT ENDED" not in out.stdout
    assert "rank 1 exited" in out.stderr and "ending the run" in out.stderr
    assert time.monotonic() - t0 < 60


def test_rank_0_sees_its_card_finish_within_a_poll(monkeypatch, driver):
    """Rank 0 notices the end of its card's work at the card's poll, not at
    the peers' 10 ms one: a late notice leaves every card idle until the
    next chunk, by an amount that depends on where the run's chunks fall
    against the poll, and so differs from run to run."""
    import torch

    work_s = 0.003

    class Event:
        def record(self):
            self.at = time.monotonic() + work_s

        def query(self):
            return time.monotonic() >= self.at

    monkeypatch.setattr(torch.cuda, "Event", Event)
    d = driver.__new__(driver)
    d.on_card, d.peers = True, []
    late = []
    for _ in range(21):
        t0 = time.monotonic()
        d._wait()
        late.append(time.monotonic() - t0 - work_s)
    late.sort()
    assert late[10] < 0.1 * manifest.load_module("drivers", "ch2d_dist").POLL_S
