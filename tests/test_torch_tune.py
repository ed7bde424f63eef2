"""repro_torch.tune on the CPU, mirroring the reference's
``tests/test_tune.py`` on tiny shapes with a fresh cache each: cache hit,
miss, force and off, the force env, the key across processes and its
device fingerprint, a corrupted cache, the fft arbitrage and its round trip
through the cache, the analytic prior, and tuned fp64 results bit for bit
the untuned ones when fft does not win (the stream-geometry grid
included).

Deliberate differences: on the CPU the candidates are the plain path and
fft (the card adds the kernels' launch geometries: the card-only tests in
``tests/test_torch_kernels_cuda.py``); a candidate that raises is not
skipped but propagates; the prior's mirror asserts the winner, not a time
ordering.
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch as rt
from repro_torch import tune as T
from repro_torch.core.adi import _sweep_candidates, make_adi_operator
from repro_torch.core.cahn_hilliard import (
    CahnHilliardADI,
    CHConfig,
    ch_evolve,
    deep_quench_ic,
)
from repro_torch.core.stencil import stencil_create_1d_batch, stencil_create_2d

ROOT = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.filterwarnings(
    "ignore:.*the unified four-function facade:DeprecationWarning")


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    """A fresh, empty cache dir wired in through the env var."""
    root = tmp_path / "tune-cache"
    monkeypatch.setenv(T.ENV_VAR, str(root))
    monkeypatch.delenv(T.FORCE_ENV, raising=False)
    monkeypatch.delenv("REPRO_TUNE_NOPRIOR", raising=False)
    T.reset_stats()
    return T.TuneCache(root)


def _toy_candidates():
    return [{"w": 1}, {"w": 2}]


def _toy_build(cfg):
    w = cfg["w"]
    return lambda x: x * w


ARGS = (torch.ones(8),)
KEY_KW = dict(shape=(8,), dtype=torch.float32, bc="periodic", backend="auto")


class TestCacheHitMiss:
    def test_miss_measures_then_hit_does_not(self, cache):
        best = T.autotune(
            "toy", _toy_candidates(), _toy_build, ARGS, mode="cached", **KEY_KW
        )
        assert best in _toy_candidates()
        assert T.stats.cache_misses == 1
        assert T.stats.measure_runs >= 2  # both candidates timed
        (race,) = T.stats.races
        assert race["winner"] == best and len(race["measured"]) == 2
        runs_before = T.stats.measure_runs
        again = T.autotune(
            "toy", _toy_candidates(), _toy_build, ARGS, mode="cached", **KEY_KW
        )
        assert again == best
        assert T.stats.cache_hits == 1
        assert T.stats.measure_runs == runs_before  # no re-measurement

    def test_force_remeasures(self, cache):
        T.autotune("toy", _toy_candidates(), _toy_build, ARGS, mode="cached",
                   **KEY_KW)
        runs_before = T.stats.measure_runs
        T.autotune("toy", _toy_candidates(), _toy_build, ARGS, mode="force",
                   **KEY_KW)
        assert T.stats.measure_runs > runs_before

    def test_off_never_measures(self, cache):
        best = T.autotune(
            "toy", _toy_candidates(), _toy_build, ARGS, mode="off", **KEY_KW
        )
        assert best == _toy_candidates()[0]
        assert T.stats.measure_runs == 0

    def test_single_candidate_short_circuits(self, cache):
        best = T.autotune(
            "toy", [{"w": 7}], _toy_build, ARGS, mode="cached", **KEY_KW
        )
        assert best == {"w": 7}
        assert T.stats.measure_runs == 0

    def test_stale_cache_entry_not_in_candidates_is_miss(self, cache):
        key = T.tune_key("toy", extra=None, **KEY_KW)
        cache.put(key, {"w": 999})  # config no longer offered
        best = T.autotune(
            "toy", _toy_candidates(), _toy_build, ARGS, mode="cached", **KEY_KW
        )
        assert best in _toy_candidates()
        assert T.stats.cache_misses == 1

    def test_infeasible_candidate_is_skipped_and_a_failure_propagates(
            self, cache):
        """``build`` returning None rules a candidate out (as the geometry
        functions do on the host); an exception is not swallowed, unlike
        the reference's tuner: no fallback hides a failing kernel."""
        best = T.autotune(
            "toy", _toy_candidates(),
            lambda c: None if c["w"] == 2 else _toy_build(c), ARGS,
            mode="force", **KEY_KW)
        assert best == {"w": 1} and T.stats.measure_runs == 1

        def boom(x):
            raise RuntimeError("kernel failed")

        with pytest.raises(RuntimeError, match="kernel failed"):
            T.autotune("toy", _toy_candidates(),
                       lambda c: boom if c["w"] == 2 else _toy_build(c), ARGS,
                       mode="force", **KEY_KW)

    def test_cache_given_explicitly(self, cache, tmp_path):
        T.autotune("toy", _toy_candidates(), _toy_build, ARGS, mode="cached",
                   cache=T.TuneCache(tmp_path / "elsewhere"), **KEY_KW)
        assert list((tmp_path / "elsewhere").glob("*.json"))
        assert not cache.root.exists()


class TestSecondCreateIsFree:
    def test_adi_create_cached_performs_no_measurement(self, cache):
        make_adi_operator(32, 32, 0.3, cyclic=True, tune="cached",
                          device="cpu")
        assert T.stats.measure_runs > 0
        runs_before = T.stats.measure_runs
        op2 = make_adi_operator(32, 32, 0.3, cyclic=True, tune="cached",
                                device="cpu")
        assert T.stats.measure_runs == runs_before
        assert T.stats.cache_hits >= 2  # both sweeps hit
        assert op2.x_cfg is not None and op2.y_cfg is not None

    def test_ch_solver_second_create_is_free(self, cache):
        cfg = CHConfig(nx=32, ny=32, dt=1e-3, tune="cached", device="cpu")
        CahnHilliardADI(cfg)
        assert T.stats.measure_runs > 0
        runs_before = T.stats.measure_runs
        CahnHilliardADI(cfg)
        assert T.stats.measure_runs == runs_before

    def test_3d_operator_second_create_is_free(self, cache):
        rt.create("diffusion", (8, 12, 16), mode="adi", alpha=0.2,
                  tune="cached", device="cpu")
        assert T.stats.measure_runs > 0
        T.reset_stats()
        op = rt.create("diffusion", (8, 12, 16), mode="adi", alpha=0.2,
                       tune="cached", device="cpu")
        assert T.stats.measure_runs == 0 and T.stats.cache_hits == 3
        assert None not in (op.x_cfg, op.y_cfg, op.z_cfg)


class TestHostFingerprint:
    def test_key_contains_fingerprint(self):
        fp = T.host_fingerprint()
        assert fp and fp == T.host_fingerprint()
        key = json.loads(T.tune_key("k", shape=(8,), dtype=torch.float32))
        assert key["host"] == fp and fp.endswith("/cpu")
        assert key["torch"] == torch.__version__
        assert key["cuda"] == torch.version.cuda
        assert key["dtype"] == "float32"

    def test_differing_host_is_a_different_key(self, monkeypatch):
        from repro_torch.tune import cache as C

        base = T.tune_key("k", shape=(8,), dtype=torch.float32)
        monkeypatch.setattr(C, "host_fingerprint",
                            lambda device="cpu": "other-arch/96cpu/H100")
        assert T.tune_key("k", shape=(8,), dtype=torch.float32) != base

    def test_device_is_part_of_the_key(self, monkeypatch):
        from repro_torch.tune import cache as C

        base = T.tune_key("k", shape=(8,), dtype=torch.float32)
        monkeypatch.setattr(C, "device_fingerprint",
                            lambda device="cpu": "NVIDIA H100/sm_90/132sm")
        C.host_fingerprint.cache_clear()
        try:
            card = T.tune_key("k", shape=(8,), dtype=torch.float32,
                              device="cuda:0")
        finally:
            C.host_fingerprint.cache_clear()
        assert card != base and "sm_90" in json.loads(card)["host"]

    def test_force_env_remeasures_on_hit(self, cache, monkeypatch):
        T.autotune("toy", _toy_candidates(), _toy_build, ARGS, mode="cached",
                   **KEY_KW)
        runs_before = T.stats.measure_runs
        monkeypatch.setenv(T.FORCE_ENV, "1")
        T.autotune("toy", _toy_candidates(), _toy_build, ARGS, mode="cached",
                   **KEY_KW)
        assert T.stats.measure_runs > runs_before  # hit was re-measured

    def test_force_env_does_not_enable_tuning_when_off(self, cache,
                                                       monkeypatch):
        monkeypatch.setenv(T.FORCE_ENV, "1")
        T.reset_stats()
        best = T.autotune(
            "toy", _toy_candidates(), _toy_build, ARGS, mode="off", **KEY_KW
        )
        assert best == _toy_candidates()[0]
        assert T.stats.measure_runs == 0

    def test_force_env_zero_is_off(self, cache, monkeypatch):
        T.autotune("toy", _toy_candidates(), _toy_build, ARGS, mode="cached",
                   **KEY_KW)
        runs_before = T.stats.measure_runs
        monkeypatch.setenv(T.FORCE_ENV, "0")
        T.autotune("toy", _toy_candidates(), _toy_build, ARGS, mode="cached",
                   **KEY_KW)
        assert T.stats.measure_runs == runs_before  # plain cached hit

    def test_enable_force(self, cache, monkeypatch):
        monkeypatch.setenv(T.FORCE_ENV, "0")  # restored after the test
        T.enable_force()
        import os

        assert os.environ[T.FORCE_ENV] == "1"


class TestKeyStability:
    def test_key_is_deterministic_across_processes(self, cache):
        kw = dict(shape=(64, 32), dtype=torch.float64, bc="periodic",
                  backend="auto", extra={"cyclic": True})
        key_here = T.tune_key("adi_solve_x", **kw)
        code = (
            "import torch; from repro_torch.tune import tune_key; "
            "print(tune_key('adi_solve_x', shape=(64, 32), "
            "dtype=torch.float64, bc='periodic', backend='auto', "
            "extra={'cyclic': True}), end='')"
        )
        key_there = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            check=True, env={"PYTHONPATH": str(ROOT / "src"),
                             "PATH": "/usr/bin:/bin:/usr/local/bin"},
        ).stdout
        assert key_here == key_there

    def test_key_discriminates(self):
        base = T.tune_key("k", shape=(8,), dtype=torch.float32)
        assert base != T.tune_key("k2", shape=(8,), dtype=torch.float32)
        assert base != T.tune_key("k", shape=(16,), dtype=torch.float32)
        assert base != T.tune_key("k", shape=(8,), dtype=torch.float64)
        assert base != T.tune_key("k", shape=(8,), dtype=torch.float32,
                                  bc="np")
        assert base == T.tune_key("k", shape=[8], dtype="float32")


class TestBitMatch:
    def test_tuned_plans_bit_match_untuned_fp64(self, cache):
        rng = np.random.default_rng(0)
        data = torch.as_tensor(rng.standard_normal((32, 32)))
        w = rng.standard_normal((5, 5))
        p0 = stencil_create_2d("xy", "periodic", weights=w, backend="torch",
                               device="cpu")
        p1 = stencil_create_2d("xy", "periodic", weights=w, backend="torch",
                               tune="cached", shape=(32, 32), device="cpu")
        assert torch.equal(p0.apply(data), p1.apply(data))
        w1 = rng.standard_normal(5)
        b0 = stencil_create_1d_batch("periodic", weights=w1, backend="torch",
                                     device="cpu")
        b1 = stencil_create_1d_batch("periodic", weights=w1, backend="torch",
                                     tune="cached", shape=(32, 32),
                                     device="cpu")
        assert torch.equal(b0.apply(data), b1.apply(data))

    def test_tuned_auto_plans_bit_match_when_fft_loses(self, cache):
        """Under 'auto' the race includes fft; whenever the plain path
        wins, the tuned plan computes the untuned one's bits."""
        rng = np.random.default_rng(1)
        for name, shape in (("laplacian", (32, 32)), ("biharmonic", (32, 32)),
                            ("laplacian", (8, 12, 16))):
            data = torch.as_tensor(rng.standard_normal(shape))
            p0 = rt.create(name, shape, device="cpu")
            p1 = rt.create(name, shape, tune="force", device="cpu")
            if p1.backend != "fft":
                assert p1.geometry is None
                assert torch.equal(p0.apply(data), p1.apply(data)), name

    def test_tuned_ch_step_matches_untuned_fp64(self, cache):
        c0 = deep_quench_ic(32, 32, seed=1, device="cpu")
        s0 = CahnHilliardADI(CHConfig(nx=32, ny=32, dt=1e-3, backend="torch",
                                      device="cpu"))
        s1 = CahnHilliardADI(CHConfig(nx=32, ny=32, dt=1e-3, backend="torch",
                                      tune="cached", device="cpu"))
        c1 = s0.initial_step(c0)
        a0, _ = s0.step(c1, c0)
        a1, _ = s1.step(c1, c0)
        # an explicit backend keeps fft out of the race: bitwise equal
        assert torch.equal(a0, a1)

    def test_tune_needs_shape(self):
        with pytest.raises(ValueError):
            stencil_create_2d("xy", "periodic", weights=np.ones((3, 3)),
                              tune="cached", device="cpu")

    def test_bad_mode_rejected(self):
        with pytest.raises(ValueError):
            make_adi_operator(16, 16, 0.1, tune="always", device="cpu")
        with pytest.raises(ValueError):
            CHConfig(nx=16, ny=16, tune="sometimes", device="cpu").validate()


class TestStreamGeometryGrid:
    N = 32
    KW = dict(nx=N, ny=N, dt=1e-3, rhs_mode="fused", backend="torch",
              streams=2, max_tile_bytes=N * N * 8 // 4, device="cpu")

    def test_tuned_streamed_solver_matches_untuned(self, cache):
        """The (width x chunk_rows) grid is result-invariant: a tuned
        streamed solver's 20 steps equal the untuned one's bit for bit."""
        s0 = CahnHilliardADI(CHConfig(**self.KW))
        s1 = CahnHilliardADI(CHConfig(**self.KW, tune="force"))
        assert s1._streams_eff >= 1
        assert s1._chunk_rows_eff is None or self.N % s1._chunk_rows_eff == 0
        race = [r for r in T.stats.races if r["kernel"] == "ch_stream_geometry"]
        assert len(race) == 1 and len(race[0]["measured"]) > 1
        c0 = deep_quench_ic(self.N, self.N, seed=4, device="cpu")
        a0, _ = ch_evolve(s0, c0, 20)
        a1, _ = ch_evolve(s1, c0, 20)
        assert torch.equal(a0, a1)

    def test_geometry_winner_is_cached(self, cache):
        CahnHilliardADI(CHConfig(**self.KW, tune="cached"))
        runs_before = T.stats.measure_runs
        s = CahnHilliardADI(CHConfig(**self.KW, tune="cached"))
        assert T.stats.measure_runs == runs_before  # second Create is free
        assert (s._streams_eff, s._chunk_rows_eff) != (None, None)

    def test_candidates_respect_the_byte_budget(self, cache):
        CahnHilliardADI(CHConfig(**self.KW, tune="force"))
        (race,) = [r for r in T.stats.races
                   if r["kernel"] == "ch_stream_geometry"]
        heights = {m["config"]["chunk_rows"] for m in race["measured"]}
        widths = {m["config"]["streams"] for m in race["measured"]}
        # ny/4 = 8 and ny/8 = 4 rows plus the halo exceed 2048 bytes
        assert heights == {None, 2} and widths == {1, 2, 4, 8}


class TestCorruptedCache:
    def test_corrupted_file_is_ignored_not_fatal(self, cache):
        key = T.tune_key("toy", extra=None, **KEY_KW)
        T.autotune("toy", _toy_candidates(), _toy_build, ARGS, mode="cached",
                   **KEY_KW)
        path = cache.path_for(key)
        assert path.exists()
        path.write_bytes(b"{ not json at all \x00\xff")
        T.reset_stats()
        again = T.autotune(
            "toy", _toy_candidates(), _toy_build, ARGS, mode="cached", **KEY_KW
        )
        assert again in _toy_candidates()
        assert T.stats.cache_misses == 1  # treated as a miss, re-measured
        healed = json.loads(path.read_text())
        assert healed["key"] == key and healed["best"] in _toy_candidates()

    def test_foreign_key_file_is_miss(self, cache):
        key = T.tune_key("toy", extra=None, **KEY_KW)
        path = cache.path_for(key)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps({"key": "something-else", "best": {"w": 5}}))
        assert cache.get(key) is None

    def test_missing_dir_is_miss(self, tmp_path):
        c = T.TuneCache(tmp_path / "never-created")
        assert c.get("whatever") is None

    def test_roundtrip_and_unserialisable_payload(self, tmp_path):
        c = T.TuneCache(tmp_path)
        c.put("k", {"backend": "auto"}, us=1.5)
        assert c.get("k") == {"backend": "auto"}
        c.put("k", {"bad": {1, 2, 3}})  # a set is not JSON
        assert c.get("k") == {"backend": "auto"}  # old entry intact
        assert list(tmp_path.glob("*.tmp")) == []


class TestSpectralArbitrage:
    def test_fft_winner_round_trips_the_cache(self, cache):
        candidates = [{"backend": "auto"}, {"backend": "fft"}]

        def build(cfg):
            if cfg["backend"] == "fft":
                return lambda x: x

            def slow(x):  # 50 ms: past the spread of a loaded host
                time.sleep(0.05)
                return x
            return slow

        kw = dict(shape=(64, 64), dtype=torch.float64, bc="periodic",
                  backend="auto", extra={"cyclic": True, "operator": "hyper"})
        best = T.autotune("adi_solve_x", candidates, build, ARGS,
                          mode="force", **kw)
        assert best["backend"] == "fft"
        T.reset_stats()
        again = T.autotune("adi_solve_x", candidates, build, ARGS,
                           mode="cached", **kw)
        assert again["backend"] == "fft"
        assert T.stats.measure_runs == 0 and T.stats.cache_hits == 1

    def test_fft_tuned_adi_plan_round_trips_cross_process(self, cache):
        op = rt.create("hyperdiffusion", (64, 64), mode="adi", alpha=0.2,
                       tune="force", lint="off", device="cpu")
        code = (
            "import json\n"
            "import repro_torch as rt\n"
            "from repro_torch import tune as T\n"
            "T.reset_stats()\n"
            "op = rt.create('hyperdiffusion', (64, 64), mode='adi',"
            " alpha=0.2, tune='cached', lint='off', device='cpu')\n"
            "print(json.dumps({'runs': T.stats.measure_runs,"
            " 'x': op.x_cfg, 'y': op.y_cfg}), end='')\n"
        )
        out = subprocess.run(
            [sys.executable, "-c", code], capture_output=True, text=True,
            check=True, env={"PYTHONPATH": str(ROOT / "src"),
                             "PATH": "/usr/bin:/bin:/usr/local/bin",
                             T.ENV_VAR: str(cache.root)},
        ).stdout
        got = json.loads(out)
        assert got["runs"] == 0, "cross-process Create re-measured"
        assert got["x"] == op.x_cfg and got["y"] == op.y_cfg

    def test_explicit_backend_excludes_fft_from_the_race(self, cache):
        kw = dict(itemsize=8, device="cpu", cyclic=True)
        assert all(c["backend"] != "fft"
                   for c in _sweep_candidates("rows", 32, 32, **kw))
        assert {"backend": "fft"} in _sweep_candidates("rows", 32, 32,
                                                       fft=True, **kw)
        # off the card the sweep races no launch geometry
        assert _sweep_candidates("cols", 32, 32, backend="cuda", **kw) == [
            {"backend": "cuda"}]
        op = rt.create("hyperdiffusion", (32, 32), mode="adi", alpha=0.2,
                       backend="torch", tune="force", device="cpu")
        assert T.stats.measure_runs == 0
        assert op.x_cfg == op.y_cfg == {"backend": "torch", "geometry": None}

    def test_auto_stencil_plan_races_fft(self, cache, monkeypatch):
        """The speculative symbol is attached under 'auto' with tuning on,
        so the race includes fft (the prior disabled, so that it races); the
        tuned plan keeps a symbol either way and stays correct."""
        monkeypatch.setenv("REPRO_TUNE_NOPRIOR", "1")
        plan = rt.create("hyperdiffusion", (64, 64), tune="force", lint="off",
                         device="cpu")
        assert plan.symbol is not None
        assert plan.backend in ("auto", "fft")
        (race,) = T.stats.races
        assert {m["config"]["backend"] for m in race["measured"]} == {
            "auto", "fft"}
        rng = np.random.default_rng(3)
        x = torch.as_tensor(rng.standard_normal((64, 64)))
        ref = rt.create("hyperdiffusion", (64, 64), backend="torch",
                        lint="off", device="cpu")
        torch.testing.assert_close(plan.apply(x), ref.apply(x), rtol=1e-10,
                                   atol=1e-10)

    def test_fft_winning_adi_operator_matches_within_fft_scale(self, cache):
        op0 = rt.create("hyperdiffusion", (32, 32), mode="adi", alpha=0.2,
                        device="cpu")
        op1 = dataclasses.replace(op0, x_cfg={"backend": "fft", "geometry": None},
                                y_cfg={"backend": "fft", "geometry": None})
        rng = np.random.default_rng(5)
        x = torch.as_tensor(rng.standard_normal((32, 32)))
        from repro_torch.util import tolerance_for

        torch.testing.assert_close(rt.compute(op1, x), rt.compute(op0, x),
                                   **tolerance_for("float64", scale=50))


class TestCostPrior:
    def test_prune_keeps_the_band_and_drops_the_rest(self):
        cands = [{"w": 1}, {"w": 2}, {"w": 3}]
        scores = {1: 100.0, 2: 120.0, 3: 1000.0}
        kept, dropped = T.prune_candidates(cands, lambda c: scores[c["w"]])
        assert kept == [{"w": 1}, {"w": 2}]  # 1.2x is inside the band
        assert dropped == [{"w": 3}]

    def test_unscorable_candidates_always_race(self):
        kept, dropped = T.prune_candidates(
            [{"w": 1}, {"w": 2}], lambda c: 1.0 if c["w"] == 1 else None)
        assert dropped == [] and len(kept) == 2

    def test_scoring_exception_means_keep(self):
        def prior(c):
            if c["w"] == 2:
                raise RuntimeError("cannot model")
            return float(c["w"])

        kept, dropped = T.prune_candidates([{"w": 1}, {"w": 2}, {"w": 30}],
                                           prior)
        assert {"w": 2} in kept and dropped == [{"w": 30}]

    def test_autotune_skips_measuring_dominated_candidates(self, cache):
        calls = []

        def build(cfg):
            calls.append(cfg["w"])
            return _toy_build(cfg)

        best = T.autotune(
            "toy", _toy_candidates(), build, ARGS, **KEY_KW,
            mode="force", prior=lambda c: {1: 1.0, 2: 100.0}[c["w"]],
        )
        assert best == {"w": 1}
        assert calls == []
        assert T.stats.measure_runs == 0
        assert T.stats.pruned == 1

    def test_stencil_prior_prefers_direct_for_sparse_small(self):
        prior = T.stencil_prior((64, 64), taps=5, itemsize=8)
        direct = prior({"backend": "auto"})
        fft = prior({"backend": "fft"})
        assert direct < fft  # 5-tap laplacian at 64^2: direct wins
        assert prior({"backend": "cuda", "geometry": {"route": "direct"}}) \
            == direct  # every launch geometry scores alike
        assert prior({"backend": "mystery"}) is None

    def test_stencil_prior_scores_the_port_as_implemented(self):
        """A direct apply moves expected_stencil's bytes (one read, one
        write), not the reference jnp path's taps + 1 passes."""
        from repro_torch.analysis import expected_stencil

        e = expected_stencil((64, 64), 13, 8)
        prior = T.stencil_prior((64, 64), taps=13, itemsize=8)
        assert prior({"backend": "auto"}) == T.predicted_score(e)
        assert prior({"backend": "auto"}) < (13 + 1) * 64 * 64 * 8

    def test_noprior_env_disables_pruning(self, monkeypatch):
        monkeypatch.setenv("REPRO_TUNE_NOPRIOR", "1")
        assert not T.prior_enabled()
        monkeypatch.setenv("REPRO_TUNE_NOPRIOR", "0")
        assert T.prior_enabled()

    def test_plan_prior_measures_strictly_less_same_winner_fp64(
            self, cache, monkeypatch):
        """The laplacian at 64^2 under 'auto' races the plain path against
        fft.  With the prior the fft candidate is pruned (strictly fewer
        measurements); the winner and the fp64 numbers are asserted equal
        when fft loses the unpruned race, which a wall-clock race on a
        loaded host may rarely flip."""
        rng = np.random.default_rng(7)
        x = torch.as_tensor(rng.standard_normal((64, 64)))
        monkeypatch.setenv("REPRO_TUNE_NOPRIOR", "1")
        T.reset_stats()
        p_off = rt.create("laplacian", (64, 64), tune="force", lint="off",
                          device="cpu")
        runs_off = T.stats.measure_runs
        monkeypatch.delenv("REPRO_TUNE_NOPRIOR")
        T.reset_stats()
        p_on = rt.create("laplacian", (64, 64), tune="force", lint="off",
                         device="cpu")
        runs_on = T.stats.measure_runs
        assert runs_off >= 2, "without the prior both candidates race"
        assert runs_on < runs_off, "the prior must measure strictly less"
        assert T.stats.pruned >= 1
        assert p_on.backend == "auto"
        if p_off.backend == "auto":
            assert torch.equal(p_on.apply(x), p_off.apply(x))


class TestSpreadRule:
    """The default stays unless the fastest candidate beats it by more
    than the spread of either's timings (a port-only rule: a race decided
    by noise changes nothing)."""

    @pytest.mark.parametrize("times,winner,kept", [
        ({1: [10.0, 11.0, 14.0], 2: [9.0, 10.5, 12.0]}, {"w": 1}, True),
        ({1: [10.0, 11.0, 12.0], 2: [5.0, 5.5, 6.0]}, {"w": 2}, False),
        ({1: [10.0, 11.0, 12.0], 2: [11.5, 12.0, 13.0]}, {"w": 1}, False),
    ])
    def test_default_kept_within_the_spread(self, cache, monkeypatch, times,
                                            winner, kept):
        from repro_torch.tune import autotuner

        def fake(fn, args, **kw):
            autotuner.stats.measure_runs += 1
            return sorted(times[fn.w]), False

        def build(cfg):
            f = _toy_build(cfg)
            f.w = cfg["w"]
            return f

        monkeypatch.setattr(autotuner, "_timings", fake)
        best = T.autotune("toy", _toy_candidates(), build, ARGS,
                          mode="force", **KEY_KW)
        (race,) = T.stats.races
        assert best == winner and race["kept_default"] is kept
        assert race["held"] is None  # no card: no stream hold
        assert [m["spread_us"] for m in race["measured"]] == [
            max(times[w]) - min(times[w]) for w in (1, 2)]


class TestStreamedRacesNoGeometry:
    def test_a_streamed_sweep_offers_no_launch_geometry(self):
        """``geometries=False`` (a sweep that streams at the Create shape)
        leaves the backend and fft alone, without consulting a card."""
        kw = dict(itemsize=8, device="cuda", cyclic=True, fft=True)
        for layout in ("rows", "cols", "mid"):
            assert _sweep_candidates(layout, 32, 32, geometries=False,
                                     **kw) == [{"backend": "auto"},
                                               {"backend": "fft"}]


class TestReferenceParity:
    """The port's tuner against the reference's (``repro.tune``) on the
    same seeded numpy inputs: tuned Computes of the biharmonic plan and the
    2D and 3D ADI operators, the prior's prune decisions, the key's fields
    and the autotune contract's outcomes on the same toy candidates.

    Tolerances: ``tolerance_for('float64', scale=10)`` where both
    packages' winners run the direct path (the recurrences' rounding, as
    in ``test_torch_adi3d.py``), the fft scale 50 where either's winner is
    fft (a wall-clock race on each side may pick either)."""

    CASES = {
        "biharmonic plan": (("biharmonic", (32, 32)), {}),
        "hyperdiffusion ADI": (("hyperdiffusion", (32, 32)),
                               dict(mode="adi", alpha=0.2)),
        "3D diffusion ADI": (("diffusion", (8, 12, 16)),
                             dict(mode="adi", alpha=0.2)),
    }

    @staticmethod
    def _uses_fft(obj) -> bool:
        cfgs = [getattr(obj, k, None) for k in ("x_cfg", "y_cfg", "z_cfg")]
        return getattr(obj, "backend", None) == "fft" or any(
            (c or {}).get("backend") == "fft" for c in cfgs)

    @pytest.mark.parametrize("case", sorted(CASES))
    def test_tuned_compute_matches_reference(self, cache, case):
        import jax.numpy as jnp

        import repro
        from repro import tune as RT
        from repro_torch.util import tolerance_for

        args, kw = self.CASES[case]
        rng = np.random.default_rng(11)
        x = rng.standard_normal(args[1])
        RT.reset_stats()
        ref = repro.create(*args, tune="force", lint="off", **kw)
        mine = rt.create(*args, tune="force", lint="off", device="cpu", **kw)
        # each tuner raced, or its prior settled the race
        for st in (T.stats, RT.stats):
            assert st.tuned + st.pruned >= 1
        want = np.asarray(repro.compute(ref, jnp.asarray(x)))
        got = rt.compute(mine, torch.as_tensor(x)).numpy()
        fft = self._uses_fft(mine) or self._uses_fft(ref)
        np.testing.assert_allclose(
            got, want, **tolerance_for("float64", scale=50 if fft else 10))

    @pytest.mark.parametrize("scores", [
        [100.0, 120.0, 1000.0],
        [100.0, 150.0, 150.1],
        [None, 3.0, 1.0],
        [7.0],
        [2.0, None],
    ])
    def test_prune_decisions_match_reference(self, scores):
        from repro.tune import prior as RP

        cands = [{"i": i} for i in range(len(scores))]
        score = lambda c: scores[c["i"]]  # noqa: E731
        assert T.PRUNE_RATIO == RP.PRUNE_RATIO
        assert T.prune_candidates(cands, score) == RP.prune_candidates(
            cands, score)

    def test_key_fields_match_reference(self):
        import jax
        import jax.numpy as jnp

        from repro import tune as RT

        kw = dict(shape=(64, 32), bc="periodic", backend="auto",
                  extra={"cyclic": True, "operator": "hyperdiffusion"})
        ref = json.loads(RT.tune_key("adi_solve_x", dtype=jnp.float64, **kw))
        mine = json.loads(T.tune_key("adi_solve_x", dtype=torch.float64,
                                     **kw))
        # the framework's versions take the place of jax's
        assert set(ref) - {"jax"} == set(mine) - {"torch", "cuda"}
        assert ref["jax"] == jax.__version__
        for field in ("schema", "kernel", "shape", "dtype", "bc", "backend",
                      "extra"):
            assert mine[field] == ref[field], field

    @pytest.mark.parametrize("outcome", ["off", "single", "stale", "hit",
                                         "force", "winner"])
    def test_autotune_outcomes_match_reference(self, cache, outcome):
        """The same toy candidates through both tuners: the returned
        config and the counters (measurements, hits, misses) agree.  The
        default (first) candidate is the fast one, except in ``winner``,
        where the second is faster by 50 ms, far past a loaded host's
        spread, so both tuners must switch to it."""
        import jax.numpy as jnp

        from repro import tune as RT

        def builder(fast, sleep):
            def build(cfg):
                w = cfg["w"]

                def f(x):
                    if w != fast:
                        time.sleep(sleep)
                    return x * w
                return f
            return build

        cands = [{"w": 1}, {"w": 2}]
        runs = []
        for pkg, args, dtype in ((T, ARGS, torch.float32),
                                 (RT, (jnp.ones(8),), jnp.float32)):
            kw = dict(shape=(8,), dtype=dtype, bc="periodic", backend="auto")
            build = (builder(fast=2, sleep=0.05) if outcome == "winner"
                     else builder(fast=1, sleep=0.005))
            pkg.reset_stats()
            if outcome == "off":
                best = pkg.autotune("toy", cands, build, args, mode="off",
                                    **kw)
            elif outcome == "single":
                best = pkg.autotune("toy", [{"w": 7}], build, args,
                                    mode="cached", **kw)
            elif outcome == "stale":
                cache.put(pkg.tune_key("toy", **kw), {"w": 999})
                best = pkg.autotune("toy", cands, build, args, mode="cached",
                                    **kw)
            elif outcome == "hit":
                pkg.autotune("toy", cands, build, args, mode="cached", **kw)
                pkg.reset_stats()
                best = pkg.autotune("toy", cands, build, args, mode="cached",
                                    **kw)
            elif outcome == "force":
                pkg.autotune("toy", cands, build, args, mode="cached", **kw)
                pkg.reset_stats()
                best = pkg.autotune("toy", cands, build, args, mode="force",
                                    **kw)
            else:
                best = pkg.autotune("toy", cands, build, args, mode="force",
                                    **kw)
            st = pkg.stats
            runs.append((best, st.measure_runs, st.cache_hits,
                         st.cache_misses, st.tuned))
        assert runs[0] == runs[1], runs
        if outcome == "winner":
            assert runs[0][0] == {"w": 2}
        elif outcome in ("stale", "force", "hit"):
            assert runs[0][0] == {"w": 1}
