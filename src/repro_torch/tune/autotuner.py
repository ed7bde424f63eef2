"""Create-time autotuner: measure candidate configurations, keep the winner
(counterpart of ``repro.tune.autotuner``).

The plan layer (``create(tune=...)``, the ADI factories, ``CHConfig``,
``ServeEngine``) passes a ``tune`` knob through to :func:`autotune`:

- ``'off'``     — no measurement; the static geometry functions choose the
  configuration, exactly the untuned behaviour.
- ``'cached'``  — look the problem up in the persistent cache
  (:mod:`repro_torch.tune.cache`); measure only on a miss and store the
  winner, so repeated plan creation is free.
- ``'force'``   — always re-measure (and refresh the cache entry).

Candidates are plain dicts of knob values; the caller supplies a
``build(config) -> callable`` factory producing a ready-to-time closure
over representative arguments, or ``None`` to declare the config
infeasible.  On the card a candidate is a launch geometry the port's
kernels already support (or the fft backend); one the card cannot run is
ruled out on the host by the kernels' geometry functions before any
launch, so ``build`` returns ``None`` for it.  **Deliberate difference
from the reference:** the reference skips a candidate whose build or
timed call raises; here an exception — a CUDA error during a measurement
among them — propagates, so no fallback hides a failing kernel.

Timing (:func:`measure`) is a median of a few calls: CUDA events after a
``torch.cuda.synchronize()`` on the card, ``perf_counter`` on the CPU.

Module-level :data:`stats` counts measurement runs and cache hits/misses
so tests (and curious users) can verify that a cached Create performs no
measurement work at all, and keeps each race's candidates, times, pruned
candidates and winner in ``stats.races``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from collections.abc import Callable, Sequence

import torch

from repro_torch.tune.cache import TuneCache, tune_key

MODES = ("off", "cached", "force")

# Escape hatch for a warm cache shipped between hosts: with
# REPRO_TUNE_FORCE=1 every tune='cached' Create re-measures and refreshes
# its cache entry, even on a hit.  tune='off' stays off: the hatch forces
# re-measurement, never measurement.
FORCE_ENV = "REPRO_TUNE_FORCE"

# the device-side sleep's cycles a second, measured once a card
_SLEEP_HZ: dict = {}


def _force_requested() -> bool:
    return os.environ.get(FORCE_ENV, "").strip().lower() not in (
        "", "0", "false",
    )


def enable_force() -> None:
    """Turn the re-measurement escape hatch on for this process: every
    subsequent ``tune='cached'`` Create re-measures and refreshes its
    cache entry."""
    os.environ[FORCE_ENV] = "1"


@dataclasses.dataclass
class TuneStats:
    """Instrumentation counters (reset with :func:`reset_stats`).
    ``races`` holds one record a measured :func:`autotune` call: its kernel,
    each measured candidate with its microseconds, the candidates the
    prior pruned, and the winner."""

    measure_runs: int = 0  # individual candidate timings executed
    cache_hits: int = 0
    cache_misses: int = 0
    tuned: int = 0  # autotune() calls that produced a winner
    pruned: int = 0  # candidates skipped by the analytic cost prior
    races: list = dataclasses.field(default_factory=list)


stats = TuneStats()


def reset_stats() -> TuneStats:
    """Zero the counters in place (the module-level object stays valid)."""
    stats.measure_runs = 0
    stats.cache_hits = 0
    stats.cache_misses = 0
    stats.tuned = 0
    stats.pruned = 0
    stats.races.clear()
    return stats


def check_mode(mode: str) -> str:
    if mode not in MODES:
        raise ValueError(f"tune must be one of {MODES}, got {mode!r}")
    return mode


def _device_of(args) -> torch.device:
    """The device of the first tensor among ``args`` (the CPU if none)."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return torch.device("cpu")


def _sleep_hz(dev: torch.device, sleep) -> float:
    """Cycles a second of ``sleep`` (``torch.cuda._sleep``) on ``dev``,
    timed once by CUDA events, so that a hold of a given length needs no
    assumed clock."""
    if dev not in _SLEEP_HZ:
        cycles = 2_000_000
        sleep(cycles)  # warm
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sleep(cycles)
        end.record()
        end.synchronize()
        _SLEEP_HZ[dev] = cycles / max(start.elapsed_time(end) * 1e-3, 1e-9)
    return _SLEEP_HZ[dev]


def _timings(fn: Callable, args, *, warmup: int, repeat: int,
             hold: bool) -> tuple[list[float], bool]:
    """``repeat`` timings in microseconds of ``fn(*args)``, sorted, and
    whether the stream was held (see :func:`measure`)."""
    stats.measure_runs += 1
    dev = _device_of(args)
    for _ in range(warmup):
        fn(*args)
    times, held = [], False
    if dev.type == "cuda":
        sleep = getattr(torch.cuda, "_sleep", None) if hold else None
        held = sleep is not None
        with torch.cuda.device(dev):
            cycles = 0
            if held:
                # the host's enqueue time of one warm call sizes the hold
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(*args)
                host_s = time.perf_counter() - t0
                cycles = int(min(2.0 * host_s * _sleep_hz(dev, sleep),
                                 1e9)) + 100_000
            torch.cuda.synchronize()
            for _ in range(repeat):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                if held:
                    sleep(cycles)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) * 1e3)
    else:
        for _ in range(repeat):
            t0 = time.perf_counter()
            fn(*args)
            times.append((time.perf_counter() - t0) * 1e6)
    times.sort()
    return times, held


def measure(fn: Callable, *args, warmup: int = 1, repeat: int = 3,
            hold: bool = True) -> float:
    """Median microseconds a call of ``fn(*args)`` takes (counts toward
    ``stats.measure_runs``).

    On the card each call is timed by a pair of CUDA events after a
    ``torch.cuda.synchronize()``.  With ``hold`` (the default) the stream
    is first held by a device-side sleep (``torch.cuda._sleep``, its clock
    measured once a card) long enough for the host to enqueue the call, so
    the events time the device's work alone: what a launch geometry
    changes, the host's cost being the same for every geometry of one
    kernel.  A torch without ``_sleep`` times the call unheld, host
    enqueue included; :func:`autotune` records ``held`` in each race.
    ``hold=False`` times the call as its caller's stream sees it (for
    knobs that change the host's work, such as the streamed chunk count).
    On the CPU, ``perf_counter``."""
    times, _ = _timings(fn, args, warmup=warmup, repeat=repeat, hold=hold)
    return times[len(times) // 2]


def autotune(
    kernel: str,
    candidates: Sequence[dict],
    build: Callable[[dict], Callable | None],
    args: Sequence,
    *,
    shape,
    dtype,
    bc: str | None = None,
    backend: str | None = None,
    extra=None,
    mode: str = "cached",
    default: dict | None = None,
    cache: TuneCache | None = None,
    prior: Callable[[dict], float | None] | None = None,
    hold: bool = True,
) -> dict:
    """Pick the fastest candidate configuration for one kernel problem.

    Returns the winning config dict.  ``mode='off'`` (or an empty or
    single candidate list) short-circuits to ``default`` (or the first
    candidate) without any measurement.  A candidate whose ``build``
    returns ``None`` is skipped; if every candidate is, the default is
    returned.  An exception from ``build`` or from the timed call
    propagates (a deliberate difference from the reference, which skips
    such a candidate).  The problem runs on the device of ``args``'s first
    tensor, which is part of the cache key; ``hold`` is :func:`measure`'s.
    ``cache`` is a :class:`~repro_torch.tune.cache.TuneCache` (None: the
    default directory).

    The fastest candidate (by median) wins, but the default stays unless
    it is beaten by more than the spread (slowest minus fastest timing)
    of either's timings; each race's record says so in ``kept_default``,
    and in ``held`` whether its card timings held the stream (None off
    the card).

    ``prior`` is an optional analytic scorer ``config -> predicted time
    proxy`` (:mod:`repro_torch.tune.prior`): candidates predicted far
    slower than the best prediction are skipped without measurement
    (counted in ``stats.pruned``).  The cache is still consulted against
    the *full* candidate list, so a previously measured winner is
    honoured even if the prior would have pruned it; a prune down to a
    single survivor returns it unmeasured (and uncached — the next Create
    re-derives it from the prior for free).
    """
    check_mode(mode)
    if mode == "cached" and _force_requested():
        mode = "force"  # REPRO_TUNE_FORCE: re-measure on a hit
    candidates = list(candidates)
    fallback = default if default is not None else (
        candidates[0] if candidates else {})
    if mode == "off" or len(candidates) <= 1:
        return dict(fallback)

    device = _device_of(args)
    key = tune_key(kernel, shape=shape, dtype=dtype, bc=bc, backend=backend,
                   extra=extra, device=device)
    cache = cache if cache is not None else TuneCache()

    if mode == "cached":
        best = cache.get(key)
        if isinstance(best, dict) and best in candidates:
            stats.cache_hits += 1
            return dict(best)
        stats.cache_misses += 1

    to_measure, dropped = candidates, []
    if prior is not None:
        from repro_torch.tune.prior import prune_candidates

        to_measure, dropped = prune_candidates(candidates, prior)
        stats.pruned += len(dropped)
        if len(to_measure) == 1:
            return dict(to_measure[0])

    measured, held = [], []
    for config in to_measure:
        fn = build(dict(config))
        if fn is None:
            continue
        times, h = _timings(fn, args, warmup=1, repeat=3, hold=hold)
        held.append(h)
        measured.append(dict(config=dict(config), us=times[len(times) // 2],
                             spread_us=times[-1] - times[0]))
    if not measured:
        return dict(fallback)
    win = min(measured, key=lambda m: m["us"])
    # the default stays unless the winner beats it by more than the
    # spread of either's timings: a race decided by noise changes nothing
    base = next((m for m in measured if m["config"] == fallback), None)
    kept_default = (base is not None and win is not base and
                    base["us"] - win["us"] <= max(base["spread_us"],
                                                  win["spread_us"]))
    if kept_default:
        win = base
    best, best_us = dict(win["config"]), win["us"]
    stats.tuned += 1
    stats.races.append(dict(kernel=kernel, shape=[int(s) for s in shape],
                            device=str(device), measured=measured,
                            pruned=[dict(c) for c in dropped], winner=best,
                            us=best_us, kept_default=kept_default,
                            held=all(held) if device.type == "cuda" else None))
    cache.put(key, best, us=best_us)
    return best
