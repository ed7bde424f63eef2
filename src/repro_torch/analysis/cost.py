"""The cost model: the analytic floors of each plan family and the measured
cost of one call (counterpart of ``repro.analysis.cost``).

The floors (:class:`Expected`, :func:`expected_stencil`,
:func:`expected_fft`, :func:`expected_penta`, :func:`expected_ch_step`)
say what the paper's roofline argument says one Compute *should* cost: the
flops it executes, the bytes it moves through memory and the memory it
holds live at peak.  A direct stencil apply reads one field and its halo
and writes one field, ``2*taps`` flops a point; an fft apply spends
``~10 n log2 n`` flops over a handful of field passes; a factored penta
solve O(1) flops a point.  :mod:`repro_torch.tune.prior` ranks the
autotuner's candidates with them.  The numbers are the reference's for the
same arguments (``tests/test_torch_cost.py`` holds them to 1e-12
relative), so ``expected_penta`` keeps the reference's six field passes a
sweep where the port's kernel moves two (PERF.md compares them with the
card's bounds).

The measured half (:func:`measure`, the counterpart of
``measure_compiled``) reads the op trace of one call
(:mod:`repro_torch.analysis.trace`) in place of compiled HLO:

- flops: each elementwise aten op counts its output's elements (the
  reference's ``_ELEMENTWISE`` table, transcendentals as one), a
  reduction its input's, an fft ``5 n log2 n``, a matmul or convolution
  its exact count (``torch.utils.flop_counter``'s formulas); a kernel
  launch counts the family floor's flops for the shape it ran on
  (:func:`launch_flops`), since no aten op shows its arithmetic;
- bytes: the inputs plus the outputs of each op that is not a view, and
  the tensor arguments of each kernel launch;
- peak memory: on the CPU the trace's live-storage high-water mark; on a
  card ``torch.cuda.max_memory_allocated()`` after
  ``reset_peak_memory_stats()``, less the bytes live before the call, plus
  the arguments' own bytes, so that both count arguments + outputs +
  temporaries as the reference's ``memory_stats`` does;
- loops: one :class:`LoopCost` a driver loop marked with
  :func:`~repro_torch.analysis.trace.trip`, its per-trip cost the largest
  trip's;
- device time (``timed=True``, on a card only): the call's device time,
  kernels and glue, by CUDA events around back-to-back calls on a stream
  held until the host has enqueued them (:func:`_device_ms`).  The ``device_time_budget``
  rule holds it to the floor's time on the H100's published peaks
  (:data:`HBM_BYTES_PER_S`, :data:`PEAK_FLOPS_FP64`).

The reference's HLO parser (``analyze_hlo``, ``parse_module`` and the
rest) has no counterpart: there is no HLO.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

__all__ = [
    "HBM_BYTES_PER_S",
    "PEAK_FLOPS_FP64",
    "SCHEMA_VERSION",
    "CostVector",
    "Expected",
    "LoopCost",
    "device_kernels",
    "expected_ch_step",
    "expected_fft",
    "expected_penta",
    "expected_stencil",
    "floor_ms",
    "launch_flops",
    "measure",
    "memory_stats",
    "op_flops",
]

SCHEMA_VERSION = 2  # the analysis/cost report schema (the reference's)

# Published H100 SXM peaks, from NVIDIA's H100 SXM data sheet: HBM3
# bandwidth and float64 outside the tensor cores (the bound column of
# PERF.md's kernel table)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS_FP64 = 34e12


@dataclasses.dataclass
class Expected:
    """The analytic floor for one Compute: what the paper's roofline
    argument says the kernel *should* cost."""

    flops: float
    bytes: float
    peak_memory: float
    # the analytic per-step traffic of one trip of the outermost loop;
    # 0 when the program has no loop floor
    step_bytes: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def expected_stencil(shape, taps: int, itemsize: int, *, halo: int = 0) -> Expected:
    """A direct stencil apply: read one field + halo, write one field;
    ``2*taps`` flops per point (multiply + accumulate per tap)."""
    n = 1
    for d in shape:
        n *= int(d)
    halo_pts = halo * (n // max(int(shape[-1]), 1)) * 2 if halo else 0
    bytes_ = (2 * n + halo_pts) * itemsize
    return Expected(
        flops=2.0 * taps * n,
        bytes=float(bytes_),
        peak_memory=float(3 * n * itemsize),  # in + out + one live temp
        step_bytes=float(bytes_),
    )


def expected_fft(shape, itemsize: int, *, transforms: int = 1) -> Expected:
    """A spectral apply: forward + inverse transform plus the symbol
    multiply — ``~2 * 5 n log2 n`` flops and a handful of field-sized
    passes (real field in/out, complex spectrum in/out, symbol read)."""
    n = 1
    for d in shape:
        n *= int(d)
    logn = max(math.log2(n), 1.0)
    flops = transforms * (2 * 5.0 * n * logn + 6.0 * n)
    # real in/out + complex intermediate (2x itemsize) passes + symbol
    bytes_ = transforms * (2 * n + 3 * 2 * n + 2 * n) * itemsize
    return Expected(
        flops=flops,
        bytes=float(bytes_),
        peak_memory=float(6 * n * itemsize),
        step_bytes=float(bytes_),
    )


def expected_penta(shape, itemsize: int, *, sweeps: int = 1) -> Expected:
    """A factored (cyclic) penta solve: forward + backward substitution
    (~2 FMAs each per unknown) plus the Woodbury closure (4 broadcast
    FMAs) — O(1) flops/point, ~constant field passes per sweep."""
    n = 1
    for d in shape:
        n *= int(d)
    per_pt_flops = 2 * (2 + 2) + 2 * 4  # substitutions + Woodbury FMAs
    # rhs read + solution write + factor rows + correction passes
    bytes_ = sweeps * 6 * n * itemsize
    return Expected(
        flops=float(sweeps * per_pt_flops * n),
        bytes=float(bytes_),
        peak_memory=float(4 * n * itemsize),
        step_bytes=float(bytes_ / max(sweeps, 1)),
    )


def expected_ch_step(shape, itemsize: int) -> Expected:
    """One fused Cahn–Hilliard ADI step: the explicit RHS (a ~25-tap
    biharmonic + 9-tap nonlinear Laplacian + axpys) and two implicit
    penta sweeps."""
    rhs = expected_stencil(shape, taps=34, itemsize=itemsize)
    solve = expected_penta(shape, itemsize, sweeps=2)
    n = 1
    for d in shape:
        n *= int(d)
    step_bytes = rhs.bytes + solve.bytes
    return Expected(
        flops=rhs.flops + solve.flops + 6.0 * n,
        bytes=step_bytes,
        peak_memory=float(6 * n * itemsize),
        step_bytes=float(step_bytes),
    )


def floor_ms(e: Expected) -> float:
    """The least time the H100 could take for a floor's work, in ms: the
    larger of its bytes over the HBM bandwidth and its flops over the
    float64 peak."""
    return max(e.bytes / HBM_BYTES_PER_S, e.flops / PEAK_FLOPS_FP64) * 1e3


# ---------------------------------------------------------------------------
# Flops of an aten op and of a kernel launch
# ---------------------------------------------------------------------------

# the reference's _ELEMENTWISE table under aten's names (the in-place and
# out= variants share the stem): one flop an output element
_ELEMENTWISE = frozenset({
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "exp", "expm1", "log",
    "log1p", "tanh", "sqrt", "rsqrt", "pow", "maximum", "minimum", "eq",
    "ne", "lt", "le", "gt", "ge", "where", "logical_and", "logical_or",
    "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
    "bitwise_xor", "bitwise_not", "sign", "floor", "ceil", "round", "cos",
    "sin", "atan2", "erf", "sigmoid", "remainder", "fmod", "clamp",
    "clamp_min", "clamp_max", "isfinite", "reciprocal", "square", "_to_copy",
})
# two operations an output element
_ELEMENTWISE2 = frozenset({"addcmul", "addcdiv", "lerp"})
_REDUCTIONS = frozenset({
    "sum", "mean", "amax", "amin", "max", "min", "prod", "norm",
    "linalg_vector_norm", "std", "var", "any", "all", "argmax", "argmin",
})
_FFT = frozenset({"_fft_r2c", "_fft_c2r", "_fft_c2c"})


def _numel(metas) -> int:
    return sum(math.prod(m.shape) for m in metas)


def op_flops(func, args, kwargs, out, record) -> float:
    """The flops of one aten op (module docstring): ``record`` is its
    :class:`~repro_torch.analysis.trace.OpRecord`."""
    from torch.utils.flop_counter import flop_registry

    packet = func.overloadpacket
    if packet in flop_registry:
        return float(flop_registry[packet](*args, **kwargs, out_val=out))
    stem = packet.__name__.rstrip("_")
    if stem in _ELEMENTWISE:
        return float(_numel(record.outputs))
    if stem in _ELEMENTWISE2:
        return 2.0 * _numel(record.outputs)
    if stem in _REDUCTIONS:
        return float(_numel(record.inputs[:1]))
    if stem in _FFT:
        n = max(_numel(record.inputs[:1]), _numel(record.outputs[:1]))
        return 5.0 * n * max(math.log2(n), 1.0) if n else 0.0
    return 0.0


# WENO5 has no floor among the families: about 170 flops a point on the
# upwind-only design (two phi of ~71 operations, 12 differences, the
# products and selects), as chip_smoke.py's bound counts them
_WENO_FLOPS_PER_POINT = 170


def launch_flops(record) -> float:
    """The flops of one kernel launch: the family floor's for the shape it
    ran on, with the tensor arguments in the wrapper's order (the field
    first; the sweeps' rhs and out last).  The stencil kernels count their
    Create-time taps (``record.taps``), or every window of their
    coefficient vector when they sum the dense box."""
    name, metas = record.name, record.inputs
    if name in ("stencil2d", "stencil1d_batch", "stencil3d"):
        taps = record.taps if record.taps is not None else math.prod(
            metas[1].shape)
        return expected_stencil(metas[0].shape, taps, 8).flops
    if name in ("penta_cols", "penta_rows", "penta_mid"):
        return expected_penta(metas[-1].shape, 8).flops
    if name == "ch_rhs":
        return expected_stencil(metas[0].shape, 34, 8).flops
    if name == "ch_rhs_xsweep":
        shape = metas[0].shape
        return (expected_stencil(shape, 34, 8).flops
                + expected_penta(shape, 8).flops)
    if name == "weno5_advect":
        return float(_WENO_FLOPS_PER_POINT * math.prod(metas[0].shape))
    raise ValueError(f"no flop count for kernel {name!r}")


# ---------------------------------------------------------------------------
# Measured cost vectors
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class LoopCost:
    """One driver loop of a measured call: its trip count and the cost of
    its costliest trip.

    ``per_trip_bytes`` is the quantity the ``no_remat`` rule budgets: on a
    healthy driver it does not depend on the trip count; a body that
    re-reads an O(trips) history every trip makes it grow with the trips
    (quadratic total traffic)."""

    body: str
    trips: int
    per_trip_flops: float
    per_trip_bytes: float


@dataclasses.dataclass
class CostVector:
    """The measured cost of one call: the three roofline inputs, the
    per-loop breakdown the ``no_remat`` rule reads, and the device time a
    call (ms; None where it was not measured, always on the CPU)."""

    flops: float
    bytes: float
    peak_memory: float
    loops: list[LoopCost] = dataclasses.field(default_factory=list)
    device_ms: float | None = None

    @property
    def intensity(self) -> float:
        """Arithmetic intensity (flops per byte moved)."""
        return self.flops / self.bytes if self.bytes else 0.0

    def to_dict(self) -> dict:
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "peak_memory": self.peak_memory,
            "intensity": self.intensity,
            "loops": [dataclasses.asdict(lp) for lp in self.loops],
            "device_ms": self.device_ms,
        }


def memory_stats(tr) -> dict:
    """The peak memory of a traced call (a
    :class:`~repro_torch.analysis.trace.Trace`), split as the reference
    splits XLA's buffer assignment: arguments, outputs, temporaries and
    the output bytes that alias an argument (an in-place result), with
    ``peak_bytes = argument + output + temp - alias``.  There is no code
    size to count."""
    arg, outb, alias = tr.argument_bytes, tr.output_bytes, tr.alias_bytes
    temp = max(0, tr.peak_bytes - arg - outb + alias)
    return {
        "argument_bytes": int(arg),
        "output_bytes": int(outb),
        "temp_bytes": int(temp),
        "alias_bytes": int(alias),
        "peak_bytes": int(arg + outb + temp - alias),
    }


def _loops(tr) -> list[LoopCost]:
    per: dict = {}
    for op in tr.ops:
        if op.trip is None:
            continue
        body = "/".join(op.path)
        trips = per.setdefault(body, {})
        f, b = trips.get(op.trip, (0.0, 0.0))
        trips[op.trip] = (f + op.flops, b + op.bytes)
    return [
        LoopCost(body=body, trips=len(trips),
                 per_trip_flops=max(f for f, _ in trips.values()),
                 per_trip_bytes=max(b for _, b in trips.values()))
        for body, trips in per.items()
    ]


def _args_bytes(args) -> int:
    from repro_torch.analysis.trace import _storage, _tensors

    seen = {}
    for t in _tensors(args):
        ptr, nbytes = _storage(t)
        seen[ptr] = nbytes
    return sum(seen.values())


def device_kernels(fn, *args, n: int = 5, windows: int = 3) -> list:
    """``torch.profiler`` windows over ``n`` calls of ``fn(*args)`` on a
    card: ``[(device activity, count, device ms a call)]`` for every
    kernel, copy and memset of the first of up to ``windows`` windows that
    recorded any (a window can lose all its records in a process that has
    run many); ``[]`` if none did."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(windows):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn(*args)
            torch.cuda.synchronize()
        rows = [(e.key, e.count, e.self_device_time_total / n / 1e3)
                for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA")
                and e.self_device_time_total > 0]
        if rows:
            return rows
    return []


def _device_ms(fn, args, n: int = 20) -> float:
    """The device time of one call of ``fn(*args)`` in ms: CUDA events
    around ``n`` back-to-back calls on a stream held by a device-side sleep
    (``torch.cuda._sleep``) until the host has enqueued them all, so the
    events read the device's work (kernels, glue and the gaps between
    them) and not the host's, over ``n``.  Not the profiler: in a process
    that has run many profiler windows, a window can lose some or all of
    its records, and a sum over the rows that remain reads short."""
    from repro_torch.tune.autotuner import _sleep_hz

    sleep = torch.cuda._sleep
    fn(*args)  # warm-up (first-use builds, cuFFT plans)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args)
    host_s = time.perf_counter() - t0
    cycles = int(min(2.0 * n * host_s * _sleep_hz(torch.device(
        "cuda", torch.cuda.current_device()), sleep), 1e10)) + 100_000
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sleep(cycles)
    start.record()
    for _ in range(n):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def measure(fn, *args, timed: bool = False) -> CostVector:
    """The cost vector of one call of ``fn(*args)`` (module docstring).
    ``timed`` adds the device time a call, which needs a card."""
    from repro_torch.analysis.trace import _tensors, trace

    on_card = any(t.is_cuda for t in _tensors(args))
    if timed and not on_card:
        raise ValueError("device time needs the call's tensors on a card")
    if on_card:
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    tr = trace(fn, *args)
    if on_card:
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - before
                + _args_bytes(args))
    else:
        peak = tr.peak_bytes
    return CostVector(
        flops=sum(op.flops for op in tr.ops),
        bytes=sum(op.bytes for op in tr.ops),
        peak_memory=float(peak),
        loops=_loops(tr),
        device_ms=_device_ms(fn, args) if timed else None,
    )
