"""The 2D Cahn–Hilliard ADI solver (paper §V, "cuCahnPentADI"; counterpart of
``repro.core.cahn_hilliard``).

Solves  dC/dt = D grad^2 (C^3 - C - gamma grad^2 C)  on a periodic box with
the two-step scheme of paper eq. (2):

    L_x w = -(2/3)(C^n - C^{n-1})
            - (2/3) dt D gamma grad^4 Cbar^{n+1}
            + (2/3) D dt grad^2 (C^3 - C)^n
    L_y v = w
    C^{n+1} = Cbar^{n+1} + v,        Cbar^{n+1} = 2 C^n - C^{n-1}

with L = I + (2/3) D gamma dt d^4/dx^4 (pentadiagonal, factored once), and
the ADI half-step pair of eq. (3) to bootstrap C^1 from C^0.

Three RHS paths:

- ``rhs_mode='fused'`` (default) — the RHS and the x-sweep in one CUDA
  kernel (:func:`repro_torch.kernels.ops.ch_rhs_xsweep`); ``rhs`` alone is
  the standalone RHS kernel (:func:`repro_torch.kernels.ops.ch_rhs`);
- ``rhs_mode='stencil'`` — paper-faithful: the RHS from cuSten plan calls,
  a 5x5 weighted plan for grad^4 and a 3x3 function-pointer plan applying
  the Laplacian to (C^3 - C);
- ``rhs_mode='batch1d'`` — the RHS assembled from batched-1D plans
  (cuSten's 1DBatch family) applied along x and along y: delta^2 and delta
  factors for grad^4 and a 3-point function-pointer plan for the
  Laplacian of (C^3 - C), six directional applies per step.

``CHConfig.streams``/``max_tile_bytes`` (cuSten's ``nStreams``) stream
every piece of a step in row or column chunks on CUDA streams
(:mod:`repro_torch.launch.stream`): the fused RHS + x-sweep, the RHS alone,
the stencil plans and the sweeps.  The geometry is ``choose_chunk_rows``'s
unless ``CHConfig.tune`` is on.

``CHConfig.tune='cached'|'force'`` tunes at Create, as the reference does:
the ADI operators' sweeps (``op_half`` reads ``op_full``'s cache entry),
the 2D plans, the batched-1D plans when ``ny == nx`` (they are applied
along both axes), and, when the fused step is streamed, the (streams x
chunk_rows) geometry of its RHS + x-sweep, raced on
:func:`repro_torch.launch.stream.stream_ch_rhs_xsweep`
(:meth:`CahnHilliardADI._tune_stream_geometry`).

Everything runs on ``CHConfig.device`` (the card unless the caller asks for
the CPU).  ``CHConfig(backend='fft')`` is refused at Create, as in the
reference: the function-pointer Laplacian plan has no Fourier symbol.  A
solver whose ``op_full`` and ``op_half`` are replaced with
``dataclasses.replace(op, backend='fft')`` steps with spectral implicit
sweeps.
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Callable

import numpy as np
import torch

from repro_torch import api as _api
from repro_torch.core import metrics as _metrics
from repro_torch.core.adi import apply_along_x, apply_along_y
from repro_torch.kernels import ops as _ops
from repro_torch.launch import stream as _stream
from repro_torch.runtime import chaos as _chaos
from repro_torch.util import resolve_device, torch_dtype

# Stencil weight tables (paper eq. 4; §V.B stencil shapes), from the registry
_D4 = np.asarray(_api.get_operator("biharmonic").weights(1))  # eq. (4b)
_D2 = np.asarray(_api.get_operator("laplacian").weights(1))  # eq. (4a)
_LAP = np.asarray(_api.get_operator("laplacian").weights(2))


def biharmonic_weights() -> np.ndarray:
    """5x5 weights of delta_x^2 + delta_y^2 + 2 delta_x delta_y (units h^-4)."""
    return np.asarray(_api.get_operator("biharmonic").weights(2))


def init_explicit_weights_a() -> np.ndarray:
    """(5y x 3x) weights of 2 delta_x delta_y + delta_y^2 (eq. 3a explicit)."""
    w = np.zeros((5, 3))
    w[:, 1] += _D4
    w[1:4, :] += 2.0 * np.outer(_D2, _D2)
    return w


def init_explicit_weights_b() -> np.ndarray:
    """(3y x 5x) weights of delta_x^2 + 2 delta_x delta_y (eq. 3b explicit)."""
    w = np.zeros((3, 5))
    w[1, :] += _D4
    w[:, 1:4] += 2.0 * np.outer(_D2, _D2)
    return w


def cube_laplacian_point_fn(windows, coeffs):
    """The paper's flagship function pointer: apply Laplacian weights to
    (C^3 - C) of each window — nonlinearity inside the stencil sweep.  Its
    CUDA counterpart is the stencil kernel's ``CubePoint``."""
    out = None
    for w, c in zip(windows, coeffs, strict=True):
        term = c * (w * w * w - w)
        out = term if out is None else out + term
    return out


cube_laplacian_point_fn.device_point_fn = "cube_laplacian"

_RHS_MODES = ("fused", "stencil", "batch1d")


@dataclasses.dataclass(frozen=True)
class CHConfig:
    nx: int = 1024
    ny: int = 1024
    lx: float = 2.0 * np.pi
    ly: float = 2.0 * np.pi
    dt: float = 1e-3
    D: float = 0.6
    gamma: float = 0.01
    dtype: str = "float64"
    rhs_mode: str = "fused"  # 'fused' | 'stencil' | 'batch1d'
    backend: str = "auto"  # 'auto' | 'cuda' | 'torch' | 'fft'
    streams: int | None = None
    max_tile_bytes: int | None = None
    tune: str = "off"
    device: str = "cuda"

    @property
    def dx(self) -> float:
        return self.lx / self.nx

    @property
    def dy(self) -> float:
        return self.ly / self.ny

    def validate(self):
        if abs(self.dx - self.dy) > 1e-12:
            raise ValueError("paper scheme assumes a uniform grid dx == dy")
        from repro_torch.tune import check_mode

        check_mode(self.tune)
        if self.rhs_mode not in _RHS_MODES:
            raise ValueError(f"unknown rhs_mode {self.rhs_mode!r}")


class CahnHilliardADI:
    """Create-once / compute-many solver object (the cuSten usage pattern)."""

    def __init__(self, cfg: CHConfig):
        cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.dtype = torch_dtype(cfg.dtype)
        h2, h4 = cfg.dx**2, cfg.dx**4
        self.inv_h2 = 1.0 / h2
        self.inv_h4 = 1.0 / h4

        # Create: factor the implicit operators once (cuPentBatch pattern).
        # With tune != 'off' each sweep's configuration is measured;
        # op_half shares op_full's cache entry: the key is (shape, dtype,
        # backend, operator), not alpha, since a sweep's cost does not
        # depend on the coefficients
        beta_full = (2.0 / 3.0) * cfg.D * cfg.gamma * cfg.dt / h4
        beta_half = 0.5 * cfg.D * cfg.gamma * cfg.dt / h4
        knobs = dict(streams=cfg.streams, max_tile_bytes=cfg.max_tile_bytes)
        mk_op = functools.partial(
            _api.create, "hyperdiffusion", (cfg.ny, cfg.nx), mode="adi",
            cyclic=True, dtype=self.dtype, backend=cfg.backend,
            device=self.device, **knobs,
        )
        self.op_full = mk_op(alpha=beta_full, tune=cfg.tune)
        self.op_half = mk_op(
            alpha=beta_half,
            tune="cached" if cfg.tune == "force" else cfg.tune,
        )

        # Create: the stencil plans (bootstrap and paper-faithful RHS path);
        # shape doubles as the tuning shape
        mk = functools.partial(
            _api.create, shape=(cfg.ny, cfg.nx), mode="xy", bc="periodic",
            dtype=self.dtype, backend=cfg.backend, device=self.device,
            tune=cfg.tune, **knobs,
        )
        self.plan_bih = mk("biharmonic")
        self.plan_lap_cube = mk(
            cube_laplacian_point_fn,
            coeffs=_LAP.ravel(),
            extents=dict(left=1, right=1, top=1, bottom=1),
        )
        self.plan_init_a = mk(init_explicit_weights_a())
        self.plan_init_b = mk(init_explicit_weights_b())

        # Create: the batched-1D plans (rhs_mode='batch1d').  Each is one
        # directional factor; apply_along_{x,y} runs it over all grid lines.
        # They are applied to the (ny, nx) rows and to the (nx, ny)
        # transpose, so they are tuned only where the two coincide
        mk1d = functools.partial(
            _api.create, shape=(cfg.ny, cfg.nx), mode="batch", bc="periodic",
            dtype=self.dtype, backend=cfg.backend, device=self.device,
            tune=cfg.tune if cfg.ny == cfg.nx else "off", **knobs,
        )
        self.plan_d4_1d = mk1d(_D4)
        self.plan_d2_1d = mk1d(_D2)
        self.plan_lap_cube_1d = mk1d(
            cube_laplacian_point_fn, coeffs=_D2, extents=dict(left=1, right=1),
        )
        # the fused kernels' own streams (rhs_mode='fused')
        self._pool = _stream.make_stream_pool(cfg.streams, self.device)
        # the streamed fused RHS + x-sweep's geometry: the pipeline width
        # and the chunk height (None: choose_chunk_rows), tuned when
        # streaming is on (both are properties of the host, not the PDE)
        self._streams_eff, self._chunk_rows_eff = cfg.streams, None
        self._xsweep_pool = self._pool
        if (cfg.tune != "off" and cfg.rhs_mode == "fused"
                and self._streamed_shape()):
            self._streams_eff, self._chunk_rows_eff = (
                self._tune_stream_geometry())
            self._xsweep_pool = _stream.make_stream_pool(self._streams_eff,
                                                         self.device)

    def _streamed_shape(self) -> bool:
        cfg = self.cfg
        return _stream.should_stream(
            (cfg.ny, cfg.nx), self.dtype.itemsize, streams=cfg.streams,
            max_tile_bytes=cfg.max_tile_bytes)

    def _tune_stream_geometry(self) -> tuple:
        """Race the (pipeline width x chunk height) grid of the streamed
        fused RHS + x-sweep (:func:`repro_torch.launch.stream.
        stream_ch_rhs_xsweep`) and return the winning ``(streams,
        chunk_rows)``.

        Widths {1, 2, 4, 8, cfg.streams}; heights ``None`` (let
        ``choose_chunk_rows`` decide: the untuned geometry stays in the
        race, so tuning can only match or beat it) and the divisors ny/4,
        ny/8 and ny/16 whose halo-padded slab fits ``max_tile_bytes``, so
        tuning cannot unbound the working set.  Every candidate computes
        each row as the monolithic launch does, so the result is the same
        bit for bit.  The race times wall time (``hold=False``): the
        chunk count is host work as much as device work."""
        from repro_torch.tune import autotune

        cfg = self.cfg
        c = torch.zeros((cfg.ny, cfg.nx), dtype=self.dtype, device=self.device)
        fac_x = self.op_full.fac_x

        def build(cand):
            kw = dict(self._fused_kw(), streams=cand["streams"],
                      chunk_rows=cand["chunk_rows"],
                      max_tile_bytes=cfg.max_tile_bytes,
                      pool=_stream.make_stream_pool(cand["streams"],
                                                    self.device))
            return lambda a, b: _stream.stream_ch_rhs_xsweep(a, b, fac_x,
                                                             **kw)

        base = cfg.streams or 1
        budget = cfg.max_tile_bytes
        heights = [None] + sorted(
            {
                r for r in (cfg.ny // k for k in (4, 8, 16))
                if r > 0 and cfg.ny % r == 0 and (
                    budget is None or _stream.slab_bytes(
                        r, cfg.nx, self.dtype.itemsize,
                        top=2, bottom=2, left=2, right=2) <= budget)
            },
            reverse=True,
        )
        best = autotune(
            "ch_stream_geometry",
            [{"streams": w, "chunk_rows": r}
             for w in sorted({1, 2, 4, 8, base}) for r in heights],
            build, (c, c), shape=(cfg.ny, cfg.nx), dtype=self.dtype,
            backend=cfg.backend,
            # streams is part of the key: it shapes the candidate list
            extra={"max_tile_bytes": cfg.max_tile_bytes,
                   "streams": cfg.streams},
            mode=cfg.tune, default={"streams": base, "chunk_rows": None},
            hold=False,
        )
        return best["streams"], best.get("chunk_rows")

    def _streamed(self, c: torch.Tensor) -> bool:
        return _stream.should_stream(
            c.shape, c.element_size(), streams=self.cfg.streams,
            max_tile_bytes=self.cfg.max_tile_bytes,
        )

    def _fused_kw(self) -> dict:
        cfg = self.cfg
        return dict(dt=cfg.dt, D=cfg.D, gamma=cfg.gamma, inv_h2=self.inv_h2,
                    inv_h4=self.inv_h4, backend=cfg.backend)

    def _stream_kw(self) -> dict:
        cfg = self.cfg
        return dict(streams=cfg.streams, max_tile_bytes=cfg.max_tile_bytes,
                    pool=self._pool)

    # -- batched-1D directional assembly (rhs_mode='batch1d') ----------------
    def _cross_batch1d(self, c: torch.Tensor) -> torch.Tensor:
        """delta_x delta_y c — two directional 3-point factors."""
        return apply_along_x(self.plan_d2_1d, apply_along_y(self.plan_d2_1d, c))

    def _bih_batch1d(self, c: torch.Tensor) -> torch.Tensor:
        """delta_x^2 + delta_y^2 + 2 delta_x delta_y (units h^-4)."""
        return (
            apply_along_x(self.plan_d4_1d, c)
            + apply_along_y(self.plan_d4_1d, c)
            + 2.0 * self._cross_batch1d(c)
        )

    def _lap_cube_batch1d(self, c: torch.Tensor) -> torch.Tensor:
        """Laplacian of (C^3 - C) via the per-direction function-pointer
        plan: the nonlinearity is evaluated inside each 1D sweep."""
        return apply_along_x(self.plan_lap_cube_1d, c) + apply_along_y(
            self.plan_lap_cube_1d, c
        )

    # -- explicit RHS of the full scheme (eq. 2a) ---------------------------
    def rhs(self, c_n: torch.Tensor, c_nm1: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if cfg.rhs_mode == "fused":
            if self._streamed(c_n):
                return _stream.stream_ch_rhs(
                    c_n, c_nm1, **self._fused_kw(), **self._stream_kw())
            return _ops.ch_rhs(c_n, c_nm1, **self._fused_kw())
        batch1d = cfg.rhs_mode == "batch1d"
        bih = self._bih_batch1d if batch1d else self.plan_bih.apply
        lap_cube = self._lap_cube_batch1d if batch1d else self.plan_lap_cube.apply
        cbar = 2.0 * c_n - c_nm1
        lin = -(2.0 / 3.0) * (c_n - c_nm1)
        hyper = (
            -(2.0 / 3.0) * cfg.dt * cfg.gamma * cfg.D * self.inv_h4 * bih(cbar)
        )
        nonlin = (2.0 / 3.0) * cfg.D * cfg.dt * self.inv_h2 * lap_cube(c_n)
        return lin + hyper + nonlin

    def _increment(self, c_n: torch.Tensor, c_nm1: torch.Tensor) -> torch.Tensor:
        """``v = L_y^{-1} L_x^{-1} rhs(c_n, c_nm1)``: the fused path
        assembles the RHS straight into the x-sweep (one kernel, or one per
        row chunk when streamed); both sweeps consume their Create-time
        factors in their native layout."""
        if self.cfg.rhs_mode == "fused":
            w = self._fused_xsweep(c_n, c_nm1)
        else:
            w = self.op_full.solve_x(self.rhs(c_n, c_nm1))
        return self.op_full.solve_y(w)

    def _fused_xsweep(self, c_n: torch.Tensor, c_nm1: torch.Tensor) -> torch.Tensor:
        """``L_x^{-1} rhs(c_n, c_nm1)`` in one fused pass, streamed in row
        chunks when the domain exceeds one tile (the tuned geometry, when
        ``CHConfig.tune`` is on)."""
        fac_x = self.op_full.fac_x
        if self._streamed(c_n):
            return _stream.stream_ch_rhs_xsweep(
                c_n, c_nm1, fac_x, **self._fused_kw(),
                streams=self._streams_eff, chunk_rows=self._chunk_rows_eff,
                max_tile_bytes=self.cfg.max_tile_bytes,
                pool=self._xsweep_pool)
        return _ops.ch_rhs_xsweep(c_n, c_nm1, fac_x, **self._fused_kw())

    # -- one full scheme step (eq. 2) ---------------------------------------
    def step(
        self, c_n: torch.Tensor, c_nm1: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """One full-scheme step: returns ``(c_{n+1}, c_n)``."""
        v = self._increment(c_n, c_nm1)
        return 2.0 * c_n - c_nm1 + v, c_n

    # -- bootstrap step (eq. 3) ---------------------------------------------
    def initial_step(self, c0: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        half = 0.5 * cfg.dt
        coef_h = cfg.D * cfg.gamma * self.inv_h4
        if cfg.rhs_mode == "batch1d":
            # per-direction explicit operators of eq. (3), assembled from
            # the 1D plans: a = delta_y^2 + 2 dxdy, b = delta_x^2 + 2 dxdy
            def expl_a(c):
                return apply_along_y(self.plan_d4_1d, c) + 2.0 * self._cross_batch1d(c)

            def expl_b(c):
                return apply_along_x(self.plan_d4_1d, c) + 2.0 * self._cross_batch1d(c)

            lap_cube = self._lap_cube_batch1d
        else:
            expl_a = self.plan_init_a.apply
            expl_b = self.plan_init_b.apply
            lap_cube = self.plan_lap_cube.apply
        rhs_a = c0 + half * (
            -coef_h * expl_a(c0) + cfg.D * self.inv_h2 * lap_cube(c0)
        )
        c_half = self.op_half.solve_x(rhs_a)
        rhs_b = c_half + half * (
            -coef_h * expl_b(c_half) + cfg.D * self.inv_h2 * lap_cube(c_half)
        )
        return self.op_half.solve_y(rhs_b)

    # -- drivers -------------------------------------------------------------
    def make_evolve(self, chunk: int) -> Callable:
        """A ``(c_n, c_nm1) -> (c_{n+chunk}, c_{n+chunk-1})`` multi-step
        driver on two field buffers.  It updates IN PLACE: each step writes
        ``c_{n+1} = 2 c_n - c_{n-1} + v`` over the buffer that held
        ``c_{n-1}`` and swaps the pair (cuSten's pointer Swap), so the two
        buffers passed in hold the result.  The arithmetic is that of
        :meth:`step`, rounding for rounding."""

        def evolve(c_n: torch.Tensor, c_nm1: torch.Tensor):
            for _ in range(chunk):
                v = self._increment(c_n, c_nm1)
                c_nm1.neg_().add_(c_n, alpha=2.0).add_(v)
                c_n, c_nm1 = c_nm1, c_n
            return c_n, c_nm1

        return evolve

    def run(self, c0, n_steps: int, *, save_every: int = 0,
            metrics_fn: Callable | None = None):
        """Integrate ``n_steps`` of the full scheme after the bootstrap step;
        delegates to :func:`ch_evolve`."""
        return ch_evolve(
            self, c0, n_steps, save_every=save_every, metrics_fn=metrics_fn
        )


def poison_at_chunk(carry: tuple, step: int) -> tuple:
    """The chaos hook at a chunk boundary of the drivers (site
    ``'evolve.step'``, as the reference's ``ch_evolve``): ``'crash'`` raises
    here (checkpoint/restart territory); ``'nan'`` returns the carry with
    element ``(0, 0)`` of a copy of its current field set to the fault's
    value, so the chunk blows up and the health guard of
    :mod:`repro_torch.runtime.resilient` catches it.  A copy, because
    :meth:`CahnHilliardADI.make_evolve` updates its buffers in place and a
    caller may hold them.  Without an installed plan: one global load."""
    fault = _chaos.fire("evolve.step", step=step)
    if fault is None or fault.kind != "nan":
        return carry
    c = carry[0].clone()
    c[(0,) * c.ndim] = fault.value
    return (c, carry[1])


def ch_evolve(
    solver: CahnHilliardADI,
    c0,
    n_steps: int,
    *,
    save_every: int = 0,
    metrics_fn: Callable | None = None,
):
    """Multi-step driver: the bootstrap step (step 1), then ``n_steps``
    further steps in chunks of ``save_every`` (all at once when 0).

    The reference donates a ``jit(scan)`` carry; here two preallocated
    field buffers swap and are updated in place (:meth:`CahnHilliardADI.
    make_evolve`).  ``c0`` is copied once on entry, so the caller's tensor
    is left as it was.  Returns ``(c_final, history)`` with history a list
    of ``(step, metrics_fn(c))`` every ``save_every`` steps.  Each chunk
    boundary fires the chaos site ``'evolve.step'`` (:func:`poison_at_chunk`)."""
    c0 = torch.as_tensor(c0, dtype=solver.dtype, device=solver.device).clone()
    c1 = solver.initial_step(c0)
    carry = _api.swap((c0, c1))  # the fresh field becomes the carry's current
    chunk = save_every if save_every else n_steps
    history = []
    done = 1  # the bootstrap counts as step 1
    while done < n_steps + 1:
        todo = min(chunk, n_steps + 1 - done)
        carry = poison_at_chunk(carry, done)
        carry = solver.make_evolve(todo)(*carry)
        done += todo
        if metrics_fn is not None:
            history.append((done, metrics_fn(carry[0])))
    return carry[0], history


def deep_quench_ic(
    ny: int, nx: int, *, seed: int = 0, amp: float = 0.1, dtype="float64",
    device="cuda",
) -> torch.Tensor:
    """The paper's initial condition: uniform random values in [-amp, amp],
    drawn with numpy from ``seed`` (the same values as the reference's)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    return torch.as_tensor(
        rng.uniform(-amp, amp, (ny, nx)), dtype=torch_dtype(dtype), device=dev
    )


def coarsening_metrics(cfg: CHConfig):
    """metrics_fn for :meth:`CahnHilliardADI.run` returning (s, 1/k1, F, M)."""

    def fn(c):
        s = _metrics.s_metric(c, cfg.lx, cfg.ly)
        k1 = _metrics.k1_metric(c, cfg.lx, cfg.ly)
        F = _metrics.free_energy(c, cfg.gamma, cfg.lx, cfg.ly)
        m = _metrics.mass(c, cfg.lx, cfg.ly)
        return s, 1.0 / k1, F, m

    return fn
