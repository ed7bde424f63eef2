"""Distributed Cahn–Hilliard ADI, the paper's solver over a device mesh
(counterpart of ``repro.core.dist_ch``), on ``torch.distributed``.

Decomposition (the reference's):

- the explicit RHS runs on the 2D block layout (y over ``data``, x over
  ``model``): each rank pads its blocks of ``c_n`` and ``c_{n-1}`` with a
  halo of 2 (:func:`repro_torch.core.domain.halo_pad`, one exchange for
  the pair) and runs ONE launch of the periodic ``ch_rhs`` kernel on the
  padded pair; its 13-point support has radius 2, so the crop is exact;
- the x-sweep runs on the layout with y over (data, model) and x local:
  ONE ``penta_rows`` launch on the rank's rows (transpose-free); the
  y-sweep on the layout with x over (data, model) and y local: ONE
  ``penta_cols`` launch on the rank's columns (``penta_mid`` over an
  ``(E, ny, nx_loc)`` ensemble block: one launch for the stack, where
  ``penta_cols`` would take one a member);
- the three reshards (block -> x-sweep -> y-sweep -> block) are the
  paper's "transpose between sweeps": each is ONE ``all_to_all_single``
  over the ranks of the (data, model) sub-mesh, which each rank packs
  from the overlaps of its block with the others' (counted in
  :data:`repro_torch.core.domain.COLLECTIVES`).  With one rank in the
  sub-mesh a reshard is a no-op and issues nothing;
- an ensemble axis (independent runs of the same PDE) maps onto ``pod``.

The sweeps reuse a single-device Create's factors (``op_full.fac_x`` and
``fac_y``).  The layouts are DTensor placements; the flattened (data,
model) dim is split in the mesh's dim order.

The eq. 3 bootstrap (:meth:`DistributedCahnHilliard.initial_step`) runs
the single-device Create's plans (``plan_init_a``, ``plan_init_b``,
``plan_lap_cube``) through :func:`~repro_torch.core.domain.
distributed_stencil_apply` on the block layout and ``op_half``'s factors
in the sweeps, four reshards in all.  The coarsening diagnostics
(:meth:`DistributedCahnHilliard.metrics`) reduce each rank's block to
partial sums (``F``'s gradient after a halo of 1; ``k1``'s spectrum as a
1D FFT along x on the x-sweep layout and one along y on the y-sweep
layout, resharded between) and add them in ONE ``all_reduce``.  No field
is gathered.

Spans (:mod:`repro_torch.runtime.spans`, behind its ``ON`` test):
``repro.dist.step`` (a step's root), ``repro.dist.bootstrap``,
``repro.dist.reshard`` (``src``, ``dst`` and ``bytes_sent``, the bytes
this rank sends off itself), ``repro.dist.diagnostics``, and
``repro.dist.halo`` inside :func:`~repro_torch.core.domain.halo_pad`.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core import metrics as _metrics
from repro_torch.core.cahn_hilliard import CahnHilliardADI, CHConfig
from repro_torch.core.domain import (
    COLLECTIVES,
    DomainDecomposition,
    distributed_stencil_apply,
    from_block,
    halo_pad,
    local_box,
    placements_for,
    to_block,
)
from repro_torch.kernels import ops as _ops
from repro_torch.kernels.penta import (
    cyclic_penta_solve_factored,
    cyclic_penta_solve_factored_mid,
    cyclic_penta_solve_factored_rows,
)
from repro_torch.runtime import spans as _spans


@dataclasses.dataclass(frozen=True)
class DistCHLayouts:
    block: list  # 2D block decomposition for stencil work
    xsweep: list  # y fully sharded, x local
    ysweep: list  # x fully sharded, y local


def make_layouts(dd: DomainDecomposition, rank: int = 2) -> DistCHLayouts:
    """The three layouts of a (ny, nx) field, or of an (E, ny, nx)
    ensemble (``rank=3``; the members over the ensemble axis, or whole on
    every rank without one)."""
    ya, xa, ea = dd.y_axis, dd.x_axis, dd.ensemble_axis
    flat = tuple(a for a in (ya, xa) if a is not None)
    specs = ((ya, xa), (flat, None), (None, flat))
    if ea or rank == 3:
        specs = tuple((ea,) + s for s in specs)
    return DistCHLayouts(*(placements_for(dd.mesh, s) for s in specs))


class _SweepGroup:
    """The ranks that reshard together: those sharing this rank's place on
    every mesh dim but the y and x axes, as one process group (None when
    it is this rank alone), and each member's mesh coordinates in the
    group's rank order."""

    def __init__(self, dd: DomainDecomposition):
        mesh = dd.mesh
        names = mesh.mesh_dim_names
        sweep = [names.index(a) for a in (dd.y_axis, dd.x_axis) if a is not None]
        sweep.sort()
        self.size = math.prod(mesh.size(m) for m in sweep)
        self.group = None
        self.peers = [mesh.get_coordinate()]
        if self.size == 1:
            return
        other = [m for m in range(mesh.ndim) if m not in sweep]
        rows = mesh.mesh.permute(other + sweep).reshape(-1, self.size).tolist()
        # every rank creates every group, in the same order
        self.group, _ = dist.new_subgroups_by_enumeration(rows)
        self.peers = [
            [int(i) for i in (mesh.mesh == dist.get_global_rank(self.group, q))
             .nonzero()[0]]
            for q in range(self.size)
        ]


def _overlap(a: tuple, b: tuple) -> tuple | None:
    """The intersection of two boxes of (y, x) slices, or None."""
    ys = slice(max(a[0].start, b[0].start), min(a[0].stop, b[0].stop))
    xs = slice(max(a[1].start, b[1].start), min(a[1].stop, b[1].stop))
    return (ys, xs) if ys.start < ys.stop and xs.start < xs.stop else None


def _rel(box: tuple, origin: tuple) -> tuple:
    return tuple(slice(s.start - o.start, s.stop - o.start)
                 for s, o in zip(box, origin))


class _ReshardPlan:
    """One reshard's boxes and counts on this rank, worked out once: for
    each member of the sweep group (in its rank order), the part of this
    rank's ``src`` piece that goes to it and the place in this rank's
    ``dst`` piece of what comes from it, as indices into the local
    tensors, with the element counts of both; ``sent`` counts the
    elements this rank sends off itself."""

    def __init__(self, mesh, peers: list, src, dst, shape, lead: tuple):
        def box(placements, coords):
            return local_box(shape, mesh, placements, coords)[-2:]

        me = mesh.get_coordinate()
        mine_src, mine_dst = box(src, me), box(dst, me)
        per = math.prod(lead)
        self.send_boxes, self.send_n, self.recv_into, self.recv_n = [], [], [], []
        self.sent = 0
        for peer in peers:
            a = _overlap(mine_src, box(dst, peer))
            n = 0 if a is None else per * _area(a)
            self.send_boxes.append(None if a is None
                                   else (...,) + _rel(a, mine_src))
            self.send_n.append(n)
            if tuple(peer) != tuple(me):
                self.sent += n
            b = _overlap(box(src, peer), mine_dst)
            if b is None:
                self.recv_into.append(None)
                self.recv_n.append(0)
            else:
                rel = _rel(b, mine_dst)
                self.recv_into.append(((...,) + rel, lead + tuple(
                    s.stop - s.start for s in rel)))
                self.recv_n.append(per * _area(b))
        self.out_shape = lead + tuple(s.stop - s.start for s in mine_dst)


def _area(box: tuple) -> int:
    return (box[0].stop - box[0].start) * (box[1].stop - box[1].start)


class DistributedCahnHilliard:
    """Create-once distributed solver: the factors and the layouts are
    captured; a step launches the kernels on every rank's pieces."""

    def __init__(self, cfg: CHConfig, dd: DomainDecomposition):
        cfg.validate()
        if cfg.backend == "fft":
            raise ValueError(
                "the distributed step sweeps with the penta kernels on "
                "resharded slabs; backend='fft' transforms whole fields")
        self.cfg = cfg
        self.dd = dd
        self.layouts = make_layouts(dd)
        # Reuse the single-device Create (factors are (n,)-sized, every rank
        # holds them); the step calls the sweeps on slabs directly, so the
        # Create neither streams nor tunes
        self._local = CahnHilliardADI(dataclasses.replace(
            cfg, rhs_mode="fused", streams=None, max_tile_bytes=None,
            tune="off"))
        self._sweep = _SweepGroup(dd)
        self._plans: dict = {}  # the reshards' plans, by layouts and shape
        self._layouts3 = None  # an ensemble's layouts, made at its first step

    def _reshard(self, local: torch.Tensor, lay: DistCHLayouts, src: str,
                 dst: str, shape) -> torch.Tensor:
        """``local`` (this rank's piece of a ``shape`` field under layout
        ``src`` of ``lay``) as its piece under layout ``dst``: one
        ``all_to_all_single`` over the sweep group, packed from the
        overlaps of the (y, x) boxes.  The span ``'repro.dist.reshard'``."""
        if self._sweep.group is None:
            return local
        if _spans.ON:
            with _spans.span("repro.dist.reshard", src=src, dst=dst) as sp:
                out, sent = self._all_to_all(local, getattr(lay, src),
                                             getattr(lay, dst), shape)
                sp.fields["bytes_sent"] = sent * local.element_size()
            return out
        return self._all_to_all(local, getattr(lay, src), getattr(lay, dst),
                                shape)[0]

    def _all_to_all(self, local: torch.Tensor, src, dst, shape):
        """The reshard's exchange: the piece under ``dst`` placements and
        the number of elements this rank sent to the others."""
        lead = tuple(local.shape[:-2])
        key = (tuple(src), tuple(dst), tuple(shape), lead)
        plan = self._plans.get(key)
        if plan is None:
            plan = self._plans[key] = _ReshardPlan(
                self.dd.mesh, self._sweep.peers, src, dst, shape, lead)
        sends = [local.new_empty(0) if box is None else local[box].reshape(-1)
                 for box in plan.send_boxes]
        recv = local.new_empty(sum(plan.recv_n))
        dist.all_to_all_single(recv, torch.cat(sends), plan.recv_n,
                               plan.send_n, group=self._sweep.group)
        COLLECTIVES["all_to_all"] += 1
        out = local.new_empty(plan.out_shape)
        for flat, into in zip(recv.split(plan.recv_n), plan.recv_into):
            if into is not None:
                box, view = into
                out[box] = flat.view(view)
        return out, plan.sent

    def _rhs(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Eq. 2a's RHS on the block layout: the pair padded by a halo of 2
        in one exchange, one periodic ``ch_rhs`` launch on the padded pair
        (an ensemble's members stacked along y), cropped."""
        loc = self._local
        cfg = self.cfg
        padded = halo_pad(torch.stack([a, b]), halos=(2, 2, 2, 2), dd=self.dd)
        H, W = padded.shape[-2:]
        pa, pb = (p.reshape(-1, W) for p in padded)
        rhs = _ops.ch_rhs(pa, pb, dt=cfg.dt, D=cfg.D, gamma=cfg.gamma,
                          inv_h2=loc.inv_h2, inv_h4=loc.inv_h4,
                          backend=cfg.backend)
        rhs = rhs.view(a.shape[:-2] + (H, W))
        return rhs[..., 2:-2, 2:-2].contiguous()

    def step(self, c_n: torch.Tensor, c_nm1: torch.Tensor):
        """One full-scheme step on (ny, nx) or ensemble (E, ny, nx) fields
        (DTensors laid out as :meth:`field_sharding`, or whole tensors that
        every rank holds): returns ``(c_{n+1}, c_n)`` as DTensors.  The
        span ``'repro.dist.step'``."""
        lay, shape = self._layouts_of(c_n), tuple(c_n.shape)
        a = to_block(c_n, self.dd.mesh, lay.block)
        b = to_block(c_nm1, self.dd.mesh, lay.block)
        return (self._wrap(self._advance(a, b, lay, shape), lay, shape),
                c_n if isinstance(c_n, DTensor) else self._wrap(a, lay, shape))

    def multi_step(self, c_n, c_nm1, n_steps: int):
        """``n_steps`` steps (a Python loop; the reference scans), each on
        this rank's blocks: the fields are unwrapped before the first and
        wrapped as DTensors after the last."""
        if n_steps <= 0:
            return c_n, c_nm1
        lay, shape = self._layouts_of(c_n), tuple(c_n.shape)
        a = to_block(c_n, self.dd.mesh, lay.block)
        b = to_block(c_nm1, self.dd.mesh, lay.block)
        for _ in range(n_steps):
            a, b = self._advance(a, b, lay, shape), a
        return self._wrap(a, lay, shape), self._wrap(b, lay, shape)

    def _layouts_of(self, c: torch.Tensor) -> DistCHLayouts:
        """The layouts of a field (rank 2) or of an ensemble (rank 3)."""
        if c.ndim == 3 and not self.dd.ensemble_axis:
            if self._layouts3 is None:
                self._layouts3 = make_layouts(self.dd, rank=3)
            return self._layouts3
        return self.layouts

    def _wrap(self, block: torch.Tensor, lay: DistCHLayouts, shape) -> DTensor:
        return from_block(block, self.dd.mesh, lay.block, shape)

    def _advance(self, a: torch.Tensor, b: torch.Tensor, lay: DistCHLayouts,
                 shape) -> torch.Tensor:
        """One step on this rank's blocks of ``c_n`` and ``c_{n-1}``: its
        block of ``c_{n+1}``.  The span ``'repro.dist.step'``."""
        if _spans.ON:
            with _spans.span("repro.dist.step"):
                return self._advance_blocks(a, b, lay, shape)
        return self._advance_blocks(a, b, lay, shape)

    def _advance_blocks(self, a, b, lay, shape) -> torch.Tensor:
        cfg, op = self.cfg, self._local.op_full
        rhs = self._rhs(a, b)
        w = self._reshard(rhs, lay, "block", "xsweep", shape)
        w = cyclic_penta_solve_factored_rows(
            op.fac_x, w.reshape(-1, shape[-1]), backend=cfg.backend
        ).view(w.shape)
        v = self._reshard(w, lay, "xsweep", "ysweep", shape)
        if v.ndim == 3:
            v = cyclic_penta_solve_factored_mid(op.fac_y, v, backend=cfg.backend)
        else:
            v = cyclic_penta_solve_factored(op.fac_y, v, backend=cfg.backend)
        v = self._reshard(v, lay, "ysweep", "block", shape)
        return 2.0 * a - b + v

    # -- bootstrap step (eq. 3) ---------------------------------------------
    def initial_step(self, c0: torch.Tensor) -> DTensor:
        """C^1 from C^0 by eq. 3 (:meth:`CahnHilliardADI.initial_step`)
        across the mesh: ``c0`` a (ny, nx) DTensor laid out as
        :meth:`field_sharding`, or a whole tensor that every rank holds;
        returns C^1 as a DTensor on the block layout.  The explicit
        operators are the single-device Create's plans on halo-padded
        blocks, the sweeps ``op_half``'s factors on the resharded slabs.
        The span ``'repro.dist.bootstrap'``."""
        if self.cfg.rhs_mode == "batch1d":
            raise ValueError(
                "the distributed bootstrap assembles eq. 3 from the 2D "
                "stencil plans; rhs_mode='batch1d' (the batched-1D plans "
                "across the mesh) has no distributed path")
        if c0.ndim != 2:
            raise ValueError(f"initial_step takes a (ny, nx) field, got "
                             f"shape {tuple(c0.shape)}")
        if _spans.ON:
            with _spans.span("repro.dist.bootstrap"):
                return self._initial_step(c0)
        return self._initial_step(c0)

    def _initial_step(self, c0: torch.Tensor) -> DTensor:
        lay, mesh, cfg, loc = self.layouts, self.dd.mesh, self.cfg, self._local
        shape = tuple(c0.shape)
        half = 0.5 * cfg.dt
        coef_h = cfg.D * cfg.gamma * loc.inv_h4
        coef_l = cfg.D * loc.inv_h2
        op = loc.op_half

        def explicit(plan, c):
            return distributed_stencil_apply(plan, c, self.dd).to_local()

        def half_rhs(expl, c):
            field = from_block(c, mesh, lay.block, shape)
            return c + half * (-coef_h * explicit(expl, field)
                               + coef_l * explicit(loc.plan_lap_cube, field))

        a = to_block(c0, mesh, lay.block)
        w = self._reshard(half_rhs(loc.plan_init_a, a), lay, "block",
                          "xsweep", shape)
        w = cyclic_penta_solve_factored_rows(op.fac_x, w, backend=cfg.backend)
        c_half = self._reshard(w, lay, "xsweep", "block", shape)
        v = self._reshard(half_rhs(loc.plan_init_b, c_half), lay, "block",
                          "ysweep", shape)
        v = cyclic_penta_solve_factored(op.fac_y, v, backend=cfg.backend)
        return from_block(self._reshard(v, lay, "ysweep", "block", shape),
                          mesh, lay.block, shape)

    # -- coarsening diagnostics (paper §V.C) ----------------------------------
    def metrics(self) -> Callable:
        """The function from the current (ny, nx) field (a DTensor laid out
        as :meth:`field_sharding`, or this rank's block) to ``(s, 1/k1, F,
        M)``, the numbers :func:`~repro_torch.core.cahn_hilliard.
        coarsening_metrics` gives on the whole field, on every rank: each
        rank's partial sums, added in one ``all_reduce``.  Each call is the
        span ``'repro.dist.diagnostics'``."""
        cfg, lay, mesh = self.cfg, self.layouts, self.dd.mesh
        shape = (cfg.ny, cfg.nx)
        lx, ly, area = cfg.lx, cfg.ly, cfg.lx * cfg.ly
        dx, dy = lx / cfg.nx, ly / cfg.ny
        kw = dict(dtype=self._local.dtype, device=self._local.device)
        me = mesh.get_coordinate()
        ys, xs = local_box(shape, mesh, lay.block, me)
        wy = (_metrics.simpson_weights_periodic(cfg.ny, **kw) * (ly / cfg.ny))[ys]
        wx = (_metrics.simpson_weights_periodic(cfg.nx, **kw) * (lx / cfg.nx))[xs]
        # the y-sweep layout's columns: the x frequencies this rank holds
        cols = local_box(shape, mesh, lay.ysweep, me)[1]
        kx = 2 * math.pi * torch.fft.fftfreq(cfg.nx, d=dx, **kw)[cols]
        ky = 2 * math.pi * torch.fft.fftfreq(cfg.ny, d=dy, **kw)
        lay2 = make_layouts(self.dd, rank=3)  # a pair of fields, stacked
        group = self._sweep.group

        def spectrum_sums(c: torch.Tensor) -> tuple:
            rows = torch.fft.fft(self._reshard(c, lay, "block", "xsweep",
                                               shape), dim=-1)
            # NCCL moves no complex tensors: the real and imaginary parts
            # as a leading dim of two
            parts = self._reshard(torch.stack([rows.real, rows.imag]), lay2,
                                  "xsweep", "ysweep", (2,) + shape)
            chat2 = torch.abs(torch.fft.fft(torch.complex(parts[0], parts[1]),
                                            dim=-2)) ** 2
            kmag = torch.sqrt(kx[None, :] ** 2 + ky[:, None] ** 2)
            inv_k = torch.where(kmag > 0, 1.0 / torch.clamp(kmag, min=1e-30),
                                torch.zeros_like(kmag))
            return torch.sum(chat2), torch.sum(inv_k * chat2)

        def sums(c: torch.Tensor) -> torch.Tensor:
            p = halo_pad(c, halos=(1, 1, 1, 1), dd=self.dd)
            gx = (p[1:-1, 2:] - p[1:-1, :-2]) / (2 * dx)
            gy = (p[2:, 1:-1] - p[:-2, 1:-1]) / (2 * dy)
            dens = 0.25 * (c * c - 1.0) ** 2 + 0.5 * cfg.gamma * (gx * gx + gy * gy)
            part = torch.stack([wy @ f @ wx for f in (c * c, dens, c)]
                               + list(spectrum_sums(c)))
            if group is not None:
                dist.all_reduce(part, group=group)
                COLLECTIVES["all_reduce"] += 1
            return part

        def compute(c):
            c = to_block(c, mesh, lay.block) if isinstance(c, DTensor) else c
            cc, dens, m, chat2, inv_k_chat2 = sums(c)
            s = 1.0 / (1.0 - cc / area)
            return (s, 1.0 / (chat2 / inv_k_chat2), dens / area * lx * ly,
                    m / area * lx * ly)

        def fn(c):
            if _spans.ON:
                with _spans.span("repro.dist.diagnostics"):
                    return compute(c)
            return compute(c)

        return fn

    def streamed_apply(
        self,
        plan,
        field: torch.Tensor,
        out_init: torch.Tensor | None = None,
        *,
        streams: int | None = None,
        max_tile_bytes: int | None = None,
        chunk_rows: int | None = None,
    ) -> DTensor:
        """Apply a stencil plan to an oversized field through this solver's
        mesh: y-chunks stream, each chunk's x extent sharded over
        ``dd.x_axis`` with its halo exchanged
        (:func:`repro_torch.launch.stream.stream_stencil_apply_dist`)."""
        from repro_torch.launch.stream import stream_stencil_apply_dist

        return stream_stencil_apply_dist(
            plan, field, self.dd, out_init, streams=streams,
            max_tile_bytes=max_tile_bytes, chunk_rows=chunk_rows)

    def field_sharding(self) -> list:
        return self.layouts.block

    def input_specs(self, ensemble: int | None = None):
        """Stand-ins of the step's inputs: ``device='meta'`` tensors of the
        global shape and dtype (the reference's ``ShapeDtypeStruct``)."""
        cfg = self.cfg
        shape = (cfg.ny, cfg.nx)
        if ensemble:
            shape = (ensemble,) + shape
        spec = torch.empty(shape, dtype=self._local.dtype, device="meta")
        return spec, spec
