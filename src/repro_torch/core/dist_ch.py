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
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.core.cahn_hilliard import CahnHilliardADI, CHConfig
from repro_torch.core.domain import (
    COLLECTIVES,
    DomainDecomposition,
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


@dataclasses.dataclass(frozen=True)
class DistCHLayouts:
    block: list  # 2D block decomposition for stencil work
    xsweep: list  # y fully sharded, x local
    ysweep: list  # x fully sharded, y local


def make_layouts(dd: DomainDecomposition) -> DistCHLayouts:
    ya, xa, ea = dd.y_axis, dd.x_axis, dd.ensemble_axis
    flat = tuple(a for a in (ya, xa) if a is not None)
    if ea:
        specs = ((ea, ya, xa), (ea, flat, None), (ea, None, flat))
    else:
        specs = ((ya, xa), (flat, None), (None, flat))
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

    def _reshard(self, local: torch.Tensor, src, dst, shape) -> torch.Tensor:
        """``local`` (this rank's piece of a ``shape`` field under ``src``)
        as its piece under ``dst``: one ``all_to_all_single`` over the sweep
        group, packed from the overlaps of the (y, x) boxes."""
        sg = self._sweep
        if sg.group is None:
            return local
        mesh = self.dd.mesh
        lead = tuple(local.shape[:-2])

        def box(placements, coords):
            return local_box(shape, mesh, placements, coords)[-2:]

        me = mesh.get_coordinate()
        mine_src, mine_dst = box(src, me), box(dst, me)
        sends, send_n, recv_boxes, recv_n = [], [], [], []
        for peer in sg.peers:
            a = _overlap(mine_src, box(dst, peer))
            piece = (local[(...,) + _rel(a, mine_src)].reshape(-1) if a
                     else local.new_empty(0))
            sends.append(piece)
            send_n.append(piece.numel())
            b = _overlap(box(src, peer), mine_dst)
            recv_boxes.append(b)
            recv_n.append(0 if b is None else math.prod(lead) * (
                (b[0].stop - b[0].start) * (b[1].stop - b[1].start)))
        recv = local.new_empty(sum(recv_n))
        dist.all_to_all_single(recv, torch.cat(sends), recv_n, send_n,
                               group=sg.group)
        COLLECTIVES["all_to_all"] += 1
        out = local.new_empty(lead + tuple(s.stop - s.start for s in mine_dst))
        for flat, b in zip(recv.split(recv_n), recv_boxes):
            if b is not None:
                rel = _rel(b, mine_dst)
                out[(...,) + rel] = flat.view(
                    lead + tuple(s.stop - s.start for s in rel))
        return out

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
        every rank holds): returns ``(c_{n+1}, c_n)`` as DTensors."""
        lay, mesh, cfg = self.layouts, self.dd.mesh, self.cfg
        shape = tuple(c_n.shape)
        a = to_block(c_n, mesh, lay.block)
        b = to_block(c_nm1, mesh, lay.block)
        op = self._local.op_full
        rhs = self._rhs(a, b)
        w = self._reshard(rhs, lay.block, lay.xsweep, shape)
        w = cyclic_penta_solve_factored_rows(
            op.fac_x, w.reshape(-1, shape[-1]), backend=cfg.backend
        ).view(w.shape)
        v = self._reshard(w, lay.xsweep, lay.ysweep, shape)
        if v.ndim == 3:
            v = cyclic_penta_solve_factored_mid(op.fac_y, v, backend=cfg.backend)
        else:
            v = cyclic_penta_solve_factored(op.fac_y, v, backend=cfg.backend)
        v = self._reshard(v, lay.ysweep, lay.block, shape)
        c_np1 = 2.0 * a - b + v
        return (from_block(c_np1, mesh, lay.block, shape),
                c_n if isinstance(c_n, DTensor)
                else from_block(a, mesh, lay.block, shape))

    def multi_step(self, c_n, c_nm1, n_steps: int):
        """``n_steps`` steps (a Python loop; the reference scans)."""
        for _ in range(n_steps):
            c_n, c_nm1 = self.step(c_n, c_nm1)
        return c_n, c_nm1

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
