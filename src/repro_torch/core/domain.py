"""Distributed domain decomposition with halo exchange (paper §VI.B;
counterpart of ``repro.core.domain``), on ``torch.distributed``.

cuSten sketches multi-GPU scaling: one rank per device, apply the
non-periodic stencils locally, swap boundary halos.  Here:

- the 2D grid is block-decomposed over a
  :class:`~torch.distributed.device_mesh.DeviceMesh`: y over one mesh dim
  (default ``data``), x over another (default ``model``); an optional
  leading *ensemble* axis of independent fields maps onto a third
  (``pod``).  A field is a DTensor with the placements of
  :meth:`DomainDecomposition.field_sharding`; the functions here work on
  its local block (``to_local``) and rebuild the result with
  ``DTensor.from_local``, so no DTensor redistribution (whose collectives
  torch chooses, all-gathers included) runs on the hot path;
- halos move as edge strips between circular neighbours, the port's own
  point-to-point exchange (``batch_isend_irecv``); never an all-gather.
  The y exchange runs first and the x exchange second on the y-padded
  block, so the corner halos ride along.  With one shard on an axis the
  exchange is the local wrap;
- each rank's answer is ONE launch of the plan's stencil in ``bc='np'``
  mode on its halo-padded block (``kernels/stencil2d.py``'s kernel on a
  CUDA tensor, with the plan's Create-time taps; its plain version on a
  CPU tensor): the cells whose support lies in the padded block are
  exactly the local block, and the kernel computes each of them as the
  single-device Compute does.  An ensemble block is one stacked launch;
- ``overlap=True`` posts the halo exchange, launches the interior on the
  unpadded block while it is in flight, waits, then computes the four
  edge bands (one launch each: row windows of the padded block for the
  top and bottom bands, narrow slabs for the left and right);
- ``bc='np'`` masks the *global* boundary ring to ``out_init``, as the
  single-device Compute leaves it.

Every collective this module and :mod:`repro_torch.core.dist_ch` issue is
counted in :data:`COLLECTIVES` (a halo strip sent is one ``p2p``).
"""

from __future__ import annotations

import dataclasses
import functools
from collections.abc import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import _build
from repro_torch.kernels.stencil2d import stencil2d_cuda, stencil2d_torch
from repro_torch.runtime import spans as _spans

# collectives issued since the last reset_collectives(): halo strips sent
# point to point, all-to-all reshards, all-gathers of a whole field,
# all-reduces of partial sums (the distributed diagnostics)
COLLECTIVES: dict[str, int] = {"p2p": 0, "all_to_all": 0, "all_gather": 0,
                               "all_reduce": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


def placements_for(mesh: DeviceMesh, spec: tuple) -> list:
    """The DTensor placements of a partition spec: ``spec`` names, for each
    tensor dim, the mesh dim that shards it (or a tuple of mesh dims, which
    shard it in the mesh's dim order, or None).  A mesh dim that shards
    nothing is ``Replicate()``."""
    where = {}
    for d, axes in enumerate(spec):
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            if a is not None:
                where[a] = d
    return [Shard(where[n]) if n in where else Replicate()
            for n in mesh.mesh_dim_names]


def local_box(shape, mesh: DeviceMesh, placements, coords) -> tuple[slice, ...]:
    """The slices of a ``shape`` tensor that the rank at mesh coordinates
    ``coords`` holds under ``placements`` (even splits only)."""
    box = [[0, int(n)] for n in shape]
    for m, p in enumerate(placements):
        if isinstance(p, Shard):
            a, b = box[p.dim]
            k = mesh.size(m)
            if (b - a) % k:
                raise ValueError(
                    f"mesh dim {mesh.mesh_dim_names[m]!r} ({k}) must divide "
                    f"tensor dim {p.dim} of {tuple(shape)}")
            step = (b - a) // k
            box[p.dim] = [a + coords[m] * step, a + (coords[m] + 1) * step]
    return tuple(slice(a, b) for a, b in box)


@dataclasses.dataclass(frozen=True)
class DomainDecomposition:
    """How the (ny, nx) grid maps onto the device mesh."""

    mesh: DeviceMesh
    y_axis: str | None = "data"
    x_axis: str | None = "model"
    ensemble_axis: str | None = None  # e.g. "pod" on the multi-pod mesh

    def n_shards(self, axis: str | None) -> int:
        if axis is None:
            return 1
        return self.mesh.size(self.mesh.mesh_dim_names.index(axis))

    def coord(self, axis: str | None) -> int:
        """This rank's position along ``axis`` (0 for None)."""
        return 0 if axis is None else self.mesh.get_local_rank(axis)

    @functools.cached_property
    def rings(self) -> dict:
        """The halo exchange's neighbours over each axis (:func:`_ring`),
        worked out at the axis's first exchange."""
        return {}

    @property
    def field_spec(self) -> tuple:
        if self.ensemble_axis:
            return (self.ensemble_axis, self.y_axis, self.x_axis)
        return (self.y_axis, self.x_axis)

    def field_sharding(self) -> list:
        """The placements of a field: ``distribute_tensor(x, dd.mesh,
        dd.field_sharding())`` lays ``x`` out as the reference's
        ``jax.device_put(x, dd.field_sharding())`` does."""
        return placements_for(self.mesh, self.field_spec)


def to_block(x: torch.Tensor, mesh: DeviceMesh, placements) -> torch.Tensor:
    """This rank's block of ``x`` under ``placements``: a DTensor's local
    tensor (which must already be laid out so; nothing is redistributed),
    or the block cut from a whole tensor that every rank holds."""
    if isinstance(x, DTensor):
        if tuple(x.placements) != tuple(placements):
            raise ValueError(
                f"the field is laid out as {list(x.placements)}, expected "
                f"{list(placements)}")
        return x.to_local().contiguous()
    box = local_box(x.shape, mesh, placements, mesh.get_coordinate())
    return x[box].contiguous()


def from_block(block: torch.Tensor, mesh: DeviceMesh, placements,
               shape) -> DTensor:
    """The DTensor of global ``shape`` whose local tensor is ``block``
    (no collective)."""
    stride = torch.empty(tuple(shape), device="meta").stride()
    return DTensor.from_local(block, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def gather(x: DTensor) -> torch.Tensor:
    """The whole tensor of ``x`` on every rank: an all-gather (counted), for
    checkpoints and checks, never on the hot path."""
    COLLECTIVES["all_gather"] += 1
    return x.full_tensor()


def _ring(mesh: DeviceMesh, axis_name: str | None,
          rings: dict | None = None) -> tuple | None:
    """The circular neighbours over ``axis_name``: ``(group, up, down)``,
    the axis's group and the global ranks above and below this one, or
    None with one shard on the axis (the neighbour is myself).  Kept in
    ``rings`` (:attr:`DomainDecomposition.rings`) once worked out."""
    if rings is not None and axis_name in rings:
        return rings[axis_name]
    n = 1 if axis_name is None else mesh.size(mesh.mesh_dim_names.index(axis_name))
    ring = None
    if n > 1:
        group = mesh.get_group(axis_name)
        me = mesh.get_local_rank(axis_name)
        ring = (group, dist.get_global_rank(group, (me + 1) % n),
                dist.get_global_rank(group, (me - 1) % n))
    if rings is not None:
        rings[axis_name] = ring
    return ring


def _post_exchange(block, lo: int, hi: int, axis: int, axis_name: str | None,
                   mesh: DeviceMesh, rings: dict | None = None
                   ) -> Callable[[], tuple]:
    """Post the exchange of (lo, hi) halo strips along ``axis`` with the
    circular neighbours over ``axis_name`` (:func:`_ring`, kept in
    ``rings``); return ``finish()``, which waits and gives ``(lo_halo,
    hi_halo)`` (None for a zero extent).  The lo halo is the lower
    neighbour's last ``lo`` slices, the hi halo the upper neighbour's
    first ``hi``."""
    extent = block.shape[axis]
    if max(lo, hi) > extent:
        raise ValueError(
            f"halo ({lo}, {hi}) wider than the local block's extent {extent}")
    lo_strip = block.narrow(axis, extent - lo, lo) if lo else None
    hi_strip = block.narrow(axis, 0, hi) if hi else None
    if not (lo or hi):  # no halo
        return lambda: (lo_strip, hi_strip)
    ring = _ring(mesh, axis_name, rings)
    if ring is None:  # the neighbour is myself
        return lambda: (lo_strip, hi_strip)
    group, up, down = ring
    ops, halos = [], [None, None]
    # tags tell the two strips apart where up == down (n == 2); NCCL, which
    # ignores tags, matches them in this order
    for i, (strip, to, frm) in enumerate(((lo_strip, up, down),
                                          (hi_strip, down, up))):
        if strip is None:
            continue
        halos[i] = torch.empty_like(strip, memory_format=torch.contiguous_format)
        ops += [dist.P2POp(dist.isend, strip.contiguous(), to, group, tag=i),
                dist.P2POp(dist.irecv, halos[i], frm, group, tag=i)]
        COLLECTIVES["p2p"] += 1
    works = dist.batch_isend_irecv(ops)

    def finish():
        for w in works:
            w.wait()
        return halos[0], halos[1]

    return finish


def _exchange_1d(block, lo: int, hi: int, axis: int, axis_name: str | None,
                 mesh: DeviceMesh):
    """Gather (lo, hi) halo strips along ``axis`` from the circular
    neighbours over ``axis_name``.  Returns (lo_halo, hi_halo) blocks."""
    return _post_exchange(block, lo, hi, axis, axis_name, mesh)()


def _cat(lo, mid, hi, axis):
    parts = [p for p in (lo, mid, hi) if p is not None]
    return torch.cat(parts, dim=axis) if len(parts) > 1 else mid


def halo_pad(
    block: torch.Tensor,
    *,
    halos: tuple[int, int, int, int],  # (top, bottom, left, right)
    dd: DomainDecomposition,
    during: Callable[[], None] | None = None,
) -> torch.Tensor:
    """Return the block (any leading dims) padded with neighbour halos:
    trailing shape (ny_loc + top + bottom, nx_loc + left + right).
    Circular exchange: non-periodic masking happens at the caller.
    ``during()`` runs while the first exchange is in flight.  The span
    ``'repro.dist.halo'``."""
    if _spans.ON:
        with _spans.span("repro.dist.halo"):
            return _halo_pad(block, halos, dd, during)
    return _halo_pad(block, halos, dd, during)


def _halo_pad(block, halos, dd, during):
    top, bottom, left, right = halos
    finish = _post_exchange(block, top, bottom, -2, dd.y_axis, dd.mesh,
                            dd.rings)
    if during is not None and (top or bottom):
        during()
        during = None
    up, down = finish()
    padded = _cat(up, block, down, -2)
    finish = _post_exchange(padded, left, right, -1, dd.x_axis, dd.mesh,
                            dd.rings)
    if during is not None:
        during()
    lf, rt = finish()
    return _cat(lf, padded, rt, -1)


def np_apply(plan, x: torch.Tensor, rows: tuple[int, int] | None = None,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """One ``bc='np'`` launch of ``plan``'s stencil on ``x`` (an ``(H, W)``
    block or a stack of them): valid on the cells whose support lies in
    ``x``.  On the card only the ``rows`` window is computed, into ``out``
    (made when None); the plain version computes every row.  A plan's
    ``'fft'`` backend evaluates the same windows (a block is not periodic)."""
    kw = dict(point_fn=plan.point_fn, left=plan.left, right=plan.right,
              top=plan.top, bottom=plan.bottom, bc="np")
    backend = "auto" if plan.backend == "fft" else plan.backend
    if _build.resolve_backend(backend, x) == "cuda":
        if rows is not None and out is None:
            out = torch.empty_like(x)
        return stencil2d_cuda(x, plan.coeffs, None, rows=rows, out=out,
                              taps=plan.taps, geometry=plan.geometry, **kw)
    return stencil2d_torch(x, coeffs=plan.coeffs, **kw)


def _valid_apply(padded, plan, ny_loc: int, nx_loc: int) -> torch.Tensor:
    """The stencil on the padded block, cropped to the local block."""
    t, l = plan.top, plan.left
    full = np_apply(plan, padded, rows=(t, t + ny_loc))
    return full[..., t : t + ny_loc, l : l + nx_loc].contiguous()


def _overlapped_apply(block, plan, dd) -> torch.Tensor:
    """The interior on the unpadded block while the halos are in flight,
    then the edge bands from the padded block, written into it."""
    t, b, l, r = plan.top, plan.bottom, plan.left, plan.right
    ny_loc, nx_loc = block.shape[-2:]
    res = {}
    padded = halo_pad(block, halos=(t, b, l, r), dd=dd,
                      during=lambda: res.update(out=np_apply(plan, block)))
    out = res["out"]  # valid on rows [t, ny_loc - b), cols [l, nx_loc - r)
    rows_buf = torch.empty_like(padded) if (t or b) else None
    if t:  # block rows [0, t) = padded rows [t, 2t)
        band = np_apply(plan, padded, (t, 2 * t), rows_buf)
        out[..., :t, :] = band[..., t : 2 * t, l : l + nx_loc]
    if b:  # block rows [ny_loc - b, ny_loc)
        r0 = ny_loc - b + t
        band = np_apply(plan, padded, (r0, r0 + b), rows_buf)
        out[..., ny_loc - b :, :] = band[..., r0 : r0 + b, l : l + nx_loc]
    mid = slice(t, ny_loc - b)
    if l:  # block cols [0, l): padded cols [0, 2l + r)
        sub = padded[..., t : t + ny_loc, : 2 * l + r].contiguous()
        out[..., mid, :l] = np_apply(plan, sub)[..., mid, l : 2 * l]
    if r:  # block cols [nx_loc - r, nx_loc): padded cols [nx_loc - r, nx_loc + l + r)
        sub = padded[..., t : t + ny_loc, nx_loc - r :].contiguous()
        out[..., mid, nx_loc - r :] = np_apply(plan, sub)[..., mid, l : l + r]
    return out


def _global_edge_mask(plan, dd, ny_loc, nx_loc, ny, nx, device):
    """Mask of cells whose stencil support stays inside the *global*
    domain (the complement is the ring ``bc='np'`` leaves to out_init)."""
    iy, ix = dd.coord(dd.y_axis), dd.coord(dd.x_axis)
    gj = iy * ny_loc + torch.arange(ny_loc, device=device)[:, None]
    gi = ix * nx_loc + torch.arange(nx_loc, device=device)[None, :]
    return (
        (gi >= plan.left)
        & (gi < nx - plan.right)
        & (gj >= plan.top)
        & (gj < ny - plan.bottom)
    )


def np_ring(out, plan, dd, shape, out_init, placements) -> torch.Tensor:
    """``out`` (this rank's block of a ``shape`` field under
    ``placements``) with the global ``bc='np'`` ring set to ``out_init``'s
    block (zeros when None)."""
    ny, nx = shape[-2:]
    ny_loc, nx_loc = out.shape[-2:]
    mask = _global_edge_mask(plan, dd, ny_loc, nx_loc, ny, nx, out.device)
    base = (torch.zeros_like(out) if out_init is None
            else to_block(out_init, dd.mesh, placements).to(out.dtype))
    return torch.where(mask, out, base)


def distributed_stencil_apply(
    plan,
    field: torch.Tensor,
    dd: DomainDecomposition,
    out_init: torch.Tensor | None = None,
    *,
    overlap: bool = True,
) -> DTensor:
    """Apply a 2D stencil plan to a mesh-decomposed global field.

    ``field``: (ny, nx), or (E, ny, nx) with an ensemble axis; a DTensor
    laid out as ``dd.field_sharding()``, or a whole tensor that every rank
    holds (each cuts its block).  ``out_init`` likewise (``bc='np'``).
    Returns a DTensor laid out as ``dd.field_sharding()``."""
    ny, nx = field.shape[-2:]
    if ny % dd.n_shards(dd.y_axis) or nx % dd.n_shards(dd.x_axis):
        raise ValueError("mesh axes must divide the grid")
    placements = dd.field_sharding()
    block = to_block(field, dd.mesh, placements)
    ny_loc, nx_loc = block.shape[-2:]
    t, b, l, r = plan.top, plan.bottom, plan.left, plan.right
    if overlap and ny_loc > t + b and nx_loc > l + r:
        out = _overlapped_apply(block, plan, dd)
    else:
        padded = halo_pad(block, halos=(t, b, l, r), dd=dd)
        out = _valid_apply(padded, plan, ny_loc, nx_loc)
    if plan.bc == "np":
        out = np_ring(out, plan, dd, field.shape, out_init, placements)
    return from_block(out, dd.mesh, placements, field.shape)


def distributed_apply_jit(plan, dd: DomainDecomposition, *,
                          overlap: bool = True) -> Callable:
    """The closure over the plan for repeated Compute calls.  Nothing is
    compiled (the reference jit-compiles it): every call launches the
    plan's kernel as :func:`distributed_stencil_apply` does."""
    return functools.partial(distributed_stencil_apply, plan, dd=dd,
                             overlap=overlap)
