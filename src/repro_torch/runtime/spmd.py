"""Local regions of the LM substrate's sharded code (the counterpart of the
reference's ``jax.shard_map``).

Under a mesh the models run on DTensors and DTensor's sharding rules place
each op.  Where an op has no rule, or its rule would gather what must stay
sharded (the flash loops, the MoE dispatch, the recurrences, the vocab
dims), the model runs the op's local computation on each rank's shards in
a :func:`local_call` and states the collective it needs: its outputs come
back as DTensors, ``Partial`` where each rank holds a term of a sum, and
DTensor's redistribution (which autograd sees) does the all-reduce.
Nothing here gathers a whole parameter or cache.
"""

from __future__ import annotations

import torch


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def to_local(x):
    """A DTensor's local shard (the tensor itself, not a copy); any other
    tensor as it is."""
    return x.to_local() if is_dtensor(x) else x


def placements_of(mesh, **dims) -> list:
    """Placements on ``mesh`` from ``axis=tensor_dim`` keywords (``'P'`` for
    ``Partial()``, ``'P:max'`` for ``Partial('max')``); unnamed axes are
    replicated."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    out = []
    for name in mesh.mesh_dim_names:
        d = dims.get(name)
        if d is None:
            out.append(Replicate())
        elif d == "P":
            out.append(Partial())
        elif isinstance(d, str) and d.startswith("P:"):
            out.append(Partial(d[2:]))
        else:
            out.append(Shard(d))
    return out


def sharded_axes(x, dim: int) -> tuple[str, ...]:
    """The mesh axes over which DTensor ``x`` shards tensor dim ``dim``."""
    from torch.distributed.tensor import Shard

    mesh = x.device_mesh
    return tuple(n for n, p in zip(mesh.mesh_dim_names, x.placements)
                 if isinstance(p, Shard) and p.dim % x.ndim == dim % x.ndim)


def axes_size(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def shard_index(mesh, axes) -> int:
    """This rank's index along ``axes`` flattened in their order (the
    reference's ``idx * mesh.shape[a] + axis_index(a)``)."""
    idx = 0
    for a in axes:
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    return idx


def local_call(fn, mesh, args, in_placements, out_placements,
               grad_placements=None):
    """``fn`` on this rank's shards of ``args``, its outputs as DTensors.

    Each tensor argument is redistributed to its entry of
    ``in_placements`` (an entry of None passes the argument as it is: a
    plain tensor, a number), and ``fn`` gets the local shards.  Autograd
    runs through: ``grad_placements`` gives, for an argument, the layout
    of its gradient's local values (``Partial`` over the axes on which
    each rank's gradient is one term of the sum, where the argument is
    replicated but used on a shard of the batch); by default its
    placements.  ``fn`` returns a tensor or a tuple, each wrapped with its
    entry of ``out_placements`` (a single placements list for a single
    tensor)."""
    from torch.distributed.tensor import DTensor, Replicate

    locs, known = [], {}
    for i, (a, pl) in enumerate(zip(args, in_placements)):
        if pl is None or not isinstance(a, torch.Tensor):
            locs.append(a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        gp = grad_placements[i] if grad_placements else None
        # on a mesh dim of one rank every layout holds the same local
        # values: keep the argument's, so that nothing is copied
        one = [mesh.size(d) == 1 for d in range(mesh.ndim)]
        pl = [c if o else p for c, p, o in zip(a.placements, pl, one)]
        if gp is not None:
            gp = [c if o else g for c, g, o in zip(a.placements, gp, one)]
        a = a.redistribute(mesh, pl)
        locs.append(a.to_local(grad_placements=gp))
        for d in range(a.ndim):
            known.setdefault(_mesh_dims(a.placements, d, a.ndim), []).append(
                (locs[-1].shape[d], a.shape[d]))
    out = fn(*locs)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    pls = (out_placements,) if single else out_placements
    wrapped = tuple(
        o if pl is None else _from_local(o, mesh, pl, known)
        for o, pl in zip(outs, pls))
    return wrapped[0] if single else wrapped


def _mesh_dims(placements, dim: int, ndim: int) -> tuple[int, ...]:
    """The mesh dims over which ``placements`` shard tensor dim ``dim``."""
    from torch.distributed.tensor import Shard

    return tuple(i for i, p in enumerate(placements)
                 if isinstance(p, Shard) and p.dim % ndim == dim)


def _from_local(o, mesh, placements, known):
    """``o``, this rank's shard, as a DTensor of ``placements``.  A dim
    sharded over the same mesh dims as an argument's dim of the same local
    size (the batch rows a local region keeps) takes that dim's global
    size, which may be uneven (:func:`local_call`'s arguments as DTensor
    shards them: short or empty shards past the data); any other sharded
    dim is taken as even, as ``DTensor.from_local`` takes every dim."""
    from torch.distributed.tensor import DTensor

    shape, even = list(o.shape), list(o.shape)
    for d in range(o.ndim):
        dims = _mesh_dims(placements, d, o.ndim)
        if dims:
            for i in dims:
                even[d] *= mesh.size(i)
            same = [g for n, g in known.get(dims, ()) if n == o.shape[d]]
            shape[d] = same[0] if same else even[d]
    if shape == even:
        return DTensor.from_local(o, mesh, placements, run_check=False)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(o, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def batch_local(fn, x, *weights):
    """``fn(x, *weights)`` on each rank's batch rows of DTensor ``x`` (dim 0,
    kept sharded as it is; every other dim whole) and whole ``weights``:
    for products that DTensor's rules would place slowly or not at all.
    The output is sharded as the rows; a weight's gradient is a partial sum
    over the batch axes."""
    mesh = x.device_mesh
    rows = {a: 0 for a in sharded_axes(x, 0)}
    x_pl = placements_of(mesh, **rows)
    w_grad = placements_of(mesh, **{a: "P" for a in rows})
    return local_call(fn, mesh, (x, *weights),
                      (x_pl, *(placements_of(mesh) for _ in weights)), x_pl,
                      (None, *(w_grad for _ in weights)))
