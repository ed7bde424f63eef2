"""AdamW / Adafactor / 8-bit AdamW with a uniform functional interface (the
counterpart of ``repro.optim.optimizers``).

``opt = get_optimizer(name, lr=...)``; ``state = opt.init(params)``;
``params, state = opt.update(grads, state, params)``.  ``update`` is
functional: it returns new tensors and changes none it is given, unless
``donate=True`` gives it the params' and state's memory (the reference's
``donate_argnums``): it then writes the new values into them, leaf by
leaf, and returns them, so an update holds one leaf's temporaries at a
time instead of a second copy of the params and state.  Clipping scales
each leaf as it is updated (the values of ``clip_by_global_norm``'s
clipped tree, which is never made).  Params may be bf16: the update math
runs in float32 and casts back.  Each update
is the reference's arithmetic in the reference's order, leaf by leaf (not
``torch.optim``, whose operation order and bf16 state differ), and the
state trees are the reference's leaf for leaf, so a checkpoint of either
package restores in the other: ``step`` is a 0-d int32 tensor, the
moments float32 (int8 codes and float32 block scales for ``adamw8bit``).

On DTensor params (a mesh) the state is made as DTensors with the
placements of :func:`state_specs` and every update runs on the shards:
``global_norm`` sums each leaf's squares across its shards (an all-reduce
a leaf), Adafactor's row and column means reduce across the sharded dim
by DTensor's rules, and ``adamw8bit``'s flat 256-element blocks, which cut
across any sharding of the leaf, are kept sharded over ``data`` by blocks:
each rank quantises its blocks' flat range of the leaf, which one
all-to-all brings it from the ranks whose shards hold it (and takes back).
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.runtime import spmd
from repro_torch.runtime.sharding import (
    P, _fit_spec, placements_spec, spec_placements,
)
from repro_torch.util import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params) -> (params, state)
    name: str


def _whole(x):
    """A DTensor's value on every rank (a collective); a tensor as it is."""
    return x.full_tensor() if spmd.is_dtensor(x) else x


def global_norm(tree) -> torch.Tensor:
    leaves = [_whole(torch.sum(torch.square(x.float())))
              for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _clip(x, scale):
    """``x`` scaled by a clip scale (None: unclipped), in its dtype."""
    return x if scale is None else (x.float() * scale).to(x.dtype)


def clip_by_global_norm(tree, max_norm: float):
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda x: _clip(x, scale), tree), norm


def _lr_fn(lr):
    return lr if callable(lr) else (lambda _: lr)


def _into(old, new, donate: bool):
    """``new``; with ``donate``, its values written into ``old``, which is
    returned."""
    if not donate:
        return new
    old.copy_(new)
    return old


def _step_zero(params):
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    step = torch.zeros((), dtype=torch.int32, device=dev)
    if leaves and spmd.is_dtensor(leaves[0]):
        return _like_spec(step, P(), leaves[0].device_mesh)
    return step


def _like_spec(x, spec, mesh):
    """``x`` (the same on every rank) as a DTensor of ``spec``'s
    placements, each rank keeping its shard (no collective)."""
    from torch.distributed.tensor import DTensor, Replicate

    spec = _fit_spec(spec, x.ndim, tuple(x.shape), mesh)
    full = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
    return full.redistribute(mesh, spec_placements(spec, mesh))


def _zeros(shape, dtype, p, spec_of=None):
    """Zeros of ``shape`` beside param ``p``: on a DTensor ``p``, a DTensor
    of the spec ``spec_of(spec of p)`` (``p``'s own by default)."""
    if not spmd.is_dtensor(p):
        return torch.zeros(shape, dtype=dtype, device=p.device)
    from torch.distributed.tensor import zeros

    mesh = p.device_mesh
    spec = placements_spec(p.placements, mesh, p.ndim)
    if spec_of is not None:
        spec = spec_of(spec)
    spec = _fit_spec(spec, len(shape), tuple(shape), mesh)
    return zeros(shape, dtype=dtype, device_mesh=mesh,
                 placements=spec_placements(spec, mesh))


def _entries(spec, ndim: int) -> list:
    return list(spec) + [None] * (ndim - len(spec))


def _split(params, out, n: int):
    """The ``n`` trees of the ``n``-tuples ``out`` holds at each param."""
    return [tree_map(lambda _, t, i=i: t[i], params, out) for i in range(n)]


# ---------------------------------------------------------------------------
# AdamW (f32 moments)
# ---------------------------------------------------------------------------


def adamw(
    lr: Callable | float,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float | None = 1.0,
) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        def zeros(p):
            return _zeros(p.shape, torch.float32, p)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": _step_zero(params)}

    def update(grads, state, params, *, donate: bool = False):
        scale = _clip_scale(global_norm(grads), clip_norm) if clip_norm \
            else None
        step = state["step"] + 1
        t = spmd.to_local(step)  # the same on every rank
        lr_t = lr_fn(t)
        c1 = 1.0 - b1 ** t.float()
        c2 = 1.0 - b2 ** t.float()

        def upd(p, g, m_old, v_old):
            # b1 m + (1 - b1) g, b2 v + (1 - b2) g g, (m / c1) /
            # (sqrt(v / c2) + eps) and p - lr (u + wd p), each operation on
            # the same operands as the reference's, in place on temporaries
            g = _clip(g, scale).float()
            m = (b1 * m_old).add_((1 - b1) * g)
            v = (b2 * v_old).add_((1 - b2) * g * g)
            u = (m / c1).div_((v / c2).sqrt_().add_(eps))
            pf = p.float()
            u = u.add_(weight_decay * pf).mul_(lr_t)
            return (_into(p, (pf - u).to(p.dtype), donate),
                    _into(m_old, m, donate), _into(v_old, v, donate))

        out = tree_map(upd, params, grads, state["m"], state["v"])
        new_params, new_m, new_v = _split(params, out, 3)
        return new_params, {"m": new_m, "v": new_v, "step": step}

    return Optimizer(init=init, update=update, name="adamw")


# ---------------------------------------------------------------------------
# Adafactor (factored second moments; beta1=0 => no first moment buffer)
# ---------------------------------------------------------------------------


def adafactor(
    lr: Callable | float,
    *,
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    decay: float = 0.8,
    weight_decay: float = 0.0,
) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        def per_leaf(p):
            n = p.ndim
            if n >= 2:
                return {"vr": _zeros(p.shape[:-1], torch.float32, p,
                                     lambda s: P(*_entries(s, n)[:-1])),
                        "vc": _zeros(p.shape[:-2] + p.shape[-1:],
                                     torch.float32, p,
                                     lambda s: P(*_entries(s, n)[:-2],
                                                 _entries(s, n)[-1]))}
            return {"v": _zeros(p.shape, torch.float32, p)}

        return {"stats": tree_map(per_leaf, params),
                "step": _step_zero(params)}

    def update(grads, state, params, *, donate: bool = False):
        step = state["step"] + 1
        t = spmd.to_local(step)  # the same on every rank
        beta2 = 1.0 - t.float() ** -decay
        lr_t = lr_fn(t)

        def upd(p, g, st):
            g = g.float()
            g2 = g * g + eps
            if p.ndim >= 2:
                vr = beta2 * st["vr"] + (1 - beta2) * g2.mean(dim=-1)
                vc = beta2 * st["vc"] + (1 - beta2) * g2.mean(dim=-2)
                denom = vr.mean(dim=-1, keepdim=True)
                r = (vr / torch.clamp(denom, min=eps))[..., None]
                c = vc[..., None, :]
                u = g * torch.rsqrt(torch.clamp(r * c, min=eps))
                new_st = {"vr": _into(st["vr"], vr, donate),
                          "vc": _into(st["vc"], vc, donate)}
            else:
                v = beta2 * st["v"] + (1 - beta2) * g2
                u = g * torch.rsqrt(torch.clamp(v, min=eps))
                new_st = {"v": _into(st["v"], v, donate)}
            # relative update clipping (Adafactor's d)
            rms_u = torch.sqrt(torch.mean(u * u) + 1e-30)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            pf = p.float()
            pf = pf - lr_t * (u + weight_decay * pf)
            return _into(p, pf.to(p.dtype), donate), new_st

        out = tree_map(upd, params, grads, state["stats"])
        new_params, new_stats = _split(params, out, 2)
        return new_params, {"stats": new_stats, "step": step}

    return Optimizer(init=init, update=update, name="adafactor")


# ---------------------------------------------------------------------------
# 8-bit AdamW: block-quantised moments (Dettmers-style)
# ---------------------------------------------------------------------------

_BLOCK = 256


def _quantize(x):
    """Blockwise absmax int8 quantisation of a flat float32 tensor:
    ``(codes (n_blocks, 256) int8, scales (n_blocks, 1) float32)``.
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    n = x.numel()
    pad = (-n) % _BLOCK
    xf = F.pad(x.reshape(-1), (0, pad)).reshape(-1, _BLOCK)
    scale = torch.amax(torch.abs(xf), dim=1, keepdim=True) / 127.0
    q = torch.round(xf / torch.clamp(scale, min=1e-20)).to(torch.int8)
    return q, scale.float()


def _dequantize(q, scale, shape):
    xf = q.float() * scale
    n = 1
    for s in shape:
        n *= s
    return xf.reshape(-1)[:n].reshape(shape)


def _blocks_like(p, q, s):
    """Codes and scales beside param ``p``: on a DTensor ``p`` (every rank
    holding the same whole blocks), DTensors sharded by blocks over
    ``data`` as :func:`state_specs` places them."""
    if not spmd.is_dtensor(p):
        return {"q": q, "s": s}
    mesh = p.device_mesh
    spec = P("data", None) if "data" in mesh.mesh_dim_names else P()
    return {"q": _like_spec(q, spec, mesh), "s": _like_spec(s, spec, mesh)}


class _Rows:
    """A leaf of ``shape`` cut along dim ``j`` into ``n`` boxes of
    consecutive rows, box ``s`` on rank ``s`` of a mesh axis, against its
    flat (row-major) order: which box a flat index falls in, and how many
    of a box's elements lie below one.  A box's elements, in its own
    row-major order, are in increasing flat order."""

    def __init__(self, shape, j: int, n: int):
        self.inner = 1
        for d in shape[j + 1:]:
            self.inner *= d
        self.rows = shape[j]
        self.width = self.rows // n * self.inner  # a box's part of a period

    def below(self, s: int, v: int) -> int:
        q, r = divmod(v, self.rows * self.inner)
        return q * self.width + min(max(r - s * self.width, 0), self.width)

    def count(self, s: int, lo: int, hi: int) -> int:
        return self.below(s, hi) - self.below(s, lo)

    def box_of(self, lo: int, hi: int, device):
        g = torch.arange(lo, hi, device=device)
        return (g % (self.rows * self.inner)) // self.width


def _all_to_all(chunks, recv_sizes, mesh, axis: str):
    """Chunk ``t`` to rank ``t`` of mesh axis ``axis``; what each rank sent
    to this one, by sender."""
    from torch.distributed._functional_collectives import (
        all_to_all_single, wait_tensor,
    )

    send = torch.cat(chunks)
    if len(chunks) == 1:
        return send
    dim = mesh.mesh_dim_names.index(axis)
    return wait_tensor(all_to_all_single(
        send, recv_sizes, [c.numel() for c in chunks], (mesh, dim)))


def _block_layout(p):
    """How a DTensor leaf ``p`` meets its sharded blocks: (the axis whose
    boxes are exchanged with the block ranges, the dim it cuts, the
    placements of ``p`` with only that axis sharding), or None when the
    blocks are not sharded (every rank holds them all)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = p.device_mesh
    nb = -(-p.numel() // _BLOCK)
    if ("data" not in mesh.mesh_dim_names
            or _fit_spec(P("data"), 2, (nb, _BLOCK), mesh) == P()):
        return None
    names = mesh.mesh_dim_names
    cuts = [(a, pl.dim % p.ndim) for a, pl in zip(names, p.placements)
            if isinstance(pl, Shard)]
    # the data axis's own boxes where it shards the leaf, else another's
    cuts.sort(key=lambda c: c[0] != "data")
    axis, j = cuts[0] if cuts else (None, None)
    pls = [Shard(j) if a == axis else Replicate() for a in names]
    return axis, j, pls


def _block_range(mesh, n: int, k: int):
    """The flat range of a leaf of ``n`` elements held by data rank ``k``
    (its blocks' part before the padding) and the padded length of it."""
    nd = spmd.axes_size(mesh, ("data",))
    per = -(-n // _BLOCK) // nd * _BLOCK
    return k * per, min((k + 1) * per, n), per


def _dequantize_like(qs, p):
    """:func:`_dequantize` to ``p``'s shape and layout.  The blocks run over
    the whole leaf in flat order, across any sharding of it: on DTensors
    each rank dequantises its blocks (a flat range of the leaf) and one
    all-to-all moves each element to the ranks whose shard of ``p`` holds
    it; nothing is gathered whole that is not whole on every rank."""
    if not spmd.is_dtensor(p):
        return _dequantize(qs["q"], qs["s"], p.shape)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = p.device_mesh
    lay = _block_layout(p)
    if lay is None:  # the blocks are whole on every rank
        x = _dequantize(qs["q"].to_local(), qs["s"].to_local(), p.shape)
        return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False).redistribute(
            mesh, p.placements)
    axis, j, pls = lay
    n, nd = p.numel(), spmd.axes_size(mesh, ("data",))
    k = mesh.get_local_rank("data")
    lo, hi, per = _block_range(mesh, n, k)
    vals = (qs["q"].to_local().float() * qs["s"].to_local()).reshape(-1)
    vals = vals[:hi - lo]
    if axis is None:  # p is whole on every rank: gather its blocks
        flat = DTensor.from_local(
            F.pad(vals, (0, per - (hi - lo))), mesh,
            [Shard(0) if a == "data" else Replicate()
             for a in mesh.mesh_dim_names], run_check=False)
        x = flat.full_tensor()[:n].reshape(p.shape)
        return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False).redistribute(
            mesh, p.placements)
    na = spmd.axes_size(mesh, (axis,))
    rows = _Rows(tuple(p.shape), j, na)
    ranges = [_block_range(mesh, n, t)[:2] for t in range(nd)]
    if axis == "data":  # to data rank t: the elements of box t
        order = torch.argsort(rows.box_of(lo, hi, vals.device), stable=True)
        vals = vals[order]
        sizes = [rows.count(t, lo, hi) for t in range(nd)]
        chunks = list(torch.split(vals, sizes))
        recv = [rows.count(k, *ranges[s]) for s in range(nd)]
        mine = k
    else:  # to every data rank: the elements of this rank's box
        mine = mesh.get_local_rank(axis)
        order = torch.argsort(
            (rows.box_of(lo, hi, vals.device) != mine).to(torch.int8),
            stable=True)
        c = rows.count(mine, lo, hi)
        chunks = [vals[order[:c]]] * nd
        recv = [rows.count(mine, *ranges[s]) for s in range(nd)]
    # by sender: the box's elements in increasing flat order
    box = _all_to_all(chunks, recv, mesh, "data")
    shape = list(p.shape)
    shape[j] //= na
    x = DTensor.from_local(box.reshape(shape), mesh, pls, run_check=False)
    return x.redistribute(mesh, p.placements)


def _quantize_like(x, p):
    """:func:`_quantize` of ``x`` (``p``'s shape and layout), as
    ``_blocks_like`` places codes and scales.  On DTensors each rank
    quantises only its blocks' flat range of the leaf: one all-to-all
    over the axis that cuts the leaf brings it the range's elements from
    the ranks whose shards hold them."""
    if not spmd.is_dtensor(x):
        return _quantize(x)
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = p.device_mesh
    lay = _block_layout(p)
    if lay is None:  # every rank keeps every block
        out = _blocks_like(p, *_quantize(_whole(x)))
        return out["q"], out["s"]
    axis, j, pls = lay
    n = p.numel()
    k = mesh.get_local_rank("data")
    lo, hi, per = _block_range(mesh, n, k)
    local = x.redistribute(mesh, pls).to_local().reshape(-1)
    if axis is None:
        vals = local[lo:hi]
    else:
        na = spmd.axes_size(mesh, (axis,))
        mine = mesh.get_local_rank(axis)
        rows = _Rows(tuple(p.shape), j, na)
        if axis == "data":  # each data rank its own range
            dests = [_block_range(mesh, n, t)[:2] for t in range(na)]
        else:  # every rank of the axis this rank's range
            dests = [(lo, hi)] * na
        chunks = [local[rows.below(mine, a):rows.below(mine, b)]
                  for a, b in dests]
        got = _all_to_all(chunks, [rows.count(s, lo, hi) for s in range(na)],
                          mesh, axis)
        # by sender, each sender's part in increasing flat order
        order = torch.argsort(rows.box_of(lo, hi, got.device), stable=True)
        vals = torch.empty_like(got)
        vals[order] = got
    q, s = _quantize(F.pad(vals, (0, per - (hi - lo))))
    rep = [Shard(0) if a == "data" else Replicate()
           for a in mesh.mesh_dim_names]
    return (DTensor.from_local(q, mesh, rep, run_check=False),
            DTensor.from_local(s, mesh, rep, run_check=False))


def adamw8bit(
    lr: Callable | float,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: float | None = 1.0,
) -> Optimizer:
    lr_fn = _lr_fn(lr)

    def init(params):
        def zq(p):
            # zeros' codes and scales are zeros, made on each rank's shard
            nb = -(-p.numel() // _BLOCK)
            names = p.device_mesh.mesh_dim_names if spmd.is_dtensor(p) else ()
            spec = P("data", None) if "data" in names else P()
            return {"q": _zeros((nb, _BLOCK), torch.int8, p, lambda _: spec),
                    "s": _zeros((nb, 1), torch.float32, p, lambda _: spec)}

        return {"m": tree_map(zq, params), "v": tree_map(zq, params),
                "step": _step_zero(params)}

    def update(grads, state, params, *, donate: bool = False):
        scale = _clip_scale(global_norm(grads), clip_norm) if clip_norm \
            else None
        step = state["step"] + 1
        t = spmd.to_local(step)  # the same on every rank
        lr_t = lr_fn(t)
        c1 = 1.0 - b1 ** t.float()
        c2 = 1.0 - b2 ** t.float()

        def upd(p, g, mq, vq):
            g = _clip(g, scale).float()
            m = _dequantize_like(mq, p)
            # v is stored in sqrt-space: linear absmax quantisation of raw v
            # underflows small-|g| entries in a block to 0, exploding their
            # updates; sqrt-space halves the dynamic range
            rv = _dequantize_like(vq, p)
            v = rv * rv
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            u = (m / c1) / (torch.sqrt(torch.clamp(v, min=0.0) / c2) + eps)
            pf = p.float()
            pf = pf - lr_t * (u + weight_decay * pf)
            qm, sm = _quantize_like(m, p)
            qv, sv = _quantize_like(torch.sqrt(torch.clamp(v, min=0.0)), p)
            return (_into(p, pf.to(p.dtype), donate),
                    {"q": _into(mq["q"], qm, donate),
                     "s": _into(mq["s"], sm, donate)},
                    {"q": _into(vq["q"], qv, donate),
                     "s": _into(vq["s"], sv, donate)})

        out = tree_map(upd, params, grads, state["m"], state["v"])
        new_params, new_m, new_v = _split(params, out, 3)
        return new_params, {"m": new_m, "v": new_v, "step": step}

    return Optimizer(init=init, update=update, name="adamw8bit")


# ---------------------------------------------------------------------------


def get_optimizer(name: str, lr, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    if name == "adamw8bit":
        return adamw8bit(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")


def _spec_tree_map(fn, specs, *others):
    """``fn(spec, *other leaves)`` over a spec tree and trees of its
    layout."""
    if isinstance(specs, P):
        return fn(specs, *others)
    if isinstance(specs, dict):
        return {k: _spec_tree_map(fn, v, *(o[k] for o in others))
                for k, v in specs.items()}
    return type(specs)(_spec_tree_map(fn, v, *(o[i] for o in others))
                       for i, v in enumerate(specs))


def state_specs(opt_name: str, param_specs, param_shapes=None):
    """Partition specs for optimizer state given param specs (+ shapes,
    needed to mirror Adafactor's rank-based factoring decision)."""
    if opt_name in ("adamw",):
        return {
            "m": param_specs,
            "v": param_specs,
            "step": P(),
        }
    if opt_name == "adafactor":
        def per_leaf(spec, shape):
            ndim = len(shape.shape) if hasattr(shape, "shape") else len(shape)
            entries = list(spec) + [None] * (ndim - len(spec))
            if ndim >= 2:
                return {
                    "vr": P(*entries[:-1]),
                    "vc": P(*entries[:-2], entries[-1]),
                }
            return {"v": P(*entries)}

        if param_shapes is None:
            raise ValueError("adafactor state_specs needs param_shapes")
        return {"stats": _spec_tree_map(per_leaf, param_specs, param_shapes),
                "step": P()}
    if opt_name == "adamw8bit":
        # quantised flat blocks: shard along the block axis over fsdp
        def per_leaf(spec):
            return {"q": P("data", None), "s": P("data", None)}

        q = _spec_tree_map(per_leaf, param_specs)
        return {"m": q, "v": q, "step": P()}
    raise ValueError(opt_name)
