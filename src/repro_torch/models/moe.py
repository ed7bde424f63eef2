"""Mixture-of-Experts layer of the LM substrate (the counterpart of
``repro.models.moe``): top-k routing with GShard-style static-capacity
dispatch by dense one-hot products, and the Switch/GShard load-balance
auxiliary loss.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    ParamRNG, dense_init, mlp_apply, mlp_init, remat, stack_trees,
)
from repro_torch.runtime import spmd


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 16
    top_k: int = 2
    capacity_factor: float = 1.25
    every_k_layers: int = 1  # MoE every k-th layer (2 for jamba)
    aux_loss_weight: float = 0.01
    group_tokens: int = 8192  # GShard group size (capacity per group)


def moe_init(rng: ParamRNG, d: int, d_ff: int, cfg: MoEConfig, dtype, *,
             gated: bool):
    experts = [
        mlp_init(rng, d, d_ff, dtype, gated=gated)
        for _ in range(cfg.num_experts)
    ]
    return {
        "router": dense_init(rng, d, cfg.num_experts, dtype, std=0.02),
        "experts": stack_trees(experts),  # leaves (E, ...)
    }


def _capacity(tokens: int, cfg: MoEConfig) -> int:
    cap = int(tokens * cfg.top_k * cfg.capacity_factor / cfg.num_experts)
    return max(cap, cfg.top_k)


def moe_apply(params, x, cfg: MoEConfig, *, activation: str,
              dropless: bool = False):
    """x: (B, S, D) -> (out, aux_loss).

    ``dropless=True`` sizes capacity to the token count (the decode path:
    no token may be dropped).  Sequences of more than ``group_tokens``
    tokens that it divides are processed in token groups with capacity
    enforced per group (GShard); the aux loss is then the groups' mean.

    The tokens run in segments: a GShard group, or on DTensors a rank's
    part of one.  Each rank routes its own tokens against the whole
    router.  A token's place in its expert's queue counts the tokens before
    it in the global token order within its group, so on DTensors each
    rank's counts a (segment, slot, expert) are all-gathered over the batch
    axes and the capacity drops are the one-device run's.  Each rank
    dispatches to its own experts (those of the axes that shard the expert
    stacks) and the output is the sum over the expert axes (a
    ``Partial``).  The load-balance loss takes each group's mean router
    probability and top-1 share over all of the group's tokens."""
    b, s, d = x.shape
    t = b * s
    group = cfg.group_tokens
    grouped = not dropless and t > group and t % group == 0
    span = group if grouped else t
    cap = t if dropless else _capacity(span, cfg)
    if spmd.is_dtensor(x):
        return _moe_sharded(params, x, cfg, activation=activation,
                            dropless=dropless, span=span, cap=cap)
    lay = _Layout(t_loc=t, seg=span, per_span=1, e_loc=cfg.num_experts,
                  e0=0, dp_idx=0, cap=cap, dropless=dropless, remat=grouped)
    gv, gi, counts, me, ce = _routing(x, params["router"], cfg, lay)
    out = _dispatch(x, gv, gi, counts, params["experts"], cfg, lay,
                    activation)
    return out, _aux(me, ce, cfg, lay)


def _top_k(probs, k: int):
    """Top-k along the last axis, ties to the lower index first (as
    ``lax.top_k``; ``torch.topk`` leaves the order of ties open)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@dataclasses.dataclass(frozen=True)
class _Layout:
    """Where a rank's tokens and experts sit: ``t_loc`` tokens in segments
    of ``seg``, ``per_span`` segments a GShard group, the first of them
    the ``dp_idx * n_seg``-th segment of the global order; experts
    ``e0 .. e0 + e_loc``; ``cap`` slots an expert a group; ``remat``: each
    segment's dispatch recomputed in the backward."""
    t_loc: int
    seg: int
    per_span: int
    e_loc: int
    e0: int
    dp_idx: int
    cap: int
    dropless: bool
    remat: bool

    @property
    def n_seg(self) -> int:
        return self.t_loc // self.seg


def _routing(x, router, cfg: MoEConfig, lay: _Layout):
    """The normalised top-k gates of the local tokens, and each segment's
    count of tokens a (slot, expert), mean router probability and top-1
    share: (gate_vals (T, k), gate_idx (T, k), counts (n_seg, k, E),
    me (n_seg, E), ce (n_seg, E))."""
    e, k, n_seg = cfg.num_experts, cfg.top_k, lay.n_seg
    probs = torch.softmax((x.reshape(lay.t_loc, -1) @ router).float(),
                          dim=-1)  # (T, E)
    gate_vals, gate_idx = _top_k(probs, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)
    counts = torch.stack([
        F.one_hot(gate_idx[:, sl], e).reshape(n_seg, lay.seg, e).sum(dim=1)
        for sl in range(k)], dim=1)
    me = probs.reshape(n_seg, lay.seg, e).mean(dim=1)
    ce = F.one_hot(gate_idx[:, 0], e).float().reshape(
        n_seg, lay.seg, e).mean(dim=1)
    return gate_vals, gate_idx, counts, me, ce


def _aux(me, ce, cfg: MoEConfig, lay: _Layout):
    """Switch-style load-balance loss from every segment's ``me`` and
    ``ce``, in the global order: the groups' mean."""
    e = cfg.num_experts
    me = me.reshape(-1, lay.per_span, e).mean(dim=1)
    ce = ce.reshape(-1, lay.per_span, e).mean(dim=1)
    return cfg.aux_loss_weight * e * torch.sum(me * ce, dim=-1).mean()


def _dispatch(x, gate_vals, gate_idx, counts, experts, cfg: MoEConfig,
              lay: _Layout, activation: str):
    """The local tokens through the local experts, segment by segment;
    ``counts`` holds every segment's, in the global order."""
    k, e = cfg.top_k, cfg.num_experts
    xt = x.reshape(lay.t_loc, -1)
    cnt = counts.reshape(-1, lay.per_span, k, e)  # (groups, segs, k, E)
    cols = slice(lay.e0, lay.e0 + lay.e_loc)

    def segment(xs, gv, gi, base, experts):
        dispatch = torch.zeros((xs.shape[0], lay.e_loc, lay.cap),
                               dtype=torch.float32, device=xs.device)
        combine = torch.zeros_like(dispatch)
        for sl in range(k):
            sel = F.one_hot(gi[:, sl], e)  # (T, E)
            pos = base[sl][None, :] + torch.cumsum(sel, dim=0) - sel
            keep = sel > 0
            if not lay.dropless:
                keep = keep & (pos < lay.cap)
            pos_oh = F.one_hot(torch.where(keep[:, cols], pos[:, cols],
                                           lay.cap), lay.cap + 1)
            pos_oh = pos_oh[..., :lay.cap].float()  # overflow -> dropped
            dispatch = dispatch + pos_oh
            combine = combine + pos_oh * gv[:, sl][:, None, None]
        # (E, cap, D) expert inputs
        xin = torch.einsum("tec,td->ecd", dispatch.to(xs.dtype), xs)
        h = mlp_apply(experts, xin, activation=activation)
        return torch.einsum("tec,ecd->td", combine.to(xs.dtype), h)

    outs = []
    for j in range(lay.n_seg):
        grp, within = divmod(lay.dp_idx * lay.n_seg + j, lay.per_span)
        g_cnt = cnt[grp]
        tot = g_cnt.sum(dim=0)  # (k, E)
        # tokens of earlier slots in the group, and of this slot in the
        # group's earlier segments
        base = torch.cumsum(tot, dim=0) - tot + g_cnt[:within].sum(dim=0)
        sl = slice(j * lay.seg, (j + 1) * lay.seg)
        args = (xt[sl], gate_vals[sl], gate_idx[sl], base, experts)
        # recomputed in the backward instead of kept, as the reference's
        # jax.checkpoint of each group
        outs.append(remat(segment, *args) if lay.remat else segment(*args))
    return torch.cat(outs).reshape(x.shape)


def _moe_sharded(params, x, cfg: MoEConfig, *, activation: str,
                 dropless: bool, span: int, cap: int):
    """:func:`moe_apply` on DTensors: ``x`` (B, S, D) sharded over its batch
    axes, the expert stacks over theirs, groups of ``span`` tokens."""
    mesh = x.device_mesh
    b, s, _ = x.shape
    e = cfg.num_experts
    bat = spmd.sharded_axes(x, 0)
    eax = tuple(a for a in spmd.sharded_axes(params["experts"]["w_up"], 0)
                if a not in bat)
    t_loc = b * s // spmd.axes_size(mesh, bat)
    if t_loc % span == 0:
        seg = span  # whole groups a rank
    elif span % t_loc == 0:
        seg = t_loc  # a group over span // t_loc ranks
    else:
        raise ValueError(
            f"a GShard group of {span} tokens neither holds nor divides a "
            f"rank's {t_loc} tokens")
    e_loc = e // spmd.axes_size(mesh, eax)
    lay = _Layout(t_loc=t_loc, seg=seg, per_span=span // seg, e_loc=e_loc,
                  e0=spmd.shard_index(mesh, eax) * e_loc,
                  dp_idx=spmd.shard_index(mesh, bat), cap=cap,
                  dropless=dropless, remat=True)

    rows = {a: 0 for a in bat}
    x_pl = spmd.placements_of(mesh, **rows)
    rep = spmd.placements_of(mesh)
    rows_p = spmd.placements_of(mesh, **rows, **{a: "P" for a in eax})
    exp_pl = spmd.placements_of(mesh, **{a: 0 for a in eax})
    exp_grad = spmd.placements_of(mesh, **{a: 0 for a in eax},
                                  **{a: "P" for a in bat})

    gate_vals, gate_idx, counts, me, ce = spmd.local_call(
        lambda xl, r: _routing(xl, r, cfg, lay), mesh,
        (x, params["router"]), (x_pl, rep), (x_pl,) * 5,
        (None, spmd.placements_of(mesh, **{a: "P" for a in bat})))
    # every segment's, in the global token order
    counts, me, ce = (v.redistribute(mesh, rep) for v in (counts, me, ce))
    leaves = sorted(params["experts"])
    out = spmd.local_call(
        lambda xl, gv, gi, cnt, *ws: _dispatch(
            xl, gv, gi, cnt, dict(zip(leaves, ws)), cfg, lay, activation),
        mesh, (x, gate_vals, gate_idx, counts,
               *(params["experts"][n] for n in leaves)),
        (x_pl, x_pl, x_pl, rep, *(exp_pl for _ in leaves)), rows_p,
        (rows_p, rows_p, None, None, *(exp_grad for _ in leaves)))
    return out, _aux(me, ce, cfg, lay)
