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
    enforced per group (GShard); the aux loss is then the groups' mean."""
    b, s, d = x.shape
    t = b * s
    group = cfg.group_tokens
    if not dropless and t > group and t % group == 0:
        xg = x.reshape(t // group, group, d)

        def per_group(xs):
            return _moe_dense_dispatch(params, xs[None], cfg,
                                       activation=activation, dropless=False)

        # each group's dispatch and expert stacks are recomputed in the
        # backward instead of kept, as the reference's jax.checkpoint
        outs, auxs = [], []
        for xs in xg:
            out, aux = remat(per_group, xs)
            outs.append(out[0])
            auxs.append(aux)
        return torch.stack(outs).reshape(b, s, d), torch.stack(auxs).mean()
    return _moe_dense_dispatch(
        params, x, cfg, activation=activation, dropless=dropless
    )


def _top_k(probs, k: int):
    """Top-k along the last axis, ties to the lower index first (as
    ``lax.top_k``; ``torch.topk`` leaves the order of ties open)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_dense_dispatch(params, x, cfg: MoEConfig, *, activation: str,
                        dropless: bool):
    b, s, d = x.shape
    e = cfg.num_experts
    t = b * s
    cap = t if dropless else _capacity(t, cfg)
    xt = x.reshape(t, d)

    logits = (xt @ params["router"]).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, cfg.top_k)  # (T, k)
    gate_vals = gate_vals / torch.clamp(
        gate_vals.sum(dim=-1, keepdim=True), min=1e-9)

    # Static-capacity dispatch: position of each (token, slot) in its expert.
    dispatch = torch.zeros((t, e, cap), dtype=torch.float32, device=x.device)
    combine = torch.zeros_like(dispatch)
    counts = torch.zeros((e,), dtype=torch.int64, device=x.device)
    for slot in range(cfg.top_k):
        sel = F.one_hot(gate_idx[:, slot], e)  # (T, E)
        pos = counts[None, :] + torch.cumsum(sel, dim=0) - sel  # (T, E)
        keep = (pos < cap) & (sel > 0)
        pos_oh = F.one_hot(torch.where(keep, pos, cap), cap + 1)[..., :cap]
        pos_oh = pos_oh.float()  # (T, E, cap); overflow -> dropped
        dispatch = dispatch + pos_oh
        combine = combine + pos_oh * gate_vals[:, slot][:, None, None]
        counts = counts + sel.sum(dim=0)

    # (E, cap, D) expert inputs
    xin = torch.einsum("tec,td->ecd", dispatch.to(x.dtype), xt)
    h = mlp_apply(params["experts"], xin, activation=activation)  # (E, cap, D)
    out = torch.einsum("tec,ecd->td", combine.to(x.dtype), h)

    # Switch-style load-balance aux loss
    me = probs.mean(dim=0)  # mean router prob per expert
    ce = F.one_hot(gate_idx[:, 0], e).float().mean(dim=0)
    aux = cfg.aux_loss_weight * e * torch.sum(me * ce)
    return out.reshape(b, s, d), aux
