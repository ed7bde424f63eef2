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
"""

from __future__ import annotations

from collections.abc import Callable
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.util import tree_leaves, tree_map

_REFUSED = ("optimizer-state shardings need a mesh (ROADMAP.md, Open items: "
            "LM sharding)")


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., Any]  # (grads, state, params) -> (params, state)
    name: str


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
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
    return torch.zeros((), dtype=torch.int32, device=dev)


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
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": _step_zero(params)}

    def update(grads, state, params, *, donate: bool = False):
        scale = _clip_scale(global_norm(grads), clip_norm) if clip_norm \
            else None
        step = state["step"] + 1
        lr_t = lr_fn(step)
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()

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
            def zeros(shape):
                return torch.zeros(shape, dtype=torch.float32,
                                   device=p.device)

            if p.ndim >= 2:
                return {"vr": zeros(p.shape[:-1]),  # drop cols
                        "vc": zeros(p.shape[:-2] + p.shape[-1:])}
            return {"v": zeros(p.shape)}

        return {"stats": tree_map(per_leaf, params),
                "step": _step_zero(params)}

    def update(grads, state, params, *, donate: bool = False):
        step = state["step"] + 1
        beta2 = 1.0 - step.float() ** -decay
        lr_t = lr_fn(step)

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
            q, s = _quantize(torch.zeros(p.numel(), dtype=torch.float32,
                                         device=p.device))
            return {"q": q, "s": s}

        return {"m": tree_map(zq, params), "v": tree_map(zq, params),
                "step": _step_zero(params)}

    def update(grads, state, params, *, donate: bool = False):
        scale = _clip_scale(global_norm(grads), clip_norm) if clip_norm \
            else None
        step = state["step"] + 1
        lr_t = lr_fn(step)
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()

        def upd(p, g, mq, vq):
            g = _clip(g, scale).float()
            m = _dequantize(mq["q"], mq["s"], p.shape)
            # v is stored in sqrt-space: linear absmax quantisation of raw v
            # underflows small-|g| entries in a block to 0, exploding their
            # updates; sqrt-space halves the dynamic range
            rv = _dequantize(vq["q"], vq["s"], p.shape)
            v = rv * rv
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            u = (m / c1) / (torch.sqrt(torch.clamp(v, min=0.0) / c2) + eps)
            pf = p.float()
            pf = pf - lr_t * (u + weight_decay * pf)
            qm, sm = _quantize(m)
            qv, sv = _quantize(torch.sqrt(torch.clamp(v, min=0.0)))
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


def state_specs(opt_name: str, param_specs, param_shapes=None):
    """Shardings of an optimizer state: refused until the port shards the
    LM over a mesh."""
    raise NotImplementedError(_REFUSED)
