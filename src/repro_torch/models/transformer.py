"""Decoder-only LM assembly for the dense / MoE / SSM / hybrid families (the
counterpart of ``repro.models.transformer``).

Layer stacks keep the reference's layout: each leaf has a leading axis of
scan steps (one layer a step; for hybrids one pattern period a step, with a
list of stacks, one per position in the period), and the forward runs the
steps in a Python loop where the reference scans them.

Three entry points per model:

- ``loss_fn``     — next-token CE, differentiable by autograd;
- ``prefill``     — full-sequence forward returning the last position's
  logits and the per-layer K/V;
- ``decode_step`` — single-token step against caches, updated in place.

``prefill`` and ``decode_step`` run without autograd (:func:`serving`).
The config's ``remat`` ('full', 'dots', 'group:N' or 'none') checkpoints
the layer loop as the reference's does; it shapes only the backward's
memory, never a value.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import attention as att
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    ParamRNG,
    apply_rope,
    chunked_softmax_cross_entropy,
    dense_init,
    embed_init,
    embed_lookup,
    matmul,
    mlp_apply,
    mlp_init,
    remat,
    rmsnorm,
    rmsnorm_init,
    serving,
    softmax_cross_entropy,
    split_heads,
    stack_trees,
    unembed_logits,
    unstack_tree,
)
from repro_torch.runtime.sharding import Shardings
from repro_torch.util import resolve_device


# ---------------------------------------------------------------------------
# per-layer kinds
# ---------------------------------------------------------------------------


def layer_kind(cfg: ArchConfig, idx: int) -> str:
    """'attn' | 'mamba' | 'rwkv' for the mixer; MLP kind handled separately."""
    if cfg.family == "ssm":
        return "rwkv"
    if cfg.family == "hybrid":
        return "attn" if (idx % cfg.attn_every) == (cfg.attn_every - 1) else "mamba"
    return "attn"


def mlp_kind(cfg: ArchConfig, idx: int) -> str:
    if cfg.moe is None:
        return "dense"
    k = cfg.moe.every_k_layers
    return "moe" if (idx % k) == (k - 1) else "dense"


def _attn_init(rng: ParamRNG, cfg: ArchConfig, dtype):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": dense_init(rng, d, h * hd, dtype),
        "wk": dense_init(rng, d, kv * hd, dtype),
        "wv": dense_init(rng, d, kv * hd, dtype),
        "wo": dense_init(rng, h * hd, d, dtype),
    }


def _layer_init(rng: ParamRNG, cfg: ArchConfig, idx: int, dtype):
    kind, mk = layer_kind(cfg, idx), mlp_kind(cfg, idx)
    p: dict[str, Any] = {"ln1": rmsnorm_init(rng, cfg.d_model, dtype)}
    if kind == "attn":
        p["attn"] = _attn_init(rng, cfg, dtype)
    elif kind == "mamba":
        p["mamba"] = ssm_mod.mamba_init(rng, cfg.d_model, cfg.mamba, dtype)
    elif kind == "rwkv":
        p["tmix"] = ssm_mod.rwkv_time_mix_init(rng, cfg.d_model, cfg.rwkv,
                                               dtype)
    p["ln2"] = rmsnorm_init(rng, cfg.d_model, dtype)
    if cfg.family == "ssm":
        p["cmix"] = ssm_mod.rwkv_channel_mix_init(rng, cfg.d_model, cfg.d_ff,
                                                  dtype)
    elif mk == "moe":
        p["moe"] = moe_mod.moe_init(rng, cfg.d_model, cfg.d_ff, cfg.moe,
                                    dtype, gated=cfg.gated_mlp)
    else:
        p["mlp"] = mlp_init(rng, cfg.d_model, cfg.d_ff, dtype,
                            gated=cfg.gated_mlp)
    return p


def _stack_period(cfg: ArchConfig) -> int:
    """Layers per scan step: 1 for homogeneous stacks, the pattern period
    for hybrids (jamba: lcm(attn_every=8, moe_every=2) = 8)."""
    if cfg.family != "hybrid":
        return 1
    return math.lcm(cfg.attn_every, cfg.moe.every_k_layers if cfg.moe else 1)


def init_params(rng: ParamRNG, cfg: ArchConfig):
    dtype = cfg.dtype_policy.pdt
    period = _stack_period(cfg)
    n_steps = cfg.n_layers // period

    # stack params: for each position-in-period, stack across scan steps
    # (each position's per-step layers are freed once stacked)
    stacks = [
        stack_trees([_layer_init(rng, cfg, s * period + pos, dtype)
                     for s in range(n_steps)])
        for pos in range(period)
    ]

    params = {
        "embed": embed_init(rng, cfg.vocab, cfg.d_model, dtype),
        "blocks": stacks if period > 1 else stacks[0],
        "ln_f": rmsnorm_init(rng, cfg.d_model, dtype),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = dense_init(
            rng, cfg.d_model, cfg.vocab, dtype, std=cfg.d_model**-0.5
        )
    return params


def layer_at(tree, i: int):
    """Step ``i`` of a stacked tree (views into the stacked leaves)."""
    if isinstance(tree, dict):
        return {k: layer_at(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _run_attn(p, x, cfg, sh: Shardings, *, positions, causal=True):
    b, s, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = split_heads(matmul(x, p["wq"]), h, hd)
    k = split_heads(matmul(x, p["wk"]), kv, hd)
    v = split_heads(matmul(x, p["wv"]), kv, hd)
    q = sh.act_bthd(apply_rope(q, positions, theta=cfg.rope_theta))
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    o = att.flash_attention(q, k, v, causal=causal)
    o = sh.act_bthd(o)
    out = matmul(o.reshape(b, s, h * hd), p["wo"])
    return out, (k, v)


def _run_mixer(p, x, cfg, sh, *, positions, kind):
    """Sequence mixer (pre-norm residual branch).  Returns (delta, kv)."""
    xin = rmsnorm(p["ln1"], x, eps=cfg.norm_eps)
    if kind == "attn":
        return _run_attn(p["attn"], xin, cfg, sh, positions=positions)
    if kind == "mamba":
        out, _ = ssm_mod.mamba_apply(p["mamba"], xin, cfg.mamba)
        return out, None
    if kind == "rwkv":
        out, _ = ssm_mod.rwkv_time_mix(p["tmix"], xin, cfg.rwkv)
        return out, None
    raise ValueError(kind)


def _run_mlp(p, x, cfg, sh, *, idx_kind):
    xin = rmsnorm(p["ln2"], x, eps=cfg.norm_eps)
    if cfg.family == "ssm":
        out, _ = ssm_mod.rwkv_channel_mix(p["cmix"], xin)
        return out, 0.0
    if idx_kind == "moe":
        return moe_mod.moe_apply(p["moe"], xin, cfg.moe,
                                 activation=cfg.activation)
    return mlp_apply(p["mlp"], xin, activation=cfg.activation), 0.0


def _block(p, x, cfg, sh, *, positions, kind, mk):
    delta, kv = _run_mixer(p, x, cfg, sh, positions=positions, kind=kind)
    x = sh.act_btd(x + delta)
    delta, aux = _run_mlp(p, x, cfg, sh, idx_kind=mk)
    x = sh.act_btd(x + delta)
    return x, aux, kv


def _remat(fn, cfg: ArchConfig):
    """The layer loop's checkpoint for ``cfg.remat``: 'none' keeps every
    activation; 'dots' keeps the unbatched products' outputs; 'full' (and
    the inner layers of 'group:N') keeps only each layer's input."""
    if cfg.remat == "none":
        return fn
    policy = "dots" if cfg.remat == "dots" else "full"
    return lambda *args: remat(fn, *args, policy=policy)


def _remat_group_size(cfg: ArchConfig) -> int:
    """remat='group:N' => nested checkpointing: the layers run in groups of
    N; only group *inputs* are kept across the stack (L/N residuals
    instead of L), and the layers within a group are themselves
    rematerialised during the group's backward recompute.  Memory ~ L/N
    layer-inputs + 1 layer working set; compute ~ one extra forward."""
    if cfg.remat.startswith("group:"):
        return int(cfg.remat.split(":")[1])
    return 1


def _stack_kvs(kvs: list):
    """Per-step (k, v) pairs -> (k stacked over steps, v stacked)."""
    return torch.stack([k for k, _ in kvs]), torch.stack([v for _, v in kvs])


def forward(
    params,
    cfg: ArchConfig,
    tokens,
    sh: Shardings = Shardings.none(),
    *,
    extra_embeds=None,
    collect_kv: bool = False,
    logits_mode: str = "all",  # 'all' | 'last' | 'hidden'
):
    """Full-sequence forward.  Returns (logits, aux_loss, kv_stack|None).

    ``extra_embeds``: (B, S_img, D) stub frontend embeddings prepended to the
    token embeddings (VLM).  ``logits_mode='last'`` unembeds only the final
    position (the serving prefill path); ``'hidden'`` returns the final
    normed hidden states.  With ``collect_kv`` the K/V of every attention
    layer come back stacked over scan steps, (steps, B, S, KV, hd) each (a
    tuple of such pairs, one per attention position, for hybrids); None
    for attention-free stacks."""
    x = embed_lookup(params["embed"], tokens).to(cfg.dtype_policy.cdt)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    x = sh.act_btd(x)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device)[None, :]

    period = _stack_period(cfg)
    blocks = params["blocks"] if period > 1 else [params["blocks"]]
    # steps[i][pos]: the layer at position pos of scan step i
    steps = list(zip(*(unstack_tree(stack) for stack in blocks)))

    def body(x, aux, lps):
        kvs_step = []
        for pos in range(period):
            x, a, kv = _block(
                lps[pos], x, cfg, sh, positions=positions,
                kind=layer_kind(cfg, pos), mk=mlp_kind(cfg, pos),
            )
            aux = aux + a
            kvs_step.append(kv)
        return x, aux, kvs_step

    aux = 0.0
    kvs_by_pos: list[list] = [[] for _ in range(period)]
    G = _remat_group_size(cfg)
    if (period == 1 and G > 1 and cfg.n_layers % G == 0
            and not collect_kv):
        def group_body(x, aux, group):
            for lps in group:
                x, aux, _ = remat(body, x, aux, lps)
            return x, aux

        for g in range(cfg.n_layers // G):
            x, aux = remat(group_body, x, aux, steps[g * G:(g + 1) * G])
    else:
        step_fn = _remat(body, cfg)
        for lps in steps:
            x, aux, kvs_step = step_fn(x, aux, lps)
            if collect_kv:
                for pos, kv in enumerate(kvs_step):
                    if kv is not None:
                        kvs_by_pos[pos].append(kv)
    kvs = None
    if collect_kv:
        stacked = tuple(_stack_kvs(k) for k in kvs_by_pos if k)
        if period == 1:
            kvs = stacked[0] if stacked else None
        else:
            kvs = stacked or None

    x = rmsnorm(params["ln_f"], x, eps=cfg.norm_eps)
    if logits_mode == "hidden":
        return x, aux, kvs
    if logits_mode == "last":
        x = x[:, -1:, :]
    if cfg.tie_embeddings:
        logits = unembed_logits(x, params["embed"])
    else:
        logits = matmul(x, params["unembed"])
    logits = sh.act_btv(logits)
    return logits, aux, kvs


def loss_fn(
    params,
    cfg: ArchConfig,
    tokens,
    labels,
    sh: Shardings = Shardings.none(),
    *,
    extra_embeds=None,
    z_loss: float = 1e-4,
):
    """Mean next-token CE (labels already shifted).

    Sequences of 2048 tokens and more use the sequence-chunked CE so the
    (B, S, V) logits tensor never exists, as in the reference."""
    seq = tokens.shape[1]
    if seq >= 2048 and seq % 512 == 0:
        hidden, aux, _ = forward(
            params, cfg, tokens, sh, extra_embeds=extra_embeds,
            logits_mode="hidden",
        )
        if extra_embeds is not None:
            hidden = hidden[:, extra_embeds.shape[1]:, :]
        table = params["embed"] if cfg.tie_embeddings else params["unembed"]
        ce = chunked_softmax_cross_entropy(
            hidden, table, labels, z_loss=z_loss,
            transpose_table=cfg.tie_embeddings,
        )
        return ce + aux
    logits, aux, _ = forward(params, cfg, tokens, sh,
                             extra_embeds=extra_embeds)
    if extra_embeds is not None:
        logits = logits[:, extra_embeds.shape[1]:, :]
    ce = softmax_cross_entropy(logits, labels, z_loss=z_loss)
    return ce.mean() + aux


# ---------------------------------------------------------------------------
# serving: prefill + decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None, *,
               device="cuda"):
    """Decode caches, stacked over scan steps.

    attention: dict(k=(steps, B, KV, S, hd), v=...) (int8 values and
    (steps, B, KV, S) float32 scales with ``cache_dtype='int8'``); rwkv:
    recurrent states; mamba: conv buffer + ssm state; hybrid: tuple per
    position-in-period.  On ``device``, ``'cuda'`` by default (raises on
    a host without a card)."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype_policy.cdt
    period = _stack_period(cfg)
    steps = cfg.n_layers // period

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    def one(kind):
        if kind == "attn":
            shape = (steps, batch, cfg.n_kv_heads, max_seq, cfg.hd)
            if cfg.cache_dtype == "int8":
                sshape = shape[:-1]
                return {
                    "k": zeros(shape, torch.int8),
                    "v": zeros(shape, torch.int8),
                    "k_s": zeros(sshape, torch.float32),
                    "v_s": zeros(sshape, torch.float32),
                }
            return {"k": zeros(shape, dtype), "v": zeros(shape, dtype)}
        if kind == "mamba":
            din = cfg.mamba.expand * cfg.d_model
            return {
                "conv": zeros((steps, batch, cfg.mamba.d_conv - 1, din), dtype),
                "h": zeros((steps, batch, din, cfg.mamba.d_state),
                           torch.float32),
            }
        if kind == "rwkv":
            hd = cfg.rwkv.head_dim
            nh = cfg.d_model // hd
            return {
                "x_tm": zeros((steps, batch, cfg.d_model), dtype),
                "x_cm": zeros((steps, batch, cfg.d_model), dtype),
                "wkv": zeros((steps, batch, nh, hd, hd), torch.float32),
            }
        raise ValueError(kind)

    if period == 1:
        return one(layer_kind(cfg, 0))
    return tuple(one(layer_kind(cfg, pos)) for pos in range(period))


def _decode_mixer(p, xtok, cfg, sh, cache_layer, pos, kind):
    """One-token mixer step.  xtok: (B, 1, D) normed input.  Returns the
    branch and the layer's new cache entries (attention caches updated in
    place)."""
    b = xtok.shape[0]
    if kind == "attn":
        h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = split_heads(matmul(xtok, p["attn"]["wq"]), h, hd)
        k = split_heads(matmul(xtok, p["attn"]["wk"]), kv, hd)
        v = split_heads(matmul(xtok, p["attn"]["wv"]), kv, hd)
        pp = torch.full((b, 1), pos, device=xtok.device)
        q = apply_rope(q, pp, theta=cfg.rope_theta)
        k = apply_rope(k, pp, theta=cfg.rope_theta)
        batch_axes = sh.dp_axes if b > 1 else None
        if cfg.cache_dtype == "int8":
            new_cache = att.cache_update_q(cache_layer, k, v, pos)
            if sh.use_sharded_decode:
                o = att.sharded_decode_attention_q(
                    q, new_cache, pos, mesh=sh.mesh,
                    seq_axes=sh.cache_seq_axes, batch_axes=batch_axes,
                    compute_dtype=cfg.dtype_policy.cdt)
            else:
                o = att.decode_attention_q(
                    q, new_cache, pos, compute_dtype=cfg.dtype_policy.cdt)
        else:
            kc, vc = att.cache_update(cache_layer["k"], cache_layer["v"],
                                      k, v, pos)
            if sh.use_sharded_decode:
                o = att.sharded_decode_attention(
                    q, kc, vc, pos, mesh=sh.mesh, seq_axes=sh.cache_seq_axes,
                    batch_axes=batch_axes)
            else:
                o = att.decode_attention(q, kc, vc, pos)
            new_cache = {"k": kc, "v": vc}
        out = matmul(o.reshape(b, 1, h * hd), p["attn"]["wo"])
        return out, new_cache
    if kind == "mamba":
        out, (conv, hstate) = ssm_mod.mamba_apply(
            p["mamba"], xtok, cfg.mamba,
            state=(cache_layer["conv"], cache_layer["h"]),
        )
        return out, {"conv": conv, "h": hstate}
    if kind == "rwkv":
        out, (x_tm, wkv) = ssm_mod.rwkv_time_mix(
            p["tmix"], xtok, cfg.rwkv,
            state=(cache_layer["x_tm"], cache_layer["wkv"]),
        )
        return out, {"x_tm": x_tm, "wkv": wkv}
    raise ValueError(kind)


def _decode_block(p, x, cfg, sh, cache_layer, pos, kind, mk):
    xin = rmsnorm(p["ln1"], x, eps=cfg.norm_eps)
    delta, new_cache = _decode_mixer(p, xin, cfg, sh, cache_layer, pos, kind)
    x = x + delta
    xin = rmsnorm(p["ln2"], x, eps=cfg.norm_eps)
    if cfg.family == "ssm":
        out, x_cm = ssm_mod.rwkv_channel_mix(
            p["cmix"], xin, state=cache_layer["x_cm"]
        )
        new_cache["x_cm"] = x_cm
        x = x + out
    elif mk == "moe":
        out, _ = moe_mod.moe_apply(
            p["moe"], xin, cfg.moe, activation=cfg.activation, dropless=True
        )
        x = x + out
    else:
        x = x + mlp_apply(p["mlp"], xin, activation=cfg.activation)
    return x, new_cache


def _write_layer(stacked: dict, step: int, old: dict, new: dict) -> None:
    """Write a layer's new cache entries into step ``step`` of the stacked
    cache; entries updated in place (``new[name] is old[name]``, the view
    into the stack) are there already."""
    for name, value in new.items():
        if value is not old.get(name):
            stacked[name][step].copy_(value)


@serving
def decode_step(
    params,
    cfg: ArchConfig,
    token,  # (B,)
    pos: int,  # index of this token
    cache,
    sh: Shardings = Shardings.none(),
):
    """One autoregressive step.  Returns (logits (B, V), cache), the cache
    updated in place.

    Layers run in the forward's order (scan step, then position in the
    period).  The reference's hybrid decode runs every step of one position
    before the next (``transformer.py:488-500``), which is the forward's
    order only at one step a period (ROADMAP.md, Faults)."""
    x = embed_lookup(params["embed"], token[:, None]).to(cfg.dtype_policy.cdt)
    period = _stack_period(cfg)
    n_steps = cfg.n_layers // period
    blocks = params["blocks"] if period > 1 else [params["blocks"]]
    caches = cache if period > 1 else (cache,)
    for step in range(n_steps):
        for p_pos in range(period):
            old = layer_at(caches[p_pos], step)
            x, new = _decode_block(
                layer_at(blocks[p_pos], step), x, cfg, sh, old, pos,
                layer_kind(cfg, p_pos), mlp_kind(cfg, p_pos),
            )
            _write_layer(caches[p_pos], step, old, new)

    x = rmsnorm(params["ln_f"], x, eps=cfg.norm_eps)
    logits = (
        unembed_logits(x, params["embed"])
        if cfg.tie_embeddings
        else matmul(x, params["unembed"])
    )
    return logits[:, 0, :], cache


@serving
def prefill(
    params,
    cfg: ArchConfig,
    tokens,
    sh: Shardings = Shardings.none(),
    *,
    extra_embeds=None,
):
    """Serving prefill: forward the prompt, unembed ONLY the last position,
    and collect per-layer KV (attention archs).  SSM/hybrid recurrent
    states are rebuilt by the serving loop through the decode step
    (:func:`repro_torch.launch.cells.greedy_generate`)."""
    logits, _, kvs = forward(
        params, cfg, tokens, sh, extra_embeds=extra_embeds,
        collect_kv=(cfg.family not in ("ssm",)), logits_mode="last",
    )
    return logits[:, 0, :], kvs
