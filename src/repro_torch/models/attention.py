"""Attention of the LM substrate (the counterpart of
``repro.models.attention``): GQA, chunked online-softmax attention, KV
caches for decode and the int8 cache.

Shapes: q (B, S, H, hd); k, v (B, S, KV, hd) with H % KV == 0 (GQA).
Softmax statistics are kept in float32 whatever the compute dtype, and the
products the reference accumulates in float32
(``preferred_element_type=jnp.float32``) are taken on operands cast to
float32 first.  No ``F.scaled_dot_product_attention``: the port computes
the reference's own formulation so that the two can be held together.

The decode caches are updated in place: :func:`cache_update` and
:func:`cache_update_q` write the new token into the tensors they are given
and return them (the reference returns new arrays).
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.layers import remat
from repro_torch.runtime import spmd

_NEG_INF = -1e30


def _heads_local(fn, q, k, v, kv_head_dim: int):
    """``fn(q, k, v)`` on DTensors, per rank on its batch rows and heads.

    The batch keeps ``q``'s sharding; the heads are sharded over the other
    mesh axes when they divide ``H``.  K/V heads are sharded with them when
    they divide ``KV``; otherwise each rank takes the K/V heads of its
    query heads from replicated K/V (GQA: a query head's group is whole on
    one rank), and their gradients are partial sums over the head axes.
    Where neither fits, the heads stay whole on every rank."""
    mesh = q.device_mesh
    bat = spmd.sharded_axes(q, 0)
    hax = tuple(a for a in mesh.mesh_dim_names if a not in bat)
    h, kvh = q.shape[2], k.shape[kv_head_dim]
    g = h // kvh
    n = spmd.axes_size(mesh, hax)
    h_loc = h // n
    if h % n or not (kvh % n == 0 or h_loc % g == 0 or g % h_loc == 0):
        hax, n, h_loc = (), 1, h
    kv_split = kvh % n == 0
    r = spmd.shard_index(mesh, hax)
    lo, hi = (r * h_loc) // g, ((r + 1) * h_loc - 1) // g + 1

    q_pl = spmd.placements_of(mesh, **{a: 0 for a in bat},
                              **{a: 2 for a in hax})
    kv_pl = spmd.placements_of(mesh, **{a: 0 for a in bat},
                               **{a: kv_head_dim for a in hax if kv_split})
    kv_grad = spmd.placements_of(
        mesh, **{a: 0 for a in bat},
        **{a: (kv_head_dim if kv_split else "P") for a in hax})

    def local(ql, kl, vl):
        if not kv_split:
            idx = [slice(None)] * kl.ndim
            idx[kv_head_dim] = slice(lo, hi)
            kl, vl = kl[tuple(idx)], vl[tuple(idx)]
        return fn(ql, kl, vl)

    return spmd.local_call(local, mesh, (q, k, v), (q_pl, kv_pl, kv_pl),
                           q_pl, (None, kv_grad, kv_grad))


def _expand_kv(k, n_rep: int):
    """(B, S, KV, hd) -> (B, S, KV*n_rep, hd) repeating each kv head."""
    if n_rep == 1:
        return k
    b, s, kv, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, n_rep, hd).reshape(
        b, s, kv * n_rep, hd)


def plain_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    """Reference attention (materialises the score matrix).  Oracle for the
    flash path and its fallback at ragged lengths."""
    if spmd.is_dtensor(q):
        return _heads_local(
            lambda a, b_, c: plain_attention(a, b_, c, causal=causal,
                                             q_offset=q_offset), q, k, v, 2)
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    k = _expand_kv(k, h // kv)
    v = _expand_kv(v, h // kv)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(hd)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        scores = torch.where(ki <= qi, scores, _NEG_INF)
    w = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), v)


def flash_attention(
    q,
    k,
    v,
    *,
    causal: bool,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    q_offset: int = 0,
):
    """Online-softmax attention over (q_chunk, kv_chunk) blocks: O(S * chunk)
    memory instead of O(S^2).  GQA is handled inside the products (q
    reshaped to (KV, group) heads), so the K/V blocks are never repeated.
    Lengths that the chunks do not divide fall back to
    :func:`plain_attention`, as in the reference.  On DTensors each rank
    runs the loop on its batch rows and heads (:func:`_heads_local`)."""
    if spmd.is_dtensor(q):
        return _heads_local(
            lambda a, b_, c: flash_attention(
                a, b_, c, causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
                q_offset=q_offset), q, k, v, 2)
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    g = h // kvh
    sk = k.shape[1]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, sk)
    if sq % q_chunk or sk % kv_chunk:
        return plain_attention(q, k, v, causal=causal, q_offset=q_offset)

    scale = 1.0 / math.sqrt(hd)
    nq = sq // q_chunk
    nk = sk // kv_chunk
    dev = q.device
    qb = q.reshape(b, nq, q_chunk, kvh, g, hd)
    # K and V in float32 once (the products accumulate in float32), and a
    # block's causal pattern: key index minus query index, held against
    # each block's offset (kpos <= qpos)
    kf = k.reshape(b, nk, kv_chunk, kvh, hd).float()
    vf = v.reshape(b, nk, kv_chunk, kvh, hd).float()
    rel = (torch.arange(kv_chunk, device=dev)[None]
           - torch.arange(q_chunk, device=dev)[:, None])

    def per_q_block(qi, qblk):
        qblk = qblk.float()
        m = torch.full((b, kvh, g, q_chunk), _NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, kvh, g, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, kvh, g, q_chunk, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            s = torch.einsum("bqkgd,bskd->bkgqs", qblk, kf[:, ki])
            s = s * scale
            if causal:
                offset = qi * q_chunk + q_offset - ki * kv_chunk
                s = torch.where(rel <= offset, s, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(v.dtype).float(), vf[:, ki])
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        return out.permute(0, 3, 1, 2, 4)  # (B, qc, KV, G, hd)

    # flash backward: each q block is recomputed, so autograd keeps no
    # (q, kv) block's float32 scores, as the reference's jax.checkpoint
    outs = [remat(per_q_block, qi, qb[:, qi]) for qi in range(nq)]
    return torch.cat(outs, dim=1).reshape(b, sq, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode (KV cache) paths
# ---------------------------------------------------------------------------


def decode_attention(q, k_cache, v_cache, pos):
    """Single-token decode against a (B, KV, S_max, hd) cache.  ``pos`` is the
    index of the *current* token (attends to cache[<= pos]).  On DTensors
    each rank attends with its batch rows and heads; a cache sharded along
    S takes :func:`sharded_decode_attention`."""
    if spmd.is_dtensor(k_cache):
        seq = spmd.sharded_axes(k_cache, 2)
        if seq:
            return sharded_decode_attention(
                q, k_cache, v_cache, pos, mesh=k_cache.device_mesh,
                seq_axes=seq, batch_axes=spmd.sharded_axes(k_cache, 0))
        return _heads_local(
            lambda a, b_, c: decode_attention(a, b_, c, pos), q, k_cache,
            v_cache, 1)
    b, kvh, smax, hd = k_cache.shape
    h = q.shape[2]
    g = h // kvh
    qg = q.reshape(b, q.shape[1], kvh, g, hd)
    s = torch.einsum("bqkgd,bksd->bkgqs", qg.float(), k_cache.float())
    s = s / math.sqrt(hd)
    mask = torch.arange(smax, device=q.device) <= pos
    s = torch.where(mask, s, _NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bqkgd", w.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(b, q.shape[1], h, hd).to(q.dtype)


def _seq_sharded_decode(q, caches, pos, *, mesh, seq_axes, batch_axes,
                        dequant):
    """Flash-decoding over caches whose S axis is sharded over
    ``seq_axes``: each rank scores its slice of S (the global key index is
    its shard index, flattened over ``seq_axes`` in their order, times the
    slice's length plus the local index) and keeps partial statistics,
    merged by an all-reduce MAX of the maxima and all-reduce SUMs of the
    exponentials' sums and the weighted values (the reference's
    ``pmax``/``psum``).  Only those (B, H, hd)-sized partials move: the
    cache is never gathered.  ``dequant(local caches)`` gives the local
    K and V."""
    seq_axes, batch_axes = tuple(seq_axes), tuple(batch_axes or ())
    b, h, hd = q.shape[0], q.shape[2], q.shape[3]
    kvh, smax = caches[0].shape[1], caches[0].shape[2]
    s_loc = smax // spmd.axes_size(mesh, seq_axes)
    start = spmd.shard_index(mesh, seq_axes) * s_loc
    g = h // kvh
    bdims = {a: 0 for a in batch_axes}
    q_pl = spmd.placements_of(mesh, **bdims)
    c_pl = [spmd.placements_of(mesh, **bdims, **{a: 2 for a in seq_axes})
            for _ in caches]
    part = {a: "P" for a in seq_axes}

    def scores(ql, *cl):
        k, _ = dequant(*cl)
        qg = ql.reshape(ql.shape[0], ql.shape[1], kvh, g, hd)
        s = torch.einsum("bqkgd,bksd->bkgqs", qg.float(), k.float())
        s = s / math.sqrt(hd)
        gk = start + torch.arange(s_loc, device=s.device)
        return torch.where(gk <= pos, s, _NEG_INF)

    m = spmd.local_call(
        lambda ql, *cl: scores(ql, *cl).amax(dim=-1), mesh, (q, *caches),
        (q_pl, *c_pl), spmd.placements_of(
            mesh, **bdims, **{a: "P:max" for a in seq_axes}))
    m = m.redistribute(mesh, q_pl)

    def partials(ql, ml, *cl):
        _, v = dequant(*cl)
        p = torch.exp(scores(ql, *cl) - ml[..., None])
        o = torch.einsum("bkgqs,bksd->bkgqd", p.to(v.dtype).float(),
                         v.float())
        return p.sum(dim=-1), o

    out_pl = spmd.placements_of(mesh, **bdims, **part)
    l, o = spmd.local_call(partials, mesh, (q, m, *caches),
                           (q_pl, q_pl, *c_pl), (out_pl, out_pl))
    l, o = l.redistribute(mesh, q_pl), o.redistribute(mesh, q_pl)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    # (B, KV, G, 1, hd) -> (B, 1, H, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(b, q.shape[1], h, hd).to(
        q.dtype)


def sharded_decode_attention(q, k_cache, v_cache, pos, *, mesh, seq_axes,
                             batch_axes=None):
    """Flash-decoding over a *sequence-sharded* KV cache (DTensors of
    layout (B, KV, S_max, hd), S sharded over ``seq_axes``, B over
    ``batch_axes``); see :func:`_seq_sharded_decode`.

    q: (B, 1, H, hd) with B possibly sharded over ``batch_axes``."""
    return _seq_sharded_decode(
        q, (k_cache, v_cache), pos, mesh=mesh, seq_axes=seq_axes,
        batch_axes=batch_axes, dequant=lambda k, v: (k, v))


def _write_token(cache, new, pos):
    """``cache[:, :, pos] = new``, in place; on a DTensor cache only the
    rank whose slice of S holds ``pos`` writes, into its local shard (the
    rows of its batch shard), and nothing moves between ranks."""
    if not spmd.is_dtensor(cache):
        cache[:, :, pos] = new.to(cache.dtype)
        return
    mesh = cache.device_mesh
    seq, bat = spmd.sharded_axes(cache, 2), spmd.sharded_axes(cache, 0)
    s_loc = cache.shape[2] // spmd.axes_size(mesh, seq)
    start = spmd.shard_index(mesh, seq) * s_loc
    if spmd.is_dtensor(new):
        new = new.redistribute(
            mesh, spmd.placements_of(mesh, **{a: 0 for a in bat}))
    local_new = new.to_local() if spmd.is_dtensor(new) else new
    if start <= pos < start + s_loc:
        cache.to_local()[:, :, pos - start] = local_new.to(cache.dtype)


def cache_update(k_cache, v_cache, k_new, v_new, pos):
    """Insert the new token's K/V at ``pos``, in place.  Cache layout
    (B, KV, S, hd); new values arrive as (B, 1, KV, hd) from the
    projection.  Returns the caches."""
    _write_token(k_cache, k_new[:, 0], pos)
    _write_token(v_cache, v_new[:, 0], pos)
    return k_cache, v_cache


# ---------------------------------------------------------------------------
# int8-quantised KV cache (per-token-per-head absmax scales), dequantised
# inside the decode attention.
# ---------------------------------------------------------------------------


def quantize_kv(x):
    """(B, S, KV, hd) -> (int8 values (B, KV, S, hd), f32 scales (B, KV, S)).
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    xt = x.transpose(1, 2).float()
    scale = torch.amax(torch.abs(xt), dim=-1) / 127.0  # (B, KV, S)
    q = torch.round(xt / torch.clamp(scale[..., None], min=1e-10))
    return q.to(torch.int8), scale


def cache_update_q(cache, k_new, v_new, pos):
    """Quantised-cache insert, in place.  cache: dict(k, v int8
    (B, KV, S, hd); k_s, v_s f32 (B, KV, S)).  Returns a new dict of the
    same tensors."""
    if spmd.is_dtensor(k_new):  # the (B, 1, KV, hd) token, whole a rank
        bat = spmd.sharded_axes(cache["k"], 0)
        rows = spmd.placements_of(k_new.device_mesh, **{a: 0 for a in bat})
        k_new = k_new.redistribute(k_new.device_mesh, rows).to_local()
        v_new = v_new.redistribute(v_new.device_mesh, rows).to_local()
    kq, ks = quantize_kv(k_new)
    vq, vs = quantize_kv(v_new)
    _write_token(cache["k"], kq[:, :, 0], pos)
    _write_token(cache["v"], vq[:, :, 0], pos)
    _write_token(cache["k_s"], ks[:, :, 0], pos)
    _write_token(cache["v_s"], vs[:, :, 0], pos)
    return dict(cache)


def _dequant(q, s, dtype):
    return (q.float() * s[..., None]).to(dtype)


def decode_attention_q(q, cache, pos, compute_dtype=torch.bfloat16):
    """decode_attention over an int8-quantised cache (dequant on the fly;
    on DTensors each rank dequantises its own shard)."""
    if spmd.is_dtensor(cache["k"]):
        return sharded_decode_attention_q(
            q, cache, pos, mesh=cache["k"].device_mesh,
            seq_axes=spmd.sharded_axes(cache["k"], 2),
            batch_axes=spmd.sharded_axes(cache["k"], 0),
            compute_dtype=compute_dtype)
    k = _dequant(cache["k"], cache["k_s"], compute_dtype)
    v = _dequant(cache["v"], cache["v_s"], compute_dtype)
    return decode_attention(q, k, v, pos)


def sharded_decode_attention_q(q, cache, pos, *, mesh, seq_axes,
                               batch_axes=None, compute_dtype=torch.bfloat16):
    """Flash-decode over the sequence-sharded int8 cache: each shard
    dequantises only its local slice (the whole cache is never resident in
    ``compute_dtype``)."""
    return _seq_sharded_decode(
        q, (cache["k"], cache["k_s"], cache["v"], cache["v_s"]), pos,
        mesh=mesh, seq_axes=seq_axes, batch_axes=batch_axes,
        dequant=lambda kq, ks, vq, vs: (_dequant(kq, ks, compute_dtype),
                                        _dequant(vq, vs, compute_dtype)))
