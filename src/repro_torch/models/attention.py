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

_NEG_INF = -1e30

_SHARDED = ("sharded decode over a sequence-sharded cache needs a mesh of "
            "more than one card (ROADMAP.md, Open items: LM sharding)")


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
    :func:`plain_attention`, as in the reference."""
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
    index of the *current* token (attends to cache[<= pos])."""
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


def sharded_decode_attention(q, k_cache, v_cache, pos, *, mesh, seq_axes,
                             batch_axes=None):
    """Flash-decoding over a sequence-sharded cache: refused until the port
    has the mesh it needs."""
    raise NotImplementedError(_SHARDED)


def cache_update(k_cache, v_cache, k_new, v_new, pos):
    """Insert the new token's K/V at ``pos``, in place.  Cache layout
    (B, KV, S, hd); new values arrive as (B, 1, KV, hd) from the
    projection.  Returns the caches."""
    k_cache[:, :, pos] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, :, pos] = v_new[:, 0].to(v_cache.dtype)
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
    kq, ks = quantize_kv(k_new)
    vq, vs = quantize_kv(v_new)
    cache["k"][:, :, pos] = kq[:, :, 0]
    cache["v"][:, :, pos] = vq[:, :, 0]
    cache["k_s"][:, :, pos] = ks[:, :, 0]
    cache["v_s"][:, :, pos] = vs[:, :, 0]
    return dict(cache)


def _dequant(q, s, dtype):
    return (q.float() * s[..., None]).to(dtype)


def decode_attention_q(q, cache, pos, compute_dtype=torch.bfloat16):
    """decode_attention over an int8-quantised cache (dequant on the fly)."""
    k = _dequant(cache["k"], cache["k_s"], compute_dtype)
    v = _dequant(cache["v"], cache["v_s"], compute_dtype)
    return decode_attention(q, k, v, pos)


def sharded_decode_attention_q(q, cache, pos, *, mesh, seq_axes,
                               batch_axes=None, compute_dtype=torch.bfloat16):
    """Flash-decode over the sequence-sharded int8 cache: refused until the
    port has the mesh it needs."""
    raise NotImplementedError(_SHARDED)
