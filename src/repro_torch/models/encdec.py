"""Encoder-decoder transformer, the whisper-base backbone (the counterpart
of ``repro.models.encdec``).

The conv frontend is a stub: the encoder consumes precomputed frame
embeddings (B, enc_seq, d_model) directly.  Pre-norm LayerNorm blocks, GELU
MLP, sinusoidal encoder positions, learned decoder positions,
cross-attention in every decoder layer, tied unembedding.
"""

from __future__ import annotations

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import attention as att
from repro_torch.models.layers import (
    ParamRNG,
    dense_init,
    embed_init,
    embed_lookup,
    layernorm,
    layernorm_init,
    mlp_apply,
    mlp_init,
    sinusoidal_positions,
    softmax_cross_entropy,
    stack_trees,
)
from repro_torch.models.transformer import layer_at
from repro_torch.runtime.sharding import Shardings
from repro_torch.util import resolve_device

_MAX_DEC_POS = 32768  # learned decoder positions (the 32k decode cache)


def _attn_init(rng: ParamRNG, cfg, dtype):
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    return {
        "wq": dense_init(rng, d, h * hd, dtype),
        "wk": dense_init(rng, d, cfg.n_kv_heads * hd, dtype),
        "wv": dense_init(rng, d, cfg.n_kv_heads * hd, dtype),
        "wo": dense_init(rng, h * hd, d, dtype),
    }


def _enc_layer_init(rng: ParamRNG, cfg, dtype):
    return {
        "ln1": layernorm_init(rng, cfg.d_model, dtype),
        "attn": _attn_init(rng, cfg, dtype),
        "ln2": layernorm_init(rng, cfg.d_model, dtype),
        "mlp": mlp_init(rng, cfg.d_model, cfg.d_ff, dtype,
                        gated=cfg.gated_mlp),
    }


def _dec_layer_init(rng: ParamRNG, cfg, dtype):
    return {
        "ln1": layernorm_init(rng, cfg.d_model, dtype),
        "attn": _attn_init(rng, cfg, dtype),
        "ln_x": layernorm_init(rng, cfg.d_model, dtype),
        "xattn": _attn_init(rng, cfg, dtype),
        "ln2": layernorm_init(rng, cfg.d_model, dtype),
        "mlp": mlp_init(rng, cfg.d_model, cfg.d_ff, dtype,
                        gated=cfg.gated_mlp),
    }


def init_params(rng: ParamRNG, cfg: ArchConfig):
    dtype = cfg.dtype_policy.pdt
    enc = [_enc_layer_init(rng, cfg, dtype) for _ in range(cfg.enc_layers)]
    dec = [_dec_layer_init(rng, cfg, dtype) for _ in range(cfg.n_layers)]
    return {
        "embed": embed_init(rng, cfg.vocab, cfg.d_model, dtype),
        "pos_embed": rng.trunc_normal((_MAX_DEC_POS, cfg.d_model), 0.01,
                                      dtype),
        "enc_blocks": stack_trees(enc),
        "dec_blocks": stack_trees(dec),
        "ln_enc": layernorm_init(rng, cfg.d_model, dtype),
        "ln_f": layernorm_init(rng, cfg.d_model, dtype),
    }


def _mha(p, xq, xkv, cfg, *, causal, q_offset=0):
    b, sq, d = xq.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = (xq @ p["wq"]).reshape(b, sq, h, hd)
    k = (xkv @ p["wk"]).reshape(b, xkv.shape[1], kv, hd)
    v = (xkv @ p["wv"]).reshape(b, xkv.shape[1], kv, hd)
    o = att.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    return o.reshape(b, sq, h * hd) @ p["wo"]


@torch.inference_mode()
def encode(params, cfg: ArchConfig, frames, sh: Shardings = Shardings.none()):
    """frames: (B, enc_seq, d_model) stub embeddings."""
    x = frames.to(cfg.dtype_policy.cdt)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 device=x.device)[None].to(x.dtype)
    x = sh.act_btd(x)
    for i in range(cfg.enc_layers):
        lp = layer_at(params["enc_blocks"], i)
        xn = layernorm(lp["ln1"], x)
        x = sh.act_btd(x + _mha(lp["attn"], xn, xn, cfg, causal=False))
        m = mlp_apply(lp["mlp"], layernorm(lp["ln2"], x),
                      activation=cfg.activation)
        x = sh.act_btd(x + m)
    return layernorm(params["ln_enc"], x)


def decode_train(params, cfg: ArchConfig, enc_out, tokens,
                 sh: Shardings = Shardings.none()):
    """Teacher-forced decoder over ``tokens``: (B, S, V) logits."""
    x = embed_lookup(params["embed"], tokens).to(cfg.dtype_policy.cdt)
    s = tokens.shape[1]
    x = x + params["pos_embed"][:s][None].to(x.dtype)
    x = sh.act_btd(x)
    for i in range(cfg.n_layers):
        lp = layer_at(params["dec_blocks"], i)
        xn = layernorm(lp["ln1"], x)
        x = sh.act_btd(x + _mha(lp["attn"], xn, xn, cfg, causal=True))
        c = _mha(lp["xattn"], layernorm(lp["ln_x"], x), enc_out, cfg,
                 causal=False)
        x = sh.act_btd(x + c)
        m = mlp_apply(lp["mlp"], layernorm(lp["ln2"], x),
                      activation=cfg.activation)
        x = sh.act_btd(x + m)
    x = layernorm(params["ln_f"], x)
    return torch.einsum("bsd,vd->bsv", x, params["embed"])  # tied unembed


def loss_fn(params, cfg, frames, tokens, labels, sh=Shardings.none(), *,
            z_loss=1e-4):
    enc_out = encode(params, cfg, frames, sh)
    logits = decode_train(params, cfg, enc_out, tokens, sh)
    return softmax_cross_entropy(logits, labels, z_loss=z_loss).mean()


# -- serving ------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int, dtype=None, *,
               device="cuda"):
    """Self-attention K/V caches and empty cross K/V, on ``device``
    (``'cuda'`` by default, which raises on a host without a card)."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype_policy.cdt
    L = cfg.n_layers
    kvh, hd = cfg.n_kv_heads, cfg.hd

    def zeros(s):
        return torch.zeros((L, batch, kvh, s, hd), dtype=dtype, device=device)

    # cross-attention K/V are filled once from enc_out (prefill_cross)
    return {"k": zeros(max_seq), "v": zeros(max_seq),
            "xk": zeros(cfg.enc_seq), "xv": zeros(cfg.enc_seq)}


@torch.inference_mode()
def prefill_cross(params, cfg, enc_out):
    """Cross-attention K/V of every decoder layer: (L, B, KV, T, hd) each."""
    b, t, _ = enc_out.shape
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer_at(params["dec_blocks"], i)["xattn"]
        k = (enc_out @ lp["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.hd)
        v = (enc_out @ lp["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.hd)
        ks.append(k.transpose(1, 2))
        vs.append(v.transpose(1, 2))
    return torch.stack(ks), torch.stack(vs)


@torch.inference_mode()
def decode_step(params, cfg: ArchConfig, token, pos: int, cache,
                sh: Shardings = Shardings.none()):
    """Single decoder token step against the self-attention cache (updated
    in place) and the precomputed cross K/V.  Returns (logits (B, V),
    cache)."""
    b = token.shape[0]
    x = embed_lookup(params["embed"], token[:, None]).to(cfg.dtype_policy.cdt)
    x = x + params["pos_embed"][pos: pos + 1][None].to(x.dtype)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if sh.use_sharded_decode:
        raise NotImplementedError(att._SHARDED)
    for i in range(cfg.n_layers):
        lp = layer_at(params["dec_blocks"], i)
        xk, xv = cache["xk"][i], cache["xv"][i]
        xin = layernorm(lp["ln1"], x)
        q = (xin @ lp["attn"]["wq"]).reshape(b, 1, h, hd)
        k = (xin @ lp["attn"]["wk"]).reshape(b, 1, kvh, hd)
        v = (xin @ lp["attn"]["wv"]).reshape(b, 1, kvh, hd)
        kc, vc = att.cache_update(cache["k"][i], cache["v"][i], k, v, pos)
        o = att.decode_attention(q, kc, vc, pos)
        x = x + o.reshape(b, 1, h * hd) @ lp["attn"]["wo"]
        # cross attention against the precomputed encoder KV
        xin = layernorm(lp["ln_x"], x)
        qx = (xin @ lp["xattn"]["wq"]).reshape(b, 1, h, hd)
        ox = att.decode_attention(qx, xk, xv, xk.shape[2] - 1)
        x = x + ox.reshape(b, 1, h * hd) @ lp["xattn"]["wo"]
        x = x + mlp_apply(lp["mlp"], layernorm(lp["ln2"], x),
                          activation=cfg.activation)
    x = layernorm(params["ln_f"], x)
    logits = torch.einsum("bsd,vd->bsv", x, params["embed"])[:, 0, :]
    return logits, cache
