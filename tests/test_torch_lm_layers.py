"""The LM substrate's layers in the port against the reference, module by
module, in float32 on the CPU: norms, rope, MLPs, embeddings and CE
(``models/layers.py``), attention and the KV caches, the int8 cache
(``models/attention.py``), MoE dispatch (``models/moe.py``), RWKV6 and
Mamba (``models/ssm.py``) and the single-device ``Shardings``.

Inputs are made from a seed with numpy; reference parameters come from the
reference's own init functions and cross as numpy.  Tolerances are
``tests/_torch_lm_common.py``'s, each scale with its reason there."""

from __future__ import annotations

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_common import (
    LAYER, RECURRENT, assert_close, assert_trees_close, jitted, to_np,
    tree_torch,
)
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models import ssm as RS
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS
from repro_torch.runtime.sharding import Shardings

ROOT = Path(__file__).resolve().parents[1]


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _ref_tree(tree):
    return jax.device_get(tree)


# -- layers -------------------------------------------------------------------


def test_param_rng_draws_on_its_device():
    """A seed makes a generator on the device; a caller's generator must
    live on the device the parameters are made on; 'meta' makes shapes."""
    a = TL.ParamRNG(3, "cpu").trunc_normal((4, 5), 0.5, torch.float32)
    b = TL.ParamRNG(torch.Generator().manual_seed(3), "cpu").trunc_normal(
        (4, 5), 0.5, torch.float32)
    assert torch.equal(a, b) and float(a.abs().max()) <= 1.0
    m = TL.ParamRNG(0, "meta").trunc_normal((4, 5), 0.5, torch.bfloat16)
    assert m.is_meta and m.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="cannot make parameters on meta"):
        TL.ParamRNG(torch.Generator(), "meta")


def test_dtype_policy_gives_torch_dtypes():
    p = TL.DTypePolicy()
    assert (p.pdt, p.cdt) == (torch.bfloat16, torch.bfloat16)
    p = TL.DTypePolicy("float32", "float32", "float32")
    assert (p.pdt, p.cdt, p.norm) == (torch.float32, torch.float32, "float32")
    assert RL.DTypePolicy() == RL.DTypePolicy(*(getattr(TL.DTypePolicy(), f)
                                                for f in ("params", "compute",
                                                          "norm")))


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_norms_match_reference(norm, eps):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 64, scale=3.0)
    p = {"scale": _rand(rng, 64) + 1.0, "bias": _rand(rng, 64)}
    if norm == "rmsnorm":
        p.pop("bias")
    ref = getattr(RL, norm)({k: jnp.asarray(v) for k, v in p.items()},
                            jnp.asarray(x), eps=eps)
    got = getattr(TL, norm)(tree_torch(p), torch.as_tensor(x), eps=eps)
    assert got.dtype == torch.float32
    assert_close(got, ref, LAYER, norm)


@pytest.mark.parametrize("theta", [1e4, 5e6])
def test_apply_rope_matches_reference(theta):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 4, 16)
    pos = np.arange(7)[None, :] + 3
    ref = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=theta)
    got = TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta=theta)
    assert_close(got, ref, LAYER)


def test_sinusoidal_positions_match_reference():
    ref = RL.sinusoidal_positions(40, 64)
    got = TL.sinusoidal_positions(40, 64)
    assert got.shape == (40, 64)
    assert_close(got, ref, LAYER)


@pytest.mark.parametrize("activation,gated", [
    ("silu", True), ("gelu", False), ("gelu", True), ("relu2", False),
    ("relu", False)])
def test_mlp_apply_matches_reference(activation, gated):
    p = RL.mlp_init(jax.random.PRNGKey(3), 32, 48, jnp.float32, gated=gated)
    x = _rand(np.random.default_rng(2), 3, 5, 32)
    ref = jitted(RL.mlp_apply, activation=activation)(p, jnp.asarray(x))
    got = TL.mlp_apply(tree_torch(_ref_tree(p)), torch.as_tensor(x),
                       activation=activation)
    assert_close(got, ref, LAYER, activation)
    with pytest.raises(ValueError, match="unknown activation"):
        TL.mlp_apply(tree_torch(_ref_tree(p)), torch.as_tensor(x),
                     activation="tanh")


def test_embed_lookup_and_unembed_match_reference():
    rng = np.random.default_rng(4)
    table = _rand(rng, 50, 16)
    toks = rng.integers(0, 50, (3, 9)).astype(np.int32)
    ref = RL.embed_lookup(jnp.asarray(table), jnp.asarray(toks))
    got = TL.embed_lookup(torch.as_tensor(table), torch.as_tensor(toks))
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    x = _rand(rng, 3, 9, 16)
    assert_close(TL.unembed_logits(torch.as_tensor(x), torch.as_tensor(table)),
                 RL.unembed_logits(jnp.asarray(x), jnp.asarray(table)), LAYER)


@pytest.mark.parametrize("seq", [8, 16])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_matches_reference(seq, z_loss):
    """Per-token CE, and the chunked mean (chunk 8: one path per seq
    divisibility, since 8 divides both; seq 12 takes the direct path)."""
    rng = np.random.default_rng(5)
    hidden = _rand(rng, 2, seq, 16)
    table = _rand(rng, 16, 40)
    labels = rng.integers(0, 40, (2, seq)).astype(np.int64)
    logits = hidden @ table
    assert_close(TL.softmax_cross_entropy(torch.as_tensor(logits),
                                          torch.as_tensor(labels),
                                          z_loss=z_loss),
                 RL.softmax_cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(labels), z_loss=z_loss),
                 LAYER)
    for s, chunk in ((seq, 8), (12, 8)):
        for transpose in (False, True):
            tab = table.T.copy() if transpose else table
            ref = jitted(RL.chunked_softmax_cross_entropy, z_loss=z_loss,
                         chunk=chunk, transpose_table=transpose)(
                jnp.asarray(hidden[:, :s]), jnp.asarray(tab),
                jnp.asarray(labels[:, :s]))
            got = TL.chunked_softmax_cross_entropy(
                torch.as_tensor(hidden[:, :s]), torch.as_tensor(tab),
                torch.as_tensor(labels[:, :s]), z_loss=z_loss, chunk=chunk,
                transpose_table=transpose)
            ref_mean = ref.mean() if ref.ndim else ref
            got_mean = got.mean() if got.ndim else got
            assert_close(got_mean, ref_mean, LAYER, f"s={s} t={transpose}")


# -- attention ------------------------------------------------------------------


def _qkv(rng, b, sq, sk, h, kv, hd):
    return (_rand(rng, b, sq, h, hd), _rand(rng, b, sk, kv, hd),
            _rand(rng, b, sk, kv, hd))


@pytest.mark.parametrize("causal", [True, False])
def test_plain_attention_matches_reference(causal):
    q, k, v = _qkv(np.random.default_rng(6), 2, 9, 9, 4, 2, 8)
    ref = RA.plain_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                             q_offset=2)
    got = TA.plain_attention(*map(torch.as_tensor, (q, k, v)), causal=causal,
                             q_offset=2)
    assert_close(got, ref, LAYER)


@pytest.mark.parametrize("sq,sk,qc,kc,causal,off", [
    (16, 16, 4, 8, True, 0),  # divisible: 4 x 2 blocks
    (16, 16, 4, 8, False, 0),
    (8, 16, 4, 4, True, 8),  # q_offset: the queries sit after the keys
    (15, 15, 4, 8, True, 0),  # ragged: falls back to plain attention
    (16, 13, 4, 8, False, 0),  # ragged keys
])
def test_flash_attention_matches_reference_and_plain(sq, sk, qc, kc, causal,
                                                     off):
    q, k, v = _qkv(np.random.default_rng(7), 2, sq, sk, 4, 2, 8)
    kw = dict(causal=causal, q_chunk=qc, kv_chunk=kc, q_offset=off)
    ref = jitted(RA.flash_attention, **kw)(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    got = TA.flash_attention(tq, tk, tv, **kw)
    assert got.shape == (2, sq, 4, 8)
    assert_close(got, ref, LAYER, "flash vs reference flash")
    plain = TA.plain_attention(tq, tk, tv, causal=causal, q_offset=off)
    assert_close(got, plain, LAYER, "flash vs plain")


def test_flash_attention_keeps_float32_statistics_in_bf16():
    """bf16 operands: the blocks are upcast before both products, so the
    result stays within bf16 rounding of the float32 computation."""
    q, k, v = _qkv(np.random.default_rng(8), 1, 16, 16, 4, 2, 16)
    f32 = TA.flash_attention(*map(torch.as_tensor, (q, k, v)), causal=True,
                             q_chunk=8, kv_chunk=8)
    bf = TA.flash_attention(*(torch.as_tensor(a).bfloat16()
                              for a in (q, k, v)),
                            causal=True, q_chunk=8, kv_chunk=8)
    assert bf.dtype == torch.bfloat16
    assert_close(bf.float(), f32, dict(rtol=2e-2, atol=2e-2))


@pytest.mark.parametrize("pos", [0, 5, 11])
def test_decode_attention_and_cache_update_match_reference(pos):
    rng = np.random.default_rng(9)
    b, kvh, smax, hd, h = 2, 2, 12, 8, 4
    kc, vc = _rand(rng, b, kvh, smax, hd), _rand(rng, b, kvh, smax, hd)
    q, kn, vn = _rand(rng, b, 1, h, hd), _rand(rng, b, 1, kvh, hd), \
        _rand(rng, b, 1, kvh, hd)
    rk, rv = RA.cache_update(*map(jnp.asarray, (kc, vc, kn, vn)), pos)
    tk, tv = TA.cache_update(*map(torch.as_tensor, (kc, vc, kn, vn)), pos)
    np.testing.assert_array_equal(to_np(tk), np.asarray(rk))
    np.testing.assert_array_equal(to_np(tv), np.asarray(rv))
    ref = RA.decode_attention(jnp.asarray(q), rk, rv, pos)
    got = TA.decode_attention(torch.as_tensor(q), tk, tv, pos)
    assert_close(got, ref, LAYER)


def test_int8_cache_round_trip_matches_reference():
    """quantize_kv gives the reference's int8 values (round half to even in
    both) and scales; cache_update_q, _dequant and decode_attention_q
    follow."""
    rng = np.random.default_rng(10)
    b, kvh, smax, hd, h = 2, 2, 6, 8, 4
    x = _rand(rng, b, 1, kvh, hd, scale=2.0)
    x[0, 0, 0, :4] = [127.0, 63.5, -0.5, 1.5]  # exact halves after scaling
    rq, rs = RA.quantize_kv(jnp.asarray(x))
    tq, ts = TA.quantize_kv(torch.as_tensor(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(to_np(tq), np.asarray(rq))
    np.testing.assert_array_equal(to_np(ts), np.asarray(rs))
    cache = {"k": np.zeros((b, kvh, smax, hd), np.int8),
             "v": np.zeros((b, kvh, smax, hd), np.int8),
             "k_s": np.zeros((b, kvh, smax), np.float32),
             "v_s": np.zeros((b, kvh, smax), np.float32)}
    rc = {k: jnp.asarray(v) for k, v in cache.items()}
    tc = tree_torch(cache)
    for pos in range(smax):
        kn, vn = _rand(rng, b, 1, kvh, hd), _rand(rng, b, 1, kvh, hd)
        rc = RA.cache_update_q(rc, jnp.asarray(kn), jnp.asarray(vn), pos)
        tc = TA.cache_update_q(tc, torch.as_tensor(kn), torch.as_tensor(vn),
                               pos)
    for name in cache:
        np.testing.assert_array_equal(to_np(tc[name]), np.asarray(rc[name]))
    assert_close(TA._dequant(tc["k"], tc["k_s"], torch.float32),
                 RA._dequant(rc["k"], rc["k_s"], jnp.float32), LAYER)
    q = _rand(rng, b, 1, h, hd)
    ref = RA.decode_attention_q(jnp.asarray(q), rc, 3,
                                compute_dtype=jnp.float32)
    got = TA.decode_attention_q(torch.as_tensor(q), tc, 3,
                                compute_dtype=torch.float32)
    assert_close(got, ref, LAYER)


# -- MoE --------------------------------------------------------------------------


def test_top_k_orders_ties_as_lax_top_k():
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    rv, ri = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = TM._top_k(torch.as_tensor(probs), 2)
    np.testing.assert_array_equal(to_np(ti), np.asarray(ri))
    np.testing.assert_array_equal(to_np(tv), np.asarray(rv))


@pytest.mark.parametrize("mode", ["ungrouped", "grouped", "dropless"])
def test_moe_apply_matches_reference(mode):
    """GShard grouping (t > group_tokens and t % group == 0: 32 tokens in
    groups of 8, capacity per group), the ungrouped dispatch with drops
    (capacity_factor 1.0), and dropless (capacity T)."""
    cfg = RM.MoEConfig(num_experts=4, top_k=2, capacity_factor=1.0,
                       group_tokens=8 if mode == "grouped" else 8192)
    tcfg = TM.MoEConfig(**{f: getattr(cfg, f) for f in
                           cfg.__dataclass_fields__})
    p = _ref_tree(RM.moe_init(jax.random.PRNGKey(1), 32, 64, cfg,
                              jnp.float32, gated=True))
    x = _rand(np.random.default_rng(11), 2, 16, 32)
    dropless = mode == "dropless"
    ref, raux = jitted(RM.moe_apply, cfg=cfg, activation="silu",
                       dropless=dropless)(p, jnp.asarray(x))
    got, taux = TM.moe_apply(tree_torch(p), torch.as_tensor(x), tcfg,
                             activation="silu", dropless=dropless)
    assert_close(got, ref, RECURRENT, mode)
    assert_close(taux, raux, RECURRENT, mode)


def test_moe_aux_loss_and_balance():
    """The port's counterpart of the reference's test (value only): aux > 0,
    dropless equals a huge capacity, and both match the reference."""
    cfg = TM.MoEConfig(num_experts=4, top_k=2)
    rp = _ref_tree(RM.moe_init(jax.random.PRNGKey(0), 32, 64,
                               RM.MoEConfig(num_experts=4, top_k=2),
                               jnp.float32, gated=True))
    params = tree_torch(rp)
    x = _rand(np.random.default_rng(0), 2, 16, 32)
    out, aux = TM.moe_apply(params, torch.as_tensor(x), cfg,
                            activation="silu")
    assert out.shape == x.shape
    assert float(aux) > 0
    _, raux = RM.moe_apply(rp, jnp.asarray(x), RM.MoEConfig(num_experts=4,
                                                             top_k=2),
                           activation="silu")
    assert_close(aux, raux, RECURRENT)
    out2, _ = TM.moe_apply(params, torch.as_tensor(x), cfg,
                           activation="silu", dropless=True)
    out3, _ = TM.moe_apply(params, torch.as_tensor(x),
                           TM.MoEConfig(num_experts=4, top_k=2,
                                        capacity_factor=64.0),
                           activation="silu")
    assert_close(out2, out3, dict(rtol=0, atol=1e-6))


# -- RWKV6 and Mamba ------------------------------------------------------------------


def _rwkv_params(seed=2, d=64, hd=16):
    cfg = RS.RWKVConfig(head_dim=hd, lora_mix=8, lora_decay=8)
    p = _ref_tree(RS.rwkv_time_mix_init(jax.random.PRNGKey(seed), d, cfg,
                                        jnp.float32))
    # the init leaves mu, lora_b, decay_b and bonus at zero: give them
    # values so that every term of the mix and the decay is exercised
    rng = np.random.default_rng(seed)
    for name in ("mu_x", "mu", "lora_b", "decay_b", "bonus"):
        p[name] = _rand(rng, *p[name].shape, scale=0.3)
    p["decay_base"] = p["decay_base"] + _rand(rng, d, scale=1.0) + 4.0
    return cfg, TS.RWKVConfig(head_dim=hd, lora_mix=8, lora_decay=8), p


@pytest.mark.parametrize("s", [31, 32, 64, 65])
def test_rwkv_time_mix_matches_reference(s):
    """s = 31, 32 and 65 take the per-step recurrence, s = 64 the chunked
    WKV (s % 32 == 0 and s > 32)."""
    rcfg, tcfg, p = _rwkv_params()
    x = _rand(np.random.default_rng(12), 2, s, 64, scale=0.5)
    ref, (rx, rS) = jitted(RS.rwkv_time_mix, cfg=rcfg)(p, jnp.asarray(x))
    got, (tx, tS) = TS.rwkv_time_mix(tree_torch(p), torch.as_tensor(x), tcfg)
    assert tS.dtype == torch.float32
    assert_close(got, ref, RECURRENT, "out")
    assert_close(tx, rx, RECURRENT, "x_prev")
    assert_close(tS, rS, RECURRENT, "wkv state")


def test_rwkv_chunked_wkv_equals_the_recurrence():
    """The chunked WKV (64 steps) against the port's own per-step scan."""
    rcfg, tcfg, p = _rwkv_params(seed=5)
    x = torch.as_tensor(_rand(np.random.default_rng(13), 1, 64, 64,
                              scale=0.5))
    tp = tree_torch(p)
    chunked, (_, s_chunked) = TS.rwkv_time_mix(tp, x, tcfg)
    half, state = TS.rwkv_time_mix(tp, x[:, :31], tcfg)
    rest, (_, s_steps) = TS.rwkv_time_mix(tp, x[:, 31:], tcfg, state=state)
    assert_close(torch.cat([half, rest], 1), chunked, RECURRENT)
    assert_close(s_steps, s_chunked, RECURRENT)


def test_rwkv_state_carrying_decode_matches_reference():
    """A 32-step prefix, then token-by-token decode carrying (x_prev, S)."""
    rcfg, tcfg, p = _rwkv_params(seed=3)
    x = _rand(np.random.default_rng(14), 2, 40, 64, scale=0.5)
    tp = tree_torch(p)
    rmix = jitted(RS.rwkv_time_mix, cfg=rcfg)
    _, rstate = rmix(p, jnp.asarray(x[:, :32]))
    _, tstate = TS.rwkv_time_mix(tp, torch.as_tensor(x[:, :32]), tcfg)
    for t in range(32, 40):
        ro, rstate = rmix(p, jnp.asarray(x[:, t:t + 1]), state=rstate)
        to, tstate = TS.rwkv_time_mix(tp, torch.as_tensor(x[:, t:t + 1]),
                                      tcfg, state=tstate)
        assert_close(to, ro, RECURRENT, f"step {t}")
    assert_trees_close(tstate, rstate, RECURRENT, "final state")


@pytest.mark.parametrize("with_state", [False, True])
def test_rwkv_channel_mix_matches_reference(with_state):
    p = _ref_tree(RS.rwkv_channel_mix_init(jax.random.PRNGKey(4), 32, 64,
                                           jnp.float32))
    rng = np.random.default_rng(15)
    p["mu_k"], p["mu_r"] = _rand(rng, 32, scale=0.3), _rand(rng, 32, scale=0.3)
    x = _rand(rng, 2, 5, 32)
    st = _rand(rng, 2, 32) if with_state else None
    ref, rl = RS.rwkv_channel_mix(p, jnp.asarray(x),
                                  None if st is None else jnp.asarray(st))
    got, tl = TS.rwkv_channel_mix(tree_torch(p), torch.as_tensor(x),
                                  None if st is None else torch.as_tensor(st))
    assert_close(got, ref, LAYER)
    assert_close(tl, rl, LAYER)


def _mamba(seed=6):
    rcfg = RS.MambaConfig(d_state=4, d_conv=4, expand=2, dt_rank=8)
    p = _ref_tree(RS.mamba_init(jax.random.PRNGKey(seed), 32, rcfg,
                                jnp.float32))
    rng = np.random.default_rng(seed)
    p["conv_b"] = _rand(rng, *p["conv_b"].shape, scale=0.1)
    p["dt_bias"] = _rand(rng, *p["dt_bias"].shape, scale=0.5)
    return rcfg, TS.MambaConfig(d_state=4, d_conv=4, expand=2, dt_rank=8), p


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba_apply_matches_reference(with_state):
    """Without state (a prompt) and with one: a prompt's final (conv
    buffer, h), then three one-token steps."""
    rcfg, tcfg, p = _mamba()
    tp = tree_torch(p)
    x = _rand(np.random.default_rng(16), 2, 9, 32)
    rmamba = jitted(RS.mamba_apply, cfg=rcfg)
    ref, rstate = rmamba(p, jnp.asarray(x))
    got, tstate = TS.mamba_apply(tp, torch.as_tensor(x), tcfg)
    assert tstate[1].dtype == torch.float32
    assert_close(got, ref, RECURRENT)
    assert_trees_close(tstate, rstate, RECURRENT, "state")
    if with_state:
        for t in range(3):
            xt = _rand(np.random.default_rng(17 + t), 2, 1, 32)
            ref, rstate = rmamba(p, jnp.asarray(xt), state=rstate)
            got, tstate = TS.mamba_apply(tp, torch.as_tensor(xt), tcfg,
                                         tstate)
            assert_close(got, ref, RECURRENT, f"step {t}")
        assert_trees_close(tstate, rstate, RECURRENT, "carried state")


@pytest.mark.parametrize("S", [40, 300, 512])
def test_chunked_scan_matches_reference(S):
    """Short, ragged (the reference's plain-scan fallback, S % 256 != 0)
    and chunked (S = 512) scans give the same carry and outputs."""
    rng = np.random.default_rng(18)
    xs = (_rand(rng, S, 3), _rand(rng, S, 3))
    init = _rand(rng, 3)

    def rstep(c, inp):
        a, b = inp
        c = 0.9 * c + a * b
        return c, jnp.tanh(c)

    def tstep(c, inp):
        a, b = inp
        c = 0.9 * c + a * b
        return c, torch.tanh(c)

    rc, rys = RS.chunked_scan(rstep, jnp.asarray(init),
                              tuple(map(jnp.asarray, xs)))
    tc, tys = TS.chunked_scan(tstep, torch.as_tensor(init),
                              tuple(map(torch.as_tensor, xs)))
    assert_close(tc, rc, RECURRENT)
    assert_close(tys, rys, RECURRENT)


# -- sharding -----------------------------------------------------------------------


def test_shardings_none_is_identity():
    sh = Shardings.none()
    x = torch.arange(24.0).reshape(2, 3, 4)
    for fn in (sh.act_btd, sh.act_btv, sh.batch_only, sh.cache_bskh):
        assert fn(x) is x
    assert sh.act_bthd(x[..., None]).shape == (2, 3, 4, 1)
    assert sh.use_sharded_decode is False
    assert sh.mesh is None


def _roadmap_titles():
    text = (ROOT / "ROADMAP.md").read_text()
    return set(re.findall(r"^\s*\d+\. \*\*(.+?)\.?\*\*", text, re.M))


def test_mesh_and_sharded_decode_are_refused_with_a_roadmap_title():
    """LM sharding is ported (the name is kept): on a one-rank gloo world's
    (1, 1) mesh a handle constrains DTensors and refuses a plain tensor
    with ``TypeError``, and the sequence-sharded decode (bf16 cache and
    int8 cache) equals the unsharded one; "LM sharding" is no longer
    named by a refusal, and the titles still named are ROADMAP.md's."""
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_mesh_for
    from repro_torch.runtime.sharding import P, spec_placements

    assert "LM sharding" not in "".join(
        f.read_text() for f in (ROOT / "src" / "repro_torch").rglob("*.py"))
    assert "Rank-3 serve buckets" in _roadmap_titles()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_mesh_for()
        sh = Shardings(mesh=mesh, dp_axes=("data",),
                       cache_seq_axes=("model",))
        assert sh.use_sharded_decode
        x = torch.arange(24.0).reshape(2, 3, 4)
        with pytest.raises(TypeError):
            sh.act_btd(x)
        rng = np.random.default_rng(0)
        q = torch.as_tensor(rng.standard_normal((2, 1, 4, 8)), dtype=torch.float32)
        kc = torch.as_tensor(rng.standard_normal((2, 2, 16, 8)), dtype=torch.float32)
        vc = torch.as_tensor(rng.standard_normal((2, 2, 16, 8)), dtype=torch.float32)
        pl = spec_placements(P("data", None, "model", None), mesh)
        dk, dv = (distribute_tensor(t, mesh, pl) for t in (kc, vc))
        dq = distribute_tensor(q, mesh, spec_placements(P("data"), mesh))
        with sh.scope():
            got = TA.sharded_decode_attention(dq, dk, dv, 9, mesh=mesh,
                                              seq_axes=("model",),
                                              batch_axes=("data",))
        assert_close(got.full_tensor(), TA.decode_attention(q, kc, vc, 9),
                     LAYER)
        cache = {"k": torch.zeros(2, 2, 16, 8, dtype=torch.int8),
                 "v": torch.zeros(2, 2, 16, 8, dtype=torch.int8),
                 "k_s": torch.zeros(2, 2, 16), "v_s": torch.zeros(2, 2, 16)}
        dcache = {k: distribute_tensor(
            v, mesh, spec_placements(P("data", None, "model"), mesh))
            for k, v in cache.items()}
        kn = torch.as_tensor(rng.standard_normal((2, 1, 2, 8)), dtype=torch.float32)
        vn = torch.as_tensor(rng.standard_normal((2, 1, 2, 8)), dtype=torch.float32)
        TA.cache_update_q(cache, kn, vn, 3)
        with sh.scope():
            TA.cache_update_q(dcache, kn, vn, 3)
            got = TA.sharded_decode_attention_q(
                dq, dcache, 3, mesh=mesh, seq_axes=("model",),
                batch_axes=("data",), compute_dtype=torch.float32)
        for k in cache:
            assert torch.equal(dcache[k].full_tensor(), cache[k]), k
        assert_close(got.full_tensor(),
                     TA.decode_attention_q(q, cache, 3, torch.float32), LAYER)
    finally:
        dist.destroy_process_group()
