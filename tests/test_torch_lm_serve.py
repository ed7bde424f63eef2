"""The LM substrate's serving path in the port against the reference, for
each of the ten architectures at ``cfg.reduced()`` in float32 on the CPU:
configs, init, ``prefill_logits``, ``prefill_serve``, the decode step,
``greedy_generate`` and ``convert.lm_params``; plus the port's counterparts
of the reference's serving tests in ``tests/test_arch_smoke.py``.

Reference parameters come from ``repro.models.api.build_model(cfg).init``
and cross through ``convert.lm_params``; inputs are made from a seed with
numpy.  Tolerances are ``tests/_torch_lm_common.py``'s."""

from __future__ import annotations

import dataclasses
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_common import (
    LOGITS, SELF, assert_close, assert_trees_close, jax_batch, leaves,
    make_batch, ref_params, to_np, torch_batch,
)
from repro.configs import get_config as ref_config
from repro.configs import list_archs as ref_list_archs
from repro.launch import cells as ref_cells
from repro.models import encdec as ref_encdec
from repro.models.api import build_model as ref_build
from repro.models.layers import DTypePolicy as RefPolicy
from repro_torch import convert
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import cells
from repro_torch.models import encdec as tem
from repro_torch.models import transformer as tf
from repro_torch.models.api import build_model, param_shapes
from repro_torch.models.layers import ParamRNG
from repro_torch.util import tolerance_for

ARCHS = list_archs()
DECODE_STEPS = 12


@pytest.fixture(scope="module")
def cases():
    return {}


def _case(cases, arch):
    """The reference's reduced model, its parameters (numpy) and its
    prefill and 12-step decode outputs, and the port's model on the
    converted parameters; built once per arch."""
    if arch in cases:
        return cases[arch]
    rcfg, tcfg = ref_config(arch).reduced(), get_config(arch).reduced()
    rmodel, tmodel = ref_build(rcfg), build_model(tcfg, device="cpu")
    rp = ref_params(rmodel)
    batch = make_batch(rcfg, np.random.default_rng(0), B=2, S=DECODE_STEPS)
    rb = jax_batch(batch)
    ref = types.SimpleNamespace(
        logits=np.asarray(jax.jit(rmodel.prefill_logits)(rp, rb)),
        serve=jax.device_get(jax.jit(rmodel.prefill_serve)(rp, rb)),
        loss=np.asarray(jax.jit(rmodel.loss)(rp, rb)),
        decode=[],
    )
    cache = rmodel.init_cache(2, DECODE_STEPS + 4)
    if rcfg.family == "encdec":
        enc = ref_encdec.encode(rp, rcfg, rb["frames"])
        xk, xv = ref_encdec.prefill_cross(rp, rcfg, enc)
        cache = dict(cache, xk=xk, xv=xv)
    step = jax.jit(lambda p, t, i, c: rmodel.decode(p, t, i, c))
    for i in range(DECODE_STEPS):
        lg, cache = step(rp, rb["tokens"][:, i], i, cache)
        ref.decode.append(np.asarray(lg))
    cases[arch] = types.SimpleNamespace(
        arch=arch, rcfg=rcfg, tcfg=tcfg, rmodel=rmodel, tmodel=tmodel,
        rp=rp, tp=convert.lm_params(rp, tcfg, device="cpu"), batch=batch,
        ref=ref)
    return cases[arch]


def _cross_cache(model, cfg, params, frames, cache):
    enc = tem.encode(params, cfg, frames)
    xk, xv = tem.prefill_cross(params, cfg, enc)
    return dict(cache, xk=xk, xv=xv)


# -- configs ---------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_the_references(arch):
    """Every field of the published config, nested MoE/RWKV/Mamba configs
    and the dtype policy included, and the reduced config's."""
    for cut in (False, True):
        t, r = get_config(arch), ref_config(arch)
        if cut:
            t, r = t.reduced(), r.reduced()
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        assert t.hd == r.hd


def test_registry_is_the_references():
    assert list_archs() == ref_list_archs()
    for arch in ARCHS:
        mod = arch.replace("-", "_").replace(".", "")
        assert get_config(arch) is not None
        if mod in ("yi_9b", "smollm_135m", "dbrx_132b", "rwkv6_7b"):
            assert get_config(mod) == get_config(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_formula_close(arch):
    """The port's ``param_count``/``active_param_count`` are the
    reference's at the published widths; at ``reduced()`` the formula is
    within the reference test's 25% of the port's real count, which is
    the reference's."""
    t, r = get_config(arch), ref_config(arch)
    assert t.param_count() == r.param_count()
    assert t.active_param_count() == r.active_param_count()
    cfg = t.reduced()
    actual = sum(x.numel() for _, x in leaves(param_shapes(cfg)))
    ref_actual = sum(x.size for x in jax.tree.leaves(
        jax.eval_shape(ref_build(r.reduced()).init, jax.random.PRNGKey(0))))
    assert actual == ref_actual
    assert 0.75 < cfg.param_count() / actual < 1.25, (arch, actual)


# -- init -------------------------------------------------------------------------


def _dtype_name(x):
    return str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_matches_reference(cases, arch):
    """The port's init gives the reference's tree of names, shapes and
    dtypes; a leaf that is the same under two of the port's seeds (ones,
    zeros, the decay base, Mamba's ``a_log``) is the reference's exactly,
    and a random leaf's mean and standard deviation are the reference's
    within 6 standard errors (6 / sqrt(n) of the std for the mean; 6 /
    sqrt(n) of the std itself for the std, about 3 times the standard
    error of a sample std, which a truncated normal, less heavy-tailed
    than a normal, keeps under)."""
    c = _case(cases, arch)
    ours = list(leaves(c.tmodel.init(0)))
    other = list(leaves(c.tmodel.init(torch.Generator().manual_seed(1))))
    ref = list(leaves(c.rp))
    assert [p for p, _ in ours] == [p for p, _ in ref]
    for (path, t), (_, t2), (_, r) in zip(ours, other, ref):
        assert tuple(t.shape) == r.shape, path
        assert _dtype_name(t) == r.dtype.name, path
        t, r = to_np(t).astype(np.float64), r.astype(np.float64)
        if np.array_equal(t, to_np(t2)):
            np.testing.assert_array_equal(t, r, err_msg=path)
            continue
        n, sd = r.size, r.std()
        assert sd > 0, path
        assert abs(t.mean() - r.mean()) <= 6 * sd / math.sqrt(n), path
        assert abs(t.std() / sd - 1) <= 6 / math.sqrt(n), path


@pytest.mark.parametrize("arch", ["smollm-135m", "jamba-v0.1-52b",
                                  "whisper-base", "rwkv6-7b"])
def test_published_tree_layout_matches_reference(arch):
    """Names, shapes and dtypes (bf16 params, Mamba's float32 ``a_log``)
    at the published widths, one scan step deep, on the meta device
    against the reference's ``eval_shape``."""
    r, t = ref_config(arch), get_config(arch)
    period = tf._stack_period(t)
    r = dataclasses.replace(r, n_layers=period, enc_layers=min(r.enc_layers, 1))
    t = dataclasses.replace(t, n_layers=period, enc_layers=min(t.enc_layers, 1))
    ref = list(leaves(jax.eval_shape(ref_build(r).init, jax.random.PRNGKey(0))))
    ours = list(leaves(param_shapes(t)))
    assert [p for p, _ in ours] == [p for p, _ in ref]
    for (path, x), (_, y) in zip(ours, ref):
        assert (tuple(x.shape), _dtype_name(x)) == (y.shape, y.dtype.name), path


# -- prefill and decode against the reference ---------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_match_reference(cases, arch):
    c = _case(cases, arch)
    got = c.tmodel.prefill_logits(c.tp, torch_batch(c.batch))
    assert got.shape == c.ref.logits.shape
    assert torch.isfinite(got).all()
    assert_close(got, c.ref.logits, LOGITS, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_serve_matches_reference(cases, arch):
    """The last position's logits and the K/V the prefill hands to the
    cache (stacked over scan steps; a tuple per attention position for the
    hybrid; the cross K/V for whisper; None for RWKV)."""
    c = _case(cases, arch)
    logits, kvs = cells.make_prefill_step(
        c.tmodel, sh=tf.Shardings.none())(c.tp, torch_batch(c.batch))
    rlogits, rkvs = c.ref.serve
    assert_close(logits, rlogits, LOGITS, "logits")
    if rkvs is None:
        assert kvs is None
    else:
        assert_trees_close(kvs, rkvs, LOGITS, "kvs")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference(cases, arch):
    """The train loss's value (CE with z-loss, plus MoE's aux loss)."""
    c = _case(cases, arch)
    got = c.tmodel.loss(c.tp, torch_batch(c.batch))
    assert got.shape == ()
    assert_close(got, c.ref.loss, LOGITS, arch)


@pytest.mark.parametrize("arch", ["smollm-135m", "yi-9b"])
def test_long_loss_takes_the_chunked_ce(arch):
    """At 2048 tokens ``loss_fn`` takes the sequence-chunked CE (tied
    table for smollm, untied for yi) and flash attention's blocks."""
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    rmodel = ref_build(rcfg)
    rp = ref_params(rmodel)
    batch = make_batch(cfg, np.random.default_rng(5), B=1, S=2048)
    ref = jax.jit(rmodel.loss)(rp, jax_batch(batch))
    got = build_model(cfg, device="cpu").loss(
        convert.lm_params(rp, cfg, device="cpu"), torch_batch(batch))
    assert_close(got, ref, LOGITS, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference(cases, arch):
    """12 decode steps on a batch of 2 (the int8 cache for nemotron, the
    cross K/V for whisper) against the reference's logits step by step."""
    c = _case(cases, arch)
    tb = torch_batch(c.batch)
    cache = c.tmodel.init_cache(2, DECODE_STEPS + 4)
    if c.tcfg.family == "encdec":
        cache = _cross_cache(c.tmodel, c.tcfg, c.tp, tb["frames"], cache)
    for i in range(DECODE_STEPS):
        lg, cache = c.tmodel.decode(c.tp, tb["tokens"][:, i], i, cache)
        assert_close(lg, c.ref.decode[i], LOGITS, f"{arch} step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The port's own decode against its forward, as the reference's
    ``test_decode_matches_forward`` (capacity_factor 8.0 for MoE so the
    prefill drops nothing, the exact cache in place of int8), on the
    port's own init."""
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    cfg = dataclasses.replace(cfg, cache_dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    B, S = 2, 12
    batch = torch_batch(make_batch(cfg, np.random.default_rng(1), B, S))
    toks = batch["tokens"]
    if cfg.family == "vlm":
        full = tf.forward(params, cfg, toks)[0]
    else:
        full = model.prefill_logits(params, batch)
    cache = model.init_cache(B, S + 4)
    if cfg.family == "encdec":
        cache = _cross_cache(model, cfg, params, batch["frames"], cache)
    for i in range(S):
        lg, cache = model.decode(params, toks[:, i], i, cache)
    assert_close(lg, full[:, -1, :], SELF, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_gives_reference_tokens(cases, arch):
    """The port's ``greedy_generate`` yields the reference's tokens.  The
    port is stepped along the reference's tokens and each step's logits are
    held to the reference's; where the reference's top-two gap is under
    the logit tolerance, a differing argmax is allowed there, the run goes
    on from the reference's token, and the port's own generation is
    compared up to that step."""
    c = _case(cases, arch)
    prompt = [int(t) for t in np.random.default_rng(7).integers(
        1, c.tcfg.vocab, 5)]
    n_new = 7
    ref_tokens = ref_cells.greedy_generate(
        arch=arch, prompt_tokens=prompt, max_new_tokens=n_new, reduced=True,
        params=c.rp)
    max_seq = len(prompt) + n_new + 1
    rcache, tcache = c.rmodel.init_cache(1, max_seq), c.tmodel.init_cache(
        1, max_seq)
    if c.tcfg.family == "encdec":
        frames = np.zeros((1, c.rcfg.enc_seq, c.rcfg.d_model), np.float32)
        enc = ref_encdec.encode(c.rp, c.rcfg, jnp.asarray(frames))
        xk, xv = ref_encdec.prefill_cross(c.rp, c.rcfg, enc)
        rcache = dict(rcache, xk=xk, xv=xv)
        tcache = _cross_cache(c.tmodel, c.tcfg, c.tp, torch.as_tensor(frames),
                              tcache)
    step = jax.jit(lambda p, t, i, cc: c.rmodel.decode(p, t, i, cc))
    tie = None
    for i, t in enumerate(ref_tokens[:-1]):
        rl, rcache = step(c.rp, jnp.asarray([t], jnp.int32), i, rcache)
        tl, tcache = c.tmodel.decode(c.tp, torch.tensor([t], dtype=torch.int32),
                                     i, tcache)
        assert_close(tl, rl, LOGITS, f"{arch} step {i}")
        if i < len(prompt) - 1:
            continue
        r = np.asarray(rl)[0]
        nxt = ref_tokens[i + 1]
        assert int(np.argmax(r)) == nxt
        second, first = np.sort(r)[-2:]
        if first - second < LOGITS["atol"] + LOGITS["rtol"] * abs(first):
            tie = i + 1 if tie is None else tie
        else:
            assert int(torch.argmax(tl)) == nxt, f"{arch} token {i + 1}"
    got = cells.greedy_generate(arch=arch, prompt_tokens=prompt,
                                max_new_tokens=n_new, reduced=True,
                                params=c.tp, device="cpu")
    upto = len(ref_tokens) if tie is None else tie
    assert len(got) == len(ref_tokens)
    assert got[:upto] == ref_tokens[:upto]


# -- counterparts of the reference's own tests ---------------------------------------


def test_rwkv_state_continuity():
    """Ten tokens through decode equal the one-shot forward (the reference's
    test, its 1e-5), on the port's init and on the reference's weights."""
    cfg = get_config("rwkv6-7b").reduced()
    model = build_model(cfg, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        1, cfg.vocab, (1, 10)).astype(np.int32))
    rmodel = ref_build(ref_config("rwkv6-7b").reduced())
    rp = ref_params(rmodel)
    for params in (model.init(0), convert.lm_params(rp, cfg, device="cpu")):
        full = model.prefill_logits(params, {"tokens": toks})
        cache = model.init_cache(1, 16)
        for i in range(10):
            lg, cache = model.decode(params, toks[:, i], i, cache)
        assert_close(lg, full[:, -1], tolerance_for(torch.float32))
    ref_full = jax.jit(rmodel.prefill_logits)(
        rp, {"tokens": jnp.asarray(to_np(toks))})
    assert_close(full, ref_full, LOGITS)


def test_int8_kv_cache_decode_close():
    """The int8 cache (nemotron): decode logits within 5% of the logit
    range of the forward's, greedy tokens unchanged (the reference's test),
    and the quantised decode is the reference's within the logit
    tolerance on the same weights."""
    cfg = dataclasses.replace(get_config("nemotron-4-340b").reduced(),
                              cache_dtype="int8")
    rcfg = dataclasses.replace(ref_config("nemotron-4-340b").reduced(),
                               cache_dtype="int8")
    model, rmodel = build_model(cfg, device="cpu"), ref_build(rcfg)
    rp = ref_params(rmodel)
    toks = np.random.default_rng(3).integers(1, cfg.vocab, (2, 12)).astype(
        np.int32)
    rstep = jax.jit(lambda p, t, q, c: rmodel.decode(p, t, q, c))
    for params, is_ref in ((model.init(0), False),
                           (convert.lm_params(rp, cfg, device="cpu"), True)):
        full = model.prefill_logits(params, {"tokens": torch.as_tensor(toks)})
        cache = model.init_cache(2, 16)
        assert cache["k"].dtype == torch.int8
        rcache = rmodel.init_cache(2, 16)
        for i in range(12):
            lg, cache = model.decode(params, torch.as_tensor(toks[:, i]), i,
                                     cache)
            if is_ref:
                rl, rcache = rstep(rp, jnp.asarray(toks[:, i]), i, rcache)
                assert_close(lg, rl, LOGITS, f"step {i}")
        ref = to_np(full[:, -1, :])
        diff = float(np.abs(to_np(lg) - ref).max())
        assert diff < 0.05 * float(ref.max() - ref.min())
        assert (np.argmax(to_np(lg), -1) == np.argmax(ref, -1)).all()


def test_hybrid_decode_runs_layers_in_forward_order():
    """At two pattern periods (16 layers) the port's hybrid decode equals
    its forward.  The reference's decode applies every step of one period
    position before the next there, so it is held to the port only at one
    period (the reduced jamba, above); this records that it differs at
    two (ROADMAP.md, Faults)."""
    def cut(c):
        c = c.reduced()
        return dataclasses.replace(c, n_layers=16, moe=dataclasses.replace(
            c.moe, capacity_factor=8.0))

    cfg, rcfg = cut(get_config("jamba-v0.1-52b")), cut(
        ref_config("jamba-v0.1-52b"))
    model, rmodel = build_model(cfg, device="cpu"), ref_build(rcfg)
    rp = ref_params(rmodel)
    params = convert.lm_params(rp, cfg, device="cpu")
    toks = np.random.default_rng(1).integers(1, cfg.vocab, (2, 12)).astype(
        np.int32)
    full = model.prefill_logits(params, {"tokens": torch.as_tensor(toks)})
    rfull = jax.jit(rmodel.prefill_logits)(rp, {"tokens": jnp.asarray(toks)})
    assert_close(full, rfull, LOGITS)
    cache, rcache = model.init_cache(2, 16), rmodel.init_cache(2, 16)
    rstep = jax.jit(lambda p, t, q, c: rmodel.decode(p, t, q, c))
    for i in range(12):
        lg, cache = model.decode(params, torch.as_tensor(toks[:, i]), i, cache)
        rl, rcache = rstep(rp, jnp.asarray(toks[:, i]), i, rcache)
    assert_close(lg, full[:, -1], SELF)
    assert np.abs(np.asarray(rl) - np.asarray(rfull)[:, -1]).max() > 0.1


# -- conversion ------------------------------------------------------------------------


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["smollm-135m", "jamba-v0.1-52b",
                                  "whisper-base"])
def test_lm_params_round_trip(arch, policy):
    """Reference tree -> port -> numpy equals the reference leaf for leaf,
    in the same layout (the hybrid's list of period stacks, whisper's
    encoder and decoder stacks); bf16 leaves cross bit for bit."""
    pol = RefPolicy(policy, policy, "float32")
    rcfg = dataclasses.replace(ref_config(arch).reduced(), dtype_policy=pol)
    cfg = dataclasses.replace(get_config(arch).reduced(),
                              dtype_policy=type(get_config(arch).dtype_policy)(
                                  policy, policy, "float32"))
    rp = ref_params(ref_build(rcfg))
    tp = convert.lm_params(rp, cfg, device="cpu")
    if cfg.family == "hybrid":
        assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == 8
    back = convert.lm_numpy(tp)
    a, r = list(leaves(back)), list(leaves(rp))
    assert [p for p, _ in a] == [p for p, _ in r]
    for (path, x), (_, y), (_, t) in zip(a, r, leaves(tp)):
        assert _dtype_name(t) == y.dtype.name, path
        np.testing.assert_array_equal(x, np.asarray(y, np.float32)
                                      if policy == "bfloat16" else y,
                                      err_msg=path)


def test_lm_params_refuses_a_tree_of_another_layout():
    cfg = get_config("smollm-135m").reduced()
    rp = ref_params(ref_build(ref_config("smollm-135m").reduced()))
    bad = dict(rp)
    bad.pop("ln_f")
    with pytest.raises(ValueError, match="has keys"):
        convert.lm_params(bad, cfg, device="cpu")
    bad = dict(rp, embed=rp["embed"][:, :8])
    with pytest.raises(ValueError, match="/embed is"):
        convert.lm_params(bad, cfg, device="cpu")
    jamba = get_config("jamba-v0.1-52b").reduced()
    rj = ref_params(ref_build(ref_config("jamba-v0.1-52b").reduced()))
    with pytest.raises(ValueError, match="sequence of 8 stacks"):
        convert.lm_params(dict(rj, blocks=rj["blocks"][:1]), jamba,
                          device="cpu")


# -- cells and entry points ----------------------------------------------------------------


def test_cells_shapes_and_support_are_the_references():
    assert cells.SHAPES == ref_cells.SHAPES
    for arch in ARCHS:
        for shape in cells.SHAPES:
            ok, _ = cells.cell_supported(get_config(arch), shape)
            assert ok == ref_cells.cell_supported(ref_config(arch), shape)[0]


def test_serve_step_takes_the_decode_argmax(cases):
    c = _case(cases, "yi-9b")
    serve = cells.make_serve_step(c.tmodel, sh=tf.Shardings.none())
    tb = torch_batch(c.batch)
    cache = c.tmodel.init_cache(2, 8)
    nxt, cache = serve(c.tp, cache, tb["tokens"][:, 0], 0)
    assert nxt.dtype == torch.int32
    np.testing.assert_array_equal(to_np(nxt), np.argmax(c.ref.decode[0], -1))


@pytest.mark.parametrize("arch", ["smollm-135m", "phi3.5-moe-42b-a6.6b",
                                  "llava-next-mistral-7b", "nemotron-4-340b"])
def test_cache_from_prefill_serves_as_the_chunked_cache(arch):
    """A decode cache filled from ``prefill_serve``'s K/V serves the next
    token as the cache built through the decode step does; the VLM, whose
    decode step takes no image, is held to its forward over the prompt and
    the next token.  Nemotron's int8 cache: the decode step feeds each
    layer attention over the quantised cache, the prefill exact attention,
    so from the second layer on the two caches differ by more than
    rounding; the first layer's values agree within one quantum, and the
    next token's logits as ``test_int8_kv_cache_decode_close`` (within 5%
    of the logit range, the same argmax)."""
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    B, S = 2, 12
    batch = torch_batch(make_batch(cfg, np.random.default_rng(4), B, S))
    toks = batch["tokens"]
    n_pos = S + (cfg.img_tokens if cfg.family == "vlm" else 0)
    logits, kvs = cells.make_prefill_step(model, sh=tf.Shardings.none())(
        params, batch)
    nxt = torch.argmax(logits, dim=-1).to(torch.int32)
    filled = cells.cache_from_prefill(model, model.init_cache(B, n_pos + 4),
                                      kvs)
    if cfg.cache_dtype == "int8":
        assert filled["k"].dtype == torch.int8
    if cfg.family == "vlm":
        want = tf.forward(params, cfg, torch.cat([toks, nxt[:, None]], 1),
                          extra_embeds=batch["patches"])[0][:, -1]
    else:
        cache = model.init_cache(B, n_pos + 4)
        for i in range(S):
            _, cache = model.decode(params, toks[:, i], i, cache)
        for name in cache:  # before the decode below writes position S
            if cfg.cache_dtype == "int8":
                assert_close(filled[name][0].float(), cache[name][0].float(),
                             dict(rtol=0, atol=1 if name in ("k", "v")
                                  else 1e-6),
                             f"{arch} cache {name}, first layer")
            else:
                assert_close(filled[name].float(), cache[name].float(),
                             SELF, f"{arch} cache {name}")
        want, _ = model.decode(params, nxt, n_pos, cache)
    got, _ = model.decode(params, nxt, n_pos, filled)
    if cfg.cache_dtype == "int8":
        w = to_np(want)
        assert np.abs(to_np(got) - w).max() < 0.05 * (w.max() - w.min())
        assert (np.argmax(to_np(got), -1) == np.argmax(w, -1)).all()
    else:
        assert_close(got, want, SELF, arch)


def test_cache_from_prefill_refuses_the_recurrent_families():
    for arch in ("rwkv6-7b", "jamba-v0.1-52b", "whisper-base"):
        model = build_model(get_config(arch).reduced(), device="cpu")
        with pytest.raises(ValueError, match="rebuilt through the decode"):
            cells.cache_from_prefill(model, {}, (None, None))


def test_serve_shim_is_greedy_generate_and_the_cli():
    from repro_torch.launch import serve
    from repro_torch.serve import cli

    assert serve.generate is cells.greedy_generate
    assert serve.main is cli.main


def test_entry_points_default_to_the_card():
    """``build_model``, ``greedy_generate``, ``convert.lm_params`` and the
    module-level API (``ParamRNG``, ``transformer.init_cache``,
    ``encdec.init_cache``) default to ``'cuda'``: on a host without a card
    they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal cannot occur")
    cfg = get_config("smollm-135m").reduced()
    wcfg = get_config("whisper-base").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cells.greedy_generate(arch="smollm-135m", prompt_tokens=[1, 2],
                              max_new_tokens=1, reduced=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.lm_params({}, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParamRNG(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tf.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tem.init_cache(wcfg, 1, 4)
    # on the CPU when asked
    assert tf.init_cache(cfg, 1, 4, device="cpu")["k"].device.type == "cpu"
    assert tem.init_cache(wcfg, 1, 4, device="cpu")["k"].device.type == "cpu"
    assert ParamRNG(0, "cpu").device.type == "cpu"
