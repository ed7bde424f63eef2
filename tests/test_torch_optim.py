"""The port's optimizers and schedule (``repro_torch.optim``) against the
reference's on the CPU.

Mirrors ``tests/test_optim.py`` (hand math, memory tiers, clipping, the
schedule's shape), then holds the port to the reference: N updates of each
optimizer from the same params, grads and state (the reference's state
carried across by ``convert.opt_state``) in float32 and with bf16 params,
``global_norm``, ``clip_by_global_norm``, ``warmup_cosine`` and the int8
codes of ``_quantize``.  Inputs come from numpy with a seed.

Tolerances: float32 results within ``tolerance_for(float32)`` (1e-5): each
update is the same handful of float32 operations in the same order, and
the two packages' reductions (the global norm, Adafactor's row and column
means and its update RMS) sum in another order, which moves a result by a
few ulp.  bf16 params within ``tolerance_for(bfloat16)`` (2e-2): a float32
result a few ulp off can round to the neighbouring bf16 value (one bf16
ulp, 2^-8 relative).  ``adamw8bit``'s int8 codes are equal, or differ by
one where the reference's value lies within 1e-3 of a rounding tie
(|x / scale| <= 127 held to a few float32 ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # optional dep: deterministic sweep fallback
    from _hypothesis_fallback import given, settings, strategies as st

from repro.optim import get_optimizer as ref_get_optimizer
from repro.optim import global_norm as ref_global_norm
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.optim.optimizers import _quantize as ref_quantize
from repro_torch import convert
from repro_torch.optim import (
    clip_by_global_norm,
    get_optimizer,
    global_norm,
    state_specs,
    warmup_cosine,
)
from repro_torch.optim.optimizers import _dequantize, _quantize
from repro_torch.util import tolerance_for, tree_leaves

F32 = tolerance_for(torch.float32)
BF16 = tolerance_for(torch.bfloat16)
TIE = 1e-3


def tree_like(seed, shapes, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return {k: torch.as_tensor(rng.standard_normal(s), dtype=dtype)
            for k, s in shapes.items()}


SHAPES = {"w": (8, 16), "b": (16,), "emb": (32, 8)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if \
        jnp.asarray(x).dtype == jnp.bfloat16 else np.asarray(x)


class TestAdamW:
    def test_first_step_matches_hand_math(self):
        opt = get_optimizer("adamw", 1e-2, weight_decay=0.0, clip_norm=None)
        params = tree_like(0, SHAPES)
        grads = tree_like(1, SHAPES)
        state = opt.init(params)
        new, _ = opt.update(grads, state, params)
        # step 1: m=(1-b1)g, v=(1-b2)g^2, bias-corrected => update = g/(|g|+eps)
        g = grads["w"].double().numpy()
        expect = params["w"].double().numpy() - 1e-2 * g / (np.abs(g) + 1e-8)
        np.testing.assert_allclose(new["w"].numpy(), expect, atol=1e-5)

    def test_weight_decay_pulls_to_zero(self):
        opt = get_optimizer("adamw", 1e-1, weight_decay=0.5, clip_norm=None)
        params = {"w": torch.full((4,), 10.0)}
        state = opt.init(params)
        zero_g = {"w": torch.zeros(4)}
        for _ in range(5):
            params, state = opt.update(zero_g, state, params)
        assert float(params["w"][0]) < 10.0

    def test_bf16_params_supported(self):
        opt = get_optimizer("adamw", 1e-2)
        params = {"w": torch.ones((8, 8), dtype=torch.bfloat16)}
        state = opt.init(params)
        grads = {"w": torch.ones((8, 8), dtype=torch.bfloat16)}
        new, state = opt.update(grads, state, params)
        assert new["w"].dtype == torch.bfloat16
        assert state["m"]["w"].dtype == torch.float32
        assert state["step"].dtype == torch.int32 and state["step"].ndim == 0

    def test_update_changes_nothing_it_is_given(self):
        params, grads = tree_like(0, SHAPES), tree_like(1, SHAPES)
        for name in ("adamw", "adafactor", "adamw8bit"):
            opt = get_optimizer(name, 1e-2)
            state = opt.init(params)
            before = [t.clone() for t in tree_leaves((params, grads, state))]
            opt.update(grads, state, params)
            for a, b in zip(before, tree_leaves((params, grads, state)),
                            strict=True):
                assert torch.equal(a, b), name


    @pytest.mark.parametrize("name", ["adamw", "adafactor", "adamw8bit"])
    def test_donated_update_writes_into_the_given_tensors(self, name):
        """``donate=True`` (the train loop's, as the reference's
        ``donate_argnums``) gives the functional update's values, bit for
        bit, in the params' and state's own tensors."""
        params, grads = tree_like(0, SHAPES), tree_like(1, SHAPES)
        params["h"] = torch.ones((4, 8), dtype=torch.bfloat16)
        grads["h"] = torch.full((4, 8), 0.5, dtype=torch.bfloat16)
        opt = get_optimizer(name, 1e-2)
        state = opt.init(params)
        for _ in range(2):
            want_p, want_s = opt.update(grads, state, params)
            def held(p, s):  # all but the step, a new 0-d tensor
                return tree_leaves((p, {k: v for k, v in s.items()
                                        if k != "step"}))

            given = held(params, state)
            params, state = opt.update(grads, state, params, donate=True)
            got = held(params, state)
            assert all(a is b for a, b in zip(given, got, strict=True))
            for a, b in zip(tree_leaves((want_p, want_s)),
                            tree_leaves((params, state)), strict=True):
                assert torch.equal(a, b), name


class TestAdafactor:
    def test_runs_and_descends_quadratic(self):
        opt = get_optimizer("adafactor", 1e-1)
        w = {"w": torch.as_tensor(
            np.random.default_rng(0).standard_normal((8, 8)),
            dtype=torch.float32)}
        state = opt.init(w)
        for _ in range(60):
            g = {"w": 2 * w["w"]}  # d/dw |w|^2
            w, state = opt.update(g, state, w)
        assert float(w["w"].abs().max()) < 0.5

    def test_factored_state_is_small(self):
        opt = get_optimizer("adafactor", 1e-2)
        params = {"w": torch.zeros((256, 512))}
        state = opt.init(params)
        n_state = sum(x.numel() for x in tree_leaves(state))
        assert n_state < 256 * 512 * 0.02  # ~(256+512) vs 131072

    def test_state_specs_refused_until_lm_sharding(self):
        """The stats' partition specs are the reference's: the factored
        rows drop the last entry, the columns the one before it, a vector
        keeps its own (LM sharding is ported; the name is kept)."""
        from jax.sharding import PartitionSpec as RP

        from repro.optim import state_specs as ref_state_specs
        from repro_torch.runtime.sharding import P

        specs = {"w": P("data", "model"), "b": P("model"), "e": P()}
        shapes = {"w": torch.zeros(8, 16), "b": torch.zeros(16),
                  "e": torch.zeros(4, 2, 6)}
        ref = ref_state_specs(
            "adafactor", {k: RP(*v) for k, v in specs.items()},
            {k: jnp.zeros(tuple(v.shape)) for k, v in shapes.items()})
        got = state_specs("adafactor", specs, shapes)
        for k in specs:
            assert {n: tuple(x) for n, x in got["stats"][k].items()} == {
                n: tuple(x) for n, x in ref["stats"][k].items()}, k
        assert tuple(got["step"]) == tuple(ref["step"]) == ()


class TestAdamW8bit:
    def test_quantize_roundtrip(self):
        rng = np.random.default_rng(0)
        x = torch.as_tensor(rng.standard_normal(1000), dtype=torch.float32)
        q, s = _quantize(x)
        y = _dequantize(q, s, (1000,))
        assert q.dtype == torch.int8
        np.testing.assert_allclose(y.numpy(), x.numpy(),
                                   atol=float(x.abs().max()) / 100)

    def test_tracks_adamw_approximately(self):
        params = tree_like(3, {"w": (64, 64)})
        grads = tree_like(4, {"w": (64, 64)})
        o32 = get_optimizer("adamw", 1e-2, clip_norm=None)
        o8 = get_optimizer("adamw8bit", 1e-2, clip_norm=None)
        s32, s8 = o32.init(params), o8.init(params)
        p32, p8 = params, params
        for _ in range(5):
            p32, s32 = o32.update(grads, s32, p32)
            p8, s8 = o8.update(grads, s8, p8)
        diff = float((p32["w"] - p8["w"]).abs().max())
        scale = float((p32["w"] - params["w"]).abs().max())
        assert diff < 0.25 * scale, (diff, scale)


class TestClipAndSchedule:
    @settings(max_examples=10, deadline=None)
    @given(seed=st.integers(0, 1000), max_norm=st.floats(0.1, 10.0))
    def test_clip_by_global_norm(self, seed, max_norm):
        tree = tree_like(seed, SHAPES)
        clipped, norm = clip_by_global_norm(tree, max_norm)
        new_norm = float(global_norm(clipped))
        assert new_norm <= max_norm * 1.001 + 1e-6
        if float(norm) <= max_norm:
            np.testing.assert_allclose(clipped["w"].numpy(),
                                       tree["w"].numpy(), rtol=1e-6)

    def test_warmup_cosine_shape(self):
        lr = warmup_cosine(1e-3, warmup_steps=100, total_steps=1000)
        assert float(lr(0)) == 0.0
        assert abs(float(lr(100)) - 1e-3) < 1e-9
        assert abs(float(lr(50)) - 5e-4) < 1e-9
        assert float(lr(1000)) < float(lr(500)) < float(lr(100))
        assert float(lr(1000)) >= 1e-4 * 0.999  # end_frac floor


# -- parity with the reference ---------------------------------------------------


PARITY_SHAPES = {"w": (8, 16), "b": (16,), "emb": (3, 32, 8), "x": (300,),
                 "blocks": [{"k": (2, 4, 6)}, {"k": (2, 4, 6)}]}


def _draw(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _draw(rng, v, scale) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_draw(rng, v, scale) for v in shapes]
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _as(tree, dtype, kind):
    """A numpy tree as jax arrays (``kind='jax'``) or tensors, in ``dtype``
    (bf16 leaves hold the same values in both)."""
    if isinstance(tree, dict):
        return {k: _as(v, dtype, kind) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as(v, dtype, kind) for v in tree]
    j = jnp.asarray(tree, dtype)
    if kind == "jax":
        return j
    return torch.as_tensor(np.array(j.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _assert_trees(actual, expected, tol, what):
    a, e = tree_leaves(actual), tree_leaves(jax.device_get(expected))
    assert len(a) == len(e), what
    for i, (x, y) in enumerate(zip(a, e)):
        np.testing.assert_allclose(_np(x), _np(y), err_msg=f"{what} leaf {i}",
                                   **tol)


def _assert_codes(q, ref_q, ref_m, ref_s, what):
    """int8 codes equal, or one apart where the reference's value lies
    within ``TIE`` of a rounding tie."""
    d = q.numpy().astype(np.int32) - np.asarray(ref_q).astype(np.int32)
    off = np.abs(d) > 0
    assert np.abs(d).max(initial=0) <= 1, what
    if off.any():
        x = np.asarray(ref_m) / np.maximum(np.asarray(ref_s), 1e-20)
        frac = np.abs(np.abs(x) - np.floor(np.abs(x)) - 0.5)
        assert (frac[off] < TIE).all(), what


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adamw", "adafactor", "adamw8bit"])
def test_updates_match_reference(name, dtype):
    """Two reference updates, the state carried across by
    ``convert.opt_state``, then three more updates in both packages from
    the same params and grads (a warming-up schedule, grads of growing
    size so that clipping engages): params and state agree."""
    rng = np.random.default_rng(7)
    p0 = _draw(rng, PARITY_SHAPES)
    grads = [_draw(rng, PARITY_SHAPES, scale=0.3 * (i + 1)) for i in range(5)]
    ref = ref_get_optimizer(name, ref_warmup_cosine(1e-2, warmup_steps=3))
    port = get_optimizer(name, warmup_cosine(1e-2, warmup_steps=3))
    # the reference's adamw8bit does not trace under jax.jit
    # (_dequantize's int() of a traced size), so it runs eagerly
    upd = ref.update if name == "adamw8bit" else jax.jit(ref.update)
    rp = _as(p0, dtype, "jax")
    rs = ref.init(rp)
    for g in grads[:2]:
        rp, rs = upd(_as(g, dtype, "jax"), rs, rp)
    tp = _as(jax.device_get(jax.tree.map(lambda x: x.astype(jnp.float32),
                                         rp)), dtype, "torch")
    ts = convert.opt_state(jax.device_get(rs), tp, device="cpu")
    assert int(ts["step"]) == 2 and ts["step"].dtype == torch.int32
    for g in grads[2:]:
        rp, rs = upd(_as(g, dtype, "jax"), rs, rp)
        tp, ts = port.update(_as(g, dtype, "torch"), ts, tp)
    _assert_trees(tp, rp, F32 if dtype == "float32" else BF16, "params")
    assert int(ts["step"]) == int(rs["step"]) == 5
    if name == "adamw8bit":
        for mom in ("m", "v"):
            for (q, s), rq, rsc in zip(
                    zip(tree_leaves(tree_map_q(ts[mom], "q")),
                        tree_leaves(tree_map_q(ts[mom], "s"))),
                    tree_leaves(jax.device_get(tree_map_q(rs[mom], "q"))),
                    tree_leaves(jax.device_get(tree_map_q(rs[mom], "s")))):
                np.testing.assert_allclose(s.numpy(), np.asarray(rsc), **F32)
                deq = (np.asarray(rq).astype(np.float32) * np.asarray(rsc))
                _assert_codes(q, rq, deq, rsc, f"{mom} codes")
    else:
        _assert_trees(ts, rs, F32, "state")


def tree_map_q(tree, key):
    """The ``key`` entries of a tree of ``{"q", "s"}`` moments."""
    if isinstance(tree, dict) and set(tree) == {"q", "s"}:
        return tree[key]
    if isinstance(tree, dict):
        return {k: tree_map_q(v, key) for k, v in tree.items()}
    return [tree_map_q(v, key) for v in tree]


def test_opt_state_holds_the_layout():
    """``opt_state`` reads the optimizer from the layout and refuses a
    state of other shapes or keys, naming the leaf."""
    from repro.configs import get_config as ref_config
    from repro.models.api import build_model as ref_build
    from repro_torch.configs import get_config

    cfg = get_config("smollm-135m").reduced()
    rp = ref_build(ref_config("smollm-135m").reduced()).init(
        jax.random.PRNGKey(0))
    for name in ("adamw", "adafactor", "adamw8bit"):
        rs = jax.device_get(ref_get_optimizer(name, 1e-3).init(rp))
        ts = convert.opt_state(rs, cfg, device="cpu")
        want = get_optimizer(name, 1e-3).init(
            convert.lm_params(jax.device_get(rp), cfg, device="cpu"))
        got, exp = tree_leaves(ts), tree_leaves(want)
        assert [(t.shape, t.dtype) for t in got] == [
            (t.shape, t.dtype) for t in exp], name
    rs = jax.device_get(ref_get_optimizer("adamw", 1e-3).init(rp))
    with pytest.raises(ValueError, match="opt_state \\(adamw\\): /m/embed"):
        convert.opt_state(dict(rs, m=dict(rs["m"], embed=rs["m"]["embed"][:3])),
                          cfg, device="cpu")
    with pytest.raises(ValueError, match="has keys"):
        convert.opt_state({k: v for k, v in rs.items() if k != "v"} | {
            "v": {}}, cfg, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_norm_and_clip_match_reference(seed):
    rng = np.random.default_rng(seed)
    tree = _draw(rng, PARITY_SHAPES, scale=2.0)
    np.testing.assert_allclose(float(global_norm(_as(tree, "float32", "t"))),
                               float(ref_global_norm(_as(tree, "float32",
                                                         "jax"))), **F32)
    for max_norm in (0.5, 1e3):
        got, n = clip_by_global_norm(_as(tree, "float32", "t"), max_norm)
        want, rn = ref_clip(_as(tree, "float32", "jax"), max_norm)
        np.testing.assert_allclose(float(n), float(rn), **F32)
        _assert_trees(got, want, F32, f"clip {max_norm}")


@pytest.mark.parametrize("step", [0, 1, 2000, 100_000, 51_234])
def test_warmup_cosine_matches_reference(step):
    got, want = warmup_cosine(3e-4)(step), ref_warmup_cosine(3e-4)(step)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), **F32)
    t = warmup_cosine(3e-4)(torch.tensor(step, dtype=torch.int32))
    assert float(t) == float(got)


@pytest.mark.parametrize("n", [1000, 256, 7])
def test_quantize_codes_match_reference(n):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * np.exp(rng.uniform(-8, 2, n))).astype(
        np.float32)
    q, s = _quantize(torch.as_tensor(x))
    rq, rs = ref_quantize(jnp.asarray(x))
    assert q.shape == rq.shape and s.shape == rs.shape
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
