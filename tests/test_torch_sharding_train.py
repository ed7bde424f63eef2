"""The LM's sharded train step (accum 2, each of the three optimizers) and
``train_loop``'s resume on a gloo world of 8 ranks (a ``(2, 2, 2)`` mesh;
``train_loop`` builds its own ``(4, 2)`` ``data x model`` mesh with
``model_parallel=2``): two steps against two of the reference's jitted
train step from the same weights and batch, and against the port's own
one-rank run.  adamw8bit's blocks, which cut across every sharding of a
leaf, are checked on their own on each layout a spec can give."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_lm_common import (
    jax_batch, leaves, make_batch, ref_params, run_lm_world, torch_batch,
    tree_np,
)
from repro.configs import get_config as ref_config
from repro.launch import cells as ref_cells
from repro.models.api import build_model as ref_build
from repro.runtime.sharding import Shardings as RefShardings
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import cells
from repro_torch.models.api import build_model
from repro_torch.runtime.sharding import Shardings
from repro_torch.util import tolerance_for, tree_leaves

ARCH = "yi-9b"
OPTS = ["adamw", "adafactor", "adamw8bit"]
# two steps of an optimizer over grads that are sums across ranks in
# another order than the one-rank run's: scale 10 over float32's 1e-5,
# normwise; adamw8bit's int8 codes may then round one step apart
SHARDED = tolerance_for(torch.float32, scale=10)
# against the reference: the same two steps, with XLA's reduction order
# beside the sharded partial sums; the port's one-rank step holds scale 10
# against it (tests/test_torch_lm_train.py), and the sharded step does
# too (the largest gap found, normwise: 1.0e-6 of a leaf's largest value,
# in adamw's moments); int8 codes may round one step apart
REFERENCE = tolerance_for(torch.float32, scale=10)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_train")
    cfg0 = get_config(ARCH).reduced()
    tree = ref_params(ref_build(ref_config(ARCH).reduced()), seed=3)
    batch = make_batch(cfg0, np.random.default_rng(3), B=8, S=16)
    want, ref = {}, {}
    for name in OPTS:
        cfg = dataclasses.replace(cfg0, optimizer=name)
        model = build_model(cfg, device="cpu")
        step = cells.make_train_step(model, sh=Shardings.none(), accum=2)
        params = convert.lm_params(tree, cfg, device="cpu")
        state = step.optimizer.init(params)
        for _ in range(2):
            params, state, m = step(params, state, torch_batch(batch))
        want[name] = (m["loss"], params, state)
        rmodel = ref_build(dataclasses.replace(ref_config(ARCH).reduced(),
                                               optimizer=name))
        rstep = ref_cells.make_train_step(rmodel, sh=RefShardings.none(),
                                          accum=2)
        assert rstep.optimizer.name == step.optimizer.name == name
        # the reference's adamw8bit sizes a leaf with int() of a traced
        # product, which jax.jit refuses: that step runs eagerly
        jstep = rstep if name == "adamw8bit" else jax.jit(rstep)
        rp, rs = tree, rstep.optimizer.init(tree)
        for _ in range(2):
            rp, rs, rm = jstep(rp, rs, jax_batch(batch))
        ref[name] = (np.asarray(rm["loss"]), jax.device_get(rp),
                     jax.device_get(rs))
    out, reports = run_lm_world(
        tmp, "train", {"train": {"arch": ARCH, "params": tree,
                                 "batch": batch}})
    return out, reports, want, ref


def _normwise(a, e, tol, what):
    a, e = np.asarray(a, np.float64), np.asarray(e, np.float64)
    assert a.shape == e.shape, what
    err = float(np.abs(a - e).max(initial=0.0))
    assert err <= tol["atol"] + tol["rtol"] * float(np.abs(e).max(initial=0.0)), \
        (what, err)


@pytest.mark.parametrize("opt", OPTS)
def test_train_step_matches_one_rank(world, opt):
    out, reports, want, _ = world
    loss, params, state = want[opt]
    _normwise(out[opt]["loss"], loss.numpy(), SHARDED, "loss")
    for i, (g, e) in enumerate(zip(tree_leaves(out[opt]["params"]),
                                   tree_leaves(params), strict=True)):
        _normwise(g, e.numpy(), SHARDED, f"{opt} param {i}")
    for i, (g, e) in enumerate(zip(tree_leaves(out[opt]["state"]),
                                   tree_leaves(state), strict=True)):
        if e.dtype == torch.int8:
            assert np.abs(g.astype(np.int32) - e.numpy()).max() <= 1, i
        else:
            _normwise(g, e.numpy(), SHARDED, f"{opt} state {i}")
    for r, rep in enumerate(reports):
        assert rep[opt]["bad_shards"] == [], (r, rep[opt]["bad_shards"])


@pytest.mark.parametrize("opt", OPTS)
def test_train_step_matches_reference(world, opt):
    out, _, _, ref = world
    rloss, rparams, rstate = ref[opt]
    _normwise(out[opt]["loss"], rloss, REFERENCE, "loss")
    for what, got, exp in (("param", out[opt]["params"], rparams),
                           ("state", out[opt]["state"], rstate)):
        got, exp = list(leaves(got)), list(leaves(tree_np(exp)))
        assert [p for p, _ in got] == [p for p, _ in exp], what
        for (path, g), (_, e) in zip(got, exp):
            if e.dtype == np.int8:
                assert g.shape == e.shape, path
                assert np.abs(g.astype(np.int32) - e).max() <= 1, path
            else:
                _normwise(g, e, REFERENCE, f"{opt} {what} {path}")


def test_adamw8bit_blocks_on_every_layout(world):
    """Each rank quantises its blocks' range of a leaf sharded over data,
    over model only, over both or not at all, and dequantises back to its
    shard (and a leaf whose odd count of blocks stays whole on every
    rank): the codes, scales and values are the whole leaf's."""
    _, reports, _, _ = world
    for r, rep in enumerate(reports):
        assert rep["blocks"] and all(rep["blocks"].values()), (r, rep["blocks"])


def test_train_loop_resumes_bit_for_bit(world):
    out, _, _, _ = world
    straight = [m["loss"] for m in out["straight"]]
    resumed = [m["loss"] for m in out["resumed"]]
    assert [m["step"] for m in out["resumed"]] == [0, 1, 2, 3]
    assert resumed == straight
    assert np.isfinite(straight).all()
