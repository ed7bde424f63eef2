"""The LM's sharded loss and grads on a gloo world of 8 ranks, a
``(pod, data, model) = (2, 2, 2)`` mesh, against the reference's jitted
``value_and_grad`` on the same weights and batch, and against the port's
own one-rank run.

The archs are the reference's mini-dry-run set (yi-9b, phi3.5-moe,
rwkv6-7b; ``tests/test_sharding_rules.py``) plus jamba-v0.1 and
whisper-base, reduced and in float32, with the reference's weights carried
across by ``convert.lm_params``.  Each rank holds only its shard: the
params, the optimizer state and the grads (redistributed to the params'
placements, as the train step does) are checked against their specs.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from _torch_lm_common import (
    jax_batch, leaves, make_batch, ref_params, run_lm_world, torch_batch,
    tree_np,
)
from repro.configs import get_config as ref_config
from repro.models.api import build_model as ref_build
from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.launch import cells
from repro_torch.models.api import build_model
from repro_torch.runtime.sharding import Shardings
from repro_torch.util import tolerance_for, tree_leaves

ARCHS = ["yi-9b", "phi3.5-moe-42b-a6.6b", "rwkv6-7b", "jamba-v0.1-52b",
         "whisper-base"]
# The sharded run sums each reduction in partial sums across ranks (the
# vocab and head axes, the batch rows' gradients) where the one-rank run
# sums once, in another order: scale 10 over float32's 1e-5, normwise (the
# reference's own grad parity in tests/test_torch_lm_train.py uses 10).
SHARDED = tolerance_for(torch.float32, scale=10)
# Against the reference: XLA's reduction order against torch's (the port's
# one-rank grads hold scale 10 against it, tests/test_torch_lm_train.py)
# and the sharded run's partial sums on top of that.  The two need not
# add up to more: the largest gap found, normwise, is 1.2e-5 of the
# largest grad (jamba; the others 1.7e-6), under scale 10's 1e-4.
REFERENCE = tolerance_for(torch.float32, scale=10)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm_grads")
    inp, want, ref = {"grads": {}}, {}, {}
    for i, arch in enumerate(ARCHS):
        cfg = get_config(arch).reduced()
        rmodel = ref_build(ref_config(arch).reduced())
        tree = ref_params(rmodel, seed=i)
        batch = make_batch(cfg, np.random.default_rng(i), B=8, S=16)
        inp["grads"][arch] = {"params": tree, "batch": batch}
        model = build_model(cfg, device="cpu")
        params = convert.lm_params(tree, cfg, device="cpu")
        want[arch] = cells.value_and_grad(model, params, torch_batch(batch),
                                          Shardings.none())
        loss, grads = jax.jit(jax.value_and_grad(rmodel.loss))(
            tree, jax_batch(batch))
        ref[arch] = (np.asarray(loss), jax.device_get(grads))
    out, reports = run_lm_world(tmp, "grads", inp)
    return out, reports, want, ref


def _normwise(a, e, tol, what):
    a, e = np.asarray(a, np.float64), np.asarray(e, np.float64)
    assert a.shape == e.shape, what
    err = float(np.abs(a - e).max(initial=0.0))
    assert err <= tol["atol"] + tol["rtol"] * float(np.abs(e).max(initial=0.0)), \
        (what, err)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_one_rank(world, arch):
    out, _, want, _ = world
    loss, grads = want[arch]
    _normwise(out[arch]["loss"], loss.numpy(), SHARDED, "loss")
    got = tree_leaves(out[arch]["grads"])
    exp = tree_leaves(grads)
    assert len(got) == len(exp)
    for i, (g, e) in enumerate(zip(got, exp)):
        _normwise(g, e.numpy(), SHARDED, f"{arch} grad leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(world, arch):
    out, _, _, ref = world
    rloss, rgrads = ref[arch]
    _normwise(out[arch]["loss"], rloss, REFERENCE, "loss")
    got, exp = list(leaves(out[arch]["grads"])), list(leaves(tree_np(rgrads)))
    assert [p for p, _ in got] == [p for p, _ in exp]
    for (path, g), (_, e) in zip(got, exp):
        _normwise(g, e, REFERENCE, f"{arch} grad {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_shard(world, arch):
    _, reports, _, _ = world
    for r, rep in enumerate(reports):
        assert rep[arch]["bad_shards"] == [], (r, rep[arch]["bad_shards"])
        assert rep[arch]["n_leaves"] > 0
