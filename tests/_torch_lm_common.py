"""Shared helpers of the LM substrate's parity tests
(``tests/test_torch_lm_*.py``): numpy trees in, tensors and jax arrays out,
and the batches both packages see."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.util import tolerance_for


def to_np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def tree_np(tree):
    """A jax or torch tree as numpy, same layout."""
    if isinstance(tree, dict):
        return {k: tree_np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_np(v) for v in tree)
    return to_np(tree)


def tree_torch(tree):
    """A numpy/jax tree as CPU tensors, same layout."""
    if isinstance(tree, dict):
        return {k: tree_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_torch(v) for v in tree)
    return torch.as_tensor(np.array(tree, copy=True))


def leaves(tree, path=""):
    """(path, leaf) pairs of a nested dict/list/tuple tree, dict keys sorted
    (``jax.device_get`` rebuilds dicts in sorted key order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def assert_close(actual, expected, tol, what=""):
    np.testing.assert_allclose(to_np(actual), to_np(expected), err_msg=what,
                               **tol)


def assert_trees_close(actual, expected, tol, what=""):
    a, e = list(leaves(tree_np(actual))), list(leaves(tree_np(expected)))
    assert [p for p, _ in a] == [p for p, _ in e], what
    for (p, x), (_, y) in zip(a, e):
        assert x.shape == y.shape, (what, p, x.shape, y.shape)
        assert_close(x, y, tol, f"{what} {p}")


def make_batch(cfg, rng, B=2, S=12):
    """The reference's ``tests/test_arch_smoke.py`` batch as numpy."""
    batch = {"tokens": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = (rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
                           * 0.1).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = (rng.standard_normal(
            (B, cfg.img_tokens, cfg.d_model)) * 0.1).astype(np.float32)
    return batch


def jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def torch_batch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def jitted(fn, **kw):
    """The reference's ``fn`` with ``kw`` bound, compiled once by
    ``jax.jit`` (eager jax compiles each op on its first call, which takes
    longer than the whole compiled call at these sizes)."""
    return jax.jit(functools.partial(fn, **kw))


def ref_params(model, seed=0):
    return jax.device_get(model.init(jax.random.PRNGKey(seed)))


# Tolerances (float32 throughout, tolerance_for's 1e-5 baseline):
# - one layer (a norm, rope, an MLP, one attention): the two packages round
#   the same operations in another order (XLA's dot and reduction order
#   against torch's) -> scale 2;
# - a recurrence over time (RWKV's WKV, Mamba's scan), MoE dispatch (a
#   sum over experts and slots) -> scale 5;
# - a model's logits (up to 8 layers, logits up to ~4 in magnitude; the
#   reduced jamba differs by 9e-6 at most) -> scale 10;
# - the port's own decode against its forward: the reference's test holds
#   this to 2e-4 -> scale 20.
LAYER = tolerance_for(torch.float32, scale=2)
RECURRENT = tolerance_for(torch.float32, scale=5)
LOGITS = tolerance_for(torch.float32, scale=10)
SELF = tolerance_for(torch.float32, scale=20)
