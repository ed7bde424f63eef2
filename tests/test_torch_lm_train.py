"""LM training in the port against the reference, on the CPU: autograd
through the ten reduced architectures, the reference's remat, the train
step, the training loop, its CLI and its restart supervisor.

- loss and every gradient leaf of the ten reduced archs (float32, B=2,
  S=64: RWKV's chunked WKV, whisper's encoder and decoder) against the
  reference's ``jax.value_and_grad`` on the same parameters
  (``convert.lm_params``);
- the remat sites' gradients against the reference's at the layer level
  (a flash attention of two q blocks, a chunked CE of two chunks, a Mamba
  scan of two 256-step pieces, MoE groups), and every ``remat`` mode of
  the layer loop against ``'none'``, with the bytes autograd keeps;
- ``make_train_step`` with ``accum`` 1 and 2 (and nemotron's bf16
  accumulation under Adafactor) against the reference's, from the same
  params and optimizer state (``convert.opt_state``);
- mirrors of ``tests/test_arch_smoke.py::test_forward_and_train_step_smoke``
  (ten archs) and ``::test_tiny_model_learns``, and of
  ``tests/test_system.py::TestTrainLoop::test_train_driver_smoke``;
- the CLI at ``--device cpu``, ``supervise`` with ``fail_at_step`` ending
  on the uninterrupted run's final checkpoint bit for bit, and the
  refusals.

Tolerances (float32): a loss within ``tests/_torch_lm_common.py``'s
logits tolerance (scale 10, elementwise); a gradient leaf norm-wise,
max|port - ref| <= atol + rtol max|ref| at ``tolerance_for(float32, 10)``:
the backward runs the forward's products again, transposed, in another
summation order, through up to 8 layers (RWKV's grads reach ~270, so an
elementwise limit would hold its small entries to a few ulp of its
largest).  The layer-level grads at the RECURRENT scale (5).  Remat
modes against 'none' at ``tolerance_for(float32)``: recomputation runs
the same operations on the same values.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_common import (
    LOGITS, RECURRENT, assert_close, jax_batch, leaves, make_batch, ref_params, to_np,
    torch_batch, tree_np, tree_torch,
)
from repro.configs import get_config as ref_config
from repro.launch import cells as ref_cells
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import moe as RM
from repro.models import ssm as RS
from repro.models.api import build_model as ref_build
from repro.runtime.sharding import Shardings as RefShardings
from repro_torch import convert
from repro_torch.checkpoint import latest_step, restore_pytree
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import cells
from repro_torch.launch import train as train_mod
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.models import ssm as TS
from repro_torch.models.api import build_model
from repro_torch.runtime.fault import supervise
from repro_torch.runtime.sharding import P, Shardings
from repro_torch.util import tolerance_for, tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list_archs()
GRAD = tolerance_for(torch.float32, scale=10)
SAME = tolerance_for(torch.float32)
SH = Shardings.none()


def _close_normwise(actual, expected, tol, what):
    a, e = to_np(actual), to_np(expected)
    assert a.shape == e.shape, (what, a.shape, e.shape)
    err = float(np.abs(a - e).max(initial=0.0))
    limit = tol["atol"] + tol["rtol"] * float(np.abs(e).max(initial=0.0))
    assert err <= limit, (what, err, limit)


def _trees_close_normwise(actual, expected, tol, what=""):
    a, e = list(leaves(tree_np(actual))), list(leaves(tree_np(expected)))
    assert [p for p, _ in a] == [p for p, _ in e], what
    for (p, x), (_, y) in zip(a, e):
        _close_normwise(x, y, tol, f"{what} {p}")


@pytest.fixture(scope="module")
def ref_grads():
    return {}


def _grad_case(ref_grads, arch):
    """The reference's reduced model, its parameters, a B=2 S=64 batch and
    its jitted loss and gradients; built once per arch."""
    if arch not in ref_grads:
        rcfg = ref_config(arch).reduced()
        rmodel = ref_build(rcfg)
        rp = ref_params(rmodel)
        batch = make_batch(rcfg, np.random.default_rng(0), B=2, S=64)
        loss, grads = jax.jit(jax.value_and_grad(rmodel.loss))(
            rp, jax_batch(batch))
        ref_grads[arch] = (rp, batch, np.asarray(loss), jax.device_get(grads))
    return ref_grads[arch]


# -- autograd through the models -----------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(ref_grads, arch):
    rp, batch, rloss, rgrads = _grad_case(ref_grads, arch)
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    loss, grads = cells.value_and_grad(
        model, convert.lm_params(rp, cfg, device="cpu"), torch_batch(batch),
        SH)
    np.testing.assert_allclose(to_np(loss), rloss, **LOGITS)
    _trees_close_normwise(grads, rgrads, GRAD, arch)


def test_whisper_loss_backpropagates():
    """``encode`` records for autograd (it ran under inference mode, and
    ``loss.backward`` raised "Inference tensors cannot be saved for
    backward"); the serving entry points still run without recording."""
    cfg = get_config("whisper-base").reduced()
    model = build_model(cfg, device="cpu")
    params = tree_map(lambda p: p.requires_grad_(True), model.init(0))
    batch = torch_batch(make_batch(cfg, np.random.default_rng(1), B=2, S=8))
    loss = model.loss(params, batch)
    loss.backward()
    for leaf in tree_leaves(params):
        assert leaf.grad is not None and torch.isfinite(leaf.grad).all()
    assert float(params["enc_blocks"]["attn"]["wq"].grad.abs().max()) > 0
    logits = model.prefill_logits(params, batch)
    assert logits.is_inference() and not logits.requires_grad


def _layer_grads(fn, tensors):
    """Gradients of ``fn(*tensors)`` (a scalar) with respect to each of
    ``tensors`` (numpy arrays)."""
    ts = [torch.as_tensor(t).requires_grad_(True) for t in tensors]
    return torch.autograd.grad(fn(*ts), ts)


def test_flash_attention_q_blocks_backpropagate_as_the_reference():
    rng = np.random.default_rng(3)
    q = rng.standard_normal((1, 1024, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 1024, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 1024, 2, 16)).astype(np.float32)
    w = rng.standard_normal((1, 1024, 4, 16)).astype(np.float32)

    def ref(q, k, v):
        return jnp.sum(RA.flash_attention(q, k, v, causal=True) * w)

    want = jax.jit(jax.grad(ref, argnums=(0, 1, 2)))(q, k, v)
    got = _layer_grads(lambda q, k, v: torch.sum(
        TA.flash_attention(q, k, v, causal=True) * torch.as_tensor(w)),
        (q, k, v))
    for g, r, name in zip(got, want, "qkv"):
        _close_normwise(g, r, RECURRENT, name)


def test_chunked_ce_backpropagates_as_the_reference():
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 1024, 32)).astype(np.float32)
    table = (rng.standard_normal((32, 64)) * 0.2).astype(np.float32)
    labels = rng.integers(0, 64, (2, 1024)).astype(np.int32)

    def ref(h, t):
        return RL.chunked_softmax_cross_entropy(h, t, jnp.asarray(labels),
                                                z_loss=1e-4)

    want = jax.jit(jax.grad(ref, argnums=(0, 1)))(h, table)
    got = _layer_grads(lambda h, t: TL.chunked_softmax_cross_entropy(
        h, t, torch.as_tensor(labels), z_loss=1e-4), (h, table))
    for g, r, name in zip(got, want, ("hidden", "table")):
        _close_normwise(g, r, RECURRENT, name)


def test_mamba_scan_pieces_backpropagate_as_the_reference():
    """S = 512: two 256-step pieces of ``chunked_scan``, each recomputed."""
    rcfg = RS.MambaConfig(d_state=4, d_conv=4, expand=2, dt_rank=8)
    tcfg = TS.MambaConfig(d_state=4, d_conv=4, expand=2, dt_rank=8)
    p = jax.device_get(RS.mamba_init(jax.random.PRNGKey(6), 32, rcfg,
                                     jnp.float32))
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((1, 512, 32)) * 0.5).astype(np.float32)
    w = rng.standard_normal((1, 512, 32)).astype(np.float32)

    def ref(x, p):
        return jnp.sum(RS.mamba_apply(p, x, rcfg)[0] * w)

    rgx, rgp = jax.jit(jax.grad(ref, argnums=(0, 1)))(x, p)
    tp = tree_map(lambda a: a.requires_grad_(True), tree_torch(p))
    tx = torch.as_tensor(x).requires_grad_(True)
    loss = torch.sum(TS.mamba_apply(tp, tx, tcfg)[0] * torch.as_tensor(w))
    loss.backward()
    _close_normwise(tx.grad, rgx, RECURRENT, "x")
    _trees_close_normwise(tree_map(lambda a: a.grad, tp), rgp, RECURRENT,
                          "params")


def test_moe_groups_backpropagate_as_the_reference():
    """64 tokens in four GShard groups of 16, each group recomputed."""
    cfg = RM.MoEConfig(num_experts=4, top_k=2, group_tokens=16)
    tcfg = TM.MoEConfig(**{f: getattr(cfg, f)
                           for f in cfg.__dataclass_fields__})
    p = jax.device_get(RM.moe_init(jax.random.PRNGKey(1), 32, 64, cfg,
                                   jnp.float32, gated=True))
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 32, 32)).astype(np.float32)
    w = rng.standard_normal((2, 32, 32)).astype(np.float32)

    def ref(x, p):
        out, aux = RM.moe_apply(p, x, cfg, activation="silu")
        return jnp.sum(out * w) + aux

    rgx, rgp = jax.jit(jax.grad(ref, argnums=(0, 1)))(x, p)
    tp = tree_map(lambda a: a.requires_grad_(True), tree_torch(p))
    tx = torch.as_tensor(x).requires_grad_(True)
    out, aux = TM.moe_apply(tp, tx, tcfg, activation="silu")
    (torch.sum(out * torch.as_tensor(w)) + aux).backward()
    _close_normwise(tx.grad, rgx, RECURRENT, "x")
    _trees_close_normwise(tree_map(lambda a: a.grad, tp), rgp, RECURRENT,
                          "params")


def _saved_bytes_and_grads(cfg, params, batch):
    """Loss, grads and the bytes autograd keeps outside the checkpoints."""
    kept = [0]

    def pack(t):
        kept[0] += t.numel() * t.element_size()
        return t

    model = build_model(cfg, device="cpu")
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, grads = cells.value_and_grad(model, params, batch, SH)
    return loss, grads, kept[0]


@pytest.mark.parametrize("mode", ["full", "dots", "group:2"])
@pytest.mark.parametrize("arch", ["smollm-135m", "jamba-v0.1-52b",
                                  "rwkv6-7b"])
def test_remat_modes_match_none(arch, mode):
    """Every remat mode gives 'none''s loss and grads (S = 64: RWKV's
    time mix in 32-step chunks); 'full' keeps fewer bytes for the
    backward than 'none' and 'dots' no more.  'group:2'
    nests the layer checkpoints in groups of two where the stack is one
    layer a step (the hybrid falls back to 'full' per period, as in the
    reference)."""
    base = get_config(arch).reduced()
    params = build_model(base, device="cpu").init(1)
    batch = torch_batch(make_batch(base, np.random.default_rng(2), B=2,
                                   S=64))
    l0, g0, b0 = _saved_bytes_and_grads(
        dataclasses.replace(base, remat="none"), params, batch)
    l1, g1, b1 = _saved_bytes_and_grads(
        dataclasses.replace(base, remat=mode), params, batch)
    np.testing.assert_allclose(to_np(l1), to_np(l0), **SAME)
    _trees_close_normwise(g1, g0, SAME, mode)
    if mode == "dots":
        assert b1 <= b0, (b1, b0)
    else:
        assert b1 < b0, (b1, b0)


# -- the train step ------------------------------------------------------------------


@pytest.mark.parametrize("arch,accum", [("smollm-135m", 1),
                                        ("smollm-135m", 2),
                                        ("nemotron-4-340b", 2)])
def test_make_train_step_matches_reference(arch, accum):
    """Two steps of the reference's jitted train step and the port's, from
    the same params and optimizer state, on the step-keyed batches: loss
    and params agree after each (nemotron: Adafactor, bf16 accumulation,
    'group:8' remat over 2 layers, i.e. 'full')."""
    rcfg, cfg = ref_config(arch).reduced(), get_config(arch).reduced()
    if arch == "nemotron-4-340b":
        assert (cfg.optimizer, cfg.accum_dtype) == ("adafactor", "bfloat16")
    rmodel, model = ref_build(rcfg), build_model(cfg, device="cpu")
    rstep = ref_cells.make_train_step(rmodel, sh=RefShardings.none(),
                                      accum=accum, lr=1e-3)
    step = cells.make_train_step(model, sh=SH, accum=accum, lr=1e-3)
    assert step.optimizer.name == rstep.optimizer.name == cfg.optimizer
    rp = rmodel.init(jax.random.PRNGKey(0))
    rs = rstep.optimizer.init(rp)
    tp = convert.lm_params(jax.device_get(rp), cfg, device="cpu")
    ts = convert.opt_state(jax.device_get(rs), cfg, device="cpu")
    from repro_torch.data import make_source

    src = make_source(cfg, global_batch=4, seq_len=16, seed=0)
    jstep = jax.jit(rstep)
    for i in range(2):
        b = src.get_batch(i)
        rp, rs, rm = jstep(rp, rs, jax_batch(b))
        tp, ts, tm = step(tp, ts, torch_batch(b))
        np.testing.assert_allclose(to_np(tm["loss"]), np.asarray(rm["loss"]),
                                   **LOGITS)
        _trees_close_normwise(tp, jax.device_get(rp), GRAD, f"step {i}")
        assert int(ts["step"]) == int(rs["step"]) == i + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_train_step_smoke(arch):
    """Mirror of the reference's: logits shape, finite; one SGD step
    (loss + grads + sgd) finite, the loss reasonable."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    batch = torch_batch(make_batch(cfg, np.random.default_rng(0), B=2,
                                   S=16))
    logits = model.prefill_logits(params, batch)
    S = 16 + (cfg.img_tokens if cfg.family == "vlm" else 0)
    assert logits.shape == (2, S, cfg.vocab)
    assert torch.isfinite(logits).all()
    loss, g = cells.value_and_grad(model, params, batch, SH)
    params2 = tree_map(lambda w, gw: w - 1e-2 * gw.to(w.dtype), params, g)
    assert torch.isfinite(loss)
    assert 0.0 < float(loss) < 3 * np.log(cfg.vocab)
    assert all(torch.isfinite(x).all() for x in tree_leaves(params2))


def test_tiny_model_learns():
    """Mirror of the reference's: 50 SGD steps on a repeating pattern cut
    the loss below half its first value."""
    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg, device="cpu")
    params = model.init(0)
    toks = torch.tile(torch.arange(16, dtype=torch.int32)[None], (4, 1)) + 5
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    losses = []
    for _ in range(50):
        loss, g = cells.value_and_grad(model, params, batch, SH)
        params = tree_map(lambda w, gw: w - 0.5 * gw.to(w.dtype), params, g)
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])


# -- the training loop -----------------------------------------------------------------


def test_train_driver_smoke():
    """Mirror of ``tests/test_system.py::TestTrainLoop``'s."""
    metrics = train_mod.train_loop(
        arch="smollm-135m", reduced=True, steps=8, global_batch=4,
        seq_len=16, checkpoint_dir=None, log_every=4, device="cpu")
    assert len(metrics) == 8
    assert all(np.isfinite(m["loss"]) for m in metrics)
    assert [m["step"] for m in metrics] == list(range(8))


def _ckpt_leaves(directory):
    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg, device="cpu")
    step = cells.make_train_step(model, sh=SH, accum=1)
    params = model.init(0)
    tree, manifest = restore_pytree(
        {"params": params, "opt": step.optimizer.init(params)}, directory)
    return tree_leaves(tree), manifest["step"]


def test_supervise_fail_at_step_ends_on_the_uninterrupted_checkpoint(
        tmp_path, capsys):
    """A run that fails after step 3 (its checkpoint of step 4 committed)
    and restarts under ``supervise`` ends on the uninterrupted run's final
    checkpoint, bit for bit: the resume restores params and optimizer
    state and the batches are step-keyed."""
    kw = dict(arch="smollm-135m", reduced=True, steps=6, global_batch=2,
              seq_len=8, checkpoint_every=2, log_every=0, device="cpu")
    straight = train_mod.train_loop(checkpoint_dir=str(tmp_path / "a"), **kw)
    attempts = []

    def run(start):
        attempts.append(start)
        return (train_mod.train_loop(checkpoint_dir=str(tmp_path / "b"),
                                     fail_at_step=3, **kw), kw["steps"])[1]

    report = supervise(run, max_restarts=2)
    assert report.restarts == 1 and report.completed_steps == 6
    assert "injected failure" in report.failures[0]
    assert "[train] resumed from step 4" in capsys.readouterr().out
    a, step_a = _ckpt_leaves(str(tmp_path / "a"))
    b, step_b = _ckpt_leaves(str(tmp_path / "b"))
    assert step_a == step_b == 6 == latest_step(str(tmp_path / "b"))
    for x, y in zip(a, b, strict=True):
        assert torch.equal(x, y)
    assert len(straight) == 6


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    rc = train_mod.main([
        "--arch", "smollm-135m", "--reduced", "--steps", "3",
        "--global-batch", "2", "--seq-len", "8", "--checkpoint-dir",
        str(tmp_path), "--checkpoint-every", "2", "--supervise",
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "[train] step 0 loss" in out and "[train] step 2 loss" in out
    assert "[supervisor] done" in out
    assert latest_step(str(tmp_path)) == 3


def test_module_cli_runs_without_jax(tmp_path):
    """``python -m repro_torch.launch.train --device cpu`` trains and
    imports neither jax nor the reference."""
    code = (
        "import runpy, sys\n"
        "sys.argv = ['train', '--arch', 'whisper-base', '--reduced',\n"
        "            '--steps', '2', '--global-batch', '2', '--seq-len', '8',\n"
        "            '--accum', '2', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.train', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               TMPDIR=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "[train] step 1 loss" in res.stdout


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal cannot occur")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.train_loop(arch="smollm-135m", reduced=True, steps=1,
                             global_batch=2, seq_len=8)


def test_mesh_training_is_refused_with_a_roadmap_title():
    """LM sharding is ported (the name is kept): a mesh the world cannot
    hold is refused with ``ValueError``, and on a one-rank gloo world's
    (1, 1) mesh the sharded train step (params by the inferred specs,
    state by ``state_specs``) equals the unsharded one."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import dp_axes_of, make_mesh_for
    from repro_torch.runtime.sharding import infer_param_specs, shard_params

    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg, device="cpu")
    batch = torch_batch(make_batch(cfg, np.random.default_rng(0), B=4, S=8))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="divisible"):
            train_mod.train_loop(arch="smollm-135m", reduced=True, steps=1,
                                 global_batch=2, seq_len=8,
                                 model_parallel=2, device="cpu")
        mesh = make_mesh_for()
        sh = Shardings(mesh=mesh, dp_axes=dp_axes_of(mesh))
        specs = infer_param_specs(model.init(0), mesh)
        step = cells.make_train_step(model, sh=sh, accum=2, param_specs=specs)
        params = shard_params(model.init(0), mesh, specs)
        state = step.optimizer.init(params)
        dbatch = {k: shard_params({"embed": v}, mesh, {"embed": P("data")})
                  ["embed"] for k, v in batch.items()}
        p1, _, m1 = step(params, state, dbatch)
        plain = cells.make_train_step(model, sh=SH, accum=2)
        params0 = model.init(0)
        p0, _, m0 = plain(params0, plain.optimizer.init(params0), batch)
        assert_close(m1["loss"].full_tensor(), m0["loss"], SAME)
        _trees_close_normwise(tree_map(lambda x: x.full_tensor(), p1), p0,
                              GRAD, "params")
    finally:
        dist.destroy_process_group()
