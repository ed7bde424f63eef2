"""(architecture x input-shape) cells of the LM substrate (the counterpart
of ``repro.launch.cells``): the assigned shapes, which cells an
architecture supports, their shardings and input stand-ins, the train
step, the prefill and serve steps, the greedy decode loop, and the cell
assembly the dry-run runs.

Shapes:

- ``train_4k``     seq 4096,   global batch 256  -> train step
- ``prefill_32k``  seq 32768,  global batch 32   -> prefill (serve) step
- ``decode_32k``   cache 32768, global batch 128 -> serve step (1 new token)
- ``long_500k``    cache 524288, batch 1         -> serve step; only for
  sub-quadratic archs (rwkv6, jamba).

Sharding assembly per cell: batch over (pod, data); params FSDP over data
+ TP over model; decode caches sequence-sharded over model (32k) or all
axes (500k) feeding the sequence-sharded flash decode.  The stand-ins of a
cell's inputs are DTensors of fake tensors (``FakeTensorMode``) with the
specs' placements: nothing is allocated (the reference's
``ShapeDtypeStruct`` with a ``NamedSharding``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable
from typing import Any

import torch

from repro_torch.configs import ArchConfig, get_config
from repro_torch.launch.mesh import dp_axes_of
from repro_torch.models.api import Model, build_model, param_shapes
from repro_torch.models.attention import quantize_kv
from repro_torch.optim import get_optimizer, state_specs, warmup_cosine
from repro_torch.runtime import spmd
from repro_torch.runtime.sharding import (
    P,
    Shardings,
    _fit_spec,
    infer_param_specs,
    local_shape,
    map_with_path,
    spec_placements,
    zip_specs,
)
from repro_torch.util import torch_dtype, tree_leaves, tree_map

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def cell_supported(cfg: ArchConfig, shape_name: str) -> tuple[bool, str]:
    info = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "full-attention arch: 500k-token full attention is O(S^2) by "
            "design; cell reserved for SSM/hybrid archs"
        )
    if info["kind"] == "decode" and not cfg.decode_supported:
        return False, "encoder-only arch has no decode step"
    return True, ""


def make_shardings(cfg: ArchConfig, mesh, shape_name: str) -> Shardings:
    dp = dp_axes_of(mesh)
    if SHAPES[shape_name]["kind"] != "decode":
        return Shardings(mesh=mesh, dp_axes=dp, tp_axis="model",
                         fsdp_axis="data")
    if shape_name == "long_500k":
        seq_axes = tuple(mesh.mesh_dim_names)  # all axes: 512-way seq
        dp = ()
    else:
        seq_axes = ("model",)
    return Shardings(
        mesh=mesh, dp_axes=dp, tp_axis="model", fsdp_axis="data",
        cache_seq_axes=seq_axes,
    )


# ---------------------------------------------------------------------------
# input stand-ins (DTensors of fake tensors: never allocated)
# ---------------------------------------------------------------------------


def stand_in(shape, dtype, mesh, spec: P):
    """A DTensor of ``shape`` and ``dtype`` with ``spec``'s placements on
    ``mesh`` whose local shard is made by the tensor mode in force (a fake
    tensor under ``FakeTensorMode``).  ``spec`` is taken as given: where
    its axes do not divide a dim, this rank's shard is a short one
    (:func:`~repro_torch.runtime.sharding.local_shape`)."""
    from torch.distributed.tensor import DTensor

    local = torch.empty(local_shape(shape, spec, mesh), dtype=dtype)
    return DTensor.from_local(local, mesh, spec_placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


def batch_specs(cfg: ArchConfig, mesh, shape_name: str, *,
                batch: int | None = None) -> dict[str, Any]:
    """Stand-ins for the data batch of a cell (under a ``FakeTensorMode``);
    ``batch`` replaces the shape's global batch (the dry-run's traces of
    fewer microbatches)."""
    info = SHAPES[shape_name]
    b, s = batch or info["batch"], info["seq"]
    dp = dp_axes_of(mesh)
    dspec = P(dp)
    out: dict[str, Any] = {}
    i32, bf16 = torch.int32, torch.bfloat16
    if info["kind"] in ("train", "prefill"):
        s_tok = s - (cfg.img_tokens if cfg.family == "vlm" else 0)
        out["tokens"] = stand_in((b, s_tok), i32, mesh, dspec)
        if info["kind"] == "train":
            out["labels"] = stand_in((b, s_tok), i32, mesh, dspec)
        if cfg.family == "encdec":
            out["frames"] = stand_in((b, s, cfg.d_model), bf16, mesh,
                                     P(dp, None, None))
            # decoder operates on a standard 448-token transcript window
            out["tokens"] = stand_in((b, 448), i32, mesh, dspec)
            if info["kind"] == "train":
                out["labels"] = stand_in((b, 448), i32, mesh, dspec)
        if cfg.family == "vlm":
            out["patches"] = stand_in((b, cfg.img_tokens, cfg.d_model), bf16,
                                      mesh, P(dp, None, None))
    else:  # decode
        bspec = dspec if b > 1 else P(None)
        out["token"] = stand_in((b,), i32, mesh, bspec)
    return out


def param_specs_tree(model: Model, mesh):
    """The param tree's shapes (``model.init`` on the ``'meta'`` device, in
    place of the reference's ``eval_shape``: nothing allocated) and their
    inferred specs."""
    shapes = param_shapes(model.cfg)
    return shapes, infer_param_specs(shapes, mesh)


def _cache_spec_for(name: str, leaf, sh: Shardings, mesh) -> P:
    """Spec for a decode-cache leaf by name (see init_cache layouts)."""
    dp = sh.dp_axes if sh.dp_axes else None
    seq = sh.cache_seq_axes if sh.cache_seq_axes else None
    if name.endswith(("k", "v")) and leaf.ndim == 5:  # (steps,B,KV,S,hd)
        spec = P(None, dp, None, seq, None)
    elif name.endswith(("k_s", "v_s")) and leaf.ndim == 4:  # (steps,B,KV,S)
        spec = P(None, dp, None, seq)
    elif name.endswith("conv"):  # (steps,B,k,din)
        spec = P(None, dp, None, "model")
    elif name.endswith("h"):  # (steps,B,din,state)
        spec = P(None, dp, "model", None)
    elif name.endswith(("x_tm", "x_cm")):  # (steps,B,D)
        spec = P(None, dp, "model")
    elif name.endswith("wkv"):  # (steps,B,H,hd,hd)
        spec = P(None, dp, "model", None, None)
    elif name.endswith(("xk", "xv")):  # (L,B,T,KV,hd) whisper cross
        spec = P(None, dp, None, None, None)
    else:
        spec = P()
    return _fit_spec(spec, leaf.ndim, tuple(leaf.shape), mesh)


def cache_specs_tree(model: Model, sh: Shardings, batch: int, seq: int):
    """The decode cache's shapes (``init_cache`` on the ``'meta'``
    device) and their specs."""
    shapes = build_model(model.cfg, device="meta").init_cache(batch, seq)
    return shapes, map_with_path(
        lambda name, leaf: _cache_spec_for(name, leaf, sh, sh.mesh), shapes)


def value_and_grad(model: Model, params, batch, sh: Shardings):
    """``(loss, grads)`` of ``model.loss`` at ``params``: the loss detached,
    the grads a tree of the params' layout and dtypes (zeros for a leaf
    the loss does not reach), by ``torch.autograd.grad``.  On DTensors the
    loss is replicated first, and the backward runs under the handle's
    scope (it recomputes checkpointed model code)."""
    from torch.distributed.tensor import Replicate

    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    loss = model.loss(tree_map(lambda _: next(it), params), batch, sh)
    if spmd.is_dtensor(loss):
        loss = loss.redistribute(loss.device_mesh,
                                 [Replicate()] * loss.device_mesh.ndim)
    with sh.scope():
        grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True,
                                         materialize_grads=True))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(
    model: Model,
    *,
    sh: Shardings,
    accum: int | None = None,
    lr: float = 3e-4,
    param_specs=None,
    donate: bool = False,
) -> Callable:
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    Gradient accumulation: the global batch is split into ``accum``
    microbatches (contiguous slices of the batch's rows), each one's
    gradient added into a buffer of ``cfg.accum_dtype``, which is divided
    by ``accum`` in float32; the loss is the microbatches' mean.  Then the
    config's optimizer with ``warmup_cosine(lr)``; with ``donate`` the
    step updates the params and state it is given in place and returns
    them (the reference's jit with ``donate_argnums=(0, 1)``).

    With ``param_specs`` (and a handle with a mesh) the params are
    DTensors of those specs: the grads and the accumulation buffer are
    redistributed to the params' placements (a reduce-scatter of each
    grad's partial sums), as the reference constrains them; the optimizer
    state is sharded as :func:`repro_torch.optim.state_specs` gives."""
    cfg = model.cfg
    accum = accum if accum is not None else cfg.grad_accum_train4k
    opt = get_optimizer(cfg.optimizer, warmup_cosine(lr))

    def like_params(tree):
        if param_specs is None or sh.mesh is None:
            return tree
        return zip_specs(lambda x, s: x.redistribute(
            sh.mesh, spec_placements(s, sh.mesh)), tree, param_specs)

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, grads = value_and_grad(model, params, batch, sh)
            grads = like_params(grads)
        else:
            adt = torch_dtype(cfg.accum_dtype)
            n = next(iter(batch.values())).shape[0] // accum
            gsum = tree_map(lambda p: torch.zeros_like(p, dtype=adt), params)
            lsum = 0.0
            for i in range(accum):
                mbatch = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                l, g = value_and_grad(model, params, mbatch, sh)
                tree_map(lambda a, x: a.add_(x.to(adt)), gsum,
                         like_params(g))
                lsum = lsum + l
                del g  # freed before the next microbatch's backward
            # in place on the buffer (a float32 buffer is the grads)
            grads = tree_map(lambda g: g.float().div_(accum), gsum)
            loss = lsum / accum
        params, opt_state = opt.update(grads, opt_state, params,
                                       donate=donate)
        return params, opt_state, {"loss": loss}

    train_step.optimizer = opt
    return train_step


def make_prefill_step(model: Model, *, sh: Shardings) -> Callable:
    def prefill_step(params, batch):
        return model.prefill_serve(params, batch, sh)

    return prefill_step


def cache_from_prefill(model: Model, cache, kvs):
    """Write ``prefill_serve``'s K/V into a decode cache, in place, so that
    a batched prompt is served from one prefill.

    ``kvs`` is ``(k, v)``, each ``(steps, B, S, KV, hd)``; the cache is
    ``model.init_cache``'s ``(steps, B, KV, S_max, hd)``, int8 values and
    ``(steps, B, KV, S_max)`` scales through ``quantize_kv`` where
    ``cache_dtype='int8'``.  For the attention families (dense, moe, vlm);
    the recurrent and encoder-decoder families rebuild their state through
    the decode step, as ``greedy_generate`` does."""
    cfg = model.cfg
    if cfg.family not in ("dense", "moe", "vlm"):
        raise ValueError(f"{cfg.family!r} caches are rebuilt through the "
                         "decode step, not filled from the prefill's K/V")
    k, v = kvs
    steps, b, s, kvh, hd = k.shape
    with torch.no_grad():
        for name, x in (("k", k), ("v", v)):
            if cfg.cache_dtype == "int8":
                q, sc = quantize_kv(x.reshape(steps * b, s, kvh, hd))
                cache[name][..., :s, :] = q.reshape(steps, b, kvh, s, hd)
                cache[name + "_s"][..., :s] = sc.reshape(steps, b, kvh, s)
            else:
                cache[name][..., :s, :] = x.transpose(2, 3).to(
                    cache[name].dtype)
    return cache


def make_serve_step(model: Model, *, sh: Shardings) -> Callable:
    """One decode iteration: greedy-sample the next token, update the cache
    (in place).  The token stays on the device."""

    def serve_step(params, cache, token, pos):
        logits, new_cache = model.decode(params, token, pos, cache, sh)
        if spmd.is_dtensor(logits):  # each rank's rows, the vocab whole
            logits = logits.redistribute(logits.device_mesh, spmd.placements_of(
                logits.device_mesh,
                **{a: 0 for a in spmd.sharded_axes(logits, 0)}))
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_token, new_cache

    return serve_step


def greedy_generate(
    *,
    arch: str | ArchConfig,
    prompt_tokens,
    max_new_tokens: int = 16,
    reduced: bool = False,
    seed: int = 0,
    params=None,
    device="cuda",
) -> list[int]:
    """Prefill + greedy decode with KV caches: the LM decode loop.

    The prompt runs token by token through the decode step (a chunked
    prefill that is state-exact for every family), then ``max_new_tokens``
    greedy tokens follow; each step's token is read on the host.  Without
    ``params`` the weights are random from ``seed`` (a ``torch.Generator``
    on ``device``, so not the reference's weights for the same seed).
    ``arch`` is a name, as in the reference, or an :class:`ArchConfig`
    used as it is (a published config cut in depth, for example)."""
    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, device=device)
    dev = model.device
    if params is None:
        params = model.init(seed)
    sh = Shardings.none()

    toks = [int(t) for t in prompt_tokens]
    max_seq = len(toks) + max_new_tokens + 1
    cache = model.init_cache(1, max_seq)

    if cfg.family == "encdec":
        from repro_torch.models import encdec as em

        frames = torch.zeros((1, cfg.enc_seq, cfg.d_model),
                             dtype=torch.float32, device=dev)
        with torch.inference_mode():
            enc = em.encode(params, cfg, frames, sh)
            xk, xv = em.prefill_cross(params, cfg, enc)
        cache = dict(cache, xk=xk, xv=xv)

    def step(t, i, c):
        return model.decode(params, torch.tensor([t], dtype=torch.int32,
                                                 device=dev), i, c, sh)

    # chunked prefill through the decode path (state-exact for all families)
    logits = None
    for i, t in enumerate(toks):
        logits, cache = step(t, i, cache)

    out = list(toks)
    for j in range(max_new_tokens):
        nxt = int(torch.argmax(logits, dim=-1)[0])
        out.append(nxt)
        logits, cache = step(nxt, len(toks) + j, cache)
    return out


# ---------------------------------------------------------------------------
# cell assembly for the dry-run
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    step_fn: Callable
    args: tuple  # the stand-ins the step runs on
    donate: tuple[int, ...]
    model: Model
    sh: Shardings
    mode: Any  # the FakeTensorMode the stand-ins belong to


def build_cell(arch: str | ArchConfig, shape_name: str, mesh, *,
               lr=3e-4, batch: int | None = None) -> Cell:
    """The step and input stand-ins of one cell on ``mesh``.  Run the step
    under ``cell.mode``: ``with cell.mode: cell.step_fn(*cell.args)``.
    ``arch`` is a name or an :class:`ArchConfig` (a config cut in depth);
    ``batch`` replaces the shape's global batch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = arch if isinstance(arch, ArchConfig) else get_config(arch)
    ok, why = cell_supported(cfg, shape_name)
    if not ok:
        raise ValueError(f"cell ({cfg.name}, {shape_name}) unsupported: "
                         f"{why}")
    dev = "cuda" if mesh.device_type == "cuda" else "cpu"
    model = build_model(cfg, device=dev)
    sh = make_shardings(cfg, mesh, shape_name)
    info = SHAPES[shape_name]
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    name = arch if isinstance(arch, str) else cfg.name

    def stand_ins(shapes, specs):
        return zip_specs(lambda x, s: stand_in(tuple(x.shape), x.dtype, mesh,
                                               s), shapes, specs)

    with mode:
        pshapes, pspecs = param_specs_tree(model, mesh)
        params = stand_ins(pshapes, pspecs)
        bspecs = batch_specs(cfg, mesh, shape_name, batch=batch)
        if info["kind"] == "train":
            step = make_train_step(model, sh=sh, lr=lr, param_specs=pspecs,
                                   donate=True)
            oshapes = step.optimizer.init(pshapes)
            ospecs = zip_specs(
                lambda x, sp: _fit_spec(sp, x.ndim, tuple(x.shape), mesh),
                oshapes, state_specs(cfg.optimizer, pspecs, pshapes))
            ostate = stand_ins(oshapes, ospecs)
            return Cell(name, shape_name, step, (params, ostate, bspecs),
                        donate=(0, 1), model=model, sh=sh, mode=mode)
        if info["kind"] == "prefill":
            step = make_prefill_step(model, sh=sh)
            return Cell(name, shape_name, step, (params, bspecs), donate=(),
                        model=model, sh=sh, mode=mode)
        # decode: the last position of the cache (every slice of S scored)
        step = make_serve_step(model, sh=sh)
        cshapes, cspecs = cache_specs_tree(model, sh, batch or info["batch"],
                                           info["seq"])
        cache = stand_ins(cshapes, cspecs)
        return Cell(name, shape_name, step,
                    (params, cache, bspecs["token"], info["seq"] - 1),
                    donate=(1,), model=model, sh=sh, mode=mode)
