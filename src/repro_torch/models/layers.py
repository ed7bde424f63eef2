"""Shared neural-net layers of the LM substrate (the counterpart of
``repro.models.layers``).

Parameters are plain trees (nested dicts, lists and tuples of tensors).
Every init function takes a :class:`ParamRNG` (a ``torch.Generator`` on the
device the parameters are made on) where the reference takes a
``jax.random`` key, and draws from the reference's distributions; apply
functions are pure functions of tensors.  Layer stacks keep the reference's
leading layer axis, and the models index it in a Python loop where the
reference scans it.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.runtime import spmd
from repro_torch.util import resolve_device, torch_dtype


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    """Mixed-precision policy: bf16 params/compute, f32 softmax/norms."""

    params: str = "bfloat16"
    compute: str = "bfloat16"
    norm: str = "float32"

    @property
    def pdt(self) -> torch.dtype:
        return torch_dtype(self.params)

    @property
    def cdt(self) -> torch.dtype:
        return torch_dtype(self.compute)


class ParamRNG:
    """The random source of an init, in place of the reference's PRNGKey.

    ``ParamRNG(seed, device)`` seeds a ``torch.Generator`` on ``device``
    (``'cuda'`` by default, which raises on a host without a card; pass
    ``device='cpu'`` for the CPU); ``ParamRNG(generator, device)`` draws
    from the caller's generator, which must live on ``device``.  On the
    ``'meta'`` device it makes shapes and dtypes only (no generator), which
    is how a parameter tree's layout is read without allocating it."""

    def __init__(self, seed_or_generator: int | torch.Generator = 0,
                 device="cuda"):
        meta = str(device) == "meta"
        dev = torch.device("meta") if meta else resolve_device(device)
        if isinstance(seed_or_generator, torch.Generator):
            gen_dev = seed_or_generator.device
            if dev.type != gen_dev.type:
                raise ValueError(f"a generator on {gen_dev} cannot make "
                                 f"parameters on {device}")
            self.gen = seed_or_generator
            self.device = gen_dev
            return
        self.device = dev
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(int(seed_or_generator))

    def _f32(self, shape) -> torch.Tensor:
        return torch.empty(shape, dtype=torch.float32, device=self.device)

    def trunc_normal(self, shape, std: float, dtype) -> torch.Tensor:
        """``std`` times a standard normal truncated to [-2, 2], as
        ``repro.models.layers.trunc_normal``."""
        t = self._f32(shape)
        if self.gen is not None:
            torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                        generator=self.gen)
        return t.mul_(std).to(dtype)

    def normal(self, shape, dtype) -> torch.Tensor:
        """A standard normal cast to ``dtype``."""
        t = self._f32(shape)
        if self.gen is not None:
            t.normal_(generator=self.gen)
        return t.to(dtype)

    def zeros(self, shape, dtype) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def ones(self, shape, dtype) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype, device=self.device)

    def full(self, shape, value: float, dtype) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)


def matmul(x, w):
    """``x @ w`` for a weight matrix ``w`` (d_in, d_out).  On DTensors the
    product is placed as Megatron and ZeRO-3 place it: ``x``'s batch rows
    stay on their ranks; a weight sharded along d_out over non-batch axes
    is column-parallel (``x`` whole along d_in, the output sharded along
    d_out), one sharded along d_in is row-parallel (``x`` sharded along
    d_in, the output a ``Partial`` sum), and whatever else shards the
    weight (the FSDP axis) is gathered for the product."""
    if not spmd.is_dtensor(w):
        return x @ w
    mesh = w.device_mesh
    bat = spmd.sharded_axes(x, 0) if spmd.is_dtensor(x) else ()
    col = tuple(a for a in spmd.sharded_axes(w, 1) if a not in bat)
    row = () if col else tuple(
        a for a in spmd.sharded_axes(w, 0) if a not in bat)
    last = x.ndim - 1
    rows = {a: 0 for a in bat}
    w_pl = spmd.placements_of(mesh, **{a: 1 for a in col},
                              **{a: 0 for a in row})
    w_grad = spmd.placements_of(mesh, **{a: 1 for a in col},
                                **{a: 0 for a in row},
                                **{a: "P" for a in bat})
    x_pl = spmd.placements_of(mesh, **rows, **{a: last for a in row})
    x_grad = spmd.placements_of(mesh, **rows, **{a: "P" for a in col},
                                **{a: last for a in row})
    out_pl = spmd.placements_of(mesh, **rows, **{a: last for a in col},
                                **{a: "P" for a in row})
    return spmd.local_call(torch.matmul, mesh, (x, w), (x_pl, w_pl), out_pl,
                           (x_grad, w_grad))


def split_heads(x, h: int, hd: int):
    """``x`` (..., h * hd) as (..., h, hd).  On a DTensor whose last dim is
    sharded over axes that do not divide ``h`` (a head would straddle two
    ranks), those axes are gathered first."""
    if spmd.is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard

        last = x.ndim - 1
        if h % spmd.axes_size(x.device_mesh, spmd.sharded_axes(x, last)):
            x = x.redistribute(x.device_mesh, [
                Replicate() if isinstance(p, Shard) and p.dim % x.ndim == last
                else p for p in x.placements])
    return x.reshape(*x.shape[:-1], h, hd)


def dense_init(rng: ParamRNG, d_in: int, d_out: int, dtype, *,
               std: float | None = None):
    std = (d_in**-0.5) if std is None else std
    return rng.trunc_normal((d_in, d_out), std, dtype)


def _save_mm(ctx, op, *args, **kwargs):
    """'dots': keep the outputs of the unbatched products (``aten.mm``,
    which ``x @ W`` folds to), recompute the rest, the batched ``bmm``s of
    attention included."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_DOTS = functools.partial(create_selective_checkpoint_contexts, _save_mm)


def remat(fn, *args, policy: str = "full"):
    """``fn(*args)`` under the reference's ``jax.checkpoint``: while
    autograd records, the backward recomputes what ``fn`` computed instead
    of keeping it (``policy='dots'``: all but the unbatched products, the
    counterpart of ``checkpoint_dots_with_no_batch_dims``).  Values and
    gradients are those of the plain call, which is what runs when nothing
    is recorded (serving, ``torch.no_grad``)."""
    if not torch.is_grad_enabled():
        return fn(*args)
    kw = {"context_fn": _DOTS} if policy == "dots" else {}
    # the models draw no random numbers, so no RNG state is kept
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def serving(fn):
    """Run ``fn`` without autograd: under ``torch.inference_mode()``, or
    ``torch.no_grad()`` when its first argument (the params) holds DTensors
    (DTensor's views cannot be made of inference tensors)."""

    @functools.wraps(fn)
    def run(*args, **kwargs):
        first = args[0] if args else None
        while isinstance(first, (dict, list, tuple)) and first:
            first = (next(iter(first.values())) if isinstance(first, dict)
                     else first[0])
        ctx = torch.no_grad if spmd.is_dtensor(first) else \
            torch.inference_mode
        with ctx():
            return fn(*args, **kwargs)

    return run


def stack_trees(trees: list):
    """Stack a list of equally shaped trees leaf by leaf along a new leading
    axis (the reference's ``jax.tree.map(lambda *xs: jnp.stack(xs), ...)``)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def unstack_tree(tree) -> list:
    """A stacked tree as the list of its steps (views, by ``torch.unbind``,
    whose backward stacks the steps' gradients once, where indexing each
    step would add a zero-filled stack per step)."""
    if isinstance(tree, dict):
        cols = {k: unstack_tree(v) for k, v in tree.items()}
        n = len(next(iter(cols.values())))
        return [{k: c[i] for k, c in cols.items()} for i in range(n)]
    return list(torch.unbind(tree))


# -- norms -------------------------------------------------------------------


def rmsnorm_init(rng: ParamRNG, d: int, dtype):
    return {"scale": rng.ones((d,), dtype)}


def rmsnorm(params, x, *, eps: float = 1e-6):
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def layernorm_init(rng: ParamRNG, d: int, dtype):
    return {"scale": rng.ones((d,), dtype), "bias": rng.zeros((d,), dtype)}


def layernorm(params, x, *, eps: float = 1e-5):
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(dt)


# -- rotary position embedding -------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10000.0, *, device=None):
    return 1.0 / (
        theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                               device=device) / head_dim)
    )


def apply_rope(x, positions, *, theta: float = 10000.0):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)  # (hd/2,)
    ang = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, d: int, dtype=torch.float32, *,
                         device=None):
    """Whisper-style fixed sinusoidal embeddings (S, d)."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    inv = torch.exp(-math.log(10000.0) * dim / (d // 2 - 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# -- MLP ----------------------------------------------------------------------


def mlp_init(rng: ParamRNG, d: int, d_ff: int, dtype, *, gated: bool):
    p = {
        "w_up": dense_init(rng, d, d_ff, dtype),
        "w_down": dense_init(rng, d_ff, d, dtype),
    }
    if gated:
        p["w_gate"] = dense_init(rng, d, d_ff, dtype)
    return p


def mlp_apply(params, x, *, activation: str):
    """activation: 'silu' (gated SwiGLU), 'gelu' (tanh approximation, as
    ``jax.nn.gelu``), 'relu2' (squared ReLU, Nemotron-4), 'relu'.  Leaves
    with leading expert axes apply per expert (batched products)."""
    up = matmul(x, params["w_up"])
    if activation == "silu":
        h = F.silu(matmul(x, params["w_gate"])) * up
    elif activation == "gelu":
        h = F.gelu(up, approximate="tanh")
    elif activation == "relu2":
        h = torch.square(F.relu(up))
    elif activation == "relu":
        h = F.relu(up)
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return matmul(h, params["w_down"])


# -- embeddings / unembedding ---------------------------------------------------


def embed_init(rng: ParamRNG, vocab: int, d: int, dtype):
    return rng.trunc_normal((vocab, d), d**-0.5, dtype)


def embed_lookup(table, tokens):
    """Rows of ``table`` at ``tokens``.  The reference multiplies a one-hot
    by the table (its vocab-sharded form); with one 1 and zeros a row, that
    product is the row exactly, so a gather gives the same values.  On a
    DTensor table each rank looks up the rows of its vocab shard and the
    sum over the vocab axes (a ``Partial`` output) is the lookup."""
    if spmd.is_dtensor(table):
        return _embed_lookup_sharded(table, tokens)
    return F.embedding(tokens.long(), table)


def _vocab_axes(x, dim: int, other=None) -> tuple[str, ...]:
    """The axes over which ``x`` shards its vocab dim ``dim``, less those
    sharding ``other``'s batch (dim 0)."""
    taken = spmd.sharded_axes(other, 0) if spmd.is_dtensor(other) else ()
    return tuple(a for a in spmd.sharded_axes(x, dim) if a not in taken)


def _embed_lookup_sharded(table, tokens):
    mesh = table.device_mesh
    bat = spmd.sharded_axes(tokens, 0) if spmd.is_dtensor(tokens) else ()
    voc = _vocab_axes(table, 0, tokens)
    v_loc = table.shape[0] // spmd.axes_size(mesh, voc)
    start = spmd.shard_index(mesh, voc) * v_loc
    tok_pl = spmd.placements_of(mesh, **{a: 0 for a in bat})
    tab_pl = spmd.placements_of(mesh, **{a: 0 for a in voc})
    tab_grad = spmd.placements_of(mesh, **{a: 0 for a in voc},
                                  **{a: "P" for a in bat})
    out_pl = spmd.placements_of(mesh, **{a: 0 for a in bat},
                                **{a: "P" for a in voc})

    def local(tab, tok):
        idx = tok.long() - start
        hit = (idx >= 0) & (idx < v_loc)
        rows = F.embedding(torch.where(hit, idx, 0), tab)
        return rows * hit[..., None].to(rows.dtype)

    return spmd.local_call(local, mesh, (table, tokens), (tab_pl, tok_pl),
                           out_pl, (tab_grad, None))


def unembed_logits(x, table):
    """Tied or untied output projection: (..., d) @ (V, d)^T."""
    return matmul(x, table.transpose(0, 1))


def chunked_softmax_cross_entropy(
    hidden, table, labels, *, z_loss: float = 0.0, chunk: int = 512,
    transpose_table: bool = False,
):
    """Mean CE over sequence chunks without materialising (B, S, V) logits.

    ``hidden``: (B, S, D); ``table``: (D, V) (or (V, D) with
    ``transpose_table`` for tied embeddings).  Each chunk's logits are
    reduced to its per-token loss and dropped; :func:`remat` makes the
    backward recompute them chunk by chunk, as the reference's
    ``jax.checkpoint`` does."""
    b, s, d = hidden.shape

    def logits_of(h):
        return (unembed_logits(h, table) if transpose_table
                else matmul(h, table))

    if s % chunk:
        return softmax_cross_entropy(logits_of(hidden), labels,
                                     z_loss=z_loss)

    def one(h, lab):
        return softmax_cross_entropy(logits_of(h), lab, z_loss=z_loss)

    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(s // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        tot = tot + remat(one, hidden[:, sl], labels[:, sl]).sum()
    return tot / (b * s)


def softmax_cross_entropy(logits, labels, *, z_loss: float = 0.0):
    """Per-token loss: logsumexp minus the label's logit (picked by an
    index compare, as the reference's vocab-parallel form).  On DTensor
    logits each rank reduces its vocab shard: the max by an all-reduce
    MAX, the sum of exponentials and the label's logit by all-reduce SUMs,
    as XLA partitions the reference's."""

    def terms(x, lab, mx, start):
        lf = x.float()
        se = torch.exp(lf - mx[..., None]).sum(dim=-1)
        iota = torch.arange(lf.shape[-1], device=lf.device) + start
        hit = torch.where(iota == lab[..., None].long(), lf, 0.0).sum(dim=-1)
        return se, hit

    # the max only steadies the exponentials: no gradient flows through it
    if spmd.is_dtensor(logits):
        mx, se, label_logit = _cross_entropy_sharded(logits, labels, terms)
    else:
        mx = logits.detach().float().amax(dim=-1)
        se, label_logit = terms(logits, labels, mx, 0)
    lse = mx + torch.log(se)
    loss = lse - label_logit
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss


def _cross_entropy_sharded(logits, labels, terms):
    """:func:`softmax_cross_entropy`'s max, sum of exponentials and label
    logit of DTensor logits, each rank's terms from its vocab shard."""
    mesh = logits.device_mesh
    bat = spmd.sharded_axes(logits, 0)
    voc = _vocab_axes(logits, logits.ndim - 1, logits)
    start = spmd.shard_index(mesh, voc) * (
        logits.shape[-1] // spmd.axes_size(mesh, voc))
    x_pl = spmd.placements_of(mesh, **{a: 0 for a in bat},
                              **{a: logits.ndim - 1 for a in voc})
    row_pl = spmd.placements_of(mesh, **{a: 0 for a in bat})
    with torch.no_grad():
        mx = spmd.local_call(
            lambda x: x.float().amax(dim=-1), mesh, (logits.detach(),),
            (x_pl,), spmd.placements_of(mesh, **{a: 0 for a in bat},
                                        **{a: "P:max" for a in voc}))
        mx = mx.redistribute(mesh, row_pl)
    part = spmd.placements_of(mesh, **{a: 0 for a in bat},
                              **{a: "P" for a in voc})
    se, hit = spmd.local_call(
        lambda x, lab, m: terms(x, lab, m, start), mesh, (logits, labels, mx),
        (x_pl, row_pl, row_pl), (part, part))
    return mx, se.redistribute(mesh, row_pl), hit.redistribute(mesh, row_pl)
