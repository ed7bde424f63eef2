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
import math

import torch
import torch.nn.functional as F

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


def dense_init(rng: ParamRNG, d_in: int, d_out: int, dtype, *,
               std: float | None = None):
    std = (d_in**-0.5) if std is None else std
    return rng.trunc_normal((d_in, d_out), std, dtype)


def stack_trees(trees: list):
    """Stack a list of equally shaped trees leaf by leaf along a new leading
    axis (the reference's ``jax.tree.map(lambda *xs: jnp.stack(xs), ...)``)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


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
    up = x @ params["w_up"]
    if activation == "silu":
        h = F.silu(x @ params["w_gate"]) * up
    elif activation == "gelu":
        h = F.gelu(up, approximate="tanh")
    elif activation == "relu2":
        h = torch.square(F.relu(up))
    elif activation == "relu":
        h = F.relu(up)
    else:
        raise ValueError(f"unknown activation {activation!r}")
    return h @ params["w_down"]


# -- embeddings / unembedding ---------------------------------------------------


def embed_init(rng: ParamRNG, vocab: int, d: int, dtype):
    return rng.trunc_normal((vocab, d), d**-0.5, dtype)


def embed_lookup(table, tokens):
    """Rows of ``table`` at ``tokens``.  The reference multiplies a one-hot
    by the table (its vocab-sharded form); with one 1 and zeros a row, that
    product is the row exactly, so a gather gives the same values."""
    return F.embedding(tokens.long(), table)


def unembed_logits(x, table):
    """Tied or untied output projection: (..., d) @ (V, d)^T."""
    return x @ table.transpose(0, 1)


def chunked_softmax_cross_entropy(
    hidden, table, labels, *, z_loss: float = 0.0, chunk: int = 512,
    transpose_table: bool = False,
):
    """Mean CE over sequence chunks without materialising (B, S, V) logits
    (value only: the reference's ``jax.checkpoint`` shapes its backward).

    ``hidden``: (B, S, D); ``table``: (D, V) (or (V, D) with
    ``transpose_table`` for tied embeddings)."""
    b, s, d = hidden.shape

    def logits_of(h):
        return unembed_logits(h, table) if transpose_table else h @ table

    if s % chunk:
        return softmax_cross_entropy(logits_of(hidden), labels,
                                     z_loss=z_loss)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(s // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        tot = tot + softmax_cross_entropy(
            logits_of(hidden[:, sl]), labels[:, sl], z_loss=z_loss).sum()
    return tot / (b * s)


def softmax_cross_entropy(logits, labels, *, z_loss: float = 0.0):
    """Per-token loss: logsumexp minus the label's logit (picked by an
    index compare, as the reference's vocab-parallel form)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    iota = torch.arange(lf.shape[-1], device=lf.device)
    label_logit = torch.sum(
        torch.where(iota == labels[..., None], lf, 0.0), dim=-1
    )
    loss = lse - label_logit
    if z_loss:
        loss = loss + z_loss * torch.square(lse)
    return loss
