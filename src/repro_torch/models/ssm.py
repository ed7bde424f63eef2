"""State-space / linear-attention blocks of the LM substrate (the
counterpart of ``repro.models.ssm``): RWKV6 ("Finch") and Mamba.

Both run in their recurrent form, a Python loop over time on the host (the
reference scans it), carrying the state in float32; RWKV6's WKV also has
the reference's exact chunkwise-parallel form for prompts of more than one
32-step chunk.  Decode carries O(1) state.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    ParamRNG, dense_init, matmul, remat, rmsnorm, rmsnorm_init, split_heads,
)
from repro_torch.runtime import spmd


_TIME_CHUNK = 256


def _scan(step, carry, xs):
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(x[t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_scan(step, init, xs, *, chunk: int = _TIME_CHUNK,
                 max_pieces: int | None = None):
    """``lax.scan`` over the leading (time) axis of the tensors in ``xs``:
    ``carry, y_t = step(carry, x_t)``, returning the final carry and the
    stacked ``y``.  Scans of more than ``chunk`` steps that it divides run
    in ``chunk``-step pieces under :func:`remat`, as the reference's: the
    backward keeps only the carry at the pieces' boundaries and recomputes
    each piece, instead of keeping every step's residuals.

    ``max_pieces`` (by default that of :func:`traced_pieces`' scope, else
    every piece) runs only the first pieces and repeats the last one's
    outputs for the rest: the pieces do identical work, so a cost trace of
    ``k`` pieces scales by the trip count; the values are then not the
    scan's."""
    if max_pieces is None:
        max_pieces = _MAX_PIECES.get()
    S = xs[0].shape[0]
    if S <= chunk or S % chunk:
        return _scan(step, init, xs)
    n = S // chunk
    carry, ys = init, []
    for c in range(n if max_pieces is None else min(max_pieces, n)):
        piece = tuple(x[c * chunk:(c + 1) * chunk] for x in xs)
        carry, y = remat(_scan, step, carry, piece)
        ys.append(y)
    return carry, torch.cat(ys + ys[-1:] * (n - len(ys)))


_MAX_PIECES: contextvars.ContextVar[int | None] = contextvars.ContextVar(
    "max_pieces", default=None)


@contextlib.contextmanager
def traced_pieces(k: int | None):
    """The scope in which :func:`chunked_scan` runs at most ``k`` pieces
    (None: every piece), for cost traces that scale a scan by its trip
    count."""
    token = _MAX_PIECES.set(k)
    try:
        yield
    finally:
        _MAX_PIECES.reset(token)


# ---------------------------------------------------------------------------
# RWKV6 (Finch) — data-dependent token-shift and decay (arXiv:2404.05892)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    lora_mix: int = 32  # rank of the ddlerp LoRA
    lora_decay: int = 64  # rank of the decay LoRA


def rwkv_time_mix_init(rng: ParamRNG, d: int, cfg: RWKVConfig, dtype):
    hd = cfg.head_dim
    n_heads = d // hd
    return {
        "mu_x": rng.zeros((d,), dtype),
        "mu": rng.zeros((5, d), dtype),
        "lora_a": dense_init(rng, d, 5 * cfg.lora_mix, dtype, std=0.02),
        "lora_b": rng.zeros((5, cfg.lora_mix, d), dtype),
        "w_r": dense_init(rng, d, d, dtype),
        "w_k": dense_init(rng, d, d, dtype),
        "w_v": dense_init(rng, d, d, dtype),
        "w_g": dense_init(rng, d, d, dtype),
        "w_o": dense_init(rng, d, d, dtype),
        "decay_base": rng.full((d,), -6.0, dtype),  # w0: slow decay at init
        "decay_a": dense_init(rng, d, cfg.lora_decay, dtype, std=0.02),
        "decay_b": rng.zeros((cfg.lora_decay, d), dtype),
        "bonus": rng.zeros((n_heads, hd), dtype),  # u ("first token bonus")
        "ln_out": rmsnorm_init(rng, d, dtype),
    }


def rwkv_channel_mix_init(rng: ParamRNG, d: int, d_ff: int, dtype):
    return {
        "mu_k": rng.zeros((d,), dtype),
        "mu_r": rng.zeros((d,), dtype),
        "w_k": dense_init(rng, d, d_ff, dtype),
        "w_v": dense_init(rng, d_ff, d, dtype),
        "w_r": dense_init(rng, d, d, dtype),
    }


def _ddlerp(p, x, x_prev):
    """Data-dependent token-shift interpolation for the 5 streams."""
    dx = x_prev - x
    base = x + dx * p["mu_x"].to(x.dtype)
    r = p["lora_a"].shape[1] // 5
    lo = torch.tanh(matmul(base, p["lora_a"]))  # (..., 5r)
    lo = lo.reshape(*lo.shape[:-1], 5, r)
    if spmd.is_dtensor(lo):
        adj = spmd.batch_local(_lora_mix, lo, p["lora_b"])
    else:
        adj = _lora_mix(lo, p["lora_b"])
    mu = p["mu"].to(x.dtype) + adj  # (..., 5, d)
    return [x + dx * mu[..., i, :] for i in range(5)]


def _lora_mix(lo, lora_b):
    return torch.einsum("...nr,nrd->...nd", lo, lora_b.to(lo.dtype))


def _rwkv_decay(p, xw):
    lo = matmul(torch.tanh(matmul(xw, p["decay_a"])),
                p["decay_b"].to(xw.dtype))
    wt = p["decay_base"].float() + lo.float()
    return torch.exp(-torch.exp(wt))  # in (0, 1), data-dependent per channel


_WKV_CHUNK = 32


def _wkv_chunked(rr, kk, vv, ww, u, state, *, chunk: int = _WKV_CHUNK):
    """Chunkwise-parallel WKV6, the reference's exact reformulation of the
    recurrence.  With per-channel log-decay ``L_t = sum_{s<=t} log w_s``
    and incoming state S0, for t in a chunk:

        y_t = (r_t * e^{L_{t-1}}) S0
              + sum_{tau<t} [sum_d r_t k_tau e^{L_{t-1}-L_tau}]_d v_tau
              + (r_t . (u*k_t)) v_t
        S_C = diag(e^{L_C}) S0 + sum_tau (k_tau * e^{L_C - L_tau})^T v_tau

    Every exponent is a ratio along the chunk, hence <= 1.
    Inputs: (S, B, H, hd) time-major; state (B, H, hd, hd) f32.
    Returns (final_state, ys (S, B, H, hd))."""
    S, b, h, hd = rr.shape
    n = S // chunk
    out_dtype = rr.dtype

    def resh(x):  # (n, B, H, C, hd)
        return x.reshape(n, chunk, b, h, hd).permute(0, 2, 3, 1, 4).float()

    r_, k_, v_, w_ = resh(rr), resh(kk), resh(vv), resh(ww)
    logw = torch.log(torch.clamp(w_, min=1e-20))  # <= 0
    L = torch.cumsum(logw, dim=-2)  # L_t (inclusive)
    Lprev = L - logw  # L_{t-1}
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=rr.device), diagonal=-1)
    ys = []
    for c in range(n):
        r, k, v, Lc, Lp = r_[c], k_[c], v_[c], L[c], Lprev[c]  # (B,H,C,hd)
        # cross-chunk: (r * e^{Lp}) @ S0
        y_cross = torch.einsum("bhck,bhkv->bhcv", r * torch.exp(Lp), state)
        # intra-chunk scores with pairwise decay ratios (all <= 1)
        ratio = torch.exp(torch.clamp(
            Lp[:, :, :, None, :] - Lc[:, :, None, :, :], -60.0, 0.0))
        M = (r[:, :, :, None, :] * k[:, :, None, :, :] * ratio).sum(dim=-1)
        M = torch.where(causal, M, 0.0)
        y_intra = torch.einsum("bhts,bhsv->bhtv", M, v)
        # bonus diagonal
        diag = torch.einsum("bhtd,bhtd->bht", r, k * u[None, :, None, :])
        y = y_cross + y_intra + diag[..., None] * v  # (B,H,C,hd)
        # state propagation (all ratios <= 1)
        k_hat = k * torch.exp(Lc[:, :, -1:, :] - Lc)
        state = (torch.exp(Lc[:, :, -1, :])[..., None] * state
                 + torch.einsum("bhsk,bhsv->bhkv", k_hat, v))
        ys.append(y.to(out_dtype))
    # (n, B, H, C, hd) -> (S, B, H, hd)
    ys = torch.stack(ys).permute(0, 3, 1, 2, 4).reshape(S, b, h, hd)
    return state, ys


def rwkv_time_mix(p, x, cfg: RWKVConfig, state: tuple | None = None):
    """x: (B, S, D).  state (decode): (x_prev (B,D), S (B,H,hd,hd)).
    Returns (out, new_state)."""
    b, s, d = x.shape
    hd = cfg.head_dim
    h = d // hd

    if state is None:
        x_prev_seq = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
        wkv_state = None
    else:
        xp, wkv_state = state
        x_prev_seq = xp[:, None, :] if s == 1 else torch.cat(
            [xp[:, None, :], x[:, :-1]], dim=1)

    xw, xk, xv, xr, xg = _ddlerp(p, x, x_prev_seq)
    rr = split_heads(matmul(xr, p["w_r"]), h, hd)
    kk = split_heads(matmul(xk, p["w_k"]), h, hd)
    vv = split_heads(matmul(xv, p["w_v"]), h, hd)
    gg = F.silu(matmul(xg, p["w_g"]))
    ww = split_heads(_rwkv_decay(p, xw), h, hd)  # f32 decay in (0,1)
    if spmd.is_dtensor(rr):
        ys, wkv_state = _wkv_sharded(rr, kk, vv, ww, p["bonus"], wkv_state)
    else:
        ys, wkv_state = _wkv(rr, kk, vv, ww, p["bonus"], wkv_state)
    y = ys.reshape(b, s, d)
    y = rmsnorm(p["ln_out"], y)
    out = matmul(y * gg, p["w_o"])
    return out, (x[:, -1, :], wkv_state)


def _wkv(rr, kk, vv, ww, bonus, state):
    """The WKV6 recurrence over (B, S, H, hd) streams from ``state``
    (B, H, hd, hd) float32, zeros if None: the chunkwise-parallel form for
    sequences of more than one 32-step chunk that it divides, else the
    recurrent one.  Returns (ys (B, S, H, hd), final state)."""
    b, s, h, hd = rr.shape
    u = bonus.float()
    if state is None:
        state = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                            device=rr.device)

    def step(S, inp):
        r_t, k_t, v_t, w_t = inp  # (B, H, hd)
        a_t = torch.einsum("bhk,bhv->bhkv", k_t.float(), v_t.float())
        y = torch.einsum("bhk,bhkv->bhv", r_t.float(),
                         S + u[None, :, :, None] * a_t)
        S_new = w_t.float()[..., None] * S + a_t
        return S_new, y.to(r_t.dtype)

    xs = tuple(t.transpose(0, 1) for t in (rr, kk, vv, ww))
    if s % _WKV_CHUNK == 0 and s > _WKV_CHUNK:
        state, ys = _wkv_chunked(*xs, u, state)
    else:
        state, ys = chunked_scan(step, state, xs)
    return ys.transpose(0, 1), state


def _wkv_sharded(rr, kk, vv, ww, bonus, state):
    """:func:`_wkv` on DTensors: each rank runs the recurrence for its batch
    rows and heads (heads over the non-batch axes where they divide);
    nothing moves between ranks."""
    mesh = rr.device_mesh
    bat = spmd.sharded_axes(rr, 0)
    hax = tuple(a for a in mesh.mesh_dim_names if a not in bat)
    if rr.shape[2] % spmd.axes_size(mesh, hax):
        hax = ()
    rows = {a: 0 for a in bat}
    x_pl = spmd.placements_of(mesh, **rows, **{a: 2 for a in hax})
    u_pl = spmd.placements_of(mesh, **{a: 0 for a in hax})
    u_grad = spmd.placements_of(mesh, **{a: 0 for a in hax},
                                **{a: "P" for a in bat})
    s_pl = spmd.placements_of(mesh, **rows, **{a: 1 for a in hax})
    return spmd.local_call(
        _wkv, mesh, (rr, kk, vv, ww, bonus, state),
        (x_pl,) * 4 + (u_pl, s_pl), (x_pl, s_pl),
        (None,) * 4 + (u_grad, None))


def rwkv_channel_mix(p, x, state=None):
    """state (decode): previous token (B, D)."""
    if state is None:
        x_prev = torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    else:
        x_prev = state[:, None, :] if x.shape[1] == 1 else torch.cat(
            [state[:, None, :], x[:, :-1]], dim=1)
    dx = x_prev - x
    xk = x + dx * p["mu_k"].to(x.dtype)
    xr = x + dx * p["mu_r"].to(x.dtype)
    k = torch.square(F.relu(matmul(xk, p["w_k"])))
    r = torch.sigmoid(matmul(xr, p["w_r"]))
    return r * matmul(k, p["w_v"]), x[:, -1, :]


# ---------------------------------------------------------------------------
# Mamba (S6) — for the Jamba hybrid (arXiv:2403.19887 defaults)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 256


def mamba_init(rng: ParamRNG, d: int, cfg: MambaConfig, dtype):
    din = cfg.expand * d
    a = torch.arange(1, cfg.d_state + 1, dtype=torch.float32,
                     device=rng.device)
    return {
        "in_proj": dense_init(rng, d, 2 * din, dtype),
        "conv_w": rng.normal((cfg.d_conv, din), dtype) * (cfg.d_conv**-0.5),
        "conv_b": rng.zeros((din,), dtype),
        "x_proj": dense_init(rng, din, cfg.dt_rank + 2 * cfg.d_state, dtype),
        "dt_proj": dense_init(rng, cfg.dt_rank, din, dtype, std=0.02),
        "dt_bias": rng.zeros((din,), dtype),
        # float32 whatever the policy, as in the reference
        "a_log": torch.log(a).expand(din, cfg.d_state).contiguous(),
        "d_skip": rng.ones((din,), dtype),
        "out_proj": dense_init(rng, din, d, dtype),
    }


def mamba_apply(p, x, cfg: MambaConfig, state: tuple | None = None):
    """x: (B, S, D).  state (decode): (conv_buf (B, d_conv-1, din),
    h (B, din, d_state)).  Returns (out, new_state)."""
    if spmd.is_dtensor(x):
        return _mamba_sharded(p, x, cfg, state)
    u, z, proj, new_conv_buf = _mamba_in(
        x, p["in_proj"], p["conv_w"], p["conv_b"], p["x_proj"],
        None if state is None else state[0], cfg=cfg)
    y, h_fin = _mamba_scan(
        u, z, proj, p["dt_proj"], p["dt_bias"], p["a_log"], p["d_skip"],
        None if state is None else state[1], cfg=cfg)
    out = matmul(y, p["out_proj"])
    return out, (new_conv_buf, h_fin)


def _mamba_in(x, in_proj, conv_w, conv_b, x_proj, conv_buf, *, cfg):
    """The input projection, the causal depthwise conv along S and the
    projection to (dt_low, B, C): returns (u, z, proj, new conv buffer).
    On a rank's channels, ``in_proj`` holds its xin columns and then its
    z columns, ``conv_w``, ``conv_b``, ``x_proj`` and ``conv_buf`` its
    channels, and ``proj`` is their part of the sum."""
    b, s, _ = x.shape
    xz = x @ in_proj
    xin, z = torch.chunk(xz, 2, dim=-1)  # (B, S, din) each
    width = xin.shape[-1]

    # causal depthwise conv along S
    if conv_buf is None:
        conv_buf = torch.zeros((b, cfg.d_conv - 1, width), dtype=xin.dtype,
                               device=x.device)
    xpad = torch.cat([conv_buf, xin], dim=1)
    new_conv_buf = xpad[:, -(cfg.d_conv - 1):, :]
    conv = sum(
        xpad[:, k: k + s, :] * conv_w[k][None, None, :]
        for k in range(cfg.d_conv)
    ) + conv_b
    u = F.silu(conv)  # (B, S, din)
    return u, z, u @ x_proj, new_conv_buf


def _mamba_scan(u, z, proj, dt_proj, dt_bias, a_log, d_skip, h0, *, cfg):
    """The selective scan from state ``h0`` (zeros if None) and the gated
    output: returns (y (B, S, din), final state)."""
    b = u.shape[0]
    din = u.shape[-1]
    dt_low, Bmat, Cmat = torch.split(
        proj, [cfg.dt_rank, cfg.d_state, cfg.d_state], dim=-1)
    dt = F.softplus(dt_low @ dt_proj + dt_bias)  # (B, S, din)
    A = -torch.exp(a_log.float())  # (din, n) f32

    def step(h, inp):
        u_t, dt_t, b_t, c_t = inp  # (B, din), (B, din), (B, n), (B, n)
        dA = torch.exp(dt_t[..., None].float() * A)  # (B, din, n)
        dBu = (dt_t[..., None] * b_t[:, None, :] * u_t[..., None]).float()
        h_new = dA * h + dBu
        y = torch.einsum("bdn,bn->bd", h_new, c_t.float())
        return h_new, y.to(u_t.dtype)

    if h0 is None:
        h0 = torch.zeros((b, din, cfg.d_state), dtype=torch.float32,
                         device=u.device)
    xs = tuple(t.transpose(0, 1) for t in (u, dt, Bmat, Cmat))
    h_fin, ys = chunked_scan(step, h0, xs)
    y = ys.transpose(0, 1).to(z.dtype)
    y = y + u * d_skip
    y = y * F.silu(z)
    return y, h_fin


def _channel_columns(w, mesh, cax):
    """A rank's xin and z columns of ``in_proj`` (D, 2 din), from its block
    of ``2 din / n`` consecutive columns over the channel axis ``cax``: the
    blocks' halves move between ranks in one all-to-all (autograd runs it
    backwards), so no rank holds more than its share."""
    if not cax:
        return w
    if len(cax) > 1:
        raise ValueError(f"Mamba's channels over {cax}: one axis expected")
    from torch.distributed._functional_collectives import (
        all_to_all_single_autograd,
    )

    dim = mesh.mesh_dim_names.index(cax[0])
    n, j = mesh.size(dim), mesh.get_local_rank(cax[0])
    if n == 1:
        return w
    m = w.shape[1] // 2
    # global block b of m columns is xin's (b < n) or z's block b mod n
    halves = sorted(((2 * j + t) % n, t) for t in range(2))
    send = torch.cat([w[:, t * m:(t + 1) * m] for _, t in halves], dim=1)
    in_splits, out_splits = [0] * n, [0] * n
    for dest, _ in halves:
        in_splits[dest] += m
    for b in (j, n + j):  # xin's block first: its sender ranks lower
        out_splits[b // 2] += m
    got = all_to_all_single_autograd(send.t().contiguous(), out_splits,
                                     in_splits, (mesh, dim))
    return got.t()


def _mamba_sharded(p, x, cfg: MambaConfig, state):
    """:func:`mamba_apply` on DTensors: the inner channels (din) over the
    axes that shard ``conv_b`` (less the batch axes), the batch rows over
    the batch axes.  Each rank projects (its xin and z columns of
    ``in_proj`` moved to it by :func:`_channel_columns`), convolves and
    scans its channels; the one sum across channels, the projection to
    (dt_low, B, C), is a ``Partial`` that one all-reduce completes; the
    output projection is a DTensor product.  The states stay sharded as
    the caches are."""
    mesh = x.device_mesh
    bat = spmd.sharded_axes(x, 0)
    cax = tuple(a for a in spmd.sharded_axes(p["conv_b"], 0) if a not in bat)
    rows = {a: 0 for a in bat}
    part = {a: "P" for a in bat}

    def pl(**dims):
        return spmd.placements_of(mesh, **dims)

    x_pl = pl(**rows)
    ch3 = pl(**rows, **{a: 2 for a in cax})  # (B, S|k, din)
    ch_last = pl(**{a: 1 for a in cax})  # (k|r|D, din)
    ch_first = pl(**{a: 0 for a in cax})  # (din, ...)
    h_pl = pl(**rows, **{a: 1 for a in cax})  # (B, din, n)

    def grad(**dims):
        return pl(**dims, **part)

    def project(xl, w, *rest):
        return _mamba_in(xl, _channel_columns(w, mesh, cax), *rest, cfg=cfg)

    conv_buf, h0 = (None, None) if state is None else state
    u, z, proj, new_buf = spmd.local_call(
        project, mesh,
        (x, p["in_proj"], p["conv_w"], p["conv_b"], p["x_proj"], conv_buf),
        (x_pl, ch_last, ch_last, ch_first, ch_first, ch3),
        (ch3, ch3, pl(**rows, **{a: "P" for a in cax}), ch3),
        (pl(**rows, **{a: "P" for a in cax}), grad(**{a: 1 for a in cax}),
         grad(**{a: 1 for a in cax}), grad(**{a: 0 for a in cax}),
         grad(**{a: 0 for a in cax}), None))
    proj = proj.redistribute(mesh, x_pl)
    y, h_fin = spmd.local_call(
        lambda *a: _mamba_scan(*a, cfg=cfg), mesh,
        (u, z, proj, p["dt_proj"], p["dt_bias"], p["a_log"], p["d_skip"], h0),
        (ch3, ch3, x_pl, ch_last, ch_first, ch_first, ch_first, h_pl),
        (ch3, h_pl),
        (None, None, pl(**rows, **{a: "P" for a in cax}),
         grad(**{a: 1 for a in cax}), grad(**{a: 0 for a in cax}),
         grad(**{a: 0 for a in cax}), grad(**{a: 0 for a in cax}), None))
    return matmul(y, p["out_proj"]), (new_buf, h_fin)
