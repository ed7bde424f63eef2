"""State-space / linear-attention blocks of the LM substrate (the
counterpart of ``repro.models.ssm``): RWKV6 ("Finch") and Mamba.

Both run in their recurrent form, a Python loop over time on the host (the
reference scans it), carrying the state in float32; RWKV6's WKV also has
the reference's exact chunkwise-parallel form for prompts of more than one
32-step chunk.  Decode carries O(1) state.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (
    ParamRNG, dense_init, remat, rmsnorm, rmsnorm_init,
)


_TIME_CHUNK = 256


def _scan(step, carry, xs):
    ys = []
    for t in range(xs[0].shape[0]):
        carry, y = step(carry, tuple(x[t] for x in xs))
        ys.append(y)
    return carry, torch.stack(ys)


def chunked_scan(step, init, xs, *, chunk: int = _TIME_CHUNK):
    """``lax.scan`` over the leading (time) axis of the tensors in ``xs``:
    ``carry, y_t = step(carry, x_t)``, returning the final carry and the
    stacked ``y``.  Scans of more than ``chunk`` steps that it divides run
    in ``chunk``-step pieces under :func:`remat`, as the reference's: the
    backward keeps only the carry at the pieces' boundaries and recomputes
    each piece, instead of keeping every step's residuals."""
    S = xs[0].shape[0]
    if S <= chunk or S % chunk:
        return _scan(step, init, xs)
    carry, ys = init, []
    for c in range(S // chunk):
        piece = tuple(x[c * chunk:(c + 1) * chunk] for x in xs)
        carry, y = remat(_scan, step, carry, piece)
        ys.append(y)
    return carry, torch.cat(ys)


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
    lo = torch.tanh(base @ p["lora_a"])  # (..., 5r)
    lo = lo.reshape(*lo.shape[:-1], 5, r)
    adj = torch.einsum("...nr,nrd->...nd", lo, p["lora_b"].to(x.dtype))
    mu = p["mu"].to(x.dtype) + adj  # (..., 5, d)
    return [x + dx * mu[..., i, :] for i in range(5)]


def _rwkv_decay(p, xw):
    lo = torch.tanh(xw @ p["decay_a"]) @ p["decay_b"].to(xw.dtype)
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
        wkv_state = torch.zeros((b, h, hd, hd), dtype=torch.float32,
                                device=x.device)
    else:
        xp, wkv_state = state
        x_prev_seq = xp[:, None, :] if s == 1 else torch.cat(
            [xp[:, None, :], x[:, :-1]], dim=1)

    xw, xk, xv, xr, xg = _ddlerp(p, x, x_prev_seq)
    rr = (xr @ p["w_r"]).reshape(b, s, h, hd)
    kk = (xk @ p["w_k"]).reshape(b, s, h, hd)
    vv = (xv @ p["w_v"]).reshape(b, s, h, hd)
    gg = F.silu(xg @ p["w_g"])
    ww = _rwkv_decay(p, xw).reshape(b, s, h, hd)  # f32 decay in (0,1)
    u = p["bonus"].float()

    def step(S, inp):
        r_t, k_t, v_t, w_t = inp  # (B, H, hd)
        a_t = torch.einsum("bhk,bhv->bhkv", k_t.float(), v_t.float())
        y = torch.einsum("bhk,bhkv->bhv", r_t.float(),
                         S + u[None, :, :, None] * a_t)
        S_new = w_t.float()[..., None] * S + a_t
        return S_new, y.to(r_t.dtype)

    xs = tuple(t.transpose(0, 1) for t in (rr, kk, vv, ww))
    if s % _WKV_CHUNK == 0 and s > _WKV_CHUNK:
        wkv_state, ys = _wkv_chunked(*xs, u, wkv_state)
    else:
        wkv_state, ys = chunked_scan(step, wkv_state, xs)
    y = ys.transpose(0, 1).reshape(b, s, d)
    y = rmsnorm(p["ln_out"], y)
    out = (y * gg) @ p["w_o"]
    return out, (x[:, -1, :], wkv_state)


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
    k = torch.square(F.relu(xk @ p["w_k"]))
    r = torch.sigmoid(xr @ p["w_r"])
    return r * (k @ p["w_v"]), x[:, -1, :]


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
    b, s, d = x.shape
    din = cfg.expand * d

    xz = x @ p["in_proj"]
    xin, z = torch.chunk(xz, 2, dim=-1)  # (B, S, din) each

    # causal depthwise conv along S
    if state is None:
        conv_buf = torch.zeros((b, cfg.d_conv - 1, din), dtype=xin.dtype,
                               device=x.device)
    else:
        conv_buf = state[0]
    xpad = torch.cat([conv_buf, xin], dim=1)
    new_conv_buf = xpad[:, -(cfg.d_conv - 1):, :]
    conv = sum(
        xpad[:, k: k + s, :] * p["conv_w"][k][None, None, :]
        for k in range(cfg.d_conv)
    ) + p["conv_b"]
    u = F.silu(conv)  # (B, S, din)

    proj = u @ p["x_proj"]
    dt_low, Bmat, Cmat = torch.split(
        proj, [cfg.dt_rank, cfg.d_state, cfg.d_state], dim=-1)
    dt = F.softplus(dt_low @ p["dt_proj"] + p["dt_bias"])  # (B, S, din)
    A = -torch.exp(p["a_log"].float())  # (din, n) f32

    def step(h, inp):
        u_t, dt_t, b_t, c_t = inp  # (B, din), (B, din), (B, n), (B, n)
        dA = torch.exp(dt_t[..., None].float() * A)  # (B, din, n)
        dBu = (dt_t[..., None] * b_t[:, None, :] * u_t[..., None]).float()
        h_new = dA * h + dBu
        y = torch.einsum("bdn,bn->bd", h_new, c_t.float())
        return h_new, y.to(u_t.dtype)

    h0 = (torch.zeros((b, din, cfg.d_state), dtype=torch.float32,
                      device=x.device)
          if state is None else state[1])
    xs = tuple(t.transpose(0, 1) for t in (u, dt, Bmat, Cmat))
    h_fin, ys = chunked_scan(step, h0, xs)
    y = ys.transpose(0, 1).to(x.dtype)
    y = y + u * p["d_skip"]
    y = y * F.silu(z)
    out = y @ p["out_proj"]
    return out, (new_conv_buf, h_fin)
