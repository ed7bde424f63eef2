"""(architecture x input-shape) cells of the LM substrate, the serve half
(the counterpart of part of ``repro.launch.cells``): the assigned shapes,
which cells an architecture supports, the prefill and serve steps, and the
greedy decode loop.

Shapes:

- ``train_4k``     seq 4096,   global batch 256  -> train step
- ``prefill_32k``  seq 32768,  global batch 32   -> prefill (serve) step
- ``decode_32k``   cache 32768, global batch 128 -> serve step (1 new token)
- ``long_500k``    cache 524288, batch 1         -> serve step; only for
  sub-quadratic archs (rwkv6, jamba).

The cell assembly over a mesh (``build_cell``), the train step and the
input spec trees are not ported (ROADMAP.md, Open items: LM dry-run cells).
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.configs import ArchConfig, get_config
from repro_torch.models.api import Model, build_model
from repro_torch.models.attention import quantize_kv
from repro_torch.runtime.sharding import Shardings

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
    with torch.inference_mode():
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
