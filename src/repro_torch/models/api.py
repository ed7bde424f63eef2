"""Uniform model interface over the architecture families (the counterpart
of ``repro.models.api``).

``build_model(cfg, device=...)`` returns a :class:`Model` whose methods are
the family's functions:

- ``init(seed_or_generator)``               — parameter tree on the device
- ``loss(params, batch, sh)``               — scalar train loss (value)
- ``prefill_logits(params, batch, sh)``     — full-sequence logits
- ``init_cache(batch, max_seq)``            — decode cache on the device
- ``decode(params, token, pos, cache, sh)`` — one serve step
- ``prefill_serve(params, batch, sh)``      — (last logits, K/V)

``device`` defaults to ``'cuda'`` and raises on a host without a card;
pass ``device='cpu'`` for the CPU.  ``init`` takes a ``torch.Generator``
(on that device) or an integer seed where the reference takes a PRNGKey.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import torch

from repro_torch.configs import ArchConfig
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.layers import ParamRNG, serving
from repro_torch.runtime.sharding import Shardings
from repro_torch.util import resolve_device


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable
    loss: Callable  # (params, batch_dict, sh) -> scalar
    prefill_logits: Callable  # (params, batch_dict, sh) -> (B, S, V)
    init_cache: Callable | None  # (batch, max_seq) -> cache
    decode: Callable | None  # (params, token, pos, cache, sh)
    prefill_serve: Callable | None = None  # (params, batch, sh) -> (logits_last, kvs)
    device: torch.device = torch.device("cpu")


def param_shapes(cfg: ArchConfig):
    """The parameter tree of ``cfg`` on the ``'meta'`` device: names, shapes
    and dtypes, nothing allocated."""
    return build_model(cfg, device="meta").init(0)


def build_model(cfg: ArchConfig, device="cuda") -> Model:
    dev = torch.device("meta") if str(device) == "meta" else resolve_device(
        device)
    fam = cfg.family
    init_fn = encdec_mod.init_params if fam == "encdec" else tf_mod.init_params
    cache_fn = encdec_mod.init_cache if fam == "encdec" else tf_mod.init_cache

    def init(seed_or_generator=0):
        return init_fn(ParamRNG(seed_or_generator, dev), cfg)

    def init_cache(b, s):
        return cache_fn(cfg, b, s, device=dev)

    def decode(params, token, pos, cache, sh=Shardings.none()):
        mod = encdec_mod if fam == "encdec" else tf_mod
        with sh.scope():
            return mod.decode_step(params, cfg, token, pos, cache, sh)

    common = dict(cfg=cfg, init=init, init_cache=init_cache, decode=decode,
                  device=dev)

    if fam == "encdec":
        def loss(params, batch, sh=Shardings.none()):
            with sh.scope():
                return encdec_mod.loss_fn(
                    params, cfg, batch["frames"], batch["tokens"],
                    batch["labels"], sh)

        @serving
        def prefill_logits(params, batch, sh=Shardings.none()):
            with sh.scope():
                enc = encdec_mod.encode(params, cfg, batch["frames"], sh)
                return encdec_mod.decode_train(params, cfg, enc,
                                               batch["tokens"], sh)

        @serving
        def prefill_serve(params, batch, sh=Shardings.none()):
            with sh.scope():
                enc = encdec_mod.encode(params, cfg, batch["frames"], sh)
                xk, xv = encdec_mod.prefill_cross(params, cfg, enc)
                logits = encdec_mod.decode_train(
                    params, cfg, enc, batch["tokens"], sh)[:, -1, :]
            return logits, (xk, xv)

        return Model(loss=loss, prefill_logits=prefill_logits,
                     prefill_serve=prefill_serve, **common)

    extra = "patches" if fam == "vlm" else None

    def embeds(batch):
        return None if extra is None else batch[extra]

    # decoder-only families: dense / moe / ssm / hybrid, and the vlm
    def loss(params, batch, sh=Shardings.none()):
        with sh.scope():
            return tf_mod.loss_fn(params, cfg, batch["tokens"],
                                  batch["labels"], sh,
                                  extra_embeds=embeds(batch))

    @serving
    def prefill_logits(params, batch, sh=Shardings.none()):
        with sh.scope():
            logits, _, _ = tf_mod.forward(params, cfg, batch["tokens"], sh,
                                          extra_embeds=embeds(batch))
        return logits

    def prefill_serve(params, batch, sh=Shardings.none()):
        with sh.scope():
            return tf_mod.prefill(params, cfg, batch["tokens"], sh,
                                  extra_embeds=embeds(batch))

    return Model(loss=loss, prefill_logits=prefill_logits,
                 prefill_serve=prefill_serve, **common)
