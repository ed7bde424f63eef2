"""Deterministic synthetic data pipeline (the counterpart of
``repro.data.pipeline``, a copy: the port imports nothing of the
reference).

Every batch is a pure function of ``(seed, step)`` (counter-based Philox):
resuming from a checkpoint at step N regenerates byte-identical batches with
no pipeline state to snapshot — the property the fault-tolerance layer
relies on.  Per-host sharding slices the global
batch by ``process_index`` so each host materialises only its shard.

The synthetic stream is Zipf-distributed token ids (a more realistic
vocab-access pattern than uniform for embedding-gather benchmarking).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs import ArchConfig


@dataclasses.dataclass(frozen=True)
class TokenBatchSource:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2
    process_index: int = 0
    process_count: int = 1

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.process_count:
            raise ValueError("global batch must divide across hosts")
        return self.global_batch // self.process_count

    def _rng(self, step: int) -> np.random.Generator:
        # counter-based: key = (seed, step, process) — O(1) skip-ahead
        return np.random.default_rng(
            np.random.SeedSequence(
                entropy=self.seed, spawn_key=(step, self.process_index)
            )
        )

    def get_batch(self, step: int) -> dict[str, np.ndarray]:
        rng = self._rng(step)
        # Zipf ids folded into the vocab
        raw = rng.zipf(self.zipf_a, size=(self.host_batch, self.seq_len + 1))
        toks = (raw % (self.vocab - 1)).astype(np.int32) + 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass(frozen=True)
class EncDecBatchSource:
    inner: TokenBatchSource
    enc_seq: int
    d_model: int

    def get_batch(self, step: int) -> dict[str, np.ndarray]:
        b = self.inner.get_batch(step)
        rng = self.inner._rng(step ^ 0x5EED)
        b["frames"] = rng.standard_normal(
            (self.inner.host_batch, self.enc_seq, self.d_model)
        ).astype(np.float32) * 0.1
        return b


@dataclasses.dataclass(frozen=True)
class VLMBatchSource:
    inner: TokenBatchSource
    img_tokens: int
    d_model: int

    def get_batch(self, step: int) -> dict[str, np.ndarray]:
        b = self.inner.get_batch(step)
        rng = self.inner._rng(step ^ 0x1A6E)
        b["patches"] = rng.standard_normal(
            (self.inner.host_batch, self.img_tokens, self.d_model)
        ).astype(np.float32) * 0.1
        return b


def make_source(
    cfg: ArchConfig,
    *,
    global_batch: int,
    seq_len: int,
    seed: int = 0,
    process_index: int = 0,
    process_count: int = 1,
):
    base = TokenBatchSource(
        vocab=cfg.vocab,
        global_batch=global_batch,
        seq_len=seq_len,
        seed=seed,
        process_index=process_index,
        process_count=process_count,
    )
    if cfg.family == "encdec":
        return EncDecBatchSource(base, enc_seq=cfg.enc_seq, d_model=cfg.d_model)
    if cfg.family == "vlm":
        return VLMBatchSource(base, img_tokens=cfg.img_tokens, d_model=cfg.d_model)
    return base
