"""The port's data pipeline (``repro_torch.data``) on the CPU.

Mirrors ``TestPipeline`` of ``tests/test_data_fault.py`` (step-keyed
determinism, shifted labels, host shards, the family sources, ids in the
vocabulary), then holds the port's copy to the reference's: batches of all
three sources, host shards and the step keys equal bit for bit.
"""

import numpy as np
import pytest

from repro.configs import get_config as ref_config
from repro.data import make_source as ref_make_source
from repro.data import TokenBatchSource as RefTokenBatchSource
from repro_torch.configs import get_config
from repro_torch.data import (
    EncDecBatchSource,
    TokenBatchSource,
    VLMBatchSource,
    make_source,
)


class TestPipeline:
    def test_step_keyed_determinism(self):
        a = TokenBatchSource(vocab=100, global_batch=4, seq_len=8, seed=7)
        b = TokenBatchSource(vocab=100, global_batch=4, seq_len=8, seed=7)
        for step in (0, 3, 1000, 3):  # arbitrary revisit order
            np.testing.assert_array_equal(
                a.get_batch(step)["tokens"], b.get_batch(step)["tokens"]
            )

    def test_different_steps_differ(self):
        src = TokenBatchSource(vocab=1000, global_batch=2, seq_len=32, seed=0)
        assert not np.array_equal(
            src.get_batch(0)["tokens"], src.get_batch(1)["tokens"]
        )

    def test_labels_are_shifted_tokens(self):
        src = TokenBatchSource(vocab=50, global_batch=2, seq_len=16, seed=1)
        b = src.get_batch(5)
        np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])

    def test_host_sharding_partitions_batch(self):
        parts = [
            TokenBatchSource(
                vocab=50, global_batch=8, seq_len=4, seed=3,
                process_index=i, process_count=4,
            )
            for i in range(4)
        ]
        assert all(p.host_batch == 2 for p in parts)
        # per-host streams must be mutually distinct
        b0 = parts[0].get_batch(0)["tokens"]
        b1 = parts[1].get_batch(0)["tokens"]
        assert not np.array_equal(b0, b1)
        with pytest.raises(ValueError, match="divide across hosts"):
            TokenBatchSource(vocab=50, global_batch=7, seq_len=4,
                             process_count=4).host_batch

    def test_family_sources(self):
        for arch in ("whisper-base", "llava-next-mistral-7b", "yi-9b"):
            cfg = get_config(arch).reduced()
            src = make_source(cfg, global_batch=2, seq_len=8, seed=0)
            b = src.get_batch(0)
            assert b["tokens"].shape == (2, 8)
            if cfg.family == "encdec":
                assert isinstance(src, EncDecBatchSource)
                assert b["frames"].shape == (2, cfg.enc_seq, cfg.d_model)
            if cfg.family == "vlm":
                assert isinstance(src, VLMBatchSource)
                assert b["patches"].shape == (2, cfg.img_tokens, cfg.d_model)

    def test_ids_in_vocab_range(self):
        src = TokenBatchSource(vocab=37, global_batch=4, seq_len=64, seed=0)
        t = src.get_batch(9)["tokens"]
        assert t.min() >= 1 and t.max() < 37


# -- the reference's batches, bit for bit ---------------------------------------


@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-base",
                                  "llava-next-mistral-7b"])
@pytest.mark.parametrize("seed", [0, 11])
def test_sources_equal_the_references(arch, seed):
    """The token, encoder-decoder and VLM sources give the reference's
    arrays (values, dtypes, shapes) at the same (seed, step), at published
    widths and reduced, on every host shard."""
    for cut in (False, True):
        rc, tc = ref_config(arch), get_config(arch)
        if cut:
            rc, tc = rc.reduced(), tc.reduced()
        for pi in range(2):
            kw = dict(global_batch=4, seq_len=16, seed=seed,
                      process_index=pi, process_count=2)
            ref, port = ref_make_source(rc, **kw), make_source(tc, **kw)
            assert type(port).__name__ == type(ref).__name__
            for step in (0, 1, 7, 12345):
                want, got = ref.get_batch(step), port.get_batch(step)
                assert sorted(got) == sorted(want)
                for k in want:
                    assert got[k].dtype == want[k].dtype, k
                    np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("step", [0, 5, 2**31])
def test_step_keys_equal_the_references(step):
    """The counter-based key of (seed, step, process): the same generator
    state, so any skip-ahead lands on the reference's stream."""
    kw = dict(vocab=1000, global_batch=8, seq_len=4, seed=3, process_index=1,
              process_count=2)
    got = TokenBatchSource(**kw)._rng(step).bit_generator.state
    want = RefTokenBatchSource(**kw)._rng(step).bit_generator.state
    assert got == want
