"""Data pipelines (deterministic, step-keyed, restart-exact; the
counterpart of ``repro.data``)."""

from repro_torch.data.pipeline import (  # noqa: F401
    TokenBatchSource,
    EncDecBatchSource,
    VLMBatchSource,
    make_source,
)
