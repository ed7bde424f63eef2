"""Fault-tolerant checkpointing: async, atomic, in the reference's on-disk
layout (counterpart of ``repro.checkpoint``)."""

from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    Checkpointer,
    latest_step,
    restore_pytree,
    save_pytree,
)
