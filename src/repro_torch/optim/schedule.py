"""Learning-rate schedules (the counterpart of ``repro.optim.schedule``)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(
    peak_lr: float,
    *,
    warmup_steps: int = 2000,
    total_steps: int = 100_000,
    end_frac: float = 0.1,
):
    """Linear warmup then cosine decay to ``end_frac * peak_lr``.  The
    returned ``lr(step)`` is a 0-d float32 tensor on the device of
    ``step`` (the CPU for a Python number)."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * torch.clamp(step / max(warmup_steps, 1), max=1.0)
        t = torch.clamp(
            (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0,
            1.0)
        cos = end_frac + (1 - end_frac) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)

    return lr
