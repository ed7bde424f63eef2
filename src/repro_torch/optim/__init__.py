"""Optimizers and schedules (the counterpart of ``repro.optim``).

Three second-moment tiers:

- ``adamw``     — f32 moments (default; 8 bytes/param extra);
- ``adafactor`` — factored second moment (~0 extra per matrix dim);
- ``adamw8bit`` — block-quantised int8 moments (2 bytes/param extra).

The state trees are the reference's leaf for leaf; ``state_specs`` gives
their partition specs from the params' (DTensor params get their state
made with those placements).
"""

from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer,
    get_optimizer,
    global_norm,
    clip_by_global_norm,
    state_specs,
)
from repro_torch.optim.schedule import warmup_cosine  # noqa: F401
