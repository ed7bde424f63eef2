"""Create-time autotuning: measured kernel configuration + persistent cache
(counterpart of ``repro.tune``).

See :mod:`repro_torch.tune.autotuner` for the measurement loop,
:mod:`repro_torch.tune.cache` for the on-disk cache (``~/.cache/repro-tune``
or ``$REPRO_TUNE_CACHE``) and :mod:`repro_torch.tune.prior` for the
analytic prior that prunes candidates before they race.
"""

from repro_torch.tune.autotuner import (
    FORCE_ENV,
    MODES,
    TuneStats,
    autotune,
    check_mode,
    enable_force,
    measure,
    reset_stats,
    stats,
)
from repro_torch.tune.cache import (
    ENV_VAR,
    TuneCache,
    cache_dir,
    host_fingerprint,
    tune_key,
)
from repro_torch.tune.prior import (
    PRUNE_RATIO,
    predicted_score,
    prior_enabled,
    prune_candidates,
    stencil_prior,
)

__all__ = [
    "FORCE_ENV",
    "MODES",
    "TuneStats",
    "autotune",
    "check_mode",
    "enable_force",
    "measure",
    "reset_stats",
    "stats",
    "ENV_VAR",
    "PRUNE_RATIO",
    "TuneCache",
    "cache_dir",
    "host_fingerprint",
    "predicted_score",
    "prior_enabled",
    "prune_candidates",
    "stencil_prior",
    "tune_key",
]
