"""Analytic cost prior for the Create-time autotuner (counterpart of
``repro.tune.prior``).

The closed-form floors (:mod:`repro_torch.analysis.cost`) say roughly what
each backend's apply costs.  That is enough to *rank* candidates before
measuring them: a candidate whose predicted time is several times the
best prediction cannot plausibly win a race whose contenders differ by
integer factors, so the autotuner skips measuring it (``stats.pruned``
counts the skips).

The prior scores the port as it is implemented: a stencil apply — the
CUDA kernel, whatever its launch geometry, or the plain version — moves
:func:`~repro_torch.analysis.cost.expected_stencil`'s bytes (one read of
the field, one write) and spends ``2*taps`` flops a point, where the
reference's prior charges its jnp path ``taps + 1`` field passes; the fft
candidate is scored by :func:`~repro_torch.analysis.cost.expected_fft`.

Scores are a scalar roofline proxy — ``bytes + flops / BALANCE`` with
``BALANCE`` in flops-per-byte — so only *ratios* matter and no absolute
hardware numbers are needed.  The prune ratio is conservative
(:data:`PRUNE_RATIO`): candidates within the band are still measured.
Candidates the prior cannot score (``None``) are always measured.  Set
``REPRO_TUNE_NOPRIOR=1`` to disable pruning entirely.
"""

from __future__ import annotations

import os
from collections.abc import Callable, Sequence

# flops-per-byte balance of the scoring proxy: both backends' scores are
# bytes-dominated at these sizes, so the ranking is insensitive to it
BALANCE_FLOPS_PER_BYTE = 4.0

# a candidate predicted slower than PRUNE_RATIO x the best prediction is
# not measured; anything closer races for real
PRUNE_RATIO = 1.5

NOPRIOR_ENV = "REPRO_TUNE_NOPRIOR"


def prior_enabled() -> bool:
    return os.environ.get(NOPRIOR_ENV, "").strip().lower() in (
        "", "0", "false",
    )


def predicted_score(expected) -> float:
    """Scalar time proxy for an :class:`~repro_torch.analysis.cost.Expected`."""
    return expected.bytes + expected.flops / BALANCE_FLOPS_PER_BYTE


def stencil_prior(
    shape, taps: int, itemsize: int
) -> Callable[[dict], float | None]:
    """The candidate scorer for a stencil-apply tuning problem: the direct
    backends (``'auto'``, ``'cuda'``, ``'torch'``; every launch geometry
    scores the same, geometry stays a measured decision) by
    ``expected_stencil``, ``'fft'`` by ``expected_fft``; anything else is
    unscorable."""
    from repro_torch.analysis.cost import expected_fft, expected_stencil

    def prior(config: dict) -> float | None:
        backend = config.get("backend")
        if backend == "fft":
            return predicted_score(expected_fft(shape, itemsize))
        if backend in ("auto", "cuda", "torch", None):
            return predicted_score(expected_stencil(shape, taps, itemsize))
        return None

    return prior


def prune_candidates(
    candidates: Sequence[dict],
    prior: Callable[[dict], float | None],
    *,
    ratio: float = PRUNE_RATIO,
) -> tuple[list[dict], list[dict]]:
    """Split ``candidates`` into (kept, dropped) by predicted score.

    Unscorable candidates (prior returns ``None`` or raises) are kept;
    with fewer than two scorable candidates nothing is dropped."""
    scores: list[float | None] = []
    for c in candidates:
        try:
            s = prior(dict(c))
        except Exception:  # noqa: BLE001 — an unscorable candidate races
            s = None
        scores.append(s)
    finite = [s for s in scores if s is not None]
    if len(finite) < 2:
        return list(candidates), []
    best = min(finite)
    kept, dropped = [], []
    for c, s in zip(candidates, scores, strict=True):
        (kept if s is None or s <= ratio * best else dropped).append(c)
    return kept, dropped


__all__ = [
    "BALANCE_FLOPS_PER_BYTE",
    "NOPRIOR_ENV",
    "PRUNE_RATIO",
    "predicted_score",
    "prior_enabled",
    "prune_candidates",
    "stencil_prior",
]
