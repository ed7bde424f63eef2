"""Compatibility shim of the reference's ``repro.launch.hlo_costs`` names:
the measured cost model lives in :mod:`repro_torch.analysis.cost`, which
reads an op trace of one call instead of compiled HLO, and this module
re-exports what it has.

The reference's HLO parser (``analyze_hlo``, ``parse_module``,
``parse_shapes``, ``execution_counts``, ``op_bytes``,
``top_contributors``, ``Computation``, ``HloCosts``, ``Op``, ``Shape``)
has no counterpart: eager PyTorch compiles no HLO (as
``repro_torch/analysis/cost.py`` says).  The dry-run's trip-scaled costs
come from its fake-tensor trace (:mod:`repro_torch.launch.dryrun`).
"""

from __future__ import annotations

from repro_torch.analysis.cost import (
    _ELEMENTWISE,
    CostVector,
    LoopCost,
    measure,
    memory_stats,
    op_flops,
)
from repro_torch.launch.hlo_analysis import COLLECTIVE_KINDS

__all__ = [
    "COLLECTIVE_KINDS",
    "CostVector",
    "LoopCost",
    "measure",
    "memory_stats",
    "op_flops",
    "_ELEMENTWISE",
]
