"""Collective traffic and roofline terms of a dry-run cell (the counterpart
of ``repro.launch.hlo_analysis``).

The reference reads its collectives from the partitioned HLO text and its
flops and bytes from ``cost_analysis``.  The port has no HLO: the dry-run
(:mod:`repro_torch.launch.dryrun`) runs each cell's step under
``FakeTensorMode`` on a fake process group and records every
``_c10d_functional`` collective the step issues; :func:`collective_stats`
tallies them by kind under the reference's names.

Hardware model: one NVIDIA H100 SXM, from NVIDIA's H100 SXM data sheet —
989 TFLOP/s dense bf16 on the tensor cores, 3.35 TB/s of HBM3, and 450
GB/s a direction over NVLink 4 (900 GB/s bidirectional a GPU).

======================== ============ =======================================
reference                port         note
======================== ============ =======================================
``RooflineTerms``        same         the H100's peaks above
``collective_stats``     same         from the step's collective records,
                                      not HLO text
``input_output_aliases`` N/A          no compiled module to read aliases
                                      from: a donated step updates its
                                      params and state in place
                                      (``make_train_step(donate=True)``)
``analyze_compiled``     N/A          no compiled executable; the dry-run
                                      builds ``RooflineTerms`` from its
                                      fake-tensor trace
======================== ============ =======================================
"""

from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12  # dense bf16 / GPU (H100 SXM data sheet)
HBM_BW = 3.35e12  # B/s / GPU, HBM3 (H100 SXM data sheet)
NVLINK_BW = 450e9  # B/s a direction / GPU, NVLink 4 (H100 SXM data sheet)

COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

# the functional collectives' op names -> the reference's kinds
_KIND_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def collective_kind(op_name: str) -> str | None:
    """The reference's kind of a ``_c10d_functional`` op (by the op's name,
    with or without namespace and overload; a kind's own name is itself),
    None for a non-collective (``wait_tensor``)."""
    if op_name in COLLECTIVE_KINDS:
        return op_name
    base = op_name.split("::")[-1].split(".")
    name = base[1] if len(base) > 1 and base[0].endswith("functional") \
        else base[0]
    return _KIND_OF.get(name)


def collective_stats(records) -> dict[str, dict[str, float]]:
    """Per-collective-kind {count, bytes} from ``(op_name, bytes)`` records
    of one device's collectives (bytes: each collective's output on that
    device, as the reference counts its ops' output operands)."""
    stats = {k: {"count": 0, "bytes": 0.0} for k in COLLECTIVE_KINDS}
    for name, nbytes in records:
        kind = collective_kind(name)
        if kind is None:
            continue
        stats[kind]["count"] += 1
        stats[kind]["bytes"] += float(nbytes)
    return stats


@dataclasses.dataclass
class RooflineTerms:
    flops: float  # whole program, all devices
    bytes_accessed: float  # whole program, all devices
    collective_bytes: float  # per-device collective bytes (sum over ops)
    n_chips: int
    model_flops: float | None = None

    @property
    def t_compute(self) -> float:
        return self.flops / (self.n_chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / (self.n_chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        # collective_bytes is per device already
        return self.collective_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> float | None:
        if self.model_flops is None or self.flops == 0:
            return None
        return self.model_flops / self.flops

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_frac(self) -> float | None:
        """MODEL_FLOPS / (chips * peak * bound_time): useful work per second
        against what the dominant resource allows."""
        if self.model_flops is None or self.bound_time == 0:
            return None
        return self.model_flops / (
            self.n_chips * PEAK_FLOPS * self.bound_time
        )

    def to_dict(self):
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "collective_bytes": self.collective_bytes,
            "n_chips": self.n_chips,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "dominant": self.dominant,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
        }
