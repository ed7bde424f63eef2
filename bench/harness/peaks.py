"""The published peaks of one NVIDIA H100 SXM (NVIDIA's H100 SXM data sheet,
dense rates, at the full 700 W): HBM3 bandwidth and float64 on the tensor
cores.  A bound is the larger of bytes over bandwidth and operations over
the rate."""

HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS_PER_S = 67e12


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FP64_FLOPS_PER_S)
