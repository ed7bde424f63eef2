"""repro_torch — the PyTorch and CUDA port of the cuSten reproduction.

A second package beside ``repro`` (the JAX reference), with the same module
paths and names.  It imports torch and numpy only, never jax or ``repro``.
Every entry point runs on the card (``device='cuda'``) unless the caller
asks for the CPU; on a CUDA tensor each kernel op launches its hand-written
CUDA kernel (``repro_torch/kernels/csrc``), on a CPU tensor it runs the
plain PyTorch version::

    import repro_torch as rt
    plan = rt.create("laplacian", (64, 64), device="cpu")   # Create
    out = rt.compute(plan, field)                            # Compute
    field, out = rt.swap((out, field))                       # Swap
    rt.destroy(plan)                                         # Destroy
"""

from repro_torch.api import compute, create, destroy, swap
from repro_torch.core.cahn_hilliard import (
    CahnHilliardADI,
    CHConfig,
    ch_evolve,
    deep_quench_ic,
)

__all__ = [
    "CHConfig",
    "CahnHilliardADI",
    "ch_evolve",
    "compute",
    "create",
    "deep_quench_ic",
    "destroy",
    "swap",
]
