"""repro_torch — the PyTorch and CUDA port of the cuSten reproduction.

A second package beside ``repro`` (the JAX reference), with the same module
paths and names.  It imports torch and numpy only, never jax or ``repro``.
Every entry point runs on the card (``device='cuda'``) unless the caller
asks for the CPU; on a CUDA tensor each kernel op launches its hand-written
CUDA kernel (``repro_torch/kernels/csrc``), on a CPU tensor it runs the
plain PyTorch version.  ``backend='fft'`` runs a periodic plan or a cyclic
ADI operator through ``torch.fft`` instead::

    import repro_torch as rt
    plan = rt.create("laplacian", (64, 64), device="cpu")   # Create
    out = rt.compute(plan, field)                            # Compute
    field, out = rt.swap((out, field))                       # Swap
    rt.destroy(plan)                                         # Destroy

The public surface is the reference's (``repro.__all__``), the pre-facade
per-dimension names included as deprecation shims, plus the Cahn–Hilliard
solver's four names.
"""

from repro_torch.api import (
    OperatorDef,
    compute,
    create,
    destroy,
    get_operator,
    operator_names,
    plan_key,
    register_operator,
    swap,
)
from repro_torch.core.adi import (
    ADIOperator,
    ADIOperator3D,
    make_adi_operator,
    make_adi_operator_3d,
)
from repro_torch.core.cahn_hilliard import (
    CahnHilliardADI,
    CHConfig,
    ch_evolve,
    deep_quench_ic,
)
from repro_torch.core.stencil import (
    DoubleBuffer,
    PlanCore,
    Stencil2D,
    Stencil3D,
    StencilBatch1D,
    central_difference_weights,
    laplacian3d_weights,
    plan_destroy,
    stencil_compute_1d_batch,
    stencil_compute_2d,
    stencil_compute_3d,
    stencil_create_1d_batch,
    stencil_create_2d,
    stencil_create_3d,
    stencil_destroy_1d_batch,
    stencil_destroy_2d,
    stencil_destroy_3d,
)
from repro_torch.kernels.spectral import SpectralBackendError

__all__ = [
    # the four-function facade + operator registry (repro_torch.api)
    "create",
    "compute",
    "swap",
    "destroy",
    "register_operator",
    "get_operator",
    "operator_names",
    "plan_key",
    "OperatorDef",
    # plan classes
    "PlanCore",
    "Stencil2D",
    "StencilBatch1D",
    "Stencil3D",
    "ADIOperator",
    "ADIOperator3D",
    "DoubleBuffer",
    # the spectral (fft) backend's named Create-time refusal
    "SpectralBackendError",
    # engine-level destroy + weight helpers
    "plan_destroy",
    "central_difference_weights",
    "laplacian3d_weights",
    # deprecated pre-facade entry points (one release, warn on call)
    "stencil_create_2d",
    "stencil_compute_2d",
    "stencil_destroy_2d",
    "stencil_create_1d_batch",
    "stencil_compute_1d_batch",
    "stencil_destroy_1d_batch",
    "stencil_create_3d",
    "stencil_compute_3d",
    "stencil_destroy_3d",
    "make_adi_operator",
    "make_adi_operator_3d",
    # the Cahn–Hilliard ADI solver (the paper's application)
    "CHConfig",
    "CahnHilliardADI",
    "ch_evolve",
    "deep_quench_ic",
]
