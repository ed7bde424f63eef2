"""Small shared helpers of the PyTorch port (counterpart of ``repro.util``)."""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def next_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is ``>= n``."""
    return ceil_div(n, m) * m


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = np.dtype(dtype).name if not isinstance(dtype, str) else dtype
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {dtype!r}") from None


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch floating dtype (host-side factorisation)."""
    dt = torch_dtype(dtype)
    if dt == torch.float64:
        return np.dtype(np.float64)
    if dt == torch.float32:
        return np.dtype(np.float32)
    raise ValueError(f"no host factorisation in {dt}")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.

    ``'cuda'`` is every entry point's default; on a host without a card it
    raises here instead of running on the CPU, so a CPU run is always one
    the caller asked for with ``device='cpu'``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch path"
        )
    return dev


def refuse_unported(*, tune="off", lint=None) -> None:
    """Raise for a reference knob this port does not have yet, naming the
    ROADMAP.md item that ports it by its title (never silently ignored)."""
    if tune != "off":
        raise NotImplementedError(
            f"tune={tune!r}: Create-time autotuning is not ported yet "
            "(ROADMAP.md, Open items: Tuning); only tune='off' is accepted"
        )
    if lint not in (None, "off"):
        raise NotImplementedError(
            f"lint={lint!r}: stencil-lint is not ported yet (ROADMAP.md, "
            "Open items: Analysis)"
        )


def tolerance_for(dtype, scale: float = 1.0) -> dict:
    """allclose tolerances per dtype for kernel <-> plain-version checks.

    ``scale`` loosens both tolerances for paths with a longer rounding
    chain (substitution recurrences, multi-step runs), keeping the
    per-dtype baseline in one place."""
    dt = torch_dtype(dtype)
    if dt == torch.float64:
        tol = dict(rtol=1e-12, atol=1e-12)
    elif dt == torch.float32:
        tol = dict(rtol=1e-5, atol=1e-5)
    elif dt == torch.bfloat16:
        tol = dict(rtol=2e-2, atol=2e-2)
    elif dt == torch.float16:
        tol = dict(rtol=2e-3, atol=2e-3)
    else:
        tol = dict(rtol=1e-5, atol=1e-5)
    if scale != 1.0:
        tol = {k: v * scale for k, v in tol.items()}
    return tol
