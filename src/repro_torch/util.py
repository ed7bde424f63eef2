"""Small shared helpers of the PyTorch port (counterpart of ``repro.util``)."""

from __future__ import annotations

import warnings

import numpy as np
import torch

_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def warn_deprecated(old: str, new: str, *, stacklevel: int = 3) -> None:
    """The one-release deprecation warning of a pre-facade name (the nine
    per-dimension ``stencil_*`` functions and both ``make_adi_operator*``
    factories), with the reference's text for this package."""
    warnings.warn(
        f"{old} is deprecated; use repro_torch.{new} — "
        "the unified four-function facade (repro_torch.api)",
        DeprecationWarning,
        stacklevel=stacklevel,
    )


def deprecated_shim(old: str, new: str, impl):
    """Wrap a pre-facade entry point: warn via :func:`warn_deprecated` on
    every call, then delegate to the private implementation."""

    def shim(*args, **kwargs):
        warn_deprecated(old, new)
        return impl(*args, **kwargs)

    shim.__name__ = shim.__qualname__ = old
    shim.__doc__ = (
        f"Deprecated alias (one release): use ``repro_torch.{new}``, the "
        f"four-function facade of :mod:`repro_torch.api`.  Behaves as the "
        f"pre-facade ``{old}``; every call emits a ``DeprecationWarning``."
    )
    return shim


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


def tree_leaves(tree) -> list:
    """The leaves of a tree of nested dicts, lists and tuples in jax's
    order: dict keys sorted, sequences by index, ``None`` an empty
    subtree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree, *rest):
    """``fn(leaf, *others)`` at each leaf of ``tree``, where ``others`` are
    the entries of the trees in ``rest`` at the same place: a whole subtree
    where ``tree`` has a leaf, as jax's ``flatten_up_to``.  Dicts are
    rebuilt with sorted keys; ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return None if tree is None else fn(tree, *rest)
