"""Carry the reference's state across: turn numpy arrays into the port's
objects.

The reference's factor sets, ADI operators (2D and 3D) and stencil plans
(2D, batched-1D and 3D) hold arrays;
pass ``np.asarray`` of each and these functions build the port's
counterpart on ``device``.  Feeding the reference's own factors to the
port separates differences in the substitution from differences in the
factorisation.  Each function also carries a reference plan's ``streams``
and ``max_tile_bytes`` across, and its fft backend's Create-time symbols
(a plan's ``symbol``, an operator's ``sym_x``/``sym_y``/``sym_z``; complex
arrays), so the symbols can be held apart from the transforms.
A reference ``DomainDecomposition`` crosses as its mesh's shape and axis
names (:func:`mesh_layout`), from which :func:`domain_decomposition`
builds the port's over the initialised ``torch.distributed`` world.  An LM
parameter tree crosses leaf for leaf (:func:`lm_params`; :func:`lm_numpy`
goes back).
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.adi import ADIOperator, ADIOperator3D
from repro_torch.core.stencil import (
    Stencil2D,
    Stencil3D,
    StencilBatch1D,
    plan_taps_of,
)
from repro_torch.kernels.penta import CyclicPentaFactors, PentaFactors
from repro_torch.kernels.ref import weighted_point_fn
from repro_torch.kernels.taps import halos_1d, halos_2d
from repro_torch.launch.stream import stream_fields
from repro_torch.util import resolve_device


def _tensor(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True, order="C"), device=device)


def _symbol(a, device) -> torch.Tensor | None:
    return None if a is None else _tensor(a, device)


def penta_factors(sub, low, inv_mu, al, be, *, device="cuda") -> PentaFactors:
    """A :class:`PentaFactors` from the five factor arrays (length M)."""
    dev = resolve_device(device)
    return PentaFactors(*(_tensor(a, dev) for a in (sub, low, inv_mu, al, be)))


def cyclic_penta_factors(
    band: Sequence, z, s_inv, w, *, device="cuda"
) -> CyclicPentaFactors:
    """A :class:`CyclicPentaFactors` from the band's five factor arrays and
    the Woodbury arrays ``z`` (M, 4), ``s_inv`` (4, 4), ``w`` (M, 4)."""
    dev = resolve_device(device)
    return CyclicPentaFactors(
        penta_factors(*band, device=dev),
        _tensor(z, dev), _tensor(s_inv, dev), _tensor(w, dev),
    )


def adi_operator(
    fac_x: PentaFactors | CyclicPentaFactors,
    fac_y: PentaFactors | CyclicPentaFactors,
    *,
    backend: str = "auto",
    operator: str = "hyperdiffusion",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    sym_x=None,
    sym_y=None,
) -> ADIOperator:
    """A 2D :class:`ADIOperator` from two converted factor sets (cyclic when
    both are cyclic), with the reference operator's streaming knobs and
    band symbols."""
    cyclic = isinstance(fac_x, CyclicPentaFactors)
    if cyclic != isinstance(fac_y, CyclicPentaFactors):
        raise ValueError("fac_x and fac_y must both be cyclic or both plain")
    device = (fac_x.band if cyclic else fac_x).sub.device
    return ADIOperator(
        fac_x=fac_x, fac_y=fac_y, cyclic=cyclic, backend=backend,
        operator=operator, sym_x=_symbol(sym_x, device),
        sym_y=_symbol(sym_y, device),
        **stream_fields(streams, max_tile_bytes, device),
    )


def adi_operator_3d(
    fac_x: PentaFactors | CyclicPentaFactors,
    fac_y: PentaFactors | CyclicPentaFactors,
    fac_z: PentaFactors | CyclicPentaFactors,
    *,
    backend: str = "auto",
    operator: str = "hyperdiffusion",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    sym_x=None,
    sym_y=None,
    sym_z=None,
) -> ADIOperator3D:
    """A :class:`ADIOperator3D` from three converted factor sets (cyclic
    when all three are cyclic), with the reference operator's streaming
    knobs and band symbols."""
    kinds = {isinstance(f, CyclicPentaFactors) for f in (fac_x, fac_y, fac_z)}
    if len(kinds) != 1:
        raise ValueError("fac_x, fac_y and fac_z must all be cyclic or all plain")
    cyclic = kinds.pop()
    device = (fac_x.band if cyclic else fac_x).sub.device
    return ADIOperator3D(
        fac_x=fac_x, fac_y=fac_y, fac_z=fac_z, cyclic=cyclic,
        backend=backend, operator=operator, sym_x=_symbol(sym_x, device),
        sym_y=_symbol(sym_y, device), sym_z=_symbol(sym_z, device),
        **stream_fields(streams, max_tile_bytes, device),
    )


def _check_weighted(coeffs_t: torch.Tensor, point_fn: Callable, n: int) -> None:
    if point_fn is weighted_point_fn and coeffs_t.numel() != n:
        raise ValueError("weighted coeffs must hold one weight per window")


def stencil_batch1d(
    coeffs,
    *,
    left: int,
    right: int,
    bc: str = "periodic",
    point_fn: Callable = weighted_point_fn,
    backend: str = "auto",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    symbol=None,
    device="cuda",
) -> StencilBatch1D:
    """A :class:`StencilBatch1D` from its ``coeffs`` (left to right),
    extents, streaming knobs and fft symbol."""
    dev = resolve_device(device)
    coeffs_t = _tensor(coeffs, dev).reshape(-1)
    _check_weighted(coeffs_t, point_fn, left + right + 1)
    return StencilBatch1D(
        bc=bc, left=left, right=right, coeffs=coeffs_t, point_fn=point_fn,
        backend=backend, taps=plan_taps_of(coeffs_t, point_fn, halos_1d(left, right)),
        symbol=_symbol(symbol, dev), **stream_fields(streams, max_tile_bytes, dev),
    )


def stencil3d(
    coeffs,
    *,
    halos,
    bc: str = "periodic",
    point_fn: Callable = weighted_point_fn,
    backend: str = "auto",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    symbol=None,
    device="cuda",
) -> Stencil3D:
    """A :class:`Stencil3D` from flat ``coeffs`` (z-major, then row-major
    over (y, x)), ``halos`` ``(front, back, top, bottom, left, right)``,
    its streaming knobs and fft symbol."""
    fr, bk, tp, bt, lf, rt = (int(h) for h in halos)
    dev = resolve_device(device)
    coeffs_t = _tensor(coeffs, dev).reshape(-1)
    _check_weighted(coeffs_t, point_fn, (fr + bk + 1) * (tp + bt + 1) * (lf + rt + 1))
    axes = "".join(a for a, on in (("x", lf or rt), ("y", tp or bt), ("z", fr or bk)) if on)
    return Stencil3D(
        direction=axes if len(axes) == 1 else "xyz", bc=bc, front=fr, back=bk,
        top=tp, bottom=bt, left=lf, right=rt, coeffs=coeffs_t,
        point_fn=point_fn, backend=backend,
        taps=plan_taps_of(coeffs_t, point_fn, (fr, bk, tp, bt, lf, rt)),
        symbol=_symbol(symbol, dev), **stream_fields(streams, max_tile_bytes, dev),
    )


def stencil2d(
    coeffs,
    *,
    left: int,
    right: int,
    top: int,
    bottom: int,
    bc: str = "periodic",
    point_fn: Callable = weighted_point_fn,
    backend: str = "auto",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    symbol=None,
    device="cuda",
) -> Stencil2D:
    """A :class:`Stencil2D` from flat ``coeffs`` (row-major from the
    stencil's top-left), its extents, its streaming knobs and fft
    symbol."""
    dev = resolve_device(device)
    coeffs_t = _tensor(coeffs, dev).reshape(-1)
    _check_weighted(coeffs_t, point_fn, (left + right + 1) * (top + bottom + 1))
    direction = "xy" if (left or right) and (top or bottom) else (
        "y" if (top or bottom) else "x"
    )
    return Stencil2D(
        direction=direction, bc=bc, left=left, right=right, top=top,
        bottom=bottom, coeffs=coeffs_t, point_fn=point_fn, backend=backend,
        taps=plan_taps_of(coeffs_t, point_fn, halos_2d(left, right, top, bottom)),
        symbol=_symbol(symbol, dev), **stream_fields(streams, max_tile_bytes, dev),
    )


def mesh_layout(dd) -> dict:
    """A reference ``DomainDecomposition``'s layout as plain Python: its
    mesh's ``shape`` and axis ``names`` (in the mesh's order) and its
    ``y_axis``, ``x_axis`` and ``ensemble_axis``."""
    names = tuple(str(n) for n in dd.mesh.axis_names)
    return dict(shape=tuple(int(dd.mesh.shape[n]) for n in names), names=names,
                y_axis=dd.y_axis, x_axis=dd.x_axis,
                ensemble_axis=dd.ensemble_axis)


def domain_decomposition(layout: dict):
    """The port's :class:`~repro_torch.core.domain.DomainDecomposition` of a
    :func:`mesh_layout`, on a mesh over the initialised world (whose size
    must be the mesh's)."""
    from repro_torch.core.domain import DomainDecomposition
    from repro_torch.launch.mesh import _make_mesh

    return DomainDecomposition(
        mesh=_make_mesh(tuple(layout["shape"]), tuple(layout["names"])),
        y_axis=layout["y_axis"], x_axis=layout["x_axis"],
        ensemble_axis=layout["ensemble_axis"])


def _leaf(a, device) -> torch.Tensor:
    """One numpy leaf as a tensor; bfloat16 (``ml_dtypes``, as
    ``jax.device_get`` gives it) crosses through its 16-bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.array(a, copy=True, order="C").view(np.uint16)
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return _tensor(a, device)


def lm_params(tree, cfg, *, device="cuda"):
    """The port's LM parameters from the reference's parameter tree (numpy
    leaves, e.g. ``jax.device_get(model.init(key))``).

    The tree keeps its layout leaf for leaf: stacked layers with their
    leading scan-step axis, a list of period stacks for hybrids, the
    encoder-decoder's ``enc_blocks``/``dec_blocks``.  Names, shapes and
    dtypes are held to the port's own tree for ``cfg``
    (:func:`repro_torch.models.api.param_shapes`); a mismatch raises
    ``ValueError`` naming the leaf."""
    from repro_torch.models.api import param_shapes

    dev = resolve_device(device)

    def conv(t, want, path):
        if isinstance(want, dict):
            if not isinstance(t, dict) or set(t) != set(want):
                raise ValueError(f"lm_params: {path or '/'} has keys "
                                 f"{sorted(t) if isinstance(t, dict) else t!r}"
                                 f", expected {sorted(want)}")
            return {k: conv(t[k], want[k], f"{path}/{k}") for k in want}
        if isinstance(want, (list, tuple)):
            if not isinstance(t, (list, tuple)) or len(t) != len(want):
                raise ValueError(f"lm_params: {path} is not a sequence of "
                                 f"{len(want)} stacks")
            return type(want)(conv(a, w, f"{path}/{i}")
                              for i, (a, w) in enumerate(zip(t, want)))
        x = _leaf(t, dev)
        if tuple(x.shape) != tuple(want.shape) or x.dtype != want.dtype:
            raise ValueError(f"lm_params: {path} is {tuple(x.shape)} "
                             f"{x.dtype}, expected {tuple(want.shape)} "
                             f"{want.dtype}")
        return x

    return conv(tree, param_shapes(cfg), "")


def lm_numpy(tree):
    """The port's LM parameters (or any tree of tensors) as numpy, leaf for
    leaf in the same layout; bfloat16 leaves come back as float32 (exact)."""
    if isinstance(tree, dict):
        return {k: lm_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(lm_numpy(v) for v in tree)
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
