"""Streamed execution for the 2D, batched-1D and 3D paths (paper §III,
cuSten's ``nStreams``; counterpart of ``repro.launch.stream``).

cuSten cuts a ``(ny, nx)`` field into row chunks and computes them on
``nStreams`` overlapping CUDA streams; the 3D paths lift it one axis up
(z-slabs of an ``(nz, ny, nx)`` field, plane chunks of the 3D y-sweep).
Here:

- the chunk geometry is the reference's (:func:`choose_chunk_rows`,
  :func:`choose_chunk_cols`, :func:`should_stream`), plain Python: the
  largest divisor of the extent whose halo-padded slab fits
  ``max_tile_bytes``, preferring chunk counts that are a multiple of
  ``streams``;
- each chunk is ONE launch of the ported kernel on a window of the whole
  field (rows for the 2D stencil, the CH RHS, the fused RHS + x-sweep and
  the row-layout sweep; lines for the batched-1D stencil; columns for the
  column-layout sweep; planes for the 3D stencil and the plane-layout
  sweep).  The kernel reads the chunk's halo from the whole
  field with its own wrap, so no slab is copied, and every point is
  computed by the same code from the same inputs as in the monolithic
  launch: on the card a streamed result equals the monolithic one bit for
  bit;
- chunk ``k`` is issued on stream ``k mod S`` of the plan's pool
  (:func:`make_stream_pool`, ``S = streams``, made at Create).  Before the
  first launch every side stream waits on the caller's current stream;
  before the executor returns, the caller's stream waits on each side
  stream.  Outputs are allocated on the caller's stream before the chunk
  loop and nothing is allocated inside it, so the caching allocator never
  hands their memory to another stream while a chunk still uses it;
- on a CPU tensor the same chunk loop runs the plain versions on each
  window (slabs gathered with the periodic wrap), with no streams; they
  equal the monolithic plain versions bit for bit too.

The fused RHS + x-sweep's geometry (streams x chunk rows) is tuned at
Create by ``CHConfig.tune``
(:meth:`repro_torch.core.cahn_hilliard.CahnHilliardADI._tune_stream_geometry`).
Not ported yet, and refused where a caller could reach it: the
multi-device path (:func:`stream_stencil_apply_dist`; ROADMAP.md, Open
items: Distribution).
"""

from __future__ import annotations

import math
from collections.abc import Callable, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_ch import ch_rhs_cuda, ch_rhs_xsweep_cuda
from repro_torch.kernels.penta import (
    cyclic_penta_solve_factored,
    cyclic_penta_solve_factored_mid,
    cyclic_penta_solve_factored_rows,
    penta_cols_cuda,
    penta_mid_cuda,
    penta_rows_cuda,
    penta_solve_factored,
    penta_solve_factored_mid,
    penta_solve_factored_rows,
    rows_woodbury_correct,
    substitute_rows_torch,
)
from repro_torch.kernels.ref import (
    _np_mask,
    ch_rhs_band,
    interior_mask,
    stencil1d_batch_ref,
    weighted_point_fn,
)
from repro_torch.kernels.stencil1d_batch import in_layout, stencil1d_batch_cuda
from repro_torch.kernels.stencil2d import stencil2d_cuda
from repro_torch.kernels.stencil3d import stencil3d_cuda
from repro_torch.util import ceil_div

# ---------------------------------------------------------------------------
# Chunk geometry (reference stream.py:53-118, :589, :1212-1243)
# ---------------------------------------------------------------------------


def _divisors_desc(n: int):
    divs = []
    d = 1
    while d * d <= n:
        if n % d == 0:
            divs.append(d)
            if d != n // d:
                divs.append(n // d)
        d += 1
    return sorted(divs, reverse=True)


def slab_bytes(
    rows: int, nx: int, itemsize: int, *, top: int, bottom: int,
    left: int, right: int,
) -> int:
    """Bytes of one halo-padded chunk slab."""
    return (rows + top + bottom) * (nx + left + right) * itemsize


def choose_chunk_rows(
    ny: int,
    nx: int,
    itemsize: int,
    *,
    top: int = 0,
    bottom: int = 0,
    left: int = 0,
    right: int = 0,
    max_tile_bytes: int | None = None,
    streams: int | None = None,
) -> int:
    """Pick the row-chunk height (cuSten's per-stream tile of rows).

    The largest divisor of ``ny`` whose halo-padded slab fits the
    ``max_tile_bytes`` budget; among equally feasible heights, ones whose
    chunk count is a multiple of ``streams`` are preferred.  Falls back to
    single-row chunks when even one padded row exceeds the budget."""
    budget = math.inf if max_tile_bytes is None else max_tile_bytes
    feasible = [
        r
        for r in _divisors_desc(ny)
        if slab_bytes(r, nx, itemsize, top=top, bottom=bottom,
                      left=left, right=right) <= budget
    ]
    if not feasible:
        return 1
    if streams and streams > 1:
        aligned = [r for r in feasible if (ny // r) % streams == 0]
        if aligned:
            return aligned[0]
    return feasible[0]


def _effective_streams(streams: int | None, n_chunks: int) -> int:
    """Largest group width <= ``streams`` that divides the chunk count."""
    if not streams or streams <= 1:
        return 1
    return math.gcd(min(streams, n_chunks), n_chunks)


def choose_chunk_cols(
    M: int, N: int, itemsize: int, *, max_tile_bytes: int | None,
) -> int:
    """Column-chunk width for a batched ``(M, N)`` solve under the same
    byte budget (each chunk is ``M * cols`` values; columns are independent
    systems so any divisor of ``N`` is valid)."""
    if max_tile_bytes is None:
        return N
    feasible = [c for c in _divisors_desc(N) if M * c * itemsize <= max_tile_bytes]
    return feasible[0] if feasible else 1


def should_stream(
    shape: tuple[int, ...],
    itemsize: int,
    *,
    streams: int | None,
    max_tile_bytes: int | None,
) -> bool:
    """The plan routes through the streamed executor when a knob is set and
    the field exceeds one tile (or several streams are asked for); a field
    within budget on one stream keeps the monolithic path."""
    nbytes = itemsize
    for s in shape:
        nbytes *= s
    if max_tile_bytes is not None and nbytes > max_tile_bytes:
        return True
    return bool(streams and streams > 1)


def n_chunks_for(
    ny: int, nx: int, itemsize: int, *, halos=(0, 0, 0, 0),
    max_tile_bytes: int | None = None, streams: int | None = None,
) -> int:
    """How many row chunks the executor would use, for halos ``(top,
    bottom, left, right)``."""
    top, bottom, left, right = halos
    rows = choose_chunk_rows(
        ny, nx, itemsize, top=top, bottom=bottom, left=left, right=right,
        max_tile_bytes=max_tile_bytes, streams=streams,
    )
    return ceil_div(ny, rows)


def resolve_compute(backend: str, tensor: torch.Tensor) -> str:
    """The per-chunk evaluator of a plan ``backend``, as the monolithic
    dispatch picks it: ``'auto'`` is the kernel on a CUDA tensor and the
    plain version on a CPU tensor, so streaming never runs the plain
    version where the monolithic path would launch the kernel."""
    return _build.resolve_backend(backend, tensor)


# ---------------------------------------------------------------------------
# Streams
# ---------------------------------------------------------------------------


def make_stream_pool(streams: int | None, device) -> tuple:
    """The CUDA streams a streamed plan issues its chunks on, made at
    Create: ``streams`` side streams on a CUDA device when ``streams > 1``;
    none otherwise (every chunk then goes on the caller's stream)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not streams or streams <= 1:
        return ()
    return tuple(torch.cuda.Stream(device=dev) for _ in range(streams))


def stream_fields(streams: int | None, max_tile_bytes: int | None,
                  device) -> dict:
    """The streaming fields of a plan or ADI operator: the two knobs and
    the pool of :func:`make_stream_pool`."""
    return dict(streams=streams, max_tile_bytes=max_tile_bytes,
                stream_pool=make_stream_pool(streams, device))


def _windows(n: int, size: int, what: str) -> list[tuple[int, int]]:
    if size < 1 or n % size:
        raise ValueError(f"chunk_{what}={size} must divide {n}")
    return [(k, k + size) for k in range(0, n, size)]


def _issue(windows: Sequence, launch: Callable, pool: Sequence,
           device: torch.device) -> None:
    """``launch(window)`` for every window, window ``k`` on ``pool[k % S]``
    (S streams of the pool, at most one per window); with no pool, all on
    the caller's stream."""
    if not pool:
        for w in windows:
            launch(w)
        return
    used = pool[: len(windows)]
    if any(s.device != device for s in used):
        raise ValueError(f"the plan's streams are not on {device}")
    caller = torch.cuda.current_stream(device)
    for s in used:
        s.wait_stream(caller)
    for k, w in enumerate(windows):
        with torch.cuda.stream(used[k % len(used)]):
            launch(w)
    for s in used:
        caller.wait_stream(s)


def _rows_of(x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """Rows ``a .. b - 1`` of ``x`` with the periodic wrap."""
    return x.index_select(0, torch.arange(a, b, device=x.device) % x.shape[0])


# ---------------------------------------------------------------------------
# The streamed executors
# ---------------------------------------------------------------------------


def _stencil2d_rows_torch(data, coeffs, out_init, r0, r1, *, point_fn, left,
                          right, top, bottom, bc):
    """Plain version on the rows [r0, r1): the windows of
    :func:`repro_torch.kernels.ref.stencil2d_ref`, in its order, from a slab
    with ``top``/``bottom`` halo rows."""
    rows = r1 - r0
    slab = _rows_of(data, r0 - top, r1 + bottom)
    wins = [
        torch.roll(slab[a : a + rows], shifts=left - b, dims=1)
        for a in range(top + bottom + 1)
        for b in range(left + right + 1)
    ]
    out = point_fn(wins, coeffs)
    if bc == "np":
        mask = interior_mask(data.shape, left=left, right=right, top=top,
                             bottom=bottom)[r0:r1]
        out = _np_mask(out, mask, None if out_init is None else out_init[r0:r1])
    return out


def stream_stencil_apply(
    data: torch.Tensor,
    coeffs: torch.Tensor,
    out_init: torch.Tensor | None = None,
    *,
    point_fn: Callable = weighted_point_fn,
    left: int = 0,
    right: int = 0,
    top: int = 0,
    bottom: int = 0,
    bc: str = "periodic",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    chunk_rows: int | None = None,
    compute: str = "auto",
    pool: Sequence = (),
    taps=None,
) -> torch.Tensor:
    """Streamed 2D stencil apply: the contract (and, chunk for chunk, the
    arithmetic) of :func:`repro_torch.kernels.ops.stencil_apply`, issued as
    row chunks.  ``chunk_rows`` overrides the geometry; ``compute`` is a
    backend (``'auto'|'cuda'|'torch'``); ``taps``, the plan's non-zero
    taps, go to every chunk's launch."""
    if bc not in ("periodic", "np"):
        raise ValueError(f"bc must be 'periodic' or 'np', got {bc!r}")
    ny, nx = data.shape
    rows = chunk_rows or choose_chunk_rows(
        ny, nx, data.element_size(), top=top, bottom=bottom, left=left,
        right=right, max_tile_bytes=max_tile_bytes, streams=streams,
    )
    windows = _windows(ny, rows, "rows")
    kw = dict(point_fn=point_fn, left=left, right=right, top=top,
              bottom=bottom, bc=bc)
    out = torch.empty_like(data)
    if resolve_compute(compute, data) == "cuda":
        init = out_init if bc == "np" else None
        _issue(windows, lambda w: stencil2d_cuda(
            data, coeffs, init, rows=w, out=out, taps=taps, **kw), pool,
            data.device)
        return out
    for r0, r1 in windows:
        out[r0:r1] = _stencil2d_rows_torch(data, coeffs, out_init, r0, r1, **kw)
    return out


def stream_batch1d_apply(
    data: torch.Tensor,
    coeffs: torch.Tensor,
    out_init: torch.Tensor | None = None,
    *,
    point_fn: Callable = weighted_point_fn,
    left: int = 0,
    right: int = 0,
    bc: str = "periodic",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    chunk_rows: int | None = None,
    compute: str = "auto",
    pool: Sequence = (),
    taps=None,
) -> torch.Tensor:
    """Streamed batched-1D apply on a ``(B, M)`` stack (contiguous, or the
    transpose of a contiguous field, read in place): lines never couple, so
    chunks are groups of whole lines with no halo, the ``top = bottom = 0``
    geometry of the 2D executor.  ``taps`` as for
    :func:`stream_stencil_apply`."""
    if bc not in ("periodic", "np"):
        raise ValueError(f"bc must be 'periodic' or 'np', got {bc!r}")
    B, M = data.shape
    rows = chunk_rows or choose_chunk_rows(
        B, M, data.element_size(), left=left, right=right,
        max_tile_bytes=max_tile_bytes, streams=streams,
    )
    windows = _windows(B, rows, "rows")
    kw = dict(point_fn=point_fn, left=left, right=right, bc=bc)
    if resolve_compute(compute, data) == "cuda":
        init = None
        if bc == "np" and out_init is not None:
            init = in_layout(out_init, data)
        out = torch.empty_like(data)  # data's layout, as the kernel writes
        _issue(windows, lambda w: stencil1d_batch_cuda(
            data, coeffs, init, lines=w, out=out, taps=taps, **kw), pool,
            data.device)
        return out
    out = torch.empty_like(data)
    for b0, b1 in windows:
        out[b0:b1] = stencil1d_batch_ref(
            data[b0:b1], coeffs=coeffs,
            out_init=None if out_init is None else out_init[b0:b1], **kw)
    return out


def stream_penta_solve(
    fac,
    rhs: torch.Tensor,
    *,
    cyclic: bool,
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    chunk_cols: int | None = None,
    backend: str = "auto",
    pool: Sequence = (),
) -> torch.Tensor:
    """Streamed column-layout substitution on an ``(M, N)`` rhs (the
    y-sweep): the batch axis cut into column chunks, one launch each."""
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[:, None]
    M, N = rhs.shape
    cols = chunk_cols or choose_chunk_cols(
        M, N, rhs.element_size(), max_tile_bytes=max_tile_bytes)
    windows = _windows(N, cols, "cols")
    solve = cyclic_penta_solve_factored if cyclic else penta_solve_factored
    if len(windows) == 1:
        out = solve(fac, rhs, backend=backend)
    elif resolve_compute(backend, rhs) == "cuda":
        band, w = (fac.band, fac.w) if cyclic else (fac, None)
        out = torch.empty_like(rhs)
        _issue(windows, lambda c: penta_cols_cuda(
            band, rhs, w, cols=c, out=out), pool, rhs.device)
    else:
        out = torch.empty_like(rhs)
        for c0, c1 in windows:
            out[:, c0:c1] = solve(fac, rhs[:, c0:c1], backend="torch")
    return out[:, 0] if squeeze else out


def stream_penta_solve_rows(
    fac,
    rhs: torch.Tensor,
    *,
    cyclic: bool,
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    chunk_rows: int | None = None,
    backend: str = "auto",
    pool: Sequence = (),
) -> torch.Tensor:
    """Streamed row-layout substitution on a ``(B, M)`` rhs (the
    transpose-free x-sweep): every row is one system, so the batch axis
    streams as row chunks with no halo, one launch each."""
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[None, :]
    B, M = rhs.shape
    rows = chunk_rows or choose_chunk_rows(
        B, M, rhs.element_size(), max_tile_bytes=max_tile_bytes,
        streams=streams,
    )
    windows = _windows(B, rows, "rows")
    solve = (cyclic_penta_solve_factored_rows if cyclic
             else penta_solve_factored_rows)
    if len(windows) == 1:
        out = solve(fac, rhs, backend=backend)
    elif resolve_compute(backend, rhs) == "cuda":
        band, w = (fac.band, fac.w) if cyclic else (fac, None)
        out = torch.empty_like(rhs)
        _issue(windows, lambda r: penta_rows_cuda(
            band, rhs, w, rows=r, out=out), pool, rhs.device)
    else:
        out = torch.empty_like(rhs)
        for r0, r1 in windows:
            out[r0:r1] = solve(fac, rhs[r0:r1], backend="torch")
    return out[0] if squeeze else out


def _ch_rhs_rows_torch(c_n, c_nm1, r0, r1, **kw):
    """Plain windowed RHS on the rows [r0, r1): ``ch_rhs_band`` on the
    halo-2 slab of each field (rows and columns wrapped), which is the
    matching block of :func:`repro_torch.kernels.ref.ch_rhs_win`'s padded
    field."""
    nx = c_n.shape[1]
    cols = torch.arange(-2, nx + 2, device=c_n.device) % nx

    def slab(x):
        return _rows_of(x, r0 - 2, r1 + 2).index_select(1, cols)

    return ch_rhs_band(slab(c_n), slab(c_nm1), r1 - r0, nx, **kw)


def _ch_rows(c_n, max_tile_bytes, streams, chunk_rows):
    ny, nx = c_n.shape
    rows = chunk_rows or choose_chunk_rows(
        ny, nx, c_n.element_size(), top=2, bottom=2, left=2, right=2,
        max_tile_bytes=max_tile_bytes, streams=streams,
    )
    return _windows(ny, rows, "rows")


def stream_ch_rhs(
    c_n: torch.Tensor,
    c_nm1: torch.Tensor,
    *,
    dt: float,
    D: float,
    gamma: float,
    inv_h2: float,
    inv_h4: float,
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    chunk_rows: int | None = None,
    backend: str = "auto",
    pool: Sequence = (),
) -> torch.Tensor:
    """Streamed eq. 2a explicit RHS (periodic, halo 2, two input fields):
    row chunks of :func:`repro_torch.kernels.ops.ch_rhs`."""
    kw = dict(dt=float(dt), D=float(D), gamma=float(gamma),
              inv_h2=float(inv_h2), inv_h4=float(inv_h4))
    windows = _ch_rows(c_n, max_tile_bytes, streams, chunk_rows)
    out = torch.empty_like(c_n)
    if resolve_compute(backend, c_n) == "cuda":
        _issue(windows, lambda w: ch_rhs_cuda(
            c_n, c_nm1, rows=w, out=out, **kw), pool, c_n.device)
        return out
    for r0, r1 in windows:
        out[r0:r1] = _ch_rhs_rows_torch(c_n, c_nm1, r0, r1, **kw)
    return out


def stream_ch_rhs_xsweep(
    c_n: torch.Tensor,
    c_nm1: torch.Tensor,
    fac_x,
    *,
    dt: float,
    D: float,
    gamma: float,
    inv_h2: float,
    inv_h4: float,
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    chunk_rows: int | None = None,
    backend: str = "auto",
    pool: Sequence = (),
) -> torch.Tensor:
    """Streamed ``L_x^{-1} rhs(c_n, c_nm1)``: each row chunk assembles its
    RHS and runs its x-sweep in one launch of the fused kernel (rows are
    independent systems of the x-sweep), so the RHS never exists as a
    full-field intermediate.  The reference streams the RHS assembly and
    then sweeps the whole field at once; the result is the same."""
    kw = dict(dt=float(dt), D=float(D), gamma=float(gamma),
              inv_h2=float(inv_h2), inv_h4=float(inv_h4))
    windows = _ch_rows(c_n, max_tile_bytes, streams, chunk_rows)
    out = torch.empty_like(c_n)
    if resolve_compute(backend, c_n) == "cuda":
        _issue(windows, lambda w: ch_rhs_xsweep_cuda(
            c_n, c_nm1, fac_x, rows=w, out=out, **kw), pool, c_n.device)
        return out
    for r0, r1 in windows:
        rhs = _ch_rhs_rows_torch(c_n, c_nm1, r0, r1, **kw)
        out[r0:r1] = rows_woodbury_correct(
            substitute_rows_torch(fac_x.band, rhs), fac_x.w)
    return out


def _stencil3d_slab_torch(data, coeffs, out_init, k0, k1, *, point_fn,
                          halos, bc):
    """Plain version on the planes [k0, k1): the z-major windows of the
    reference's ``_slab_windows_3d``, in its order, sliced from the slab of
    planes ``k0 - fr .. k1 + bk - 1`` padded in y and x, every index
    wrapped.  The reference pads ``bc='np'`` with zeros instead; the
    interior's windows never reach the pad, and the other cells take
    ``out_init``."""
    fr, bk, tp, bt, lf, rt = halos
    nz, ny, nx = data.shape
    dev = data.device

    def wrapped(a, b, n):
        return torch.arange(a, b, device=dev) % n

    slab = (data.index_select(0, wrapped(k0 - fr, k1 + bk, nz))
            .index_select(1, wrapped(-tp, ny + bt, ny))
            .index_select(2, wrapped(-lf, nx + rt, nx)))
    planes = k1 - k0
    wins = [slab[c : c + planes, a : a + ny, b : b + nx]
            for c in range(fr + bk + 1)
            for a in range(tp + bt + 1)
            for b in range(lf + rt + 1)]
    out = point_fn(wins, coeffs)
    if bc == "np":
        kk = torch.arange(k0, k1, device=dev)[:, None, None]
        jj = torch.arange(ny, device=dev)[None, :, None]
        ii = torch.arange(nx, device=dev)[None, None, :]
        mask = ((kk >= fr) & (kk < nz - bk) & (jj >= tp) & (jj < ny - bt)
                & (ii >= lf) & (ii < nx - rt))
        base = (torch.zeros_like(out) if out_init is None
                else out_init[k0:k1].to(out.dtype))
        out = torch.where(mask, out, base)
    return out


def stream_stencil3d_apply(
    data: torch.Tensor,
    coeffs: torch.Tensor,
    out_init: torch.Tensor | None = None,
    *,
    point_fn: Callable = weighted_point_fn,
    halos=(0, 0, 0, 0, 0, 0),
    bc: str = "periodic",
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    chunk_slabs: int | None = None,
    compute: str = "auto",
    pool: Sequence = (),
    taps=None,
) -> torch.Tensor:
    """Streamed 3D stencil apply: the contract (and, slab for slab, the
    arithmetic) of :func:`repro_torch.kernels.ops.stencil_apply_3d`, issued
    as z-slabs.  ``chunk_slabs`` overrides the geometry (slabs of that many
    planes); otherwise the largest divisor of nz whose halo-padded slab,
    ``(planes + front + back)`` planes of ``(ny + top + bottom) x (nx +
    left + right)``, fits ``max_tile_bytes``, as the reference reckons it.
    On the card each slab is one launch of the 3D kernel on its window of
    planes, its halo planes read from the whole field."""
    if bc not in ("periodic", "np"):
        raise ValueError(f"bc must be 'periodic' or 'np', got {bc!r}")
    nz, ny, nx = data.shape
    halos = tuple(int(h) for h in halos)
    fr, bk, tp, bt, lf, rt = halos
    planes = chunk_slabs or choose_chunk_rows(
        nz, (ny + tp + bt) * (nx + lf + rt), data.element_size(),
        top=fr, bottom=bk, max_tile_bytes=max_tile_bytes, streams=streams,
    )
    windows = _windows(nz, planes, "slabs")
    kw = dict(point_fn=point_fn, halos=halos, bc=bc)
    out = torch.empty_like(data)
    if resolve_compute(compute, data) == "cuda":
        init = out_init if bc == "np" else None
        _issue(windows, lambda w: stencil3d_cuda(
            data, coeffs, init, planes=w, out=out, taps=taps, **kw), pool,
            data.device)
        return out
    for k0, k1 in windows:
        out[k0:k1] = _stencil3d_slab_torch(data, coeffs, out_init, k0, k1,
                                           **kw)
    return out


def stream_penta_solve_mid(
    fac,
    rhs: torch.Tensor,
    *,
    cyclic: bool,
    streams: int | None = None,
    max_tile_bytes: int | None = None,
    chunk_planes: int | None = None,
    backend: str = "auto",
    pool: Sequence = (),
) -> torch.Tensor:
    """Streamed plane-layout substitution on a ``(P, M, N)`` rhs (the 3D
    y-sweep): every ``(p, :, n)`` line is one system, so the plane axis
    streams as plane chunks with no halo, one launch each."""
    if rhs.ndim != 3:
        raise ValueError(f"plane layout takes a (P, M, N) rhs, got {tuple(rhs.shape)}")
    P, M, N = rhs.shape
    planes = chunk_planes or choose_chunk_rows(
        P, M * N, rhs.element_size(), max_tile_bytes=max_tile_bytes,
        streams=streams,
    )
    windows = _windows(P, planes, "planes")
    solve = (cyclic_penta_solve_factored_mid if cyclic
             else penta_solve_factored_mid)
    if len(windows) == 1:
        return solve(fac, rhs, backend=backend)
    out = torch.empty_like(rhs)
    if resolve_compute(backend, rhs) == "cuda":
        band, w = (fac.band, fac.w) if cyclic else (fac, None)
        _issue(windows, lambda p: penta_mid_cuda(
            band, rhs, w, planes=p, out=out), pool, rhs.device)
        return out
    for p0, p1 in windows:
        out[p0:p1] = solve(fac, rhs[p0:p1], backend="torch")
    return out


def stream_stencil_apply_dist(*args, **kwargs):
    """The multi-device streamed apply (chunks sharded over a mesh) is not
    ported: it waits for the distribution slice."""
    raise NotImplementedError(
        "stream_stencil_apply_dist (multi-device streamed execution) is not "
        "ported yet (ROADMAP.md, Open items: Distribution)"
    )
