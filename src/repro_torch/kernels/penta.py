"""Batched pentadiagonal solver, the cuPentBatch analogue (counterpart of
``repro.kernels.penta``).

The ADI scheme inverts ``L = I + alpha delta^4`` along each grid direction
every step.  The band is constant in time, so the solve splits like
cuSten's Create/Compute:

- :func:`penta_factor` / :func:`cyclic_penta_factor` (Create, once): LU
  factorisation on the host in the plan's dtype, exactly as the reference
  scans it, then the factors move to the device.
- The substitutions (Compute, every step), in three layouts:
  *column layout* (:func:`penta_solve_factored`, the 2D y-sweep and the 3D
  z-sweep; systems along axis 0, batch on the contiguous axis), *row
  layout* (:func:`penta_solve_factored_rows`, the x-sweep; recurrence along
  the contiguous axis) and *plane layout*
  (:func:`penta_solve_factored_mid`, the 3D y-sweep; recurrence along the
  middle axis of a (P, M, N) field).  On a CUDA tensor each launches its
  CUDA kernel (``csrc/penta.cu``); on a CPU tensor it runs the plain
  version below.
- Periodic bands close with a rank-4 Woodbury correction
  ``x = y - W (V^T y)`` whose ``W = Z S^{-1}`` is precomputed at Create.
  The CUDA kernels apply it as their epilogue; the plain path applies it
  with the same four broadcast products as the reference.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.util import ceil_div, next_multiple, numpy_dtype, resolve_device


class PentaFactors(NamedTuple):
    """LU factors of a pentadiagonal band (all shape (M,))."""

    sub: torch.Tensor  # e_i = l2 (unchanged sub-sub diagonal)
    low: torch.Tensor  # l_i = eliminated sub diagonal
    inv_mu: torch.Tensor  # 1/mu_i (reciprocal pivots)
    al: torch.Tensor  # alpha_i (first superdiagonal of U)
    be: torch.Tensor  # beta_i (second superdiagonal of U)


class CyclicPentaFactors(NamedTuple):
    band: PentaFactors
    z: torch.Tensor  # (M, 4) A^{-1} U
    s_inv: torch.Tensor  # (4, 4) inv(I + V^T A^{-1} U)
    w: torch.Tensor  # (M, 4) Z S^{-1}


def _host(a, dtype=None) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=dtype)


def _factor_host(l2, l1, d, u1, u2):
    """The reference's LU scan (``repro/kernels/penta.py:79-109``) on the
    host, in the diagonals' own dtype."""
    d = _host(d)
    dt = d.dtype
    l2, l1, u1, u2 = (_host(a, dt) for a in (l2, l1, u1, u2))
    M = d.shape[0]
    zero = dt.type(0)
    e = np.concatenate([np.zeros(2, dt), l2[2:]])
    c = np.concatenate([np.zeros(1, dt), l1[1:]])
    a = np.concatenate([u1[: M - 1], np.zeros(1, dt)])
    b = np.concatenate([u2[: M - 2], np.zeros(2, dt)])
    low, inv_mu, al, be = (np.empty(M, dt) for _ in range(4))
    a1 = a2 = b1 = b2 = zero  # alpha_{i-1}, alpha_{i-2}, beta_{i-1}, beta_{i-2}
    one = dt.type(1)
    for i in range(M):
        l_i = c[i] - e[i] * a2
        mu_i = d[i] - e[i] * b2 - l_i * a1
        inv = one / mu_i
        al_i = (a[i] - l_i * b1) * inv
        be_i = b[i] * inv
        low[i], inv_mu[i], al[i], be[i] = l_i, inv, al_i, be_i
        a1, a2, b1, b2 = al_i, a1, be_i, b1
    return e, low, inv_mu, al, be


def _to_device(arrays, device):
    return [torch.as_tensor(np.ascontiguousarray(a), device=device) for a in arrays]


def penta_factor(l2, l1, d, u1, u2, *, device="cuda") -> PentaFactors:
    """LU-factor the pentadiagonal matrix with diagonals (length M):
    ``A[i, i-2] = l2[i]``, ``A[i, i-1] = l1[i]``, ``A[i, i] = d[i]``,
    ``A[i, i+1] = u1[i]``, ``A[i, i+2] = u2[i]`` (out-of-band entries are
    ignored).  No pivoting: for the SPD / diagonally dominant operators of
    implicit time stepping.  Factors on the host in the diagonals' dtype,
    then moves the factors to ``device``."""
    dev = resolve_device(device)
    return PentaFactors(*_to_device(_factor_host(l2, l1, d, u1, u2), dev))


def cyclic_penta_factor(l2, l1, d, u1, u2, *, device="cuda") -> CyclicPentaFactors:
    """Factor the cyclic pentadiagonal matrix whose row ``i`` couples columns
    ``(i-2, i-1, i, i+1, i+2) mod M`` (reference ``:555-581``).  Needs
    M >= 6 so the corner blocks do not overlap the band."""
    dev = resolve_device(device)
    d = _host(d)
    M = d.shape[0]
    if M < 6:
        raise ValueError("cyclic pentadiagonal needs M >= 6")
    dt = d.dtype
    l2, l1, u1, u2 = (_host(a, dt) for a in (l2, l1, u1, u2))
    band = _factor_host(l2, l1, d, u1, u2)
    U = np.zeros((M, 4), dt)
    U[0, 0] = l2[0]  # (0, M-2)
    U[0, 1] = l1[0]  # (0, M-1)
    U[1, 1] = l2[1]  # (1, M-1)
    U[M - 2, 2] = u2[M - 2]  # (M-2, 0)
    U[M - 1, 2] = u1[M - 1]  # (M-1, 0)
    U[M - 1, 3] = u2[M - 1]  # (M-1, 1)
    # the Create-time solves A Z = U run the plain substitution on the CPU
    z = substitute_torch(
        PentaFactors(*map(torch.from_numpy, band)), torch.from_numpy(U)
    ).numpy()
    s = np.eye(4, dtype=dt) + np.stack([z[M - 2], z[M - 1], z[0], z[1]])
    s_inv = np.linalg.inv(s).astype(dt)
    w = (z @ s_inv).astype(dt)
    band_t = PentaFactors(*_to_device(band, dev))
    return CyclicPentaFactors(band_t, *_to_device((z, s_inv, w), dev))


def hyperdiffusion_diagonals(M: int, alpha, dtype=torch.float64):
    """Diagonals of ``I + alpha delta^4`` (eq. 4b of the paper), as host
    numpy arrays in ``dtype``."""
    one = np.ones(M, numpy_dtype(dtype))
    return (
        alpha * one,  # l2
        -4.0 * alpha * one,  # l1
        1.0 + 6.0 * alpha * one,  # d
        -4.0 * alpha * one,  # u1
        alpha * one,  # u2
    )


def diffusion_diagonals(M: int, r, dtype=torch.float64):
    """Diagonals of ``I - r delta^2`` (backward-Euler diffusion sweep) as a
    pentadiagonal band with zero outer diagonals."""
    one = np.ones(M, numpy_dtype(dtype))
    zero = np.zeros(M, numpy_dtype(dtype))
    return (zero, -r * one, 1.0 + 2.0 * r * one, -r * one, zero)


# ---------------------------------------------------------------------------
# Plain versions (CPU path, and the reference the CUDA kernels are held to)
# ---------------------------------------------------------------------------


def substitute_torch(fac: PentaFactors, rhs: torch.Tensor) -> torch.Tensor:
    """Column-layout forward/backward substitution on an (M, N) rhs."""
    M = rhs.shape[0]
    z = torch.empty_like(rhs)
    z1 = z2 = torch.zeros_like(rhs[0])
    for i in range(M):
        z[i] = (rhs[i] - fac.sub[i] * z2 - fac.low[i] * z1) * fac.inv_mu[i]
        z1, z2 = z[i], z1
    x = torch.empty_like(rhs)
    x1 = x2 = torch.zeros_like(rhs[0])
    for i in range(M - 1, -1, -1):
        x[i] = z[i] - fac.al[i] * x1 - fac.be[i] * x2
        x1, x2 = x[i], x1
    return x


def substitute_rows_torch(fac: PentaFactors, rhs: torch.Tensor) -> torch.Tensor:
    """Row-layout substitution on a (B, M) rhs, recurrence along axis 1.
    The intermediate is stored recurrence-major (M, B), as in the
    reference's ``_substitute_rows_jnp``."""
    M = rhs.shape[1]
    z = torch.empty((M,) + rhs.shape[:1], dtype=rhs.dtype, device=rhs.device)
    z1 = z2 = torch.zeros_like(rhs[:, 0])
    for i in range(M):
        z[i] = (rhs[:, i] - fac.sub[i] * z2 - fac.low[i] * z1) * fac.inv_mu[i]
        z1, z2 = z[i], z1
    x = torch.empty_like(rhs)
    x1 = x2 = torch.zeros_like(rhs[:, 0])
    for i in range(M - 1, -1, -1):
        x[:, i] = z[i] - fac.al[i] * x1 - fac.be[i] * x2
        x1, x2 = x[:, i], x1
    return x


def substitute_mid_torch(fac: PentaFactors, rhs: torch.Tensor) -> torch.Tensor:
    """Plane-layout substitution on a (P, M, N) rhs, recurrence along the
    middle axis: each (p, :, n) line is one system (reference
    ``_substitute_mid_jnp``)."""
    M = rhs.shape[1]
    z = torch.empty_like(rhs)
    z1 = z2 = torch.zeros_like(rhs[:, 0])
    for i in range(M):
        z[:, i] = (rhs[:, i] - fac.sub[i] * z2 - fac.low[i] * z1) * fac.inv_mu[i]
        z1, z2 = z[:, i], z1
    x = torch.empty_like(rhs)
    x1 = x2 = torch.zeros_like(rhs[:, 0])
    for i in range(M - 1, -1, -1):
        x[:, i] = z[:, i] - fac.al[i] * x1 - fac.be[i] * x2
        x1, x2 = x[:, i], x1
    return x


def woodbury_correct(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Column-layout Woodbury closure ``x = y - W (V^T y)`` on an (M, N)
    band solution (reference ``:604-609``)."""
    M = y.shape[0]
    return y - (
        w[:, 0:1] * y[M - 2][None, :]
        + w[:, 1:2] * y[M - 1][None, :]
        + w[:, 2:3] * y[0][None, :]
        + w[:, 3:4] * y[1][None, :]
    )


def rows_woodbury_correct(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Row-layout Woodbury closure on a (B, M) band solution, as four
    broadcast products (reference ``rows_woodbury_correct``)."""
    M = y.shape[1]
    return y - (
        y[:, M - 2][:, None] * w[None, :, 0]
        + y[:, M - 1][:, None] * w[None, :, 1]
        + y[:, 0][:, None] * w[None, :, 2]
        + y[:, 1][:, None] * w[None, :, 3]
    )


def mid_woodbury_correct(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plane-layout Woodbury closure on a (P, M, N) band solution, as four
    broadcast products (reference ``mid_woodbury_correct``)."""
    M = y.shape[1]
    return y - (
        y[:, M - 2][:, None, :] * w[None, :, 0, None]
        + y[:, M - 1][:, None, :] * w[None, :, 1, None]
        + y[:, 0][:, None, :] * w[None, :, 2, None]
        + y[:, 1][:, None, :] * w[None, :, 3, None]
    )


# ---------------------------------------------------------------------------
# CUDA kernel wrappers (csrc/penta.cu)
# ---------------------------------------------------------------------------


def _check_factors(band: PentaFactors, w, rhs: torch.Tensor, M: int) -> None:
    for name, f in zip(PentaFactors._fields, band, strict=True):
        _build.check_cuda(f, f"factor {name}", like=rhs, shape=(M,))
    if w is not None:
        _build.check_cuda(w, "Woodbury w", like=rhs, shape=(M, 4))


def rows_per_block(M: int, itemsize: int, n_rows: int, smem_optin: int,
                   n_sms: int) -> int:
    """Rows a block stages in shared memory for a row-layout sweep.

    As many as fit (row stride ``M + 1``), at most 32 (one warp runs the
    recurrences), and no more than spreads ``n_rows`` over all SMs: the
    recurrence time does not shrink with more rows per block, so more,
    smaller blocks finish sooner.  Raises if one row does not fit."""
    fit = smem_optin // ((M + 1) * itemsize)
    if fit < 1:
        raise ValueError(
            f"a row of {M} x {itemsize}-byte elements does not fit in the "
            f"{smem_optin} bytes of shared memory a block can hold"
        )
    return max(1, min(fit, 32, ceil_div(n_rows, n_sms)))


# The segmented substitution (csrc/common.cuh:substitute_segmented): one
# warp per line, each of its 32 lanes one segment of the recurrence.
WARP = 32
MIN_SEGMENT = 8
COLS_PER_BLOCK = 8


def segment_length(M: int) -> int:
    """Elements of a line that one lane of the segmented substitution
    walks: odd, so that the 32 lanes of a warp hit 32 different
    shared-memory banks, at least 9, so that a short line takes few
    carries, and ``32 L >= M``.  It depends on the line length alone,
    never on the batch or a launch's window, so every line is solved by
    the same arithmetic whatever the launch."""
    return max(ceil_div(M, WARP), MIN_SEGMENT) | 1


def tile_stride(M: int, itemsize: int) -> int:
    """Line stride (elements) of the column sweep's shared-memory tile: M
    rounded up to 128 bytes plus 16, so that the load and store phases of
    8 columns a block touch 32 different banks."""
    return next_multiple(M, 128 // itemsize) + 16 // itemsize


def cols_per_block(M: int, itemsize: int, smem_optin: int) -> int:
    """Columns, at most 8 (one warp each), that a block of the column sweep
    stages in shared memory beside the five factors of a whole line of M:
    fewer when M is long, 0 when not one fits."""
    free = smem_optin // itemsize - 5 * M
    return max(0, min(COLS_PER_BLOCK, free // tile_stride(M, itemsize)))


# The cluster routes of the column and row sweeps: each line split across
# a thread-block cluster of K blocks, K one of these (8 is the portable
# cluster size).
CLUSTER_SIZES = (2, 4, 8)


class ColsGeometry(NamedTuple):
    """Launch geometry of the column sweep (``penta_cols``)."""

    route: str  # "tile", "cluster" or "global"
    cluster: int  # K, blocks a line is split across (1 but on the cluster route)
    cols: int  # C, columns a block; 0 on the global route
    rows: int  # Mb = ceil(M / K), rows of a line a block holds
    seg: int  # L, the segment length: segment_length(Mb)
    ldt: int  # line stride of the tile (elements); 0 on the global route
    smem: int  # dynamic shared memory a block, bytes


def cols_tile_bytes(rows: int, itemsize: int, cols: int, cluster: int) -> int:
    """Shared memory of a column-sweep block holding ``rows`` rows of
    ``cols`` lines: the rows' five factors and the tile, and on the
    cluster route (``cluster`` > 1) each warp's two segment maps of six
    elements (``csrc/penta.cu:launch_cols``)."""
    maps = 12 * cols if cluster > 1 else 0
    return (5 * rows + cols * tile_stride(rows, itemsize) + maps) * itemsize


def _cluster_size(M: int, itemsize: int, smem_optin: int) -> int:
    """K of the cluster route: the smallest of :data:`CLUSTER_SIZES` whose
    blocks of 8 columns fit two to an SM, else the largest where one
    block fits; 0 when not even that one does."""
    for K in CLUSTER_SIZES:
        smem = cols_tile_bytes(ceil_div(M, K), itemsize, COLS_PER_BLOCK, K)
        if resident_blocks(smem, smem_optin) >= 2:
            return K
    return K if smem <= smem_optin else 0


@functools.lru_cache(maxsize=None)
def cols_geometry(M: int, itemsize: int, smem_optin: int, *,
                  cols: int | None = None) -> ColsGeometry:
    """Geometry of a column sweep over lines of M.

    The route depends on M and the dtype alone: the tile route where 8
    columns fit beside the whole line's factors (:func:`cols_per_block`);
    else the cluster route, each line split across a cluster of K blocks
    of Mb = ceil(M / K) rows (:func:`_cluster_size`), where 8 blocks hold
    it; else the global route, each column in device memory.  A block
    stages 8 columns, and L = ``segment_length(Mb)``.

    ``cols`` (a tuned sweep's geometry, :func:`cols_geometries`) forces C,
    1 to 8, on the tile and cluster routes: each column is one warp's
    recurrence whatever the block holds, and K never changes, so the
    choice changes no result; on the global route it raises
    ``ValueError`` here, before any launch.  Cached: every launch asks."""
    if cols_per_block(M, itemsize, smem_optin) == COLS_PER_BLOCK:
        route, K = "tile", 1
    else:
        K = _cluster_size(M, itemsize, smem_optin)
        route = "cluster" if K else "global"
    if route == "global":
        if cols is not None:
            raise ValueError(
                f"penta_cols cannot stage a column at M = {M} ({itemsize}-"
                f"byte elements) in the card's {smem_optin} bytes: the "
                f"device-memory route takes no geometry")
        return ColsGeometry("global", 1, 0, M, segment_length(M), 0, 0)
    if cols is not None and not 1 <= cols <= COLS_PER_BLOCK:
        raise ValueError(f"penta_cols stages 1 to {COLS_PER_BLOCK} columns a "
                         f"block, got {cols}")
    C = COLS_PER_BLOCK if cols is None else cols
    rows = ceil_div(M, K)
    return ColsGeometry(route, K, C, rows, segment_length(rows),
                        tile_stride(rows, itemsize),
                        cols_tile_bytes(rows, itemsize, C, K))


def cols_geometries(M: int, itemsize: int, smem_optin: int) -> list[dict]:
    """The column sweep's launch geometries a tuned sweep races besides its
    default one: 1, 2 and 4 columns a block on the tile route; none on the
    cluster route, where 8 columns beat 1, 2 and 4 at every shape raced on
    an H100 (PERF.md, PR 31), nor on the global route."""
    if cols_geometry(M, itemsize, smem_optin).route != "tile":
        return []
    return [{"cols": c} for c in (1, 2, 4)]


# The row and plane sweeps (csrc/penta.cu:penta_rows, penta_mid): blocks of
# 256 threads, 8 warps, each warp one line at a time.
BLOCK_WARPS = 8
MAX_BLOCKS_PER_SM = 8  # 2048 resident threads an SM
SM_RESERVED_SMEM = 1024  # bytes the runtime keeps of an SM's shared memory per block
# Ring depth of the row sweep: 2 overlaps the load of the next row group
# with the recurrences of the current one; 1 loads, solves and stores in
# turn (and is what a long row leaves room for).  The times of both are in
# PERF.md (chip_ab.py on an H100).
ROWS_RING = 2
# Most columns a block of the plane sweep stages; 8, 16 and 32 timed at
# 256^3 in PERF.md (chip_ab.py on an H100).
MID_MAX_COLS = 16


class RowsGeometry(NamedTuple):
    """Launch geometry of the row sweep (``penta_rows``)."""

    route: str  # "tile" (rows staged whole), "cluster" or "global"
    rows: int  # G, rows a group (one warp each); 0 on the global route
    depth: int  # ring depth, 1 or 2; 0 on the global route
    blocks: int  # grid size (K blocks a cluster on the cluster route)
    smem: int  # dynamic shared memory a block, bytes
    blocks_per_sm: int  # resident blocks an SM the grid was sized for
    cluster: int = 1  # K, blocks a row is split across (1 but on the cluster route)


class MidGeometry(NamedTuple):
    """Launch geometry of the plane sweep (``penta_mid``)."""

    route: str  # "tile" or "global"
    cols: int  # C, columns a block; 0 on the global route
    ldt: int  # line stride of the tile (elements)
    grid: tuple[int, int]  # (column groups, planes) as launched
    smem: int  # dynamic shared memory a block, bytes


def resident_blocks(smem: int, smem_optin: int) -> int:
    """Blocks of ``smem`` bytes an SM holds, as shared memory and its
    thread count allow (the row sweep's wrapper lowers it to what the
    registers allow, from the card's occupancy calculator)."""
    per_sm = (smem_optin + SM_RESERVED_SMEM) // (smem + SM_RESERVED_SMEM)
    return max(1, min(MAX_BLOCKS_PER_SM, per_sm))


def rows_tile_bytes(M: int, itemsize: int, cyclic: bool, rows: int,
                    depth: int, cluster: int = 1) -> int:
    """Shared memory of a row-sweep block: 16 bytes of mbarriers, the five
    factors (and the (M, 4) Woodbury matrix when cyclic) rounded up to 16
    bytes, ``depth`` slots of ``rows`` rows whose stride is M rounded up to
    16 bytes, and on the cluster route (``cluster`` > 1, M the part of a
    row a block holds) each warp's two segment maps of six elements and
    the four ends of its row that the closure reads
    (``csrc/penta.cu:rows_smem_bytes``)."""
    vec = 16 // itemsize
    stage = next_multiple((9 if cyclic else 5) * M, vec)
    ends = 16 * BLOCK_WARPS if cluster > 1 else 0
    return 16 + (stage + depth * rows * next_multiple(M, vec) + ends) * itemsize


def _rows_fit(M: int, itemsize: int, cyclic: bool, smem_optin: int,
              cluster: int) -> int:
    """Rows of M (parts of a row, on the cluster route) a block of the row
    sweep holds beside the factors."""
    row_bytes = next_multiple(M, 16 // itemsize) * itemsize
    return (smem_optin - rows_tile_bytes(M, itemsize, cyclic, 0, 0, cluster)) \
        // row_bytes


def _rows_cluster_size(M: int, itemsize: int, cyclic: bool,
                       smem_optin: int) -> int:
    """K of the row sweep: 1 (the tile route) where a whole row fits beside
    the factors; else the smallest of :data:`CLUSTER_SIZES` whose blocks
    of 8 rows with a ring of 2 fit two to an SM, else the largest where a
    block holds one part of a row; 0 (the global route) when not even
    that one does."""
    if _rows_fit(M, itemsize, cyclic, smem_optin, 1) >= 1:
        return 1
    for K in CLUSTER_SIZES:
        smem = rows_tile_bytes(ceil_div(M, K), itemsize, cyclic, BLOCK_WARPS,
                               ROWS_RING, K)
        if resident_blocks(smem, smem_optin) >= 2:
            return K
    return K if _rows_fit(ceil_div(M, K), itemsize, cyclic, smem_optin, K) >= 1 \
        else 0


@functools.lru_cache(maxsize=None)
def rows_geometry(M: int, itemsize: int, n_rows: int, smem_optin: int,
                  n_sms: int, *, cyclic: bool, depth: int | None = None,
                  blocks_per_sm: int | None = None, rows: int | None = None,
                  clusters: int | None = None) -> RowsGeometry:
    """Geometry of a row sweep over ``n_rows`` rows of length M.

    The route depends on M, the dtype and ``cyclic`` alone: the tile route
    when one row fits in shared memory beside the factors (and W); else the
    cluster route, each row split across a cluster of K blocks of
    Mb = ceil(M / K) elements (:func:`_rows_cluster_size`), where 8 blocks
    hold it; else the row is solved in device memory.  A group holds one
    row (one part of a row, on the cluster route) a warp, at most 8, fewer
    when the rows would not spread over all SMs or the ring does not fit;
    the ring keeps ``depth`` groups (``ROWS_RING`` by default, 1 when two
    groups do not fit).  The grid is the groups or one grid of resident
    blocks (``clusters`` resident clusters, as the card reports them, on
    the cluster route), whichever is smaller, and each block (cluster)
    walks the groups ``b, b + grid, ...``.

    ``rows`` with ``depth`` (a tuned sweep's geometry,
    :func:`rows_geometries`) force the group, 1 to 8 rows, and the ring
    depth, 1 or 2: each row is one warp's recurrence whatever the group
    and the ring, so the choice changes no result; a ring that does not
    fit raises ``ValueError`` here, before any launch.  Cached: every
    launch asks."""
    forced = rows is not None
    if forced and (not 1 <= rows <= BLOCK_WARPS or depth not in (1, 2)):
        raise ValueError(
            f"penta_rows takes 1 to {BLOCK_WARPS} rows a group and a ring of "
            f"1 or 2, got rows {rows}, depth {depth}")
    depth = ROWS_RING if depth is None else depth
    K = _rows_cluster_size(M, itemsize, cyclic, smem_optin)
    Mb = ceil_div(M, max(K, 1))
    fit = _rows_fit(Mb, itemsize, cyclic, smem_optin, max(K, 1))
    if forced and rows * depth > fit:
        raise ValueError(
            f"penta_rows cannot ring {depth} groups of {rows} rows of {M} "
            f"({itemsize}-byte elements) in the card's {smem_optin} bytes")
    if K == 0:
        return RowsGeometry("global", 0, 0, ceil_div(n_rows, BLOCK_WARPS), 0, 0)
    if not forced:
        rows = max(1, min(BLOCK_WARPS, ceil_div(n_rows * K, n_sms), fit // depth))
        depth = max(1, min(depth, fit // rows))
    smem = rows_tile_bytes(Mb, itemsize, cyclic, rows, depth, K)
    per_sm = blocks_per_sm or resident_blocks(smem, smem_optin)
    groups = ceil_div(n_rows, rows)
    if K == 1:
        return RowsGeometry("tile", rows, depth, min(groups, per_sm * n_sms),
                            smem, per_sm)
    clusters = clusters or max(1, per_sm * n_sms // K)
    return RowsGeometry("cluster", rows, depth, K * min(groups, clusters), smem,
                        per_sm, K)


def rows_geometries(M: int, itemsize: int, n_rows: int, smem_optin: int,
                    n_sms: int, *, cyclic: bool) -> list[dict]:
    """The row sweep's launch geometries a tuned sweep races besides its
    default one: groups of 1, 2, 4 and 8 rows with rings of 1 and 2, where
    they fit.  None where rows take the cluster route (as for the column
    sweep's) or the global route."""
    geo = rows_geometry(M, itemsize, n_rows, smem_optin, n_sms, cyclic=cyclic)
    if geo.route != "tile":
        return []
    out = []
    for rows in (1, 2, 4, 8):
        for depth in (1, 2):
            if (rows, depth) == (geo.rows, geo.depth):
                continue
            try:
                rows_geometry(M, itemsize, n_rows, smem_optin, n_sms,
                              cyclic=cyclic, depth=depth, rows=rows)
            except ValueError:
                continue
            out.append({"rows": rows, "depth": depth})
    return out


def mid_tile_stride(M: int, itemsize: int, cols: int) -> int:
    """Line stride (elements) of the plane sweep's tile: M rounded up to
    128 bytes plus the smallest step that puts the lanes of a half-warp
    (float64) or a warp (float32) of the load and store phases, ``cols``
    columns a row, on different banks.  For 8 columns it is the column
    sweep's :func:`tile_stride`."""
    bank_elems = 128 // itemsize
    return next_multiple(M, bank_elems) + max(1, bank_elems // cols)


def mid_geometry(P: int, M: int, N: int, itemsize: int, smem_optin: int, *,
                 max_cols: int | None = None,
                 cols: int | None = None) -> MidGeometry:
    """Geometry of a plane sweep over a (P, M, N) rhs.

    C columns a block: a power of two, at most ``max_cols``
    (``MID_MAX_COLS``) and no more than covers N, as many as fit beside the
    five factors; the global route when not one fits (it depends on M and
    the dtype alone).  The grid is (ceil(N / C), min(P, 65535)), a block a
    column group of a plane (``csrc/penta.cu:launch_mid``).

    ``cols`` (a tuned sweep's geometry, :func:`mid_geometries`) forces C,
    a power of two the default rule gives for some ``max_cols``: each line
    is one warp's recurrence whatever the block holds, so the choice
    changes no result; a C the rule does not give here raises
    ``ValueError``, before any launch."""
    if cols is not None:
        if cols < 1 or cols & (cols - 1) or BLOCK_WARPS * 32 % cols:
            raise ValueError(f"penta_mid stages a power of two of columns a "
                             f"block, at most {BLOCK_WARPS * 32}; got {cols}")
        geo = mid_geometry(P, M, N, itemsize, smem_optin, max_cols=cols)
        if geo.cols != cols:
            raise ValueError(
                f"penta_mid cannot stage {cols} columns a block of a "
                f"({P}, {M}, {N}) rhs ({itemsize}-byte elements) in the "
                f"card's {smem_optin} bytes (it fits {geo.cols})")
        return geo
    max_cols = MID_MAX_COLS if max_cols is None else max_cols
    free = smem_optin // itemsize - 5 * M
    cols = 1
    while cols < min(max_cols, N):
        cols *= 2
    cols = min(cols, max_cols)
    while cols >= 1 and cols * mid_tile_stride(M, itemsize, cols) > free:
        cols //= 2
    if cols < 1:
        return MidGeometry("global", 0, 0, (ceil_div(P * N, BLOCK_WARPS), 1), 0)
    ldt = mid_tile_stride(M, itemsize, cols)
    return MidGeometry("tile", cols, ldt, (ceil_div(N, cols), min(P, 65535)),
                       (5 * M + cols * ldt) * itemsize)


def mid_geometries(P: int, M: int, N: int, itemsize: int,
                   smem_optin: int) -> list[dict]:
    """The plane sweep's launch geometries a tuned sweep races besides its
    default one: 8, 16 and 32 columns a block (``max_cols``), those that
    give a column count of their own."""
    base = mid_geometry(P, M, N, itemsize, smem_optin)
    if base.route != "tile":
        return []
    seen, out = {base.cols}, []
    for c in (8, 16, 32):
        geo = mid_geometry(P, M, N, itemsize, smem_optin, max_cols=c)
        if geo.route == "tile" and geo.cols not in seen:
            seen.add(geo.cols)
            out.append({"cols": geo.cols})
    return out


# launches of penta_cols (ROUTES) and of penta_rows (ROWS_ROUTES) by route
# since import (kept apart from _build.LAUNCHES, which counts each launch
# once, under its kernel)
ROUTES: dict[str, int] = {"tile": 0, "cluster": 0, "global": 0}
ROWS_ROUTES: dict[str, int] = {"tile": 0, "cluster": 0, "global": 0}


def penta_cols_cuda(
    band: PentaFactors,
    rhs: torch.Tensor,
    w: torch.Tensor | None = None,
    *,
    cols: tuple[int, int] | None = None,
    out: torch.Tensor | None = None,
    geometry: dict | None = None,
) -> torch.Tensor:
    """Launch the column-layout kernel on an (M, N) CUDA rhs; with ``w``
    (the cyclic Woodbury matrix) the closure runs as its epilogue.
    ``cols=(c0, c1)`` solves only those columns into ``out``.
    ``geometry`` (``{'cols': C}``, a tuned sweep's) overrides the columns
    a block (:func:`cols_geometry`).  Counts the launch in
    :data:`ROUTES` under its route."""
    M, N = rhs.shape
    _build.check_cuda(rhs, "rhs", like=rhs, shape=(M, N))
    _check_factors(band, w, rhs, M)
    c0, c1 = _build.window(cols, N, "column", out)
    smem, _ = _build.device_info(rhs.device)
    geo = cols_geometry(M, rhs.element_size(), smem,
                        cols=(geometry or {}).get("cols"))
    out = _build.out_like(out, rhs)
    _build.launch(
        "penta_cols", rhs.device, _build.dtype_code(rhs),
        *(_build.ptr(f) for f in band), _build.ptr(w), _build.ptr(rhs),
        _build.ptr(out), M, N, c0, c1, geo.seg, geo.cols, geo.ldt,
        geo.cluster, route=geo.route,
    )
    ROUTES[geo.route] += 1
    return out


_OCCUPANCY: dict = {}


def _rows_occupancy(device: torch.device, dtype: torch.dtype, smem: int,
                    cluster: int = 1) -> int:
    """From the card: resident blocks an SM of ``device`` holds of the row
    sweep's tile kernel with ``smem`` bytes, or, for a ``cluster`` of K > 1
    blocks, the clusters of the cluster route's kernel the card holds at
    once."""
    key = (device.index, dtype, smem, cluster)
    if key not in _OCCUPANCY:
        _OCCUPANCY[key] = max(1, _build.occupancy(
            "penta_rows_occupancy", device,
            _build.dtype_code(torch.empty(0, dtype=dtype)), smem, cluster))
    return _OCCUPANCY[key]


def rows_geometry_on(device: torch.device, dtype: torch.dtype, M: int,
                     n_rows: int, *, cyclic: bool,
                     geometry: dict | None = None) -> RowsGeometry:
    """:func:`rows_geometry` on a card, the blocks an SM holds lowered to
    what its registers allow, and on the cluster route the grid sized by
    the clusters the card holds at once; ``geometry`` (``{'rows': G,
    'depth': d}``, a tuned sweep's) forces the group and the ring."""
    smem, sms = _build.device_info(device)
    isz = dtype.itemsize
    over = dict(rows=geometry["rows"], depth=geometry["depth"]) if geometry \
        else {}
    geo = rows_geometry(M, isz, n_rows, smem, sms, cyclic=cyclic, **over)
    if geo.route == "cluster":
        geo = rows_geometry(M, isz, n_rows, smem, sms, cyclic=cyclic,
                            depth=geo.depth, rows=over.get("rows"),
                            clusters=_rows_occupancy(device, dtype, geo.smem,
                                                     geo.cluster))
    if geo.route == "tile":
        occ = _rows_occupancy(device, dtype, geo.smem)
        if occ < geo.blocks_per_sm:
            geo = rows_geometry(M, isz, n_rows, smem, sms, cyclic=cyclic,
                                depth=geo.depth, blocks_per_sm=occ,
                                rows=over.get("rows"))
    return geo


def mid_geometry_on(device: torch.device, dtype: torch.dtype, P: int, M: int,
                    N: int, geometry: dict | None = None) -> MidGeometry:
    """:func:`mid_geometry` on a card; ``geometry`` (``{'cols': C}``, a
    tuned sweep's) forces the columns a block."""
    return mid_geometry(P, M, N, dtype.itemsize, _build.device_info(device)[0],
                        cols=(geometry or {}).get("cols"))


def penta_rows_cuda(
    band: PentaFactors,
    rhs: torch.Tensor,
    w: torch.Tensor | None = None,
    *,
    rows: tuple[int, int] | None = None,
    out: torch.Tensor | None = None,
    geometry: dict | None = None,
) -> torch.Tensor:
    """Launch the row-layout kernel on a (B, M) CUDA rhs; with ``w`` the
    Woodbury closure runs on the kernel's write-out.  ``rows=(r0, r1)``
    solves only those rows into ``out``.  Any M: rows whose tile does not
    fit in shared memory are split across a thread-block cluster, or
    solved in device memory past what 8 blocks hold.  ``geometry``
    (``{'rows': G, 'depth': d}``, a tuned sweep's) overrides the group
    and the ring (:func:`rows_geometry`).  Counts the launch in
    :data:`ROWS_ROUTES` under its route."""
    B, M = rhs.shape
    _build.check_cuda(rhs, "rhs", like=rhs, shape=(B, M))
    _check_factors(band, w, rhs, M)
    r0, r1 = _build.window(rows, B, "row", out)
    geo = rows_geometry_on(rhs.device, rhs.dtype, M, r1 - r0,
                           cyclic=w is not None, geometry=geometry)
    out = _build.out_like(out, rhs)
    _build.launch(
        "penta_rows", rhs.device, _build.dtype_code(rhs),
        *(_build.ptr(f) for f in band), _build.ptr(w), _build.ptr(rhs),
        _build.ptr(out), B, M, r0, r1,
        segment_length(ceil_div(M, geo.cluster)), geo.rows, geo.depth,
        geo.blocks, geo.cluster, route=geo.route,
    )
    ROWS_ROUTES[geo.route] += 1
    return out


def penta_mid_cuda(
    band: PentaFactors,
    rhs: torch.Tensor,
    w: torch.Tensor | None = None,
    *,
    planes: tuple[int, int] | None = None,
    out: torch.Tensor | None = None,
    geometry: dict | None = None,
) -> torch.Tensor:
    """Launch the plane-layout kernel on a (P, M, N) CUDA rhs; with ``w``
    the cyclic closure runs on the kernel's write-out.  Any M: lines whose
    one-column tile does not fit in shared memory are solved in device
    memory.  ``planes=(p0, p1)`` solves only those planes into ``out``:
    the launch takes the planes' slab of rhs and out (contiguous, by
    pointer offset), and its route, columns a block and L depend on M, N
    and the dtype alone, so each line is solved as in the whole call.
    ``geometry`` (``{'cols': C}``, a tuned sweep's) overrides the columns
    a block (:func:`mid_geometry`)."""
    P, M, N = rhs.shape
    _build.check_cuda(rhs, "rhs", like=rhs, shape=(P, M, N))
    _check_factors(band, w, rhs, M)
    p0, p1 = _build.window(planes, P, "plane", out)
    geo = mid_geometry_on(rhs.device, rhs.dtype, p1 - p0, M, N, geometry)
    out = _build.out_like(out, rhs)
    _build.launch(
        "penta_mid", rhs.device, _build.dtype_code(rhs),
        *(_build.ptr(f) for f in band), _build.ptr(w),
        _build.ptr(rhs[p0:p1]), _build.ptr(out[p0:p1]), p1 - p0, M, N,
        segment_length(M), geo.cols, geo.ldt,
    )
    return out


# ---------------------------------------------------------------------------
# Dispatch (backend 'auto' | 'cuda' | 'torch')
# ---------------------------------------------------------------------------


def _solve_cols(band, w, rhs, backend, geometry=None):
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[:, None]
    if _build.resolve_backend(backend, rhs) == "cuda":
        out = penta_cols_cuda(band, rhs, w, geometry=geometry)
    else:
        out = substitute_torch(band, rhs)
        if w is not None:
            out = woodbury_correct(out, w)
    return out[:, 0] if squeeze else out


def _solve_rows(band, w, rhs, backend, geometry=None):
    squeeze = rhs.ndim == 1
    if squeeze:
        rhs = rhs[None, :]
    if _build.resolve_backend(backend, rhs) == "cuda":
        out = penta_rows_cuda(band, rhs, w, geometry=geometry)
    else:
        out = substitute_rows_torch(band, rhs)
        if w is not None:
            out = rows_woodbury_correct(out, w)
    return out[0] if squeeze else out


def _solve_mid(band, w, rhs, backend, geometry=None):
    if rhs.ndim != 3:
        raise ValueError(f"plane layout takes a (P, M, N) rhs, got {tuple(rhs.shape)}")
    if _build.resolve_backend(backend, rhs) == "cuda":
        return penta_mid_cuda(band, rhs, w, geometry=geometry)
    out = substitute_mid_torch(band, rhs)
    return out if w is None else mid_woodbury_correct(out, w)


# The factored solves take ``geometry``, a tuned sweep's launch geometry
# (``{'cols': C}``, ``{'rows': G, 'depth': d}`` or, for the plane layout,
# ``{'cols': C}``), which only a kernel launch reads.


def penta_solve_factored(fac: PentaFactors, rhs, *, backend: str = "auto",
                         geometry=None):
    """Solve ``A x = rhs`` given Create-time factors.  rhs: (M,) or (M, N)."""
    return _solve_cols(fac, None, rhs, backend, geometry)


def penta_solve_factored_rows(fac: PentaFactors, rhs, *, backend: str = "auto",
                              geometry=None):
    """Row-layout solve: ``rhs`` is (B, M) (or (M,)), each row one system."""
    return _solve_rows(fac, None, rhs, backend, geometry)


def penta_solve_factored_mid(fac: PentaFactors, rhs, *, backend: str = "auto",
                             geometry=None):
    """Plane-layout solve: ``rhs`` is (P, M, N), every (p, :, n) line one
    system — the transpose-free y-sweep of a 3D ADI step."""
    return _solve_mid(fac, None, rhs, backend, geometry)


def cyclic_penta_solve_factored(
    fac: CyclicPentaFactors, rhs, *, backend: str = "auto", geometry=None
):
    """Cyclic column-layout solve: ``x = y - W V^T y``, ``y = A^{-1} rhs``."""
    return _solve_cols(fac.band, fac.w, rhs, backend, geometry)


def cyclic_penta_solve_factored_rows(
    fac: CyclicPentaFactors, rhs, *, backend: str = "auto", geometry=None
):
    """Cyclic row-layout solve on a (B, M) rhs (each row one system): the
    transpose-free x-sweep of a periodic ADI step."""
    return _solve_rows(fac.band, fac.w, rhs, backend, geometry)


def cyclic_penta_solve_factored_mid(
    fac: CyclicPentaFactors, rhs, *, backend: str = "auto", geometry=None
):
    """Cyclic plane-layout solve on a (P, M, N) rhs (each (p, :, n) line one
    cyclic system): the y-sweep of a periodic 3D ADI step."""
    return _solve_mid(fac.band, fac.w, rhs, backend, geometry)
