// Batched pentadiagonal substitution with the Create-time LU factors, in
// the three layouts of the 2D and 3D ADI steps.  Every line of every
// layout is a segmented recurrence (common.cuh:substitute_segmented): one
// warp a line (or, on the cluster routes of penta_cols and penta_rows, a
// part of one of K parts), each lane a segment of L = max(ceil(M / 32), 8)
// | 1 elements of it (M / K on a cluster route), so 32 threads work on a
// line and each walks about 4 L + 10 dependent steps instead of 3 M.  L
// depends only on the line length M (kernels/penta.py: segment_length),
// and the route (shared-memory tile, cluster or device
// memory) only on M, the dtype and whether the band is cyclic, never on
// the batch or a launch's window, so a line is computed by the same code
// whatever the launch, and a streamed sweep (repro_torch/launch/stream.py,
// one launch per chunk of lines) equals the monolithic launch bit for bit.
//
// penta_cols replaces the TPU kernel repro/kernels/penta.py:
// _substitute_pallas (body _substitute_kernel): column layout, an (M, N)
// right-hand side whose N systems lie along the contiguous axis and whose
// recurrence runs over the M rows (the y-sweep of the 2D step, the z-sweep
// of the 3D step).  Three routes, chosen by the wrapper from M, the dtype
// and the shared memory a block can hold (kernels/penta.py:cols_geometry):
//
// - tile (penta_cols_tile_kernel<T, false>), where 8 columns fit beside
//   the whole line's factors (float64 M up to 2224): a block stages the
//   five factors and an (M, C) tile of C <= 8 columns in dynamic shared
//   memory with coalesced loads (line stride ldt, M rounded up to 128
//   bytes plus 16 bytes, so the load and store phases hit 32 different
//   banks), C warps run the segmented recurrences in shared memory, and the
//   block writes the tile back coalesced with the cyclic rank-4 Woodbury
//   closure (repro/kernels/penta.py:604-609) applied on the way out.
//   Device memory sees the rhs read once and the output written once: what
//   bounds it now is those bytes and the block's serial phases (load,
//   recurrence, store).
// - cluster (penta_cols_tile_kernel<T, true>), for longer lines up to what
//   8 blocks hold (float64 M up to 17792): staged whole, a float64 line of
//   4096 left room for 2 columns, one block of 2 warps an SM pulling 160 KB
//   of factors for 64 KB of data (7.3% of its bound at 4096^2).  Now each
//   line is split across a thread-block cluster of K blocks (the smallest
//   K of 2, 4 and 8 that lets two blocks of 8 columns share an SM, else
//   8; never more than 8, the portable cluster size): block k holds rows
//   [k Mb, k Mb + Mb), Mb = ceil(M / K), their factors and an (Mb, 8)
//   tile, the shape of the 1024^2 tile block (K = 4 at 4096: 105 KB, 16
//   warps an SM), loaded by element copies (cp.async) so that a thread's
//   loads are all in flight at once.  Each warp runs the segmented
//   recurrence over its part with L = segment_length(Mb) (in registers at
//   L = 33); the carries cross the blocks through distributed shared
//   memory (ClusterCarry: one cluster barrier a direction), and the
//   closure reads y[0], y[1] from block 0 and y[M-2], y[M-1] from block
//   K - 1 after one more.  The same bytes move as on the tile route, and
//   the launch allocates nothing.  At 4096^2 it runs at 32% of its bound
//   (8 waves of blocks whose load, recurrence and store run in turn).
// - global (penta_cols_global_kernel), beyond: the same warp-per-column
//   recurrence on the column in device memory (strided, through L1/L2),
//   the closure as the epilogue.
//
// penta_rows replaces repro/kernels/penta.py:_substitute_rows_pallas (body
// rows_substitute_refs): row layout, a (B, M) right-hand side whose
// recurrence runs along the contiguous axis (the x-sweep).  The first
// design had one thread walk each row (R <= 32 rows a block, 8 of 256
// threads busy at 1024^2, the factors read from device memory at every
// step: 36x its byte bound).  Now (kernels/penta.py:rows_geometry):
//
// - tile (penta_rows_tile_kernel<T, false>), where a whole row fits beside
//   the factors (float64 M up to 2905 when cyclic, 4842 for a plain band):
//   about one grid of resident blocks walks the groups of G <= 8 rows; each
//   block stages the five factors, and W when the band is cyclic, once in
//   shared memory, then keeps a ring of `depth` (1 or 2) row groups there.  A group is contiguous in device
//   memory, so where its address and the row's bytes are multiples of 16
//   one thread loads it with one bulk copy (cp.async.bulk, the 1D TMA)
//   that completes on an mbarrier; otherwise (odd M in float64, float32
//   rows of M not a multiple of 4, a window that starts off 16 bytes) every
//   thread issues cp.async of one element.  With depth 2 the load of the
//   next group is in flight while the warps solve the current one.  At the
//   3D x-sweep's (65536, 256) on an H100 the element copies took 13% and
//   plain loads on a grid of all groups 36% longer than the bulk copies
//   (chip_ab.py; PERF.md).  Each
//   warp solves its rows one at a time, syncs, and writes the row out with
//   coalesced stores, applying the rank-4 closure (rows_woodbury_correct)
//   on the way.  Device memory sees the rhs read once and the output
//   written once, so it is bound by those bytes, by the shared-memory
//   traffic of the recurrence (about 18 accesses an element) and, for
//   short rows, by the carries' shuffles.
// - cluster (penta_rows_tile_kernel<T, true>), for longer rows up to what 8
//   blocks hold (float64 M up to 23136 when cyclic): on the global route a
//   cyclic float64 row of 4096 took a warp walking its 32 segments of 129
//   in device memory, each load of the warp touching 32 lines 1 KB apart,
//   the factors re-read at every step (4.9% of its bound at 4096^2).  Now
//   each row is split across a thread-block cluster of K blocks (the
//   smallest K of 2, 4 and 8 that lets two blocks of 8 rows with a ring of
//   2 share an SM, else 8: K = 8 at 4096, parts of 512, 101 KB a block,
//   0.236 ms at 4096^2 where K = 4, one block an SM, took 0.266; at 8192
//   parts of 1024, one block an SM): block k stages the factors and W
//   of the elements [k Mb, k Mb + Mb), Mb = ceil(M / K), once, then keeps
//   its pieces of the row groups in a ring as the tile route does, loaded
//   by bulk copies of one row piece each.  Each warp runs the segmented
//   recurrence over its row's part with L = segment_length(Mb); the carries
//   cross the blocks through distributed shared memory (ClusterCarry, as
//   penta_cols' cluster route), and the closure reads y[0], y[1] from block
//   0 and y[M-2], y[M-1] from block K - 1 after one more cluster barrier.
//   The same bytes move as on the tile route, and the launch allocates
//   nothing: a persistent grid of as many clusters as the card holds.
// - global (penta_rows_global_kernel), beyond: the same warp-a-row
//   recurrence on the row in device memory, the closure as the epilogue.
//
// penta_mid replaces repro/kernels/penta.py:_substitute_mid_pallas (body
// _substitute_mid_kernel) and its closure mid_woodbury_correct: plane
// layout, a (P, M, N) right-hand side whose recurrence runs over the middle
// axis (the y-sweep of a 3D field, transpose-free).  It is P column-layout
// sweeps of (M, N), row stride N and plane stride M N, so it takes the
// column sweep's design (kernels/penta.py:mid_geometry):
//
// - tile (penta_mid_tile_kernel): block (x, p) stages the factors, loads
//   the (M, C) tile of columns [x C, x C + C) of plane p with coalesced
//   loads (rows of C elements, wider than the column sweep's 8 where
//   shared memory allows), runs the 8 warps over its C columns as
//   segmented recurrences and writes the tile back coalesced with the
//   closure; planes beyond the grid's 65535 in a loop.  The line stride of
//   the tile makes each half-warp's loads and stores hit different banks
//   for any C.
// - global (penta_mid_global_kernel), for an M whose tile of one column
//   does not fit: one warp a (p, n) line in device memory, as
//   penta_cols_global_kernel.
//
// penta_cols computes the columns [col0, col1) and penta_rows the rows
// [row0, row1) of their output (the whole rhs is [0, N) and [0, B)): the
// systems are independent, so a streamed sweep issues one launch per chunk
// of systems.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;  // threads a block of the row and plane sweeps
constexpr int kWarps = kBlock / kWarp;

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// Elements of T in 16 bytes, the granule of the bulk copies.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// The row sweep's shared memory: 16 bytes of mbarriers, the five factors
// (and W after them when cyclic) rounded up to 16 bytes, then `depth` slots
// of G rows of stride round_up(M, kVec) (kernels/penta.py:rows_tile_bytes).
template <typename T>
__host__ __device__ int rows_stage_len(int M, bool cyclic) {
  return round_up((cyclic ? 9 : 5) * M, kVec<T>);
}

// On the cluster route (K > 1, M the part of a row a block holds), each
// warp's two segment maps and the four ends of its row follow the slots.
template <typename T>
int rows_smem_bytes(int M, bool cyclic, int G, int depth, int K) {
  return 16 + (rows_stage_len<T>(M, cyclic) + depth * G * round_up(M, kVec<T>) +
               (K > 1 ? 16 * kWarps : 0)) *
                  static_cast<int>(sizeof(T));
}

// -- mbarriers and bulk copies (PTX; element copies are in common.cuh) ------

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Expect `bytes` of asynchronous writes on `bar` and arrive once.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the completion of the phase of `bar` of parity `parity`.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// One bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -- the segmented substitution of a line in shared memory -----------------

// substitute_segmented (in place, ld = 1) with L = kL, each lane keeping
// its segment's values in registers between its four passes: the same
// arithmetic in the same order (the result is bit for bit the same), with
// 12 shared-memory accesses an element instead of 16.  The shared-memory
// and shuffle instructions of the recurrence are what bound the sweeps of
// short lines (L = 9, M <= 288: the 3D sweeps at 256); this takes a
// quarter of the former at the cost of 2 kL registers.  The column sweep's
// cluster route takes it at L = 33 (parts of 1024 rows: M = 4096 and
// 8192), where it made the 4096^2 sweep 5% faster (PERF.md).
template <typename T, int kL, typename Carry = WarpCarry<T>>
__device__ __forceinline__ void substitute_segmented_regs(
    T* v, const T* __restrict__ sub, const T* __restrict__ low,
    const T* __restrict__ imu, const T* __restrict__ al,
    const T* __restrict__ be, int M, int lane, const Carry& carry = Carry{}) {
  const int a = min(lane * kL, M);
  const int n = min(a + kL, M) - a;
  T r[kL];
#pragma unroll
  for (int j = 0; j < kL; ++j) r[j] = j < n ? v[a + j] : T(0);
  T s0, s1;
  {  // forward, pass A
    T p1 = T(0), p2 = T(0), u1 = T(1), u2 = T(0), w1 = T(0), w2 = T(1);
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      if (j < n) {
        const int i = a + j;
        const T e = sub[i], l = low[i], m = imu[i];
        const T pz = (r[j] - e * p2 - l * p1) * m;
        const T uz = -(e * u2 + l * u1) * m;
        const T wz = -(e * w2 + l * w1) * m;
        p2 = p1;
        p1 = pz;
        u2 = u1;
        u1 = uz;
        w2 = w1;
        w1 = wz;
      }
    }
    carry.forward(SegmentMap<T>{u1, w1, u2, w2, p1, p2}, lane, s0, s1);
  }
  {  // forward, pass C
    T z1 = s0, z2 = s1;
#pragma unroll
    for (int j = 0; j < kL; ++j) {
      if (j < n) {
        const int i = a + j;
        const T z = (r[j] - sub[i] * z2 - low[i] * z1) * imu[i];
        r[j] = z;
        z2 = z1;
        z1 = z;
      }
    }
  }
  {  // backward, pass A
    T p1 = T(0), p2 = T(0), u1 = T(1), u2 = T(0), w1 = T(0), w2 = T(1);
#pragma unroll
    for (int j = kL - 1; j >= 0; --j) {
      if (j < n) {
        const int i = a + j;
        const T f = al[i], g = be[i];
        const T px = r[j] - f * p1 - g * p2;
        const T ux = -(f * u1 + g * u2);
        const T wx = -(f * w1 + g * w2);
        p2 = p1;
        p1 = px;
        u2 = u1;
        u1 = ux;
        w2 = w1;
        w1 = wx;
      }
    }
    carry.backward(SegmentMap<T>{u1, w1, u2, w2, p1, p2}, lane, s0, s1);
  }
  {  // backward, pass C
    T x1 = s0, x2 = s1;
#pragma unroll
    for (int j = kL - 1; j >= 0; --j) {
      if (j < n) {
        const int i = a + j;
        const T x = r[j] - al[i] * x1 - be[i] * x2;
        v[i] = x;
        x2 = x1;
        x1 = x;
      }
    }
  }
}

// One line of length M in shared memory, solved in place by the calling
// warp with the staged factors f (sub, low, imu, al, be at strides of M);
// a segment of L = 9 (lines of at most 288) is kept in registers.
template <typename T>
__device__ __forceinline__ void solve_line_smem(T* line, const T* f, int M,
                                                int L, int lane) {
  if (L == 9)
    substitute_segmented_regs<T, 9>(line, f, f + M, f + 2 * M, f + 3 * M,
                                    f + 4 * M, M, lane);
  else
    substitute_segmented(line, line, 1, f, f + M, f + 2 * M, f + 3 * M,
                         f + 4 * M, M, L, lane);
}

// -- thread-block clusters (the column sweep's cluster route) ---------------

// The cluster's barrier in two halves (every thread of every block of the
// cluster arrives; the wait returns when all have): writes to shared memory
// before the arrive are seen by reads in any block of the cluster after
// the wait.  A block whose shared memory others read waits before it exits.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// The previous lane's v (the next lane's when kReverse).
template <bool kReverse, typename T>
__device__ __forceinline__ T shfl_prev(T v) {
  return kReverse ? __shfl_down_sync(kFullMask, v, 1)
                  : __shfl_up_sync(kFullMask, v, 1);
}

// Step B of substitute_segmented for a line split across the K blocks of a
// cluster, block k holding its rows [k Mb, k Mb + Mb): the warp scans its
// 32 segment maps as segment_carry does, its last lane (lane 0 backward)
// publishes the composed map of the block's part in `slot`, and after a
// cluster barrier every lane runs the line's zero start through the maps
// of the blocks before its own (after it, backward), read from their
// shared memory in line order, and through the composed map of the lanes
// before it.  Every warp of every block of the cluster calls it: it holds
// a cluster barrier.
template <typename T>
struct ClusterCarry {
  SegmentMap<T>* slot;  // this warp's two maps: [0] forward, [1] backward
  int rank, blocks;     // k and K

  template <bool kReverse>
  __device__ __forceinline__ void carry(SegmentMap<T> m, int lane, T& s0,
                                        T& s1) const {
    segment_scan<T, kReverse>(m, lane);
    // the composed map of the lanes before this one (the identity for the
    // first)
    SegmentMap<T> e;
    e.a00 = shfl_prev<kReverse>(m.a00);
    e.a01 = shfl_prev<kReverse>(m.a01);
    e.a10 = shfl_prev<kReverse>(m.a10);
    e.a11 = shfl_prev<kReverse>(m.a11);
    e.p0 = shfl_prev<kReverse>(m.p0);
    e.p1 = shfl_prev<kReverse>(m.p1);
    if (lane == (kReverse ? kWarp - 1 : 0))
      e = SegmentMap<T>{T(1), T(0), T(0), T(1), T(0), T(0)};
    if (lane == (kReverse ? 0 : kWarp - 1)) slot[kReverse] = m;
    cluster_sync();
    cg::cluster_group cluster = cg::this_cluster();
    T t0 = T(0), t1 = T(0);  // the state entering this block's part
    for (int j = kReverse ? blocks - 1 : 0; kReverse ? j > rank : j < rank;
         j += kReverse ? -1 : 1) {
      const SegmentMap<T> b = cluster.map_shared_rank(slot, j)[kReverse];
      const T u0 = b.a00 * t0 + b.a01 * t1 + b.p0;
      const T u1 = b.a10 * t0 + b.a11 * t1 + b.p1;
      t0 = u0;
      t1 = u1;
    }
    s0 = e.a00 * t0 + e.a01 * t1 + e.p0;
    s1 = e.a10 * t0 + e.a11 * t1 + e.p1;
  }

  __device__ __forceinline__ void forward(SegmentMap<T> m, int lane, T& s0,
                                          T& s1) const {
    carry<false>(m, lane, s0, s1);
  }
  __device__ __forceinline__ void backward(SegmentMap<T> m, int lane, T& s0,
                                           T& s1) const {
    carry<true>(m, lane, s0, s1);
  }
};

// -- column layout ------------------------------------------------------------

// Column sweep, tile and cluster routes: the columns [g C, g C + C) of an
// (M, n) window of row stride N, blockDim.x = 32 C.  Tile route
// (kCluster false): block g holds the whole lines, Mb = M.  Cluster route:
// the K blocks of cluster g split each line, block k of it (its rank)
// holding the rows [k Mb, min(k Mb + Mb, M)) and the factors of those rows;
// its warps exchange their carries through ClusterCarry, and the cyclic
// closure reads y[0], y[1] from block 0 and y[M-2], y[M-1] from block K - 1.
// The cluster route's bound of 2 blocks an SM keeps ptxas within the 128
// registers a thread that lets its two blocks of 256 threads share an SM
// (a segment of 33 in registers).  The tile route's bound of 6 keeps it at
// 40 (8 blocks of the 3D z-sweep at 256 fit an SM's shared memory): at
// (256, 65536) it ran 0.1836 ms against 0.1856 with no bound (also 40
// registers) and 0.1855 with a bound of 1 (64 registers; H100).
// The two routes keep two bodies: the cluster body at K = 1 (a cluster of
// one block) took 0.3222 ms at (256, 65536) against the tile body's 0.1845
// (more registers, cp.async loads, the map exchange; 1024^2 within the
// host-bound noise, 4096^2 untouched; H100, 700 W, PERF.md).
template <typename T, bool kCluster>
__global__ void __launch_bounds__(256, kCluster ? 2 : 6)
    penta_cols_tile_kernel(const T* __restrict__ sub,
                           const T* __restrict__ low,
                           const T* __restrict__ imu,
                           const T* __restrict__ al,
                           const T* __restrict__ be, const T* __restrict__ w,
                           const T* __restrict__ rhs, T* __restrict__ out,
                           int M, int n, size_t N, int L, int C, int ldt,
                           int Mb) {
  extern __shared__ unsigned char smem_raw[];
  int rank = 0, blocks = 1;
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    rank = static_cast<int>(cluster.block_rank());
    blocks = static_cast<int>(cluster.num_blocks());
  }
  const int base = rank * Mb;             // the block's first row
  const int Mk = min(Mb, M - base);       // and its rows
  T* f = reinterpret_cast<T*>(smem_raw);  // sub, low, imu, al, be
  T* tile = f + 5 * Mb;                   // C lines of stride ldt
  // thread (row r0 + 32 j, column c) in the load and store phases
  const int c = threadIdx.x % C;
  const int r0 = threadIdx.x / C;
  const int col = blockIdx.x / blocks * C + c;
  const T* src = rhs + static_cast<size_t>(base) * N + col;
  T* dst = out + static_cast<size_t>(base) * N + col;
  T* y = tile + c * ldt;
  if constexpr (kCluster) {
    // element copies (cp.async): all of a thread's loads in flight at once
    const T* fs[5] = {sub, low, imu, al, be};
#pragma unroll
    for (int k = 0; k < 5; ++k)
      for (int i = threadIdx.x; i < Mk; i += blockDim.x)
        elem_load(f + k * Mb + i, fs[k] + base + i);
    if (col < n) {
      for (int i = r0; i < Mk; i += kWarp) elem_load(y + i, src + i * N);
    } else {
      for (int i = r0; i < Mk; i += kWarp) y[i] = T(0);
    }
    elem_commit();
    elem_wait<0>();
  } else {
    for (int i = threadIdx.x; i < Mk; i += blockDim.x) {
      f[i] = __ldg(sub + base + i);
      f[Mb + i] = __ldg(low + base + i);
      f[2 * Mb + i] = __ldg(imu + base + i);
      f[3 * Mb + i] = __ldg(al + base + i);
      f[4 * Mb + i] = __ldg(be + base + i);
    }
    if (col < n) {
      for (int i = r0; i < Mk; i += kWarp) y[i] = src[i * N];
    }
  }
  __syncthreads();
  const int warp = threadIdx.x / kWarp;
  T* line = tile + warp * ldt;
  if constexpr (kCluster) {
    // every warp, a column or not: the carries hold cluster barriers
    SegmentMap<T>* slots = reinterpret_cast<SegmentMap<T>*>(tile + C * ldt);
    const ClusterCarry<T> carry{slots + 2 * warp, rank, blocks};
    if (L == 33)
      substitute_segmented_regs<T, 33>(line, f, f + Mb, f + 2 * Mb,
                                       f + 3 * Mb, f + 4 * Mb, Mk,
                                       threadIdx.x % kWarp, carry);
    else
      substitute_segmented(line, line, 1, f, f + Mb, f + 2 * Mb, f + 3 * Mb,
                           f + 4 * Mb, Mk, L, threadIdx.x % kWarp, carry);
    T ym2 = T(0), ym1 = T(0), y0 = T(0), y1 = T(0);
    if (w != nullptr) {
      cluster_sync();  // every part of the line solved
      cg::cluster_group cluster = cg::this_cluster();
      const T* first = cluster.map_shared_rank(y, 0);
      const T* last = cluster.map_shared_rank(y, blocks - 1);
      const int Ml = M - (blocks - 1) * Mb;  // rows of the last block
      ym2 = last[Ml - 2];
      ym1 = last[Ml - 1];
      y0 = first[0];
      y1 = first[1];
    } else {
      __syncthreads();
    }
    cluster_arrive();  // done with the other blocks' shared memory
    if (col < n) {
      for (int i = r0; i < Mk; i += kWarp) {
        if (w == nullptr) {
          dst[i * N] = y[i];
        } else {
          const T* wi = w + 4 * (base + i);
          dst[i * N] = y[i] - (__ldg(wi) * ym2 + __ldg(wi + 1) * ym1 +
                               __ldg(wi + 2) * y0 + __ldg(wi + 3) * y1);
        }
      }
    }
    cluster_wait();  // the others are done with this block's
  } else {
    if (blockIdx.x * C + warp < n)
      substitute_segmented(line, line, 1, f, f + M, f + 2 * M, f + 3 * M,
                           f + 4 * M, M, L, threadIdx.x % kWarp);
    __syncthreads();
    if (col >= n) return;
    if (w == nullptr) {
      for (int i = r0; i < M; i += kWarp) dst[i * N] = y[i];
      return;
    }
    const T ym2 = y[M - 2], ym1 = y[M - 1], y0 = y[0], y1 = y[1];
    for (int i = r0; i < M; i += kWarp) {
      const T* wi = w + 4 * i;
      dst[i * N] = y[i] - (__ldg(wi) * ym2 + __ldg(wi + 1) * ym1 +
                           __ldg(wi + 2) * y0 + __ldg(wi + 3) * y1);
    }
  }
}

// Column sweep, global route: warp g solves column g of an (M, n) window
// of row stride N in device memory; blockDim.x is a multiple of 32.
template <typename T>
__global__ void __launch_bounds__(256) penta_cols_global_kernel(
    const T* __restrict__ sub, const T* __restrict__ low,
    const T* __restrict__ imu, const T* __restrict__ al,
    const T* __restrict__ be, const T* __restrict__ w, const T* rhs, T* out,
    int M, int n, size_t N, int L) {
  const int col = (blockIdx.x * blockDim.x + threadIdx.x) / kWarp;
  if (col >= n) return;  // whole warps
  solve_line_global(sub, low, imu, al, be, w, rhs + col, out + col,
                    static_cast<long long>(N), M, L, threadIdx.x % kWarp);
}

// -- row layout ---------------------------------------------------------------

// Row sweep, tile route: the groups g = blockIdx.x, blockIdx.x + gridDim.x,
// ... of G rows of an (n, M) window (row stride M), through a ring of
// `depth` (1 or 2) slots in shared memory; blockDim.x = 256.
template <typename T>
__device__ __forceinline__ void rows_tile_sweep(
    const T* __restrict__ sub, const T* __restrict__ low,
    const T* __restrict__ imu, const T* __restrict__ al,
    const T* __restrict__ be, const T* __restrict__ w,
    const T* __restrict__ rhs, T* __restrict__ out, int n, int M, int L,
    int G, int depth, unsigned char* smem16) {
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem16);
  T* f = reinterpret_cast<T*>(smem16 + 16);  // sub, low, imu, al, be, W
  T* fw = f + 5 * M;
  const int ldr = round_up(M, kVec<T>);
  T* ring = f + rows_stage_len<T>(M, w != nullptr);
  const int groups = (n + G - 1) / G;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  // the group's rows are one contiguous, 16-byte aligned run of bytes
  const bool bulk =
      reinterpret_cast<uintptr_t>(rhs) % 16 == 0 && M % kVec<T> == 0;
  if (bulk && threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < M; i += kBlock) {
    f[i] = __ldg(sub + i);
    f[M + i] = __ldg(low + i);
    f[2 * M + i] = __ldg(imu + i);
    f[3 * M + i] = __ldg(al + i);
    f[4 * M + i] = __ldg(be + i);
  }
  if (w != nullptr) {
    for (int i = threadIdx.x; i < 4 * M; i += kBlock) fw[i] = __ldg(w + i);
  }
  __syncthreads();

  // load group g into slot s
  auto issue = [&](int g, int s) {
    const int r0 = g * G, nr = min(G, n - r0);
    T* dst = ring + s * G * ldr;
    const T* src = rhs + static_cast<size_t>(r0) * M;
    if (bulk) {
      if (threadIdx.x == 0) {
        const unsigned bytes = static_cast<unsigned>(nr) * M * sizeof(T);
        // the slot's earlier generic accesses come before the async write
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect_tx(bar + s, bytes);
        bulk_load(dst, src, bytes, bar + s);
      }
    } else {
      for (int r = 0; r < nr; ++r)
        for (int i = threadIdx.x; i < M; i += kBlock)
          elem_load(dst + r * ldr + i, src + static_cast<size_t>(r) * M + i);
      elem_commit();
    }
  };

  int g = blockIdx.x;
  if (g < groups) issue(g, 0);
  for (int j = 0; g < groups; ++j, g += gridDim.x) {
    const int s = depth == 2 ? (j & 1) : 0;
    const int uses = depth == 2 ? (j >> 1) : j;  // earlier fills of slot s
    const int next = g + gridDim.x;
    if (depth == 2) {
      if (next < groups)
        issue(next, s ^ 1);
      else if (!bulk)
        elem_commit();  // an empty group keeps wait_group 1 exact
    }
    if (bulk) {
      mbar_wait(bar + s, uses & 1);
    } else {
      if (depth == 2)
        elem_wait<1>();
      else
        elem_wait<0>();
      __syncthreads();
    }
    const int r0 = g * G, nr = min(G, n - r0);
    T* slot = ring + s * G * ldr;
    for (int r = warp; r < nr; r += kWarps) {
      T* row = slot + r * ldr;
      solve_line_smem(row, f, M, L, lane);
      __syncwarp();
      T* dst = out + static_cast<size_t>(r0 + r) * M;
      if (w == nullptr) {
        for (int i = lane; i < M; i += kWarp) dst[i] = row[i];
      } else {
        const T ym2 = row[M - 2], ym1 = row[M - 1], y0 = row[0], y1 = row[1];
        for (int i = lane; i < M; i += kWarp) {
          const T* wi = fw + 4 * i;
          dst[i] = row[i] - (wi[0] * ym2 + wi[1] * ym1 + wi[2] * y0 +
                             wi[3] * y1);
        }
      }
    }
    __syncthreads();  // slot s is read out: free for the group after next
    if (depth == 1 && next < groups) issue(next, 0);
  }
}

// The part of a row a block of the cluster route holds, solved in place by
// the calling warp with the part's staged factors f (stride Mb) and the
// carries of `carry`; a segment of 17 or 33 (parts of 512 and 1024: rows
// of 4096 and 8192 over 8 blocks) is kept in registers.
template <typename T>
__device__ __forceinline__ void solve_part_smem(T* part, const T* f, int Mb,
                                                int Mk, int L, int lane,
                                                const ClusterCarry<T>& carry) {
  const T *e = f, *l = f + Mb, *m = f + 2 * Mb, *a = f + 3 * Mb,
          *b = f + 4 * Mb;
  if (L == 17)
    substitute_segmented_regs<T, 17>(part, e, l, m, a, b, Mk, lane, carry);
  else if (L == 33)
    substitute_segmented_regs<T, 33>(part, e, l, m, a, b, Mk, lane, carry);
  else
    substitute_segmented(part, part, 1, e, l, m, a, b, Mk, L, lane, carry);
}

// Row sweep, cluster route: each row of an (n, M) window split across the K
// blocks of a cluster, block k of it (its rank) holding the elements
// [k Mb, min(k Mb + Mb, M)) of every row and the factors of those elements,
// and W's four columns at a stride of Mb (W's rows of four put the
// write-out's loads on four times the banks' wavefronts: 0.291 against
// 0.236 ms at 4096^2 on an H100, PERF.md).  The cluster c = blockIdx.x / K
// walks the groups c, c + C, ... (C clusters in the grid) of G <= 8 rows
// through a ring of `depth` slots,
// each of its blocks holding its (G, Mb) piece of the group: a row's piece
// is contiguous, so it loads with one bulk copy where its address and bytes
// are multiples of 16, else by element copies.  Warp r runs the part of row
// r of the group, its carries crossing the blocks through ClusterCarry;
// every warp of every block calls it, a row or not (a warp without one
// runs a part of length 0), since it holds cluster barriers, and the K
// blocks walk the same groups in the same order.  The cyclic closure reads
// y[0], y[1] from block 0 and y[M-2], y[M-1] from block K - 1 after one more
// cluster barrier, from the ends each warp writes beside the ring (a slot
// is refilled while the others may still be reading, the ends only after
// two more cluster barriers), and is applied on the coalesced write-out.
template <typename T>
__device__ __forceinline__ void rows_cluster_sweep(
    const T* __restrict__ sub, const T* __restrict__ low,
    const T* __restrict__ imu, const T* __restrict__ al,
    const T* __restrict__ be, const T* __restrict__ w,
    const T* __restrict__ rhs, T* __restrict__ out, int n, int M, int L,
    int G, int depth, int Mb, unsigned char* smem16) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int K = static_cast<int>(cluster.num_blocks());
  const int base = rank * Mb;        // the block's first element of a row
  const int Mk = min(Mb, M - base);  // and its elements
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(smem16);
  T* f = reinterpret_cast<T*>(smem16 + 16);  // sub, low, imu, al, be, W
  T* fw = f + 5 * Mb;
  const int ldr = round_up(Mb, kVec<T>);
  T* ring = f + rows_stage_len<T>(Mb, w != nullptr);
  SegmentMap<T>* maps = reinterpret_cast<SegmentMap<T>*>(ring + depth * G * ldr);
  T* ends = reinterpret_cast<T*>(maps + 2 * kWarps);  // y0, y1, y[-2], y[-1]
  const int groups = (n + G - 1) / G;
  const int clusters = gridDim.x / K;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  // every piece of a group is a 16-byte aligned run of a multiple of 16 bytes
  const bool bulk = reinterpret_cast<uintptr_t>(rhs) % 16 == 0 &&
                    M % kVec<T> == 0 && Mb % kVec<T> == 0;
  if (bulk && threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init(bar + 1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < Mk; i += kBlock) {
    f[i] = __ldg(sub + base + i);
    f[Mb + i] = __ldg(low + base + i);
    f[2 * Mb + i] = __ldg(imu + base + i);
    f[3 * Mb + i] = __ldg(al + base + i);
    f[4 * Mb + i] = __ldg(be + base + i);
  }
  if (w != nullptr) {  // W's four columns, each of stride Mb
    for (int i = threadIdx.x; i < 4 * Mk; i += kBlock)
      fw[(i & 3) * Mb + (i >> 2)] = __ldg(w + 4 * base + i);
  }
  __syncthreads();

  // load this block's piece of group g into slot s
  auto issue = [&](int g, int s) {
    const int r0 = g * G, nr = min(G, n - r0);
    T* dst = ring + s * G * ldr;
    const T* src = rhs + static_cast<size_t>(r0) * M + base;
    if (bulk) {
      if (threadIdx.x == 0) {
        const unsigned bytes = static_cast<unsigned>(Mk) * sizeof(T);
        // the slot's earlier generic accesses come before the async write
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_expect_tx(bar + s, bytes * nr);
        for (int r = 0; r < nr; ++r)
          bulk_load(dst + r * ldr, src + static_cast<size_t>(r) * M, bytes,
                    bar + s);
      }
    } else {
      for (int r = 0; r < nr; ++r)
        for (int i = threadIdx.x; i < Mk; i += kBlock)
          elem_load(dst + r * ldr + i, src + static_cast<size_t>(r) * M + i);
      elem_commit();
    }
  };

  int g = blockIdx.x / K;
  if (g < groups) issue(g, 0);
  for (int j = 0; g < groups; ++j, g += clusters) {
    const int s = depth == 2 ? (j & 1) : 0;
    const int uses = depth == 2 ? (j >> 1) : j;  // earlier fills of slot s
    const int next = g + clusters;
    if (depth == 2) {
      if (next < groups)
        issue(next, s ^ 1);
      else if (!bulk)
        elem_commit();  // an empty group keeps wait_group 1 exact
    }
    if (bulk) {
      mbar_wait(bar + s, uses & 1);
    } else {
      if (depth == 2)
        elem_wait<1>();
      else
        elem_wait<0>();
      __syncthreads();
    }
    const int r0 = g * G, nr = min(G, n - r0);
    const int len = warp < nr ? Mk : 0;
    T* part = ring + (s * G + min(warp, G - 1)) * ldr;
    solve_part_smem(part, f, Mb, len, L, lane,
                    ClusterCarry<T>{maps + 2 * warp, rank, K});
    __syncwarp();
    T ym2 = T(0), ym1 = T(0), y0 = T(0), y1 = T(0);
    if (w != nullptr) {
      T* e = ends + 4 * warp;
      if (lane == 0 && len > 0) {
        e[0] = part[0];
        e[1] = part[1];
        e[2] = part[Mk - 2];
        e[3] = part[Mk - 1];
      }
      cluster_sync();  // every part of the group's rows solved
      const T* first = cluster.map_shared_rank(ends, 0) + 4 * warp;
      const T* last = cluster.map_shared_rank(ends, K - 1) + 4 * warp;
      y0 = first[0];
      y1 = first[1];
      ym2 = last[2];
      ym1 = last[3];
    }
    if (len > 0) {
      T* dst = out + static_cast<size_t>(r0 + warp) * M + base;
      if (w == nullptr) {
        for (int i = lane; i < Mk; i += kWarp) dst[i] = part[i];
      } else {
        for (int i = lane; i < Mk; i += kWarp)
          dst[i] = part[i] - (fw[i] * ym2 + fw[Mb + i] * ym1 +
                              fw[2 * Mb + i] * y0 + fw[3 * Mb + i] * y1);
      }
    }
    __syncthreads();  // slot s is read out: free for the group after next
    if (depth == 1 && next < groups) issue(next, 0);
  }
  cluster_sync();  // the others are done with this block's maps and ends
}

// Row sweep, tile and cluster routes: the same template, two bodies
// (kernels/penta.py:rows_geometry picks the route from M, the dtype and
// whether the band is cyclic).  The tile route's bound of 3 blocks an SM
// lets ptxas take the registers the ring and the segment in registers need
// (80 in float64); left to itself it took 64 and spilled.  The cluster
// route's bound of 2 keeps it within the 128 registers a thread that let
// its two blocks of 256 threads share an SM (rows of 4096 in float64: parts
// of 512, K = 8) with a segment of 33 in registers.
template <typename T, bool kCluster>
__global__ void __launch_bounds__(kBlock, kCluster ? 2 : 3)
    penta_rows_tile_kernel(const T* __restrict__ sub,
                           const T* __restrict__ low,
                           const T* __restrict__ imu,
                           const T* __restrict__ al,
                           const T* __restrict__ be, const T* __restrict__ w,
                           const T* __restrict__ rhs, T* __restrict__ out,
                           int n, int M, int L, int G, int depth, int Mb) {
  extern __shared__ __align__(16) unsigned char smem16[];
  if constexpr (kCluster)
    rows_cluster_sweep(sub, low, imu, al, be, w, rhs, out, n, M, L, G, depth,
                       Mb, smem16);
  else
    rows_tile_sweep(sub, low, imu, al, be, w, rhs, out, n, M, L, G, depth,
                    smem16);
}

// Row sweep, global route: warp g solves row g of an (n, M) window in
// device memory; blockDim.x = 256.
template <typename T>
__global__ void __launch_bounds__(kBlock) penta_rows_global_kernel(
    const T* __restrict__ sub, const T* __restrict__ low,
    const T* __restrict__ imu, const T* __restrict__ al,
    const T* __restrict__ be, const T* __restrict__ w, const T* rhs, T* out,
    int n, int M, int L) {
  const long long row =
      (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) / kWarp;
  if (row >= n) return;  // whole warps
  const size_t off = static_cast<size_t>(row) * M;
  solve_line_global(sub, low, imu, al, be, w, rhs + off, out + off, 1, M, L,
                    threadIdx.x % kWarp);
}

// -- plane layout ---------------------------------------------------------

// Plane sweep, tile route: block (x, y) solves the columns [x C, x C + C)
// of the planes y, y + gridDim.y, ... (gridDim.y = min(P, 65535)) of a
// (P, M, N) rhs, the tile's line stride ldt; blockDim.x = 256 and C
// divides it.
template <typename T>
__global__ void __launch_bounds__(kBlock) penta_mid_tile_kernel(
    const T* __restrict__ sub, const T* __restrict__ low,
    const T* __restrict__ imu, const T* __restrict__ al,
    const T* __restrict__ be, const T* __restrict__ w,
    const T* __restrict__ rhs, T* __restrict__ out, int P, int M, int N,
    int L, int C, int ldt) {
  extern __shared__ unsigned char smem_raw[];
  T* f = reinterpret_cast<T*>(smem_raw);  // sub, low, imu, al, be
  T* tile = f + 5 * M;                    // C lines of stride ldt
  for (int i = threadIdx.x; i < M; i += kBlock) {
    f[i] = __ldg(sub + i);
    f[M + i] = __ldg(low + i);
    f[2 * M + i] = __ldg(imu + i);
    f[3 * M + i] = __ldg(al + i);
    f[4 * M + i] = __ldg(be + i);
  }
  // thread (row r0 + j step, column c) in the load and store phases
  const int c = threadIdx.x % C;
  const int r0 = threadIdx.x / C, step = kBlock / C;
  const int ncols = min(C, N - static_cast<int>(blockIdx.x) * C);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const size_t Ns = static_cast<size_t>(N);
  const size_t col = static_cast<size_t>(blockIdx.x) * C + c;
  T* y = tile + c * ldt;
  for (int p = blockIdx.y; p < P; p += gridDim.y) {
    const T* src = rhs + static_cast<size_t>(p) * M * Ns + col;
    T* dst = out + static_cast<size_t>(p) * M * Ns + col;
    __syncthreads();  // factors staged; the previous plane's tile written
    if (c < ncols) {
      for (int i = r0; i < M; i += step) y[i] = src[i * Ns];
    }
    __syncthreads();
    for (int k = warp; k < ncols; k += kWarps) {
      T* line = tile + k * ldt;
      solve_line_smem(line, f, M, L, lane);
    }
    __syncthreads();
    if (c >= ncols) continue;
    if (w == nullptr) {
      for (int i = r0; i < M; i += step) dst[i * Ns] = y[i];
      continue;
    }
    const T ym2 = y[M - 2], ym1 = y[M - 1], y0 = y[0], y1 = y[1];
    for (int i = r0; i < M; i += step) {
      const T* wi = w + 4 * i;
      dst[i * Ns] = y[i] - (__ldg(wi) * ym2 + __ldg(wi + 1) * ym1 +
                            __ldg(wi + 2) * y0 + __ldg(wi + 3) * y1);
    }
  }
}

// Plane sweep, global route: warp g solves the line (g / N, :, g % N) of a
// (P, M, N) rhs in device memory; blockDim.x = 256.
template <typename T>
__global__ void __launch_bounds__(kBlock) penta_mid_global_kernel(
    const T* __restrict__ sub, const T* __restrict__ low,
    const T* __restrict__ imu, const T* __restrict__ al,
    const T* __restrict__ be, const T* __restrict__ w, const T* rhs, T* out,
    int P, int M, int N, int L) {
  const long long line =
      (static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x) / kWarp;
  if (line >= static_cast<long long>(P) * N) return;  // whole warps
  const long long p = line / N, col = line % N;
  const size_t off = static_cast<size_t>(p) * M * N + col;
  solve_line_global(sub, low, imu, al, be, w, rhs + off, out + off,
                    static_cast<long long>(N), M, L, threadIdx.x % kWarp);
}

// -- launchers ------------------------------------------------------------

// Let `kernel` take `bytes` of dynamic shared memory, and prefer the
// largest shared-memory carveout (the tile kernels keep all they reuse
// there), once per kernel.
template <typename K>
cudaError_t ready_tile(K kernel, int bytes, int* current, bool* carveout) {
  if (!*carveout) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        static_cast<int>(cudaSharedmemCarveoutMaxShared));
    if (e != cudaSuccess) return e;
    *carveout = true;
  }
  return allow_smem(kernel, bytes, current);
}

template <typename T, bool kCluster>
cudaError_t ready_rows(int bytes) {
  static int smem_set = 0;
  static bool carveout = false;
  return ready_tile(penta_rows_tile_kernel<T, kCluster>, bytes, &smem_set,
                    &carveout);
}

// The launch of the row sweep's cluster route: clusters of K blocks.
inline cudaLaunchConfig_t rows_cluster_config(int blocks, int bytes, int K,
                                              cudaStream_t stream,
                                              cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = K;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T>
cudaError_t ready_mid(int bytes) {
  static int smem_set = 0;
  static bool carveout = false;
  return ready_tile(penta_mid_tile_kernel<T>, bytes, &smem_set, &carveout);
}

// The columns [col0, col1) of an (M, N) rhs: segments of L rows; C columns
// a block through shared memory (line stride ldt), each line split across
// a cluster of K blocks (K = 1: one block holds it), or C = 0 for the
// global route.
template <typename T>
int launch_cols(void* const* f, const void* w, const void* rhs, void* out,
                int M, int N, int col0, int col1, int L, int C, int ldt,
                int K, cudaStream_t stream) {
  const int n = col1 - col0;
  const T* F[5];
  for (int k = 0; k < 5; ++k) F[k] = static_cast<const T*>(f[k]);
  const T* r = static_cast<const T*>(rhs) + col0;
  T* o = static_cast<T*>(out) + col0;
  const T* wp = static_cast<const T*>(w);
  if (C > 0 && K > 1) {
    // kernels/penta.py:cols_tile_bytes: the block's factors, its tile and
    // its warps' two segment maps
    static int smem_set = 0;
    static bool carveout = false;
    const int Mb = (M + K - 1) / K;
    const int bytes =
        (5 * Mb + C * ldt + 12 * C) * static_cast<int>(sizeof(T));
    cudaError_t e = ready_tile(penta_cols_tile_kernel<T, true>, bytes,
                               &smem_set, &carveout);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = K;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((n + C - 1) / C * K);
    cfg.blockDim = dim3(kWarp * C);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, penta_cols_tile_kernel<T, true>, F[0], F[1],
                           F[2], F[3], F[4], wp, r, o, M, n,
                           static_cast<size_t>(N), L, C, ldt, Mb);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else if (C > 0) {
    static int smem_set = 0;
    const int bytes = (5 * M + C * ldt) * static_cast<int>(sizeof(T));
    cudaError_t e =
        allow_smem(penta_cols_tile_kernel<T, false>, bytes, &smem_set);
    if (e != cudaSuccess) return static_cast<int>(e);
    penta_cols_tile_kernel<T, false><<<(n + C - 1) / C, kWarp * C, bytes,
                                       stream>>>(
        F[0], F[1], F[2], F[3], F[4], wp, r, o, M, n,
        static_cast<size_t>(N), L, C, ldt, M);
  } else {
    const int per_block = 8;  // columns (warps) a block
    penta_cols_global_kernel<T>
        <<<(n + per_block - 1) / per_block, kWarp * per_block, 0, stream>>>(
            F[0], F[1], F[2], F[3], F[4], wp, r, o, M, n,
            static_cast<size_t>(N), L);
  }
  return static_cast<int>(cudaGetLastError());
}

// The rows [row0, row1) of a (B, M) rhs: segments of L elements; groups of
// G rows through a ring of `depth` slots on `blocks` blocks, each row split
// across a cluster of K of them (K = 1: one block holds it), or G = 0 for
// the global route.
template <typename T>
int launch_rows(void* const* f, const void* w, const void* rhs, void* out,
                int M, int row0, int row1, int L, int G, int depth,
                int blocks, int K, cudaStream_t stream) {
  const int n = row1 - row0;
  const size_t off = static_cast<size_t>(row0) * M;
  const T* F[5];
  for (int k = 0; k < 5; ++k) F[k] = static_cast<const T*>(f[k]);
  const T* r = static_cast<const T*>(rhs) + off;
  T* o = static_cast<T*>(out) + off;
  const T* wp = static_cast<const T*>(w);
  if (G > 0 && K > 1) {
    const int Mb = (M + K - 1) / K;
    const int bytes = rows_smem_bytes<T>(Mb, w != nullptr, G, depth, K);
    cudaError_t e = ready_rows<T, true>(bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchAttribute cluster;
    const cudaLaunchConfig_t cfg =
        rows_cluster_config(blocks, bytes, K, stream, &cluster);
    e = cudaLaunchKernelEx(&cfg, penta_rows_tile_kernel<T, true>, F[0], F[1],
                           F[2], F[3], F[4], wp, r, o, n, M, L, G, depth, Mb);
    if (e != cudaSuccess) return static_cast<int>(e);
  } else if (G > 0) {
    const int bytes = rows_smem_bytes<T>(M, w != nullptr, G, depth, 1);
    cudaError_t e = ready_rows<T, false>(bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    penta_rows_tile_kernel<T, false><<<blocks, kBlock, bytes, stream>>>(
        F[0], F[1], F[2], F[3], F[4], wp, r, o, n, M, L, G, depth, M);
  } else {
    penta_rows_global_kernel<T><<<(n + kWarps - 1) / kWarps, kBlock, 0,
                                  stream>>>(F[0], F[1], F[2], F[3], F[4], wp,
                                            r, o, n, M, L);
  }
  return static_cast<int>(cudaGetLastError());
}

// A (P, M, N) rhs: segments of L rows; C columns a block through shared
// memory (line stride ldt), a block a (column group, plane) and the planes
// beyond the grid's 65535 in a loop, or C = 0 for the global route.
template <typename T>
int launch_mid(void* const* f, const void* w, const void* rhs, void* out,
               int P, int M, int N, int L, int C, int ldt,
               cudaStream_t stream) {
  const T* F[5];
  for (int k = 0; k < 5; ++k) F[k] = static_cast<const T*>(f[k]);
  const T* r = static_cast<const T*>(rhs);
  T* o = static_cast<T*>(out);
  const T* wp = static_cast<const T*>(w);
  if (C > 0) {
    const int bytes = (5 * M + C * ldt) * static_cast<int>(sizeof(T));
    cudaError_t e = ready_mid<T>(bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((N + C - 1) / C, min(P, 65535));
    penta_mid_tile_kernel<T><<<grid, kBlock, bytes, stream>>>(
        F[0], F[1], F[2], F[3], F[4], wp, r, o, P, M, N, L, C, ldt);
  } else {
    const long long lines = static_cast<long long>(P) * N;
    penta_mid_global_kernel<T>
        <<<static_cast<unsigned>((lines + kWarps - 1) / kWarps), kBlock, 0,
           stream>>>(F[0], F[1], F[2], F[3], F[4], wp, r, o, P, M, N, L);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rows_occupancy(int bytes, int K, int* count) {
  if (K == 1) {
    cudaError_t e = ready_rows<T, false>(bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        count, penta_rows_tile_kernel<T, false>, kBlock, bytes));
  }
  cudaError_t e = ready_rows<T, true>(bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg =
      rows_cluster_config(K, bytes, K, nullptr, &cluster);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      count, penta_rows_tile_kernel<T, true>, &cfg));
}

}  // namespace

// dtype: 0 float32, 1 float64.  w may be null (non-cyclic band).  Solves
// the columns [col0, col1), 0 <= col0 < col1 <= N, C columns a block in
// shared memory with line stride ldt, each line split across a cluster of
// K <= 8 blocks of Mb = ceil(M / K) rows (the last at least 2), in
// segments of L rows (32 L >= Mb, ldt >= Mb); or from device memory when C
// is 0 (K = 1, 32 L >= M).
RT_EXPORT int penta_cols(int dtype, void* sub, void* low, void* imu, void* al,
                         void* be, void* w, void* rhs, void* out, int M,
                         int N, int col0, int col1, int L, int C, int ldt,
                         int K, void* stream) {
  if (K < 1 || K > 8 || (K > 1 && C == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Mb = (M + K - 1) / K;
  if (col0 < 0 || col1 > N || col0 >= col1 || L < 1 || kWarp * L < Mb ||
      C < 0 || C > 8 || (C > 0 && ldt < Mb) ||
      (K > 1 && M - (K - 1) * Mb < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  void* f[5] = {sub, low, imu, al, be};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_cols<double>(f, w, rhs, out, M, N, col0, col1,
                                          L, C, ldt, K, s)
                    : launch_cols<float>(f, w, rhs, out, M, N, col0, col1, L,
                                         C, ldt, K, s);
}

// Solves the rows [row0, row1), 0 <= row0 < row1 <= B, in segments of L
// elements: groups of G rows through a ring of depth 1 or 2 in shared
// memory on `blocks` blocks, each row split across a cluster of K <= 8 of
// them (G <= 8, blocks a multiple of K) in parts of Mb = ceil(M / K) (the
// last at least 2; 32 L >= Mb), or from device memory when G is 0 (K = 1,
// 32 L >= M).
RT_EXPORT int penta_rows(int dtype, void* sub, void* low, void* imu, void* al,
                         void* be, void* w, void* rhs, void* out, int B,
                         int M, int row0, int row1, int L, int G, int depth,
                         int blocks, int K, void* stream) {
  if (K < 1 || K > 8 || (K > 1 && (G < 1 || G > kWarps || blocks % K != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int Mb = (M + K - 1) / K;
  if (row0 < 0 || row1 > B || row0 >= row1 || L < 1 || kWarp * L < Mb ||
      G < 0 || (G > 0 && (depth < 1 || depth > 2 || blocks < 1)) ||
      (K > 1 && M - (K - 1) * Mb < 2))
    return static_cast<int>(cudaErrorInvalidValue);
  void* f[5] = {sub, low, imu, al, be};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_rows<double>(f, w, rhs, out, M, row0, row1, L, G,
                                          depth, blocks, K, s)
                    : launch_rows<float>(f, w, rhs, out, M, row0, row1, L, G,
                                         depth, blocks, K, s);
}

// Solves a (P, M, N) rhs along its middle axis in segments of L rows
// (32 L >= M): C columns a block (C divides 256) in shared memory with
// line stride ldt >= M, or from device memory when C is 0.
RT_EXPORT int penta_mid(int dtype, void* sub, void* low, void* imu, void* al,
                        void* be, void* w, void* rhs, void* out, int P, int M,
                        int N, int L, int C, int ldt, void* stream) {
  if (P < 1 || M < 1 || N < 1 || L < 1 || kWarp * L < M || C < 0 ||
      (C > 0 && (kBlock % C != 0 || ldt < M)))
    return static_cast<int>(cudaErrorInvalidValue);
  void* f[5] = {sub, low, imu, al, be};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_mid<double>(f, w, rhs, out, P, M, N, L, C, ldt,
                                         s)
                    : launch_mid<float>(f, w, rhs, out, P, M, N, L, C, ldt,
                                        s);
}

// The persistent grid's size, as the current device reports it for the row
// sweep with `bytes` of dynamic shared memory a block: for K = 1 the tile
// kernel's resident blocks an SM, for clusters of K > 1 blocks the cluster
// kernel's clusters the device holds at once (what the registers, shared
// memory and the placement of clusters allow).
RT_EXPORT int penta_rows_occupancy(int dtype, int bytes, int K, int* count) {
  if (bytes < 0 || K < 1 || K > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  return dtype == 1 ? rows_occupancy<double>(bytes, K, count)
                    : rows_occupancy<float>(bytes, K, count);
}
