// The Cahn–Hilliard explicit RHS of scheme eq. 2a, alone (ch_rhs) and
// fused with the cyclic x-sweep (ch_rhs_xsweep: L_x^{-1} rhs(c_n, c_nm1)).
//
// Both evaluate the RHS point by point with one __device__ function,
// ch_rhs_terms, in the expanded 13-point form of
// repro/kernels/fused_ch.py:48-97,
//   rhs = k_lin (c_n - c_nm1) + k_bih (dx2 + dy2 + 2 dxdy)[cbar]
//         + k_lap lap5[c_n^3 - c_n],   cbar = 2 c_n - c_nm1,
// with k_lin = -2/3, k_bih = -(2/3) dt gamma D / h^4 and
// k_lap = (2/3) D dt / h^2, its terms in one order, so the two kernels
// cannot drift apart.
//
// ch_rhs replaces the TPU kernel repro/kernels/fused_ch.py:ch_rhs_pallas
// (body _ch_kernel), which assembles a halo-2 band from 3x3 neighbour
// tiles of each field.  What bounds it on the card: device-memory
// bandwidth (two fields read, one written; about 60 flops a point).  The
// first design ran one thread a point, each of its 5 row and 5 column
// indices wrapped by a modulo and each of its 18 taps loaded through
// __ldg: 0.0203 ms at 1024^2 float64, 2.7x the byte bound.  Here
// (ch_rhs_tile_kernel) a block of 32 x 8 threads owns a tile of 32 columns
// and 32 rows and stages that tile of both fields, with a halo of 2 on
// every side (2 x 36 x 36 elements, 20.7 KB in float64), in shared memory
// by cp.async; only the staging loads wrap, by a compare and an add (the
// modulo where an extent is below the halo, ny or nx < 2, so that the halo
// wraps onto itself).  Then each thread computes four outputs (rows
// ty + r 8), so a tap's shared-memory address serves four points, with no
// modulo and no device-memory load in the point loop: 0.0117-0.0122 ms
// (chip_ab.py; NVIDIA H100 80GB HBM3, 700.00 W).  cbar and c^3 - c are
// formed at each tap, as in ch_rhs_at; forming them once for each staged
// point (a pass over the tile in place, and a barrier) gave the same bits
// and took 0.0128-0.0140 ms.
//
// ch_rhs_xsweep replaces repro/kernels/fused_ch.py:ch_rhs_xsweep_pallas
// (body _ch_xsweep_kernel), the first half of every fused ADI step.  A
// block of 256 threads owns R consecutive rows (R chosen by the wrapper
// from nx, the opt-in shared memory and the SM count) and works in three
// phases:
//
// 1. RHS assembly (ch_rhs_at), straight into a dynamic shared-memory
//    buffer of R rows (row stride nx+1), and, when they fit beside the
//    rows, the five factors of the band.  The halo (2 rows above and below
//    the block, 2 columns left and right) is read with periodic wrap
//    directly from global memory; neighbouring threads read neighbouring
//    x, so every tap is a coalesced load and the re-reads hit L1/L2.
// 2. The row substitution in place in shared memory as a segmented
//    recurrence (common.cuh:substitute_segmented): each of the 8 warps
//    takes a row at a time, each lane a segment of
//    L = max(ceil(nx / 32), 8) | 1 elements.  L depends only on nx (kernels/penta.py:segment_length),
//    never on R, so a row is computed by the same code whatever the
//    launch.
// 3. The rank-4 Woodbury closure on the coalesced write-out.
//
// When one row does not fit a block's shared memory (nx + 1 elements
// above the opt-in limit: nx > 29055 in float64 on the H100), the
// device-memory route (ch_rhs_xsweep_global_kernel) takes over: each warp
// assembles one row's RHS straight into `out` and solves it there in place
// (common.cuh:solve_line_global, as penta.cu's row sweep does for such
// rows).  The route depends on nx and the dtype alone, so a streamed chunk
// computes every row as the monolithic call does.
//
// On the tile route the RHS never reaches device memory, as on the TPU.  Unlike the TPU
// kernel, no tile has to divide ny and a block may hold a single row: the
// halo rows come from wherever they lie, with wrap.  What bounded the
// first design on the card was phase 2: one thread per row walked 2 nx
// dependent steps while the other 248 threads of the block waited (20x the
// byte bound).  Now a warp runs each row (all 256 threads when R >= 8), each
// lane about 4 L + 10 dependent steps, and what is left is phase 1's RHS
// assembly (about ch_rhs's time) and the block's serial phases (24 MB of
// traffic at 1024^2 float64).
//
// Both compute the output rows [row0, row1) (the whole field is [0, ny)):
// a streamed step (repro_torch/launch/stream.py) issues one launch per row
// chunk, each reading its halo rows from the whole field with the wrap, so
// every point is computed by the same code whatever the chunk.
#include "common.cuh"

namespace {

// cbar = 2 c_n - c_nm1 and the nonlinear term c^3 - c of one point, shared
// by the two kernels.
template <typename T>
__device__ __forceinline__ T cbar_of(T n, T m) {
  return T(2) * n - m;
}

template <typename T>
__device__ __forceinline__ T cube_of(T v) {
  return v * v * v - v;
}

// The eq. 2a RHS at one point from its taps: b(dy, dx) is cbar and
// nl(dy, dx) is c_n^3 - c_n at the offset (dy, dx), dy, dx in -2..2, and
// lin() is c_n - c_nm1 at the point (read last, as the first design did).
template <typename T, typename B, typename NL, typename LIN>
__device__ __forceinline__ T ch_rhs_terms(const B& b, const NL& nl,
                                          const LIN& lin, T k_lin, T k_bih,
                                          T k_lap) {
  const T dx2 = b(0, -2) - T(4) * b(0, -1) + T(6) * b(0, 0) -
                T(4) * b(0, 1) + b(0, 2);
  const T dy2 = b(-2, 0) - T(4) * b(-1, 0) + T(6) * b(0, 0) -
                T(4) * b(1, 0) + b(2, 0);
  const T dxdy = b(-1, -1) - T(2) * b(-1, 0) + b(-1, 1) -
                 T(2) * (b(0, -1) - T(2) * b(0, 0) + b(0, 1)) + b(1, -1) -
                 T(2) * b(1, 0) + b(1, 1);
  const T bih = dx2 + dy2 + T(2) * dxdy;
  const T lap = nl(-1, 0) + nl(1, 0) + nl(0, -1) + nl(0, 1) - T(4) * nl(0, 0);
  const T d = lin();
  return k_lin * d + k_bih * bih + k_lap * lap;
}

// The eq. 2a RHS at one point from device memory (ch_rhs_xsweep's phase 1).
// n_r[d] / m_r[d] are the rows j + d - 2 of c_n / c_nm1 and col[d] the
// columns i + d - 2, both already wrapped.
template <typename T>
__device__ __forceinline__ T ch_rhs_at(const T* const n_r[5],
                                       const T* const m_r[5],
                                       const int col[5], T k_lin, T k_bih,
                                       T k_lap) {
  auto b = [&](int dy, int dx) {
    const int c = col[dx + 2];
    return cbar_of(__ldg(n_r[dy + 2] + c), __ldg(m_r[dy + 2] + c));
  };
  auto nl = [&](int dy, int dx) {
    return cube_of(__ldg(n_r[dy + 2] + col[dx + 2]));
  };
  auto lin = [&] { return __ldg(n_r[2] + col[2]) - __ldg(m_r[2] + col[2]); };
  return ch_rhs_terms(b, nl, lin, k_lin, k_bih, k_lap);
}

// ch_rhs's tile: 32 columns, 8 thread rows of 4 outputs each, a halo of 2
constexpr int kRhsTX = 32;
constexpr int kRhsBY = 8;
constexpr int kRhsR = 4;
constexpr int kRhsTY = kRhsR * kRhsBY;
constexpr int kRhsH = 2;
constexpr int kRhsW = kRhsTX + 2 * kRhsH;  // a staged row's stride
constexpr int kRhsRows = kRhsTY + 2 * kRhsH;

// Block x + nbx y of grid.x, nbx = ceil(nx / 32), computes the tile
// [x 32, x 32 + 32) x [row0 + y 32, row0 + y 32 + 32) (clipped to row1);
// blockDim (32, 8).  NEAR: both extents at least the halo (a compare and
// an add wrap the staging loads), else the modulo.
template <typename T, bool NEAR>
__global__ void __launch_bounds__(kRhsTX * kRhsBY) ch_rhs_tile_kernel(
    const T* __restrict__ cn, const T* __restrict__ cm, T* __restrict__ out,
    int ny, int nx, int row0, int row1, T k_lin, T k_bih, T k_lap) {
  __shared__ __align__(16) T sn[kRhsRows * kRhsW];
  __shared__ __align__(16) T sm[kRhsRows * kRhsW];
  const int nbx = (nx + kRhsTX - 1) / kRhsTX;
  const int i0 = blockIdx.x % nbx * kRhsTX;
  const int j0 = row0 + blockIdx.x / nbx * kRhsTY;
  const int vx = min(kRhsTX, nx - i0), vy = min(kRhsTY, row1 - j0);
  const int rows = vy + 2 * kRhsH, cols = vx + 2 * kRhsH;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < rows; r += kRhsBY) {
    const size_t off =
        static_cast<size_t>(wrap<NEAR>(j0 - kRhsH + r, ny)) * nx;
    for (int c = tx; c < cols; c += kRhsTX) {
      const size_t src = off + wrap<NEAR>(i0 - kRhsH + c, nx);
      elem_load(sn + r * kRhsW + c, cn + src);
      elem_load(sm + r * kRhsW + c, cm + src);
    }
  }
  elem_commit();
  elem_wait<0>();
  __syncthreads();
  if (tx >= vx) return;
  // the thread's first point, (ty + 2, tx + 2) of the staged tile
  const int at = (ty + kRhsH) * kRhsW + tx + kRhsH;
#pragma unroll
  for (int rr = 0; rr < kRhsR; ++rr) {
    if (ty + rr * kRhsBY >= vy) break;
    const int e = at + rr * kRhsBY * kRhsW;
    auto b = [&](int dy, int dx) {
      const int q = e + dy * kRhsW + dx;
      return cbar_of(sn[q], sm[q]);
    };
    auto nl = [&](int dy, int dx) { return cube_of(sn[e + dy * kRhsW + dx]); };
    auto lin = [&] { return sn[e] - sm[e]; };
    out[static_cast<size_t>(j0 + ty + rr * kRhsBY) * nx + i0 + tx] =
        ch_rhs_terms(b, nl, lin, k_lin, k_bih, k_lap);
  }
}

// stage: the five factors go to shared memory after the R rows (else they
// are read from device memory through L1).  blockDim.x is 256.
template <typename T>
__global__ void __launch_bounds__(256) ch_rhs_xsweep_kernel(
    const T* __restrict__ cn, const T* __restrict__ cm,
    const T* __restrict__ sub, const T* __restrict__ low,
    const T* __restrict__ imu, const T* __restrict__ al,
    const T* __restrict__ be, const T* __restrict__ w, T* __restrict__ out,
    int ny, int nx, int row0, int row1, int R, int L, int stage, T k_lin,
    T k_bih, T k_lap) {
  extern __shared__ unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int ld = nx + 1;
  const int first = row0 + blockIdx.x * R;
  const int nrows = min(R, row1 - first);
  const T* f[5] = {sub, low, imu, al, be};
  if (stage) {
    T* fs = s + R * ld;
    for (int i = threadIdx.x; i < nx; i += blockDim.x) {
#pragma unroll
      for (int k = 0; k < 5; ++k) fs[k * nx + i] = __ldg(f[k] + i);
    }
#pragma unroll
    for (int k = 0; k < 5; ++k) f[k] = fs + k * nx;
  }

  for (int r = 0; r < nrows; ++r) {
    const int j = first + r;
    const T* n_r[5];
    const T* m_r[5];
#pragma unroll
    for (int d = 0; d < 5; ++d) {
      const size_t off = static_cast<size_t>(wrap_index(j + d - 2, ny)) * nx;
      n_r[d] = cn + off;
      m_r[d] = cm + off;
    }
    for (int i = threadIdx.x; i < nx; i += blockDim.x) {
      int col[5];  // nx >= 6, a cyclic factor's length: the near wrap holds
#pragma unroll
      for (int d = 0; d < 5; ++d) col[d] = wrap<true>(i + d - 2, nx);
      s[r * ld + i] = ch_rhs_at(n_r, m_r, col, k_lin, k_bih, k_lap);
    }
  }
  __syncthreads();
  const int warps = blockDim.x / kWarp;
  for (int r = threadIdx.x / kWarp; r < nrows; r += warps) {
    T* row = s + r * ld;
    substitute_segmented(row, row, 1, f[0], f[1], f[2], f[3], f[4], nx, L,
                         threadIdx.x % kWarp);
  }
  __syncthreads();
  for (int r = 0; r < nrows; ++r) {
    const T* row = s + r * ld;
    T* dst = out + static_cast<size_t>(first + r) * nx;
    for (int i = threadIdx.x; i < nx; i += blockDim.x)
      dst[i] = woodbury_row(row, w, i, nx);
  }
}

// Device-memory route: warp g of the grid takes row row0 + g of the
// window, writes its RHS to out and solves it there, closure included;
// blockDim.x is 256.
template <typename T>
__global__ void __launch_bounds__(256) ch_rhs_xsweep_global_kernel(
    const T* __restrict__ cn, const T* __restrict__ cm,
    const T* __restrict__ sub, const T* __restrict__ low,
    const T* __restrict__ imu, const T* __restrict__ al,
    const T* __restrict__ be, const T* __restrict__ w, T* out, int ny,
    int nx, int row0, int row1, int L, T k_lin, T k_bih, T k_lap) {
  const long long g =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  if (g >= row1 - row0) return;  // whole warps
  const int j = row0 + static_cast<int>(g);
  const int lane = threadIdx.x % kWarp;
  const T* n_r[5];
  const T* m_r[5];
#pragma unroll
  for (int d = 0; d < 5; ++d) {
    const size_t off = static_cast<size_t>(wrap_index(j + d - 2, ny)) * nx;
    n_r[d] = cn + off;
    m_r[d] = cm + off;
  }
  T* row = out + static_cast<size_t>(j) * nx;
  for (int i = lane; i < nx; i += kWarp) {
    int col[5];
#pragma unroll
    for (int d = 0; d < 5; ++d) col[d] = wrap<true>(i + d - 2, nx);
    row[i] = ch_rhs_at(n_r, m_r, col, k_lin, k_bih, k_lap);
  }
  __syncwarp();  // the row's RHS is written before any lane's segment reads
  solve_line_global(sub, low, imu, al, be, w, row, row, 1, nx, L, lane);
}

template <typename T>
int launch(const void* cn, const void* cm, void* const* f, const void* w,
           void* out, int ny, int nx, int row0, int row1, int R, int L,
           int stage, double k_lin, double k_bih, double k_lap,
           cudaStream_t stream) {
  if (R == 0) {
    const long long threads = static_cast<long long>(row1 - row0) * kWarp;
    ch_rhs_xsweep_global_kernel<T><<<(threads + 255) / 256, 256, 0, stream>>>(
        static_cast<const T*>(cn), static_cast<const T*>(cm),
        static_cast<const T*>(f[0]), static_cast<const T*>(f[1]),
        static_cast<const T*>(f[2]), static_cast<const T*>(f[3]),
        static_cast<const T*>(f[4]), static_cast<const T*>(w),
        static_cast<T*>(out), ny, nx, row0, row1, L, static_cast<T>(k_lin),
        static_cast<T>(k_bih), static_cast<T>(k_lap));
    return static_cast<int>(cudaGetLastError());
  }
  static int smem_set = 0;
  const int bytes =
      (R * (nx + 1) + (stage ? 5 * nx : 0)) * static_cast<int>(sizeof(T));
  cudaError_t e = allow_smem(ch_rhs_xsweep_kernel<T>, bytes, &smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  ch_rhs_xsweep_kernel<T><<<(row1 - row0 + R - 1) / R, 256, bytes, stream>>>(
      static_cast<const T*>(cn), static_cast<const T*>(cm),
      static_cast<const T*>(f[0]), static_cast<const T*>(f[1]),
      static_cast<const T*>(f[2]), static_cast<const T*>(f[3]),
      static_cast<const T*>(f[4]), static_cast<const T*>(w),
      static_cast<T*>(out), ny, nx, row0, row1, R, L, stage,
      static_cast<T>(k_lin), static_cast<T>(k_bih), static_cast<T>(k_lap));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rhs(const void* cn, const void* cm, void* out, int ny, int nx,
               int row0, int row1, double k_lin, double k_bih, double k_lap,
               cudaStream_t stream) {
  const dim3 block(kRhsTX, kRhsBY);
  const dim3 grid((nx + kRhsTX - 1) / kRhsTX *
                  ((row1 - row0 + kRhsTY - 1) / kRhsTY));
  const bool near = ny >= kRhsH && nx >= kRhsH;
  auto go = [&](auto kernel) {
    kernel<<<grid, block, 0, stream>>>(
        static_cast<const T*>(cn), static_cast<const T*>(cm),
        static_cast<T*>(out), ny, nx, row0, row1, static_cast<T>(k_lin),
        static_cast<T>(k_bih), static_cast<T>(k_lap));
    return static_cast<int>(cudaGetLastError());
  };
  return near ? go(ch_rhs_tile_kernel<T, true>)
              : go(ch_rhs_tile_kernel<T, false>);
}

}  // namespace

// dtype: 0 float32, 1 float64.  Any extent (periodic wrap; the halo wraps
// onto itself where an extent is below 2).  Computes the output rows
// [row0, row1), 0 <= row0 < row1 <= ny.
RT_EXPORT int ch_rhs(int dtype, void* cn, void* cm, void* out, int ny,
                     int nx, int row0, int row1, double k_lin, double k_bih,
                     double k_lap, void* stream) {
  if (row0 < 0 || row1 > ny || row0 >= row1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_rhs<double>(cn, cm, out, ny, nx, row0, row1,
                                         k_lin, k_bih, k_lap, s)
                    : launch_rhs<float>(cn, cm, out, ny, nx, row0, row1,
                                        k_lin, k_bih, k_lap, s);
}

// dtype: 0 float32, 1 float64.  w is the (nx, 4) Woodbury matrix (cyclic).
// Computes the output rows [row0, row1), 0 <= row0 < row1 <= ny, R rows a
// block (R = 0: the device-memory route, a warp a row), in segments of L
// elements (32 L >= nx); stage != 0 puts the factors in shared memory
// beside the rows.
RT_EXPORT int ch_rhs_xsweep(int dtype, void* cn, void* cm, void* sub,
                            void* low, void* imu, void* al, void* be, void* w,
                            void* out, int ny, int nx, int row0, int row1,
                            int R, int L, int stage, double k_lin,
                            double k_bih, double k_lap, void* stream) {
  if (row0 < 0 || row1 > ny || row0 >= row1 || R < 0 || L < 1 ||
      kWarp * L < nx)
    return static_cast<int>(cudaErrorInvalidValue);
  void* f[5] = {sub, low, imu, al, be};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<double>(cn, cm, f, w, out, ny, nx, row0, row1,
                                     R, L, stage, k_lin, k_bih, k_lap, s)
                    : launch<float>(cn, cm, f, w, out, ny, nx, row0, row1, R,
                                    L, stage, k_lin, k_bih, k_lap, s);
}
