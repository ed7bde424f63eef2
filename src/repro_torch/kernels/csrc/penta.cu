// Batched pentadiagonal substitution with the Create-time LU factors, in
// the three layouts of the 2D and 3D ADI steps.
//
// penta_cols replaces the TPU kernel repro/kernels/penta.py:
// _substitute_pallas (body _substitute_kernel): column layout, an (M, N)
// right-hand side whose N systems lie along the contiguous axis and whose
// recurrence runs over the M rows (the y-sweep of the 2D step, the z-sweep
// of the 3D step).  The recurrence is serial in M, so one thread per
// column (the first design) leaves only N threads, 1024 at the main size:
// 32 of the 132 SMs busy, one load in flight per warp, latency-bound at
// 74x the byte bound.  Here each column is a segmented recurrence
// (common.cuh:substitute_segmented): one warp per column, each lane a
// segment of L = max(ceil(M / 32), 8) | 1 rows, so 32 N threads work and
// each walks about 4 L + 10 dependent steps instead of 3 M.  The segment
// length depends only on M (kernels/penta.py:segment_length), never on N
// or the window, so a column is computed by the same code whatever the
// launch.  Two routes, chosen by the wrapper from M and the shared memory
// a block can hold (kernels/penta.py:cols_per_block):
//
// - tile (penta_cols_tile_kernel): a block stages the five factors and an
//   (M, C) tile of C <= 8 columns in dynamic shared memory with coalesced
//   loads (line stride ldt, M rounded up to 128 bytes plus 16 bytes, so
//   the load and store phases hit 32 different banks), C warps run the
//   segmented recurrences in shared memory, and the block writes the tile
//   back coalesced with the cyclic rank-4 Woodbury closure
//   (repro/kernels/penta.py:604-609) applied on the way out.  Device
//   memory sees the rhs read once and the output written once: what
//   bounds it now is those bytes and the block's serial phases (load,
//   recurrence, store).
// - global (penta_cols_global_kernel), for an M whose tile of one column
//   does not fit: the same warp-per-column recurrence on the column in
//   device memory (strided, through L1/L2), the closure as the epilogue.
//
// penta_rows replaces repro/kernels/penta.py:_substitute_rows_pallas (body
// rows_substitute_refs): row layout, a (B, M) right-hand side whose
// recurrence runs along the contiguous axis (the x-sweep).  One thread per
// row reading global memory would put the 32 lanes of a warp M elements
// apart, so no load would coalesce.  Instead a block stages R rows in
// dynamic shared memory with coalesced loads (row stride M+1 so that the R
// recurrence threads hit different banks), R threads run the recurrences
// in shared memory, and the block writes the rows back coalesced, applying
// the Woodbury closure (rows_woodbury_correct) on the way out.  R is chosen
// by the wrapper from M, the opt-in shared memory and the SM count; it is
// latency-bound: only R threads a block and B in all walk the serial
// recurrence.
//
// penta_mid replaces repro/kernels/penta.py:_substitute_mid_pallas (body
// _substitute_mid_kernel) and its closure mid_woodbury_correct: plane
// layout, a (P, M, N) right-hand side whose recurrence runs over the middle
// axis (the y-sweep of a 3D field, transpose-free).  The TPU kernel walks
// one plane's (M, tn) block per grid step; here one thread owns one (p, n)
// line, so each step's loads are coalesced across the warp along n, and
// the P N lines (65536 at 256^3) all run at once.  It runs substitute_line
// (one thread walks the whole line), with the cyclic rank-4 closure as the
// epilogue when w is given: latency-bound like a sweep with one thread a
// column, but with P times as many threads.
//
// penta_cols computes the columns [col0, col1) and penta_rows the rows
// [row0, row1) of their output (the whole rhs is [0, N) and [0, B)): the
// systems are independent, so a streamed sweep (repro_torch/launch/
// stream.py) issues one launch per chunk of systems and each system is
// solved by the same code whatever the chunk.
#include "common.cuh"

namespace {

// Forward/backward substitution of one strided line (element i at r[i * ld]
// and o[i * ld]) with the factors of a length-M band, then, when w is not
// null, the cyclic rank-4 Woodbury closure x_i = y_i - (W[i,0] y[M-2] +
// W[i,1] y[M-1] + W[i,2] y[0] + W[i,3] y[1]) as the epilogue: the thread
// already holds the four entries of y it needs.
template <typename T>
__device__ __forceinline__ void substitute_line(
    const T* __restrict__ sub, const T* __restrict__ low,
    const T* __restrict__ imu, const T* __restrict__ al,
    const T* __restrict__ be, const T* __restrict__ w,
    const T* __restrict__ r, T* __restrict__ o, size_t ld, int M) {
  T z1 = T(0), z2 = T(0);
#pragma unroll 4
  for (int i = 0; i < M; ++i) {
    const T z = (r[i * ld] - __ldg(sub + i) * z2 - __ldg(low + i) * z1) *
                __ldg(imu + i);
    o[i * ld] = z;
    z2 = z1;
    z1 = z;
  }
  T x1 = T(0), x2 = T(0);
  T y_last = T(0), y_before_last = T(0);
#pragma unroll 4
  for (int i = M - 1; i >= 0; --i) {
    const T x = o[i * ld] - __ldg(al + i) * x1 - __ldg(be + i) * x2;
    o[i * ld] = x;
    if (i == M - 1) y_last = x;
    if (i == M - 2) y_before_last = x;
    x2 = x1;
    x1 = x;
  }
  if (w != nullptr) {
    // x1 = y[0], x2 = y[1] after the backward pass
    const T y0 = x1, y1 = x2;
#pragma unroll 4
    for (int i = 0; i < M; ++i) {
      const T* wi = w + 4 * i;
      o[i * ld] = o[i * ld] - (__ldg(wi) * y_before_last +
                               __ldg(wi + 1) * y_last + __ldg(wi + 2) * y0 +
                               __ldg(wi + 3) * y1);
    }
  }
}

// Column sweep, tile route: block b solves the columns [b C, b C + C) of
// an (M, n) window of row stride N; blockDim.x = 32 C.
template <typename T>
__global__ void __launch_bounds__(256) penta_cols_tile_kernel(
    const T* __restrict__ sub, const T* __restrict__ low,
    const T* __restrict__ imu, const T* __restrict__ al,
    const T* __restrict__ be, const T* __restrict__ w,
    const T* __restrict__ rhs, T* __restrict__ out, int M, int n, size_t N,
    int L, int C, int ldt) {
  extern __shared__ unsigned char smem_raw[];
  T* f = reinterpret_cast<T*>(smem_raw);  // sub, low, imu, al, be
  T* tile = f + 5 * M;                    // C lines of stride ldt
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
    f[i] = __ldg(sub + i);
    f[M + i] = __ldg(low + i);
    f[2 * M + i] = __ldg(imu + i);
    f[3 * M + i] = __ldg(al + i);
    f[4 * M + i] = __ldg(be + i);
  }
  // thread (row r0 + 32 j, column c) in the load and store phases
  const int c = threadIdx.x % C;
  const int r0 = threadIdx.x / C;
  const int col = blockIdx.x * C + c;
  T* y = tile + c * ldt;
  if (col < n) {
    for (int i = r0; i < M; i += kWarp) y[i] = rhs[i * N + col];
  }
  __syncthreads();
  const int warp = threadIdx.x / kWarp;
  if (blockIdx.x * C + warp < n) {
    T* line = tile + warp * ldt;
    substitute_segmented(line, line, 1, f, f + M, f + 2 * M, f + 3 * M,
                         f + 4 * M, M, L, threadIdx.x % kWarp);
  }
  __syncthreads();
  if (col >= n) return;
  if (w == nullptr) {
    for (int i = r0; i < M; i += kWarp) out[i * N + col] = y[i];
    return;
  }
  const T ym2 = y[M - 2], ym1 = y[M - 1], y0 = y[0], y1 = y[1];
  for (int i = r0; i < M; i += kWarp) {
    const T* wi = w + 4 * i;
    out[i * N + col] = y[i] - (__ldg(wi) * ym2 + __ldg(wi + 1) * ym1 +
                               __ldg(wi + 2) * y0 + __ldg(wi + 3) * y1);
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
  const int lane = threadIdx.x % kWarp;
  if (col >= n) return;  // whole warps
  T* o = out + col;
  substitute_segmented(rhs + col, o, static_cast<long long>(N), sub, low,
                       imu, al, be, M, L, lane);
  if (w == nullptr) return;
  __syncwarp();
  const T ym2 = o[(M - 2) * N], ym1 = o[(M - 1) * N], y0 = o[0], y1 = o[N];
  __syncwarp();
  const int a = min(lane * L, M), b = min(a + L, M);
  for (int i = a; i < b; ++i) {
    const T* wi = w + 4 * i;
    o[i * N] -= __ldg(wi) * ym2 + __ldg(wi + 1) * ym1 + __ldg(wi + 2) * y0 +
                __ldg(wi + 3) * y1;
  }
}

template <typename T>
__global__ void __launch_bounds__(64) penta_mid_kernel(
    const T* __restrict__ sub, const T* __restrict__ low,
    const T* __restrict__ imu, const T* __restrict__ al,
    const T* __restrict__ be, const T* __restrict__ w,
    const T* __restrict__ rhs, T* __restrict__ out, int P, int M, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  for (int p = blockIdx.y; p < P; p += gridDim.y) {
    const size_t base = static_cast<size_t>(p) * M * N + n;
    substitute_line(sub, low, imu, al, be, w, rhs + base, out + base,
                    static_cast<size_t>(N), M);
  }
}

template <typename T>
__global__ void __launch_bounds__(256) penta_rows_kernel(
    const T* __restrict__ sub, const T* __restrict__ low,
    const T* __restrict__ imu, const T* __restrict__ al,
    const T* __restrict__ be, const T* __restrict__ w,
    const T* __restrict__ rhs, T* __restrict__ out, int B, int M, int R) {
  extern __shared__ unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int ld = M + 1;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, B - row0);
  for (int r = 0; r < nrows; ++r) {
    const T* src = rhs + static_cast<size_t>(row0 + r) * M;
    for (int i = threadIdx.x; i < M; i += blockDim.x) s[r * ld + i] = src[i];
  }
  __syncthreads();
  if (threadIdx.x < nrows)
    substitute_row(s + threadIdx.x * ld, sub, low, imu, al, be, M);
  __syncthreads();
  for (int r = 0; r < nrows; ++r) {
    const T* row = s + r * ld;
    T* dst = out + static_cast<size_t>(row0 + r) * M;
    for (int i = threadIdx.x; i < M; i += blockDim.x)
      dst[i] = (w != nullptr) ? woodbury_row(row, w, i, M) : row[i];
  }
}

// The columns [col0, col1) of an (M, N) rhs: segments of L rows; C columns
// a block through shared memory (line stride ldt), or C = 0 for the
// global route.
template <typename T>
int launch_cols(void* const* f, const void* w, const void* rhs, void* out,
                int M, int N, int col0, int col1, int L, int C, int ldt,
                cudaStream_t stream) {
  const int n = col1 - col0;
  const T* F[5];
  for (int k = 0; k < 5; ++k) F[k] = static_cast<const T*>(f[k]);
  const T* r = static_cast<const T*>(rhs) + col0;
  T* o = static_cast<T*>(out) + col0;
  const T* wp = static_cast<const T*>(w);
  if (C > 0) {
    static int smem_set = 0;
    const int bytes = (5 * M + C * ldt) * static_cast<int>(sizeof(T));
    cudaError_t e = allow_smem(penta_cols_tile_kernel<T>, bytes, &smem_set);
    if (e != cudaSuccess) return static_cast<int>(e);
    penta_cols_tile_kernel<T><<<(n + C - 1) / C, kWarp * C, bytes, stream>>>(
        F[0], F[1], F[2], F[3], F[4], wp, r, o, M, n,
        static_cast<size_t>(N), L, C, ldt);
  } else {
    const int per_block = 8;  // columns (warps) a block
    penta_cols_global_kernel<T>
        <<<(n + per_block - 1) / per_block, kWarp * per_block, 0, stream>>>(
            F[0], F[1], F[2], F[3], F[4], wp, r, o, M, n,
            static_cast<size_t>(N), L);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_mid(void* const* f, const void* w, const void* rhs, void* out,
               int P, int M, int N, cudaStream_t stream) {
  const int threads = 64;
  const dim3 grid((N + threads - 1) / threads, P < 65535 ? P : 65535);
  penta_mid_kernel<T><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(f[0]), static_cast<const T*>(f[1]),
      static_cast<const T*>(f[2]), static_cast<const T*>(f[3]),
      static_cast<const T*>(f[4]), static_cast<const T*>(w),
      static_cast<const T*>(rhs), static_cast<T*>(out), P, M, N);
  return static_cast<int>(cudaGetLastError());
}

// The rows [row0, row1) of a (B, M) rhs.
template <typename T>
int launch_rows(void* const* f, const void* w, const void* rhs, void* out,
                int M, int row0, int row1, int R, cudaStream_t stream) {
  static int smem_set = 0;
  const int bytes = R * (M + 1) * static_cast<int>(sizeof(T));
  cudaError_t e = allow_smem(penta_rows_kernel<T>, bytes, &smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int B = row1 - row0;
  const size_t off = static_cast<size_t>(row0) * M;
  penta_rows_kernel<T><<<(B + R - 1) / R, 256, bytes, stream>>>(
      static_cast<const T*>(f[0]), static_cast<const T*>(f[1]),
      static_cast<const T*>(f[2]), static_cast<const T*>(f[3]),
      static_cast<const T*>(f[4]), static_cast<const T*>(w),
      static_cast<const T*>(rhs) + off, static_cast<T*>(out) + off, B, M, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64.  w may be null (non-cyclic band).  Solves
// the columns [col0, col1), 0 <= col0 < col1 <= N, in segments of L rows
// (32 L >= M), C columns a block in shared memory with line stride
// ldt >= M, or from device memory when C is 0.
RT_EXPORT int penta_cols(int dtype, void* sub, void* low, void* imu, void* al,
                         void* be, void* w, void* rhs, void* out, int M,
                         int N, int col0, int col1, int L, int C, int ldt,
                         void* stream) {
  if (col0 < 0 || col1 > N || col0 >= col1 || L < 1 || kWarp * L < M ||
      C < 0 || C > 8 || (C > 0 && ldt < M))
    return static_cast<int>(cudaErrorInvalidValue);
  void* f[5] = {sub, low, imu, al, be};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_cols<double>(f, w, rhs, out, M, N, col0, col1,
                                          L, C, ldt, s)
                    : launch_cols<float>(f, w, rhs, out, M, N, col0, col1, L,
                                         C, ldt, s);
}

// Solves the rows [row0, row1), 0 <= row0 < row1 <= B.
RT_EXPORT int penta_rows(int dtype, void* sub, void* low, void* imu, void* al,
                         void* be, void* w, void* rhs, void* out, int B,
                         int M, int row0, int row1, int R, void* stream) {
  if (row0 < 0 || row1 > B || row0 >= row1)
    return static_cast<int>(cudaErrorInvalidValue);
  void* f[5] = {sub, low, imu, al, be};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_rows<double>(f, w, rhs, out, M, row0, row1, R, s)
                    : launch_rows<float>(f, w, rhs, out, M, row0, row1, R, s);
}

RT_EXPORT int penta_mid(int dtype, void* sub, void* low, void* imu, void* al,
                        void* be, void* w, void* rhs, void* out, int P, int M,
                        int N, void* stream) {
  void* f[5] = {sub, low, imu, al, be};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_mid<double>(f, w, rhs, out, P, M, N, s)
                    : launch_mid<float>(f, w, rhs, out, P, M, N, s);
}
