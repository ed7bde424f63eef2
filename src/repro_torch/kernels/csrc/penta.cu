// Batched pentadiagonal substitution with the Create-time LU factors, in
// the two layouts of the 2D ADI step.
//
// penta_cols replaces the TPU kernel repro/kernels/penta.py:
// _substitute_pallas (body _substitute_kernel): column layout, an (M, N)
// right-hand side whose N systems lie along the contiguous axis and whose
// recurrence runs over the M rows (the y-sweep).  One thread owns one
// column, so each step's loads and stores are coalesced across the warp.
// What bounds it on the card: the recurrence is serial in M and there are
// only N threads (1024 at the main size), so it is latency-bound, not
// bandwidth-bound.  Blocks are one warp each to spread the N threads over
// as many SMs as possible.  The cyclic rank-4 Woodbury closure
// (repro/kernels/penta.py:604-609) is this kernel's epilogue: each thread
// already holds its whole column, so the closure costs one more coalesced
// pass instead of a chain of elementwise launches.
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
// also latency-bound for the same reason as penta_cols.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(32) penta_cols_kernel(
    const T* __restrict__ sub, const T* __restrict__ low,
    const T* __restrict__ imu, const T* __restrict__ al,
    const T* __restrict__ be, const T* __restrict__ w,
    const T* __restrict__ rhs, T* __restrict__ out, int M, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t ld = static_cast<size_t>(N);
  const T* r = rhs + n;
  T* o = out + n;
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

template <typename T>
int launch_cols(void* const* f, const void* w, const void* rhs, void* out,
                int M, int N, cudaStream_t stream) {
  const int threads = 32;
  penta_cols_kernel<T><<<(N + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const T*>(f[0]), static_cast<const T*>(f[1]),
      static_cast<const T*>(f[2]), static_cast<const T*>(f[3]),
      static_cast<const T*>(f[4]), static_cast<const T*>(w),
      static_cast<const T*>(rhs), static_cast<T*>(out), M, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_rows(void* const* f, const void* w, const void* rhs, void* out,
                int B, int M, int R, cudaStream_t stream) {
  static int smem_set = 0;
  const int bytes = R * (M + 1) * static_cast<int>(sizeof(T));
  cudaError_t e = allow_smem(penta_rows_kernel<T>, bytes, &smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  penta_rows_kernel<T><<<(B + R - 1) / R, 256, bytes, stream>>>(
      static_cast<const T*>(f[0]), static_cast<const T*>(f[1]),
      static_cast<const T*>(f[2]), static_cast<const T*>(f[3]),
      static_cast<const T*>(f[4]), static_cast<const T*>(w),
      static_cast<const T*>(rhs), static_cast<T*>(out), B, M, R);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64.  w may be null (non-cyclic band).
RT_EXPORT int penta_cols(int dtype, void* sub, void* low, void* imu, void* al,
                         void* be, void* w, void* rhs, void* out, int M,
                         int N, void* stream) {
  void* f[5] = {sub, low, imu, al, be};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_cols<double>(f, w, rhs, out, M, N, s)
                    : launch_cols<float>(f, w, rhs, out, M, N, s);
}

RT_EXPORT int penta_rows(int dtype, void* sub, void* low, void* imu, void* al,
                         void* be, void* w, void* rhs, void* out, int B,
                         int M, int R, void* stream) {
  void* f[5] = {sub, low, imu, al, be};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_rows<double>(f, w, rhs, out, B, M, R, s)
                    : launch_rows<float>(f, w, rhs, out, B, M, R, s);
}
