// Fused Cahn–Hilliard explicit RHS + cyclic x-sweep: L_x^{-1} rhs(c_n, c_nm1).
//
// Replaces the TPU kernel repro/kernels/fused_ch.py:ch_rhs_xsweep_pallas
// (body _ch_xsweep_kernel), the first half of every fused ADI step.  A
// block owns R consecutive rows (R chosen by the wrapper from nx, the
// opt-in shared memory and the SM count) and works in three phases:
//
// 1. RHS assembly, straight into a dynamic shared-memory buffer of R rows
//    (row stride nx+1).  The eq. 2a RHS is evaluated in the expanded
//    13-point form of repro/kernels/fused_ch.py:54-63,
//      rhs = k_lin (c_n - c_nm1) + k_bih (dx2 + dy2 + 2 dxdy)[cbar]
//            + k_lap lap5[c_n^3 - c_n],   cbar = 2 c_n - c_nm1,
//    with k_lin = -2/3, k_bih = -(2/3) dt gamma D / h^4 and
//    k_lap = (2/3) D dt / h^2.  The halo (2 rows above and below the block,
//    2 columns left and right) is read with periodic wrap directly from
//    global memory; neighbouring threads read neighbouring x, so every tap
//    is a coalesced load and the re-reads hit L1/L2.
// 2. The row-layout substitution in place in shared memory, one thread per
//    row (common.cuh:substitute_row, shared with penta.cu).
// 3. The rank-4 Woodbury closure on the coalesced write-out.
//
// The RHS never reaches device memory, as on the TPU.  Unlike the TPU
// kernel, no tile has to divide ny and a block may hold a single row: the
// halo rows come from wherever they lie, with wrap.
//
// What bounds it on the card: not bandwidth (24 MB of traffic at 1024^2
// float64) but the serial recurrence of phase 2, which has only R threads
// per block and ny threads in all; it is latency-bound, like penta_rows.
#include "common.cuh"

namespace {

// near wrap for |d| <= 2 and n >= 6 (nx is a cyclic factor length)
__device__ __forceinline__ int wrap_near(int a, int n) {
  return a < 0 ? a + n : (a >= n ? a - n : a);
}

template <typename T>
__global__ void __launch_bounds__(256) ch_rhs_xsweep_kernel(
    const T* __restrict__ cn, const T* __restrict__ cm,
    const T* __restrict__ sub, const T* __restrict__ low,
    const T* __restrict__ imu, const T* __restrict__ al,
    const T* __restrict__ be, const T* __restrict__ w, T* __restrict__ out,
    int ny, int nx, int R, T k_lin, T k_bih, T k_lap) {
  extern __shared__ unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int ld = nx + 1;
  const int row0 = blockIdx.x * R;
  const int nrows = min(R, ny - row0);

  for (int r = 0; r < nrows; ++r) {
    const int j = row0 + r;
    const T* n_r[5];
    const T* m_r[5];
#pragma unroll
    for (int d = 0; d < 5; ++d) {
      const size_t off = static_cast<size_t>(wrap_index(j + d - 2, ny)) * nx;
      n_r[d] = cn + off;
      m_r[d] = cm + off;
    }
    for (int i = threadIdx.x; i < nx; i += blockDim.x) {
      int col[5];
#pragma unroll
      for (int d = 0; d < 5; ++d) col[d] = wrap_near(i + d - 2, nx);
      // cbar at (dy, dx) offsets: b(dy, dx), dy, dx in -2..2
      auto b = [&](int dy, int dx) {
        const int c = col[dx + 2];
        return T(2) * __ldg(n_r[dy + 2] + c) - __ldg(m_r[dy + 2] + c);
      };
      auto nl = [&](int dy, int dx) {
        const T v = __ldg(n_r[dy + 2] + col[dx + 2]);
        return v * v * v - v;
      };
      const T dx2 = b(0, -2) - T(4) * b(0, -1) + T(6) * b(0, 0) -
                    T(4) * b(0, 1) + b(0, 2);
      const T dy2 = b(-2, 0) - T(4) * b(-1, 0) + T(6) * b(0, 0) -
                    T(4) * b(1, 0) + b(2, 0);
      const T dxdy = b(-1, -1) - T(2) * b(-1, 0) + b(-1, 1) -
                     T(2) * (b(0, -1) - T(2) * b(0, 0) + b(0, 1)) +
                     b(1, -1) - T(2) * b(1, 0) + b(1, 1);
      const T bih = dx2 + dy2 + T(2) * dxdy;
      const T lap =
          nl(-1, 0) + nl(1, 0) + nl(0, -1) + nl(0, 1) - T(4) * nl(0, 0);
      const T lin = __ldg(n_r[2] + i) - __ldg(m_r[2] + i);
      s[r * ld + i] = k_lin * lin + k_bih * bih + k_lap * lap;
    }
  }
  __syncthreads();
  if (threadIdx.x < nrows)
    substitute_row(s + threadIdx.x * ld, sub, low, imu, al, be, nx);
  __syncthreads();
  for (int r = 0; r < nrows; ++r) {
    const T* row = s + r * ld;
    T* dst = out + static_cast<size_t>(row0 + r) * nx;
    for (int i = threadIdx.x; i < nx; i += blockDim.x)
      dst[i] = woodbury_row(row, w, i, nx);
  }
}

template <typename T>
int launch(const void* cn, const void* cm, void* const* f, const void* w,
           void* out, int ny, int nx, int R, double k_lin, double k_bih,
           double k_lap, cudaStream_t stream) {
  static int smem_set = 0;
  const int bytes = R * (nx + 1) * static_cast<int>(sizeof(T));
  cudaError_t e = allow_smem(ch_rhs_xsweep_kernel<T>, bytes, &smem_set);
  if (e != cudaSuccess) return static_cast<int>(e);
  ch_rhs_xsweep_kernel<T><<<(ny + R - 1) / R, 256, bytes, stream>>>(
      static_cast<const T*>(cn), static_cast<const T*>(cm),
      static_cast<const T*>(f[0]), static_cast<const T*>(f[1]),
      static_cast<const T*>(f[2]), static_cast<const T*>(f[3]),
      static_cast<const T*>(f[4]), static_cast<const T*>(w),
      static_cast<T*>(out), ny, nx, R, static_cast<T>(k_lin),
      static_cast<T>(k_bih), static_cast<T>(k_lap));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64.  w is the (nx, 4) Woodbury matrix (cyclic).
RT_EXPORT int ch_rhs_xsweep(int dtype, void* cn, void* cm, void* sub,
                            void* low, void* imu, void* al, void* be, void* w,
                            void* out, int ny, int nx, int R, double k_lin,
                            double k_bih, double k_lap, void* stream) {
  void* f[5] = {sub, low, imu, al, be};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<double>(cn, cm, f, w, out, ny, nx, R, k_lin,
                                     k_bih, k_lap, s)
                    : launch<float>(cn, cm, f, w, out, ny, nx, R, k_lin,
                                    k_bih, k_lap, s);
}
