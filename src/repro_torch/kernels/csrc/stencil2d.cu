// Generic 2D stencil: the cuSten compute kernel.
//
// Replaces the TPU kernel repro/kernels/stencil2d.py:stencil2d_pallas
// (body _stencil_kernel).  Halos (left, right, top, bottom); bc periodic
// (wrapped indices) or np (interior cells computed, the others copied from
// out_init, or zero when it is null); weighted mode or function-pointer
// mode.  The TPU's Python point_fn, traced into the kernel body, becomes a
// small compile-time set of device point functions, which is cuSten's own
// function-pointer design:
//   WeightedPoint  sum_k c_k w_k              (repro weighted_point_fn)
//   CubePoint      sum_k c_k (w_k^3 - w_k)    (cahn_hilliard.py:83-90)
// Windows are enumerated row-major from the top-left of the stencil; the
// coefficient of window (a, b) is coeffs[a * (left + right + 1) + b].
//
// What bounds it on the card: device-memory bandwidth (a few flops per
// tap, each input read once from DRAM, the neighbours served from L1/L2).
// Design: one thread per output point, each computing its own wrapped or
// masked indices, so any extent (odd, prime) works with no tiling rule and
// no padding; a warp covers 32 consecutive x so every tap's load is
// coalesced.  Staging a halo tile in shared memory is left to a later pass.
#include "common.cuh"

namespace {

struct WeightedPoint {
  template <typename T>
  static __device__ __forceinline__ T term(T c, T w) {
    return c * w;
  }
};

struct CubePoint {
  template <typename T>
  static __device__ __forceinline__ T term(T c, T w) {
    return c * (w * w * w - w);
  }
};

template <typename T, typename P, bool PERIODIC>
__global__ void __launch_bounds__(256) stencil2d_kernel(
    const T* __restrict__ data, const T* __restrict__ coeffs,
    const T* __restrict__ out_init, T* __restrict__ out, int ny, int nx,
    int left, int right, int top, int bottom) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const size_t idx = static_cast<size_t>(j) * nx + i;
  if (!PERIODIC &&
      (i < left || i >= nx - right || j < top || j >= ny - bottom)) {
    out[idx] = out_init != nullptr ? out_init[idx] : T(0);
    return;
  }
  const int sx = left + right + 1;
  const int sy = top + bottom + 1;
  T acc = T(0);
  for (int a = 0; a < sy; ++a) {
    int jj = j - top + a;
    if (PERIODIC) jj = wrap_index(jj, ny);
    const T* row = data + static_cast<size_t>(jj) * nx;
    for (int b = 0; b < sx; ++b) {
      int ii = i - left + b;
      if (PERIODIC) ii = wrap_index(ii, nx);
      const T t = P::term(__ldg(coeffs + a * sx + b), __ldg(row + ii));
      acc = (a == 0 && b == 0) ? t : acc + t;
    }
  }
  out[idx] = acc;
}

template <typename T, typename P>
int launch(int periodic, const void* data, const void* coeffs,
           const void* out_init, void* out, int ny, int nx, int left,
           int right, int top, int bottom, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y);
  const T* d = static_cast<const T*>(data);
  const T* c = static_cast<const T*>(coeffs);
  const T* init = static_cast<const T*>(out_init);
  T* o = static_cast<T*>(out);
  if (periodic)
    stencil2d_kernel<T, P, true><<<grid, block, 0, stream>>>(
        d, c, init, o, ny, nx, left, right, top, bottom);
  else
    stencil2d_kernel<T, P, false><<<grid, block, 0, stream>>>(
        d, c, init, o, ny, nx, left, right, top, bottom);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_point(int point_fn, int periodic, const void* data,
                   const void* coeffs, const void* out_init, void* out,
                   int ny, int nx, int left, int right, int top, int bottom,
                   cudaStream_t s) {
  switch (point_fn) {
    case 0:
      return launch<T, WeightedPoint>(periodic, data, coeffs, out_init, out,
                                      ny, nx, left, right, top, bottom, s);
    case 1:
      return launch<T, CubePoint>(periodic, data, coeffs, out_init, out, ny,
                                  nx, left, right, top, bottom, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 float32, 1 float64.  point_fn: 0 weighted, 1 cube (C^3 - C).
// periodic: 1 periodic, 0 np.  out_init may be null (np zeros).
RT_EXPORT int stencil2d(int dtype, int point_fn, int periodic, void* data,
                        void* coeffs, void* out_init, void* out, int ny,
                        int nx, int left, int right, int top, int bottom,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
             ? dispatch_point<double>(point_fn, periodic, data, coeffs,
                                      out_init, out, ny, nx, left, right,
                                      top, bottom, s)
             : dispatch_point<float>(point_fn, periodic, data, coeffs,
                                     out_init, out, ny, nx, left, right, top,
                                     bottom, s);
}
