// Shared pieces of the repro_torch CUDA kernels: the C export macro, the
// error-string and device-query entry points every library carries, the
// periodic index wrap, the device point functions of the stencil kernels
// (stencil2d.cu, stencil1d_batch.cu, stencil3d.cu), and the
// in-shared-memory row-layout pentadiagonal substitution used by both
// penta.cu (standalone x-sweep) and fused_ch.cu (fused RHS + x-sweep), so
// the two stay in lockstep as they do in the reference
// (repro/kernels/penta.py:rows_substitute_refs).
#pragma once

#include <cuda_runtime.h>

#define RT_EXPORT extern "C" __attribute__((visibility("default")))

RT_EXPORT const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Opt-in shared memory per block (bytes) and SM count of device `dev`.
RT_EXPORT int rt_device_info(int dev, int* smem_optin, int* sms) {
  cudaError_t e = cudaDeviceGetAttribute(
      smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
}

// a mod n in [0, n) for any int a (periodic wrap of an index).
__device__ __forceinline__ int wrap_index(int a, int n) {
  a %= n;
  return a < 0 ? a + n : a;
}

// The stencil kernels' "function pointer": the reference traces a Python
// point_fn into the kernel body; here each one the kernels know is a
// compile-time device point function, named by the Python function's
// device_point_fn tag (DEVICE_POINT_FNS in kernels/stencil2d.py), and a
// window's contribution is P::term(coefficient, value):
//   0 WeightedPoint  c w            (repro weighted_point_fn)
//   1 CubePoint      c (w^3 - w)    (cahn_hilliard.py cube_laplacian_point_fn)
// The kernels sum the terms in window order, as the point functions do.
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

// Call f(P{}) with the device point function of id `point_fn`; an unknown
// id is cudaErrorInvalidValue.
template <typename F>
inline int with_point_fn(int point_fn, F&& f) {
  switch (point_fn) {
    case 0:
      return f(WeightedPoint{});
    case 1:
      return f(CubePoint{});
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// In-place forward/backward substitution of one row of length M held in
// shared memory, with the Create-time LU factors of the band
// (sub = e_i, low = l_i, imu = 1/mu_i, al = alpha_i, be = beta_i):
//   z_i = (r_i - e_i z_{i-2} - l_i z_{i-1}) / mu_i,
//   x_i = z_i - alpha_i x_{i+1} - beta_i x_{i+2}.
template <typename T>
__device__ __forceinline__ void substitute_row(
    T* row, const T* __restrict__ sub, const T* __restrict__ low,
    const T* __restrict__ imu, const T* __restrict__ al,
    const T* __restrict__ be, int M) {
  T z1 = T(0), z2 = T(0);
#pragma unroll 4
  for (int i = 0; i < M; ++i) {
    const T z = (row[i] - __ldg(sub + i) * z2 - __ldg(low + i) * z1) *
                __ldg(imu + i);
    row[i] = z;
    z2 = z1;
    z1 = z;
  }
  T x1 = T(0), x2 = T(0);
#pragma unroll 4
  for (int i = M - 1; i >= 0; --i) {
    const T x = row[i] - __ldg(al + i) * x1 - __ldg(be + i) * x2;
    row[i] = x;
    x2 = x1;
    x1 = x;
  }
}

// Rank-4 Woodbury closure of a cyclic row solve, for element i of a row y
// of length M: x_i = y_i - (W[i,0] y[M-2] + W[i,1] y[M-1] + W[i,2] y[0] +
// W[i,3] y[1]), W = Z S^{-1} the Create-time (M, 4) matrix.
template <typename T>
__device__ __forceinline__ T woodbury_row(const T* row, const T* __restrict__ w,
                                          int i, int M) {
  const T* wi = w + 4 * i;
  return row[i] - (__ldg(wi) * row[M - 2] + __ldg(wi + 1) * row[M - 1] +
                   __ldg(wi + 2) * row[0] + __ldg(wi + 3) * row[1]);
}

// Set the dynamic shared memory ceiling of `kernel` once it is needed
// (anything above 48 KB must be opted into).
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes, int* current) {
  if (bytes <= 48 * 1024 || bytes <= *current) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) *current = bytes;
  return e;
}
