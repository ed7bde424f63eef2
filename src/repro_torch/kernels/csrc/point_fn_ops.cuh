// The device operations of a point function translated from Python
// (kernels/point_fn.py:emit_cuda).  The translation includes this header
// and calls these where the Python function called an aten op, so that
// the kernel rounds as the plain version's PyTorch kernels do on the
// card:
// - add, sub, mul and div round each operation on its own: the _rn
//   intrinsics, which nvcc never contracts into a fused multiply-add
//   (one PyTorch kernel an op cannot fuse either);
// - maximum, minimum and clamp propagate a NaN as PyTorch's do.
// Everything else (sqrt, exp, sin, pow, ...) is the CUDA math function
// PyTorch's kernel calls, by the same overload.
#pragma once

__device__ __forceinline__ float pf_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double pf_add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float pf_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double pf_sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float pf_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double pf_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float pf_div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double pf_div(double a, double b) {
  return __ddiv_rn(a, b);
}

template <typename T>
__device__ __forceinline__ T pf_maximum(T a, T b) {
  return a != a ? a : (b != b ? b : fmax(a, b));
}

template <typename T>
__device__ __forceinline__ T pf_minimum(T a, T b) {
  return a != a ? a : (b != b ? b : fmin(a, b));
}

template <typename T>
__device__ __forceinline__ T pf_clamp_min(T v, T lo) {
  return v != v ? v : fmax(v, lo);
}

template <typename T>
__device__ __forceinline__ T pf_clamp_max(T v, T hi) {
  return v != v ? v : fmin(v, hi);
}

template <typename T>
__device__ __forceinline__ T pf_clamp(T v, T lo, T hi) {
  return v != v ? v : fmin(fmax(v, lo), hi);
}
