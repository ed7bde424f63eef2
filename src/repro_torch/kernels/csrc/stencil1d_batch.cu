// Batched-1D stencil: cuSten's 1DBatch family.
//
// Replaces the TPU kernel repro/kernels/stencil1d_batch.py:
// stencil1d_batch_pallas (body _stencil1d_kernel): the same 1D stencil
// (extents left, right) along every line of a (B, M) stack, lines
// independent.  bc periodic wraps the element index; bc np computes the
// elements left <= m < M - right and copies the others from out_init (zero
// when it is null).  Weighted or function-pointer mode through the device
// point functions of common.cuh (a user's point_fn on the general path, as
// in stencil2d.cu); windows sweep left to right, the coefficient of window
// k is coeffs[k].
//
// Element m of line b lies at b * line_stride + m * elem_stride, and the
// output and out_init use the same strides.  A (B, M) stack has strides
// (M, 1); the transpose of an (M, B) field has strides (1, B), so the
// y direction of a 2D field (its columns as lines) is read in place, with
// no transposed copy.  Threads along x of a block walk whichever axis is
// contiguous in memory (the elements when elem_stride is 1, the lines when
// line_stride is 1), so every tap's load is coalesced in both directions.
//
// What bounds it on the card: device-memory bandwidth (2 M B elements
// moved, 2 flops per tap); the taps of neighbouring threads share lines of
// L1/L2.  Design: one thread per output element, each wrapping or masking
// its own index, so any B and M work with no tile rule and no padding; the
// second grid axis loops, so any number of lines fits the grid.
//
// A launch computes the lines [line0, line1) (the whole stack is [0, B)):
// lines never couple, so the entry point offsets the pointers by line0
// line strides and runs the kernel on line1 - line0 lines.  A streamed
// apply (repro_torch/launch/stream.py) issues one launch per line chunk.
#include "common.cuh"

namespace {

template <typename T, typename P, bool PERIODIC>
__global__ void __launch_bounds__(256) stencil1d_batch_kernel(
    const T* __restrict__ data, const T* __restrict__ coeffs,
    const T* __restrict__ out_init, T* __restrict__ out, int B, int M,
    long long line_stride, long long elem_stride, int left, int right,
    bool lines_fast) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;  // contiguous axis
  const int n_u = lines_fast ? B : M;
  const int n_v = lines_fast ? M : B;
  if (u >= n_u) return;
  const int taps = left + right + 1;
  for (int v = blockIdx.y * blockDim.y + threadIdx.y; v < n_v;
       v += gridDim.y * blockDim.y) {
    const int b = lines_fast ? u : v;
    const int m = lines_fast ? v : u;
    const T* line = data + b * line_stride;
    const long long idx = b * line_stride + m * elem_stride;
    if (!PERIODIC && (m < left || m >= M - right)) {
      out[idx] = out_init != nullptr ? out_init[idx] : T(0);
      continue;
    }
    if constexpr (P::kGeneral) {
      // the user's point function on the NWIN windows, left to right
      T w[P::kWindows];
#pragma unroll
      for (int k = 0; k < P::kWindows; ++k) {
        int mm = m - left + k;
        if (PERIODIC) mm = wrap_index(mm, M);
        w[k] = __ldg(line + mm * elem_stride);
      }
      out[idx] = P::apply(w, coeffs);
    } else {
      T acc = T(0);
      for (int k = 0; k < taps; ++k) {
        int mm = m - left + k;
        if (PERIODIC) mm = wrap_index(mm, M);
        const T t = P::term(__ldg(coeffs + k), __ldg(line + mm * elem_stride));
        acc = k == 0 ? t : acc + t;
      }
      out[idx] = acc;
    }
  }
}

template <typename T, typename P>
int launch(int periodic, const void* data, const void* coeffs,
           const void* out_init, void* out, int B, int M,
           long long line_stride, long long elem_stride, int left, int right,
           cudaStream_t stream) {
  if constexpr (P::kGeneral) {
    if (P::kWindows != left + right + 1)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool lines_fast = line_stride == 1 && elem_stride != 1;
  const int n_u = lines_fast ? B : M;
  const int n_v = lines_fast ? M : B;
  const dim3 block(32, 8);
  const int blocks_v = (n_v + block.y - 1) / block.y;
  const dim3 grid((n_u + block.x - 1) / block.x,
                  blocks_v < 65535 ? blocks_v : 65535);
  const T* d = static_cast<const T*>(data);
  const T* c = static_cast<const T*>(coeffs);
  const T* init = static_cast<const T*>(out_init);
  T* o = static_cast<T*>(out);
  if (periodic)
    stencil1d_batch_kernel<T, P, true><<<grid, block, 0, stream>>>(
        d, c, init, o, B, M, line_stride, elem_stride, left, right,
        lines_fast);
  else
    stencil1d_batch_kernel<T, P, false><<<grid, block, 0, stream>>>(
        d, c, init, o, B, M, line_stride, elem_stride, left, right,
        lines_fast);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64.  point_fn: 0 weighted, 1 cube (C^3 - C),
// 2 the user's (in a user build, whose NWIN must be the window count).
// periodic: 1 periodic, 0 np.  out_init may be null (np zeros).  Strides
// in elements; out and out_init share data's.  Computes the lines
// [line0, line1), 0 <= line0 < line1 <= B.
RT_EXPORT int stencil1d_batch(int dtype, int point_fn, int periodic,
                              void* data, void* coeffs, void* out_init,
                              void* out, int B, int M, long long line_stride,
                              long long elem_stride, int line0, int line1,
                              int left, int right, void* stream) {
  if (line0 < 0 || line1 > B || line0 >= line1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bytes = dtype == 1 ? sizeof(double) : sizeof(float);
  const long long off = static_cast<long long>(line0) * line_stride;
  auto at = [&](void* p) {
    return p == nullptr ? p : static_cast<void*>(static_cast<char*>(p) +
                                                 off * bytes);
  };
  void* d = at(data);
  void* init = at(out_init);
  void* o = at(out);
  const int nb = line1 - line0;
  return with_point_fn(point_fn, [&](auto p) {
    using P = decltype(p);
    return dtype == 1
               ? launch<double, P>(periodic, d, coeffs, init, o, nb, M,
                                   line_stride, elem_stride, left, right, s)
               : launch<float, P>(periodic, d, coeffs, init, o, nb, M,
                                  line_stride, elem_stride, left, right, s);
  });
}
