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
// k is coeffs[k].  A weighted or cube plan is reduced at Create to its
// non-zero taps (kernels/taps.py:nonzero_taps; window k is (0, 0, k)),
// passed by value as a __grid_constant__ parameter and summed in window
// order: skipping an exact-zero term changes no finite result, only the
// sign of an all-zero sum.
//
// Element m of line b lies at b * line_stride + m * elem_stride, and the
// output and out_init use the same strides.  A (B, M) stack has strides
// (M, 1); the transpose of an (M, B) field has strides (1, B), so the
// y direction of a 2D field (its columns as lines) is read in place, with
// no transposed copy.
//
// What bounds it on the card: device-memory bandwidth (2 M B elements
// moved, 2 flops a tap).  The first design ran one thread an element, each
// tap wrapping its index by a modulo and loading its coefficient.  Three
// routes now (kernels/stencil1d_batch.py:stencil1d_batch_geometry, from B,
// M, the halos, the layout and the dtype alone):
// - along x (elem_stride 1): a block of 256 threads stages nl lines of a
//   segment of sw elements (sw the power of two >= M, at most 1024, nl sw
//   = 1024, so short lines pack several to a block) and their halos in
//   shared memory by cp.async, wrapped on the staging loads alone; each
//   thread computes four outputs, consecutive threads consecutive
//   elements;
// - along y (line_stride 1): consecutive threads take consecutive lines,
//   so each load is a coalesced row of the field, and each thread marches
//   along m over a chunk of mc elements holding its left + right + 1
//   window in registers (a compile-time window of at most kMaxMarch), one
//   new load a step: each input is read from device memory about once, the
//   window's halo once a chunk;
// - direct: one thread an element, each index wrapped on its own (halos
//   too wide for shared memory along x, windows wider than kMaxMarch along
//   y).
//
// A launch computes the lines [line0, line1) (the whole stack is [0, B)):
// lines never couple, so the entry point offsets the pointers by line0
// line strides and runs the kernel on line1 - line0 lines.  A streamed
// apply (repro_torch/launch/stream.py) issues one launch per line chunk;
// every element is computed by the same code from the same inputs whatever
// the chunk.  The blocks share grid.x (up to 2^31 - 1).
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int NT = 256;         // threads a block along x and direct
constexpr int RX = 4;           // outputs a thread along x
constexpr int PER = NT * RX;    // outputs a block along x: nl lines of sw
constexpr int NTY = 128;        // threads (lines) a block along y
constexpr int kMaxMarch = 9;    // kernels/stencil1d_batch.py:MAX_MARCH

template <typename T>
__device__ __forceinline__ T np_value(const T* __restrict__ out_init,
                                      long long idx) {
  return out_init != nullptr ? out_init[idx] : T(0);
}

// Along x: block bm + nbm bl of grid.x computes the elements [bm sw,
// bm sw + sw) of the lines [bl nl, bl nl + nl); contiguous lines of M.
template <typename T, typename P, bool PERIODIC, bool NEAR>
__global__ void __launch_bounds__(NT) batch_x_kernel(
    const T* __restrict__ data, const T* __restrict__ coeffs,
    const T* __restrict__ out_init, T* __restrict__ out, int B, int M,
    int lf, int rt, int sw_log2, const __grid_constant__ Taps taps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int sw = 1 << sw_log2, nl = PER >> sw_log2, sx = lf + rt + 1;
  const int W = sw + lf + rt;  // a staged line's stride
  const int nbm = (M + sw - 1) >> sw_log2;
  const int m0 = (blockIdx.x % nbm) << sw_log2, l0 = blockIdx.x / nbm * nl;
  const int vm = min(sw, M - m0), vl = min(nl, B - l0);
  const int cols = vm + lf + rt;
  const int t = threadIdx.x;
  const int tl = min(sw_log2, 8);  // log2 of the threads a staged line
  for (int l = t >> tl; l < vl; l += NT >> tl) {
    const T* src = data + static_cast<size_t>(l0 + l) * M;
    for (int c = t & ((1 << tl) - 1); c < cols; c += 1 << tl)
      elem_load(tile + l * W + c, src + wrap<NEAR>(m0 - lf + c, M));
  }
  elem_commit();
  elem_wait<0>();
  __syncthreads();
  int off[RX];
#pragma unroll
  for (int rr = 0; rr < RX; ++rr) {
    const int p = t + rr * NT;
    off[rr] = (p >> sw_log2) * W + (p & (sw - 1));
  }
  auto get = [&](int, int, int b, int rr) { return tile[off[rr] + b]; };
  T res[RX];
  point_values<T, P, RX>(res, get, taps, coeffs, sx, 1, sx);
#pragma unroll
  for (int rr = 0; rr < RX; ++rr) {
    const int p = t + rr * NT;
    const int l = p >> sw_log2, m = m0 + (p & (sw - 1));
    if (l >= vl || m >= m0 + vm) continue;
    const long long idx = static_cast<long long>(l0 + l) * M + m;
    out[idx] = !PERIODIC && (m < lf || m >= M - rt) ? np_value(out_init, idx)
                                                    : res[rr];
  }
}

// Along y: block bb + nbb c of grid.x; thread x of it takes line bb NTY +
// x (line_stride 1) over the elements [c mc, c mc + mc), element m at
// m * es.  The window of NW = lf + rt + 1 values sits in registers.
template <typename T, typename P, int NW>
__global__ void __launch_bounds__(NTY) batch_y_kernel(
    const T* __restrict__ data, const T* __restrict__ coeffs,
    const T* __restrict__ out_init, T* __restrict__ out, int B, int M,
    long long es, int lf, int rt, int mc, bool periodic,
    const __grid_constant__ Taps taps) {
  const int nbb = (B + NTY - 1) / NTY;
  const int b = blockIdx.x % nbb * NTY + threadIdx.x;
  if (b >= B) return;
  const int m0 = blockIdx.x / nbb * mc, m1 = min(m0 + mc, M);
  // the weights by window: the taps (in window order; zero and off where
  // a window has none), or every window's coefficient (the dense path)
  T wk[NW];
  bool on[NW];
  if constexpr (!P::kGeneral) {
    int t = 0;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      if (taps.n < 0) {
        wk[k] = __ldg(coeffs + k);
        on[k] = true;
      } else {
        on[k] = t < taps.n && taps.b[t] == k;
        wk[k] = on[k] ? static_cast<T>(taps.w[t]) : T(0);
        t += on[k];
      }
    }
  }
  const T* line = data + b;
  T win[NW];
#pragma unroll
  for (int k = 0; k < NW - 1; ++k)
    win[k] = __ldg(line + wrap_index(m0 - lf + k, M) * es);
  int q = wrap_index(m0 + rt, M);  // the element entering the window
#pragma unroll 4
  for (int m = m0; m < m1; ++m) {
    win[NW - 1] = __ldg(line + q * es);
    if (++q == M) q = 0;
    T v;
    if constexpr (P::kGeneral) {
      v = P::apply(win, coeffs);
    } else {
      v = T(0);
      bool started = false;
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        if (on[k]) {
          const T term = P::term(wk[k], win[k]);
          v = started ? v + term : term;
          started = true;
        }
      }
    }
    const long long idx = b + m * es;
    out[idx] = !periodic && (m < lf || m >= M - rt) ? np_value(out_init, idx)
                                                    : v;
#pragma unroll
    for (int k = 0; k < NW - 1; ++k) win[k] = win[k + 1];
  }
}

// Direct: one thread an element.  Threads along x of a block walk whichever
// axis is contiguous in memory (the elements when elem_stride is 1, the
// lines when line_stride is 1), so every tap's load is coalesced; the
// second grid axis loops, so any number of lines fits.
template <typename T, typename P, bool PERIODIC>
__global__ void __launch_bounds__(NT) batch_direct_kernel(
    const T* __restrict__ data, const T* __restrict__ coeffs,
    const T* __restrict__ out_init, T* __restrict__ out, int B, int M,
    long long line_stride, long long elem_stride, int lf, int rt,
    bool lines_fast, const __grid_constant__ Taps taps) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;  // contiguous axis
  const int n_u = lines_fast ? B : M;
  const int n_v = lines_fast ? M : B;
  if (u >= n_u) return;
  const int sx = lf + rt + 1;
  for (int v = blockIdx.y * blockDim.y + threadIdx.y; v < n_v;
       v += gridDim.y * blockDim.y) {
    const int b = lines_fast ? u : v;
    const int m = lines_fast ? v : u;
    const T* line = data + b * line_stride;
    const long long idx = b * line_stride + m * elem_stride;
    if (!PERIODIC && (m < lf || m >= M - rt)) {
      out[idx] = np_value(out_init, idx);
      continue;
    }
    auto get = [&](int, int, int k, int) {
      int mm = m - lf + k;
      if (PERIODIC) mm = wrap_index(mm, M);
      return __ldg(line + mm * elem_stride);
    };
    T res[1];
    point_values<T, P, 1>(res, get, taps, coeffs, sx, 1, sx);
    out[idx] = res[0];
  }
}

// f(std::integral_constant<int, NW>) for the window count nw in
// [NW, kMaxMarch]; cudaErrorInvalidValue past it.
template <int NW, typename F>
int with_window(int nw, F&& f) {
  if constexpr (NW > kMaxMarch) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (nw == NW) return f(std::integral_constant<int, NW>{});
    return with_window<NW + 1>(nw, f);
  }
}

template <typename T, typename P>
int launch(int periodic, const void* data, const void* coeffs,
           const void* out_init, void* out, int B, int M,
           long long line_stride, long long elem_stride, int lf, int rt,
           int route, int param, int smem, const Taps& taps,
           cudaStream_t stream) {
  const int nw = lf + rt + 1;
  if constexpr (P::kGeneral) {
    if (P::kWindows != nw) return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* d = static_cast<const T*>(data);
  const T* c = static_cast<const T*>(coeffs);
  const T* init = static_cast<const T*>(out_init);
  T* o = static_cast<T*>(out);
  if (route == 1) {  // along x, sw = 2^param
    if (elem_stride != 1 || line_stride != M || param < 0 || param > 10)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(((M + (1 << param) - 1) >> param) *
                    ((B + (PER >> param) - 1) / (PER >> param)));
    const bool near = lf <= M && rt <= M;
    auto go = [&](auto kernel, int* smem_set) {
      cudaError_t e = allow_smem(kernel, smem, smem_set);
      if (e != cudaSuccess) return static_cast<int>(e);
      kernel<<<grid, NT, smem, stream>>>(d, c, init, o, B, M, lf, rt, param,
                                         taps);
      return static_cast<int>(cudaGetLastError());
    };
    static int set[4] = {0, 0, 0, 0};
    if (periodic)
      return near ? go(batch_x_kernel<T, P, true, true>, set)
                  : go(batch_x_kernel<T, P, true, false>, set + 1);
    return near ? go(batch_x_kernel<T, P, false, true>, set + 2)
                : go(batch_x_kernel<T, P, false, false>, set + 3);
  }
  if (route == 2) {  // along y, mc = param
    if (line_stride != 1 || param < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((B + NTY - 1) / NTY * ((M + param - 1) / param));
    auto go = [&](auto w) {
      batch_y_kernel<T, P, decltype(w)::value><<<grid, NTY, 0, stream>>>(
          d, c, init, o, B, M, elem_stride, lf, rt, param, periodic != 0,
          taps);
      return static_cast<int>(cudaGetLastError());
    };
    if constexpr (P::kGeneral)
      return go(std::integral_constant<int, P::kWindows>{});
    else
      return with_window<1>(nw, go);
  }
  const bool lines_fast = line_stride == 1 && elem_stride != 1;
  const int n_u = lines_fast ? B : M;
  const int n_v = lines_fast ? M : B;
  const dim3 block(32, 8);
  const int blocks_v = (n_v + block.y - 1) / block.y;
  const dim3 grid((n_u + block.x - 1) / block.x,
                  blocks_v < 65535 ? blocks_v : 65535);
  if (periodic)
    batch_direct_kernel<T, P, true><<<grid, block, 0, stream>>>(
        d, c, init, o, B, M, line_stride, elem_stride, lf, rt, lines_fast,
        taps);
  else
    batch_direct_kernel<T, P, false><<<grid, block, 0, stream>>>(
        d, c, init, o, B, M, line_stride, elem_stride, lf, rt, lines_fast,
        taps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64.  point_fn: 0 weighted, 1 cube (C^3 - C),
// 2 the user's (in a user build, whose NWIN must be the window count).
// periodic: 1 periodic, 0 np.  out_init may be null (np zeros).  Strides
// in elements; out and out_init share data's.  Computes the lines
// [line0, line1), 0 <= line0 < line1 <= B.  route: 0 direct; 1 along x
// (strides (M, 1)), param = log2 of the segment, smem its block's dynamic
// shared memory in bytes; 2 along y (line stride 1), param = elements a
// chunk.  The taps (n, then the window coordinates (0, 0, k) and the
// weights of n taps, n <= 32) may be null: every window, weights from
// coeffs.
RT_EXPORT int stencil1d_batch(int dtype, int point_fn, int periodic,
                              void* data, void* coeffs, void* out_init,
                              void* out, int B, int M, long long line_stride,
                              long long elem_stride, int line0, int line1,
                              int left, int right, int route, int param,
                              int smem, const int* tap_n, const int* tap_cab,
                              const double* tap_w, void* stream) {
  Taps taps;
  if (line0 < 0 || line1 > B || line0 >= line1 || route < 0 || route > 2 ||
      smem < 0 || !read_taps(tap_n, tap_cab, tap_w, &taps))
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
                                   line_stride, elem_stride, left, right,
                                   route, param, smem, taps, s)
               : launch<float, P>(periodic, d, coeffs, init, o, nb, M,
                                  line_stride, elem_stride, left, right,
                                  route, param, smem, taps, s);
  });
}
