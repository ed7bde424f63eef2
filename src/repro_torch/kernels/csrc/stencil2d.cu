// Generic 2D stencil: the cuSten compute kernel.
//
// Replaces the TPU kernel repro/kernels/stencil2d.py:stencil2d_pallas
// (body _stencil_kernel).  Halos (left, right, top, bottom); bc periodic
// (wrapped indices) or np (interior cells computed, the others copied from
// out_init, or zero when it is null); weighted mode or function-pointer
// mode.  The TPU's Python point_fn, traced into the kernel body, becomes
// a compile-time device point function of common.cuh, which is cuSten's
// own function-pointer design: WeightedPoint or CubePoint (a sum of
// per-window terms), or a user's point_fn given as CUDA source, built into
// a copy of this library (the general path: the NWIN windows gathered into
// registers, then point_fn(w, coeffs)).
// Windows are enumerated row-major from the top-left of the stencil; the
// coefficient of window (a, b) is coeffs[a * (left + right + 1) + b].
//
// Three ways to evaluate a point (common.cuh:point_values): the Create-time
// taps of a weighted or cube plan (kernels/taps.py:nonzero_taps, at most
// kMaxTaps, passed by value as a __grid_constant__ parameter), summed in
// the reference's window order (skipping an exact-zero term changes no
// finite result, only the sign of an all-zero sum: the 5x5 biharmonic is 13
// taps, not 25); every window with its coefficient from device memory (a
// plan with more non-zero taps); or a user's point function.
//
// What bounds it on the card: device-memory bandwidth (each input read
// once, each output written once; 2 flops a tap).  The first design ran one
// thread a point, each tap wrapping its two indices by a modulo and loading
// its coefficient, zero ones included: about 2.4 us a window at 1024^2
// float64, 7x the byte bound for 15 windows.  Here (the tile route) a block
// of 32 x 8 threads owns a tile of 32 columns and TY = 32 rows and stages
// the tile and its halo, (TY + top + bottom) x (32 + left + right)
// elements, in shared memory by cp.async, wrapped by a compare and an add
// (a modulo only for a halo wider than its extent) on the staging loads
// alone; after one barrier each thread computes four outputs (rows
// ty + r 8), so a tap's parameters and its shared-memory address serve
// four points.  A column strip marching down a chunk of rows through a
// ring of row slots, so that a strip's y halo is read once, took 0.0119 ms
// for the 5x3 plan at 1024^2 float64 against the tile's 0.0084 (chip_ab.py;
// NVIDIA H100 80GB HBM3, 700.00 W): the ring's slot wrap costs a compare
// and a select a tap and output, and the halo rows the tile reads again
// come from L2.  When the tile does not fit in shared memory (very wide
// halos) the direct route computes one point a thread from device memory,
// each index wrapped on its own.  The route comes from
// kernels/stencil2d.py:stencil2d_geometry, which depends on the shape, the
// halos and the dtype alone.
//
// A launch computes the rows [row0, row1) of the output (the whole field
// is [0, ny)): a streamed apply (repro_torch/launch/stream.py) issues one
// launch per row chunk, each reading its halo rows from the whole field
// with the same wrap or mask, so every point is computed by the same code
// from the same inputs whatever the chunk.  The tiles share grid.x (up to
// 2^31 - 1 blocks), so any number of rows fits.
//
// A launch takes a stack of nb fields, (nb, ny, nx) contiguous: the
// counterpart of the reference's jax.vmap of Compute over a serving
// bucket (repro/serve/batching.py).  The member index is folded into
// grid.x above the tiles (block b * tiles + t, tiles = tiles a member), so
// the grid limit stays that of the tiles alone; member b reads and writes
// at offset b * ny * nx.  The tile geometry does not depend on nb, and
// every point of every member is computed by the template code that
// computes it in a single-field launch: a stacked launch equals nb single
// launches bit for bit.  A stack (nb > 1) runs the STACKED instantiation,
// which alone moves the three field pointers to the member: moved in
// every launch, they took the float64 3x3 cube kernel from 32 to 46
// registers and its 1024^2 launch from 0.0069 to 0.0080 ms on an H100,
// where the single-field instantiation runs at 0.0069.
#include "common.cuh"

#include <type_traits>

namespace {

constexpr int TX = 32;      // tile width: one warp along x
constexpr int BY = 8;       // thread rows of a block
constexpr int R = 4;        // outputs a thread, rows ty + r BY
constexpr int TY = R * BY;  // tile height

struct Field {
  int ny, nx, tp, bt, lf, rt;
  __device__ bool interior(int j, int i) const {
    return i >= lf && i < nx - rt && j >= tp && j < ny - bt;
  }
};

template <typename T, bool PERIODIC>
__device__ __forceinline__ void store(T* __restrict__ out,
                                      const T* __restrict__ out_init,
                                      const Field& g, int j, int i, T v) {
  const size_t idx = static_cast<size_t>(j) * g.nx + i;
  if (!PERIODIC && !g.interior(j, i))
    out[idx] = out_init != nullptr ? out_init[idx] : T(0);
  else
    out[idx] = v;
}

// The offset of the member of the stack that block blockIdx.x works on,
// and in *t the block's index among that member's `per` blocks.
__device__ __forceinline__ size_t member_offset(const Field& g, int per,
                                                int* t) {
  const int b = blockIdx.x / per;
  *t = blockIdx.x - b * per;
  return static_cast<size_t>(b) * g.ny * g.nx;
}

// Tile route: block b per + x + nbx y of grid.x, nbx = ceil(nx / TX), per
// = nbx ceil((row1 - row0) / TY), computes the tile [x TX, x TX + TX) x
// [row0 + y TY, row0 + y TY + TY) (clipped to row1) of member b; blockDim
// (TX, BY).
template <typename T, typename P, bool PERIODIC, bool NEAR, bool STACKED>
__global__ void __launch_bounds__(TX * BY) stencil2d_tile_kernel(
    const T* __restrict__ data, const T* __restrict__ coeffs,
    const T* __restrict__ out_init, T* __restrict__ out, const Field g,
    int row0, int row1, int per, const __grid_constant__ Taps taps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);
  const int sy = g.tp + g.bt + 1, sx = g.lf + g.rt + 1;
  const int W = TX + g.lf + g.rt;  // the tile's row stride
  const int nbx = (g.nx + TX - 1) / TX;
  int t = blockIdx.x;
  if constexpr (STACKED) {
    const size_t off = member_offset(g, per, &t);
    data += off;
    out += off;
    if (out_init != nullptr) out_init += off;
  }
  const int i0 = t % nbx * TX, j0 = row0 + t / nbx * TY;
  const int vx = min(TX, g.nx - i0), vy = min(TY, row1 - j0);
  const int rows = vy + g.tp + g.bt, cols = vx + g.lf + g.rt;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int r = ty; r < rows; r += BY) {
    const T* row =
        data + static_cast<size_t>(wrap<NEAR>(j0 - g.tp + r, g.ny)) * g.nx;
    for (int c = tx; c < cols; c += TX)
      elem_load(tile + r * W + c, row + wrap<NEAR>(i0 - g.lf + c, g.nx));
  }
  elem_commit();
  elem_wait<0>();
  __syncthreads();
  if (tx >= vx) return;
  const T* base = tile + ty * W + tx;
  auto get = [&](int, int a, int b, int rr) {
    return base[(a + rr * BY) * W + b];
  };
  T res[R];
  point_values<T, P, R>(res, get, taps, coeffs, sy * sx, sy, sx);
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    if (ty + rr * BY >= vy) break;
    store<T, PERIODIC>(out, out_init, g, j0 + ty + rr * BY, i0 + tx, res[rr]);
  }
}

// Direct route: one point a thread, its windows read from device memory
// with each index wrapped on its own; blockDim (TX, BY), block b per + x +
// nbx y of grid.x, per = nbx ceil((row1 - row0) / BY).
template <typename T, typename P, bool PERIODIC, bool STACKED>
__global__ void __launch_bounds__(TX * BY) stencil2d_direct_kernel(
    const T* __restrict__ data, const T* __restrict__ coeffs,
    const T* __restrict__ out_init, T* __restrict__ out, const Field g,
    int row0, int row1, int per, const __grid_constant__ Taps taps) {
  const int nbx = (g.nx + TX - 1) / TX;
  int t = blockIdx.x;
  if constexpr (STACKED) {
    const size_t off = member_offset(g, per, &t);
    data += off;
    out += off;
    if (out_init != nullptr) out_init += off;
  }
  const int i = t % nbx * TX + threadIdx.x;
  const int j = row0 + t / nbx * BY + threadIdx.y;
  if (i >= g.nx || j >= row1) return;
  if (!PERIODIC && !g.interior(j, i)) {
    store<T, PERIODIC>(out, out_init, g, j, i, T(0));
    return;
  }
  const int sy = g.tp + g.bt + 1, sx = g.lf + g.rt + 1;
  auto get = [&](int, int a, int b, int) {
    int jj = j - g.tp + a, ii = i - g.lf + b;
    if (PERIODIC) {
      jj = wrap_index(jj, g.ny);
      ii = wrap_index(ii, g.nx);
    }
    return __ldg(data + static_cast<size_t>(jj) * g.nx + ii);
  };
  T res[1];
  point_values<T, P, 1>(res, get, taps, coeffs, sy * sx, sy, sx);
  store<T, PERIODIC>(out, out_init, g, j, i, res[0]);
}

template <typename T, typename P>
int launch(int periodic, const void* data, const void* coeffs,
           const void* out_init, void* out, int nb, const Field& g, int row0,
           int row1, int smem, const Taps& taps, cudaStream_t stream) {
  if constexpr (P::kGeneral) {
    if (P::kWindows != (g.lf + g.rt + 1) * (g.tp + g.bt + 1))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* d = static_cast<const T*>(data);
  const T* c = static_cast<const T*>(coeffs);
  const T* init = static_cast<const T*>(out_init);
  T* o = static_cast<T*>(out);
  const dim3 block(TX, BY);
  const int nbx = (g.nx + TX - 1) / TX;
  // blocks a member, and the grid: nb members of `per` blocks in grid.x
  const long long per =
      static_cast<long long>(nbx) * ((row1 - row0 + (smem ? TY : BY) - 1) /
                                     (smem ? TY : BY));
  if (per * nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(per * nb));
  const int p = static_cast<int>(per);
  auto run = [&](auto stacked) {
    constexpr bool S = decltype(stacked)::value;
    if (smem == 0) {  // the direct route
      if (periodic)
        stencil2d_direct_kernel<T, P, true, S>
            <<<grid, block, 0, stream>>>(d, c, init, o, g, row0, row1, p, taps);
      else
        stencil2d_direct_kernel<T, P, false, S>
            <<<grid, block, 0, stream>>>(d, c, init, o, g, row0, row1, p, taps);
      return static_cast<int>(cudaGetLastError());
    }
    const bool near =
        g.tp <= g.ny && g.bt <= g.ny && g.lf <= g.nx && g.rt <= g.nx;
    auto go = [&](auto kernel, int* smem_set) {
      cudaError_t e = allow_smem(kernel, smem, smem_set);
      if (e != cudaSuccess) return static_cast<int>(e);
      kernel<<<grid, block, smem, stream>>>(d, c, init, o, g, row0, row1, p,
                                            taps);
      return static_cast<int>(cudaGetLastError());
    };
    static int set[4] = {0, 0, 0, 0};
    if (periodic)
      return near ? go(stencil2d_tile_kernel<T, P, true, true, S>, set)
                  : go(stencil2d_tile_kernel<T, P, true, false, S>, set + 1);
    return near ? go(stencil2d_tile_kernel<T, P, false, true, S>, set + 2)
                : go(stencil2d_tile_kernel<T, P, false, false, S>, set + 3);
  };
  return nb > 1 ? run(std::true_type{}) : run(std::false_type{});
}

}  // namespace

// dtype: 0 float32, 1 float64.  point_fn: 0 weighted, 1 cube (C^3 - C),
// 2 the user's (in a user build, whose NWIN must be the window count).
// periodic: 1 periodic, 0 np.  out_init may be null (np zeros).  data,
// out_init and out hold nb >= 1 fields of (ny, nx), contiguous; computes
// the output rows [row0, row1) of each, 0 <= row0 < row1 <= ny.  smem: the tile
// route's dynamic shared memory in bytes, 0 for the direct route.  The
// taps (n, then the window coordinates c = 0, a, b and the weights of n
// taps, n <= 32) may be null: every window, weights from coeffs.
RT_EXPORT int stencil2d(int dtype, int point_fn, int periodic, void* data,
                        void* coeffs, void* out_init, void* out, int nb,
                        int ny, int nx, int row0, int row1, int left,
                        int right, int top, int bottom, int smem,
                        const int* tap_n, const int* tap_cab,
                        const double* tap_w, void* stream) {
  Taps taps;
  if (nb < 1 || row0 < 0 || row1 > ny || row0 >= row1 || smem < 0 ||
      !read_taps(tap_n, tap_cab, tap_w, &taps))
    return static_cast<int>(cudaErrorInvalidValue);
  const Field g{ny, nx, top, bottom, left, right};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_point_fn(point_fn, [&](auto p) {
    using P = decltype(p);
    return dtype == 1 ? launch<double, P>(periodic, data, coeffs, out_init,
                                          out, nb, g, row0, row1, smem, taps,
                                          s)
                      : launch<float, P>(periodic, data, coeffs, out_init,
                                         out, nb, g, row0, row1, smem, taps,
                                         s);
  });
}
