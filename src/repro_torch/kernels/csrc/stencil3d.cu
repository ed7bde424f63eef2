// 3D box stencil on an (nz, ny, nx) field: the paper's section VI.A
// extension.
//
// Replaces the TPU kernel repro/kernels/stencil3d.py:stencil3d_pallas
// (body _kernel).  Halos (front, back) along z, (top, bottom) along y,
// (left, right) along x; bc periodic wraps every index, bc np computes the
// interior (fr <= k < nz-bk, tp <= j < ny-bt, lf <= i < nx-rt) and copies
// the other cells from out_init (zero when it is null).  Windows are
// enumerated z-major, then row-major over (y, x), as in
// repro/kernels/ref.py:stencil3d_ref; the coefficient of window (c, a, b)
// is coeffs[(c * sy + a) * sx + b].
//
// Three ways to evaluate a point, one device function
// (common.cuh:point_values):
// - taps: a weighted or cube plan reduced at Create to its non-zero taps
//   (kernels/taps.py:nonzero_taps), at most kMaxTaps, passed by value
//   as a kernel parameter (read through the constant cache).  The terms
//   are summed in the reference's window order; skipping an exact-zero
//   term changes no finite result but the sign of an all-zero sum.  The
//   7-point Laplacian is 7 taps, not the 27 of its box.
// - dense: a weighted or cube plan with more non-zero taps, every window
//   with its coefficient from device memory.
// - general: a user's point function (common.cuh UserPoint), the NWIN
//   windows gathered into registers.
//
// What bounds it on the card: device-memory bandwidth (each input read
// once, each output written once; 2 flops a tap).  The TPU kernel tiles
// (z, y) with 3x3 neighbour tiles and full x rows; here (the tile route) a
// block owns a 32 x 32 (x, y) tile and marches along z over a chunk of zc
// planes (2.5D blocking).  The planes k - fr .. k + bk of its tile and halo
// sit in a ring of fr + bk + 3 shared-memory slots, filled two planes
// ahead by cp.async, so each input element is read from device memory
// about once (its x and y halo by the neighbouring blocks, mostly from L2).
// 256 threads, each four outputs of a plane (rows ty + r 8), so a tap's
// parameters and address serve four points: at 256^3 float64, two rows a
// thread (a 32 x 16 tile) took 0.155 ms and four 0.121, one plane ahead
// 2% longer than two, eight rows 0.130 (chip_ab.py; NVIDIA H100 80GB HBM3,
// 700.00 W).
// Periodic indices wrap by a compare and an add on the halo alone (NEAR:
// every halo no wider than its extent); a halo wider than its extent takes
// the modulo.  When the ring does not fit in shared memory (very wide
// halos) the direct route computes one point a thread from device memory,
// each index wrapped on its own, as the first design did.  The geometry
// (route, zc, grid) comes from kernels/stencil3d.py:stencil3d_geometry.
//
// A launch computes the planes [k0, k1) of the output (the whole field is
// [0, nz)): a streamed apply (repro_torch/launch/stream.py) issues one
// launch per z-slab, each reading its halo planes from the whole field
// with the same wrap, and for bc np testing the interior with the global
// k, so no padded slab is copied (the reference pads one, _pad_field_3d).
// The route and the point code depend on the shape, the halos and the
// dtype alone; only zc and the grid follow the slab's depth, so every
// point is computed by the same code from the same inputs whatever the
// slab.
#include "common.cuh"

namespace {

constexpr int TX = 32;      // tile width: one warp along x
constexpr int BY = 8;       // thread rows of a block
constexpr int R = 4;        // outputs a thread, rows ty + r BY
constexpr int TY = R * BY;  // tile height
constexpr int kAhead = 2;  // planes loaded ahead of the one computed

struct Box {
  int nz, ny, nx, fr, bk, tp, bt, lf, rt;
  __device__ bool interior(int k, int j, int i) const {
    return i >= lf && i < nx - rt && j >= tp && j < ny - bt && k >= fr &&
           k < nz - bk;
  }
};

// Tile route: block (x + nbx y, z), nbx = ceil(nx / TX), computes the tile
// [x TX, x TX + TX) x [y TY, y TY + TY) of the planes [kb + z zc,
// kb + z zc + zc) (clipped to ke);
// blockDim (TX, BY).  The (x, y) tiles share grid.x, whose limit is 2^31 -
// 1 blocks, not grid.y's 65535.
template <typename T, typename P, bool PERIODIC, bool NEAR>
__global__ void __launch_bounds__(TX * BY) stencil3d_tile_kernel(
    const T* __restrict__ data, const T* __restrict__ coeffs,
    const T* __restrict__ out_init, T* __restrict__ out, const Box g, int kb,
    int ke, int zc, const __grid_constant__ Taps taps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);
  const int sz = g.fr + g.bk + 1, sy = g.tp + g.bt + 1, sx = g.lf + g.rt + 1;
  const int depth = sz + kAhead;
  const int W = TX + g.lf + g.rt;  // a slot's row stride
  const int plane = W * (TY + g.tp + g.bt);
  const int nbx = (g.nx + TX - 1) / TX;
  const int i0 = blockIdx.x % nbx * TX, j0 = blockIdx.x / nbx * TY;
  const int k0 = kb + blockIdx.y * zc, k1 = min(k0 + zc, ke);
  const int vx = min(TX, g.nx - i0), vy = min(TY, g.ny - j0);
  const int rows = vy + g.tp + g.bt, cols = vx + g.lf + g.rt;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const size_t nxy = static_cast<size_t>(g.ny) * g.nx;

  // copy plane q (in [k0 - fr, k1 + bk)) of the tile and its halo into
  // its slot, (q - k0 + fr) mod depth
  auto issue = [&](int q) {
    T* dst = ring + (q - k0 + g.fr) % depth * plane;
    const T* src = data + wrap<NEAR>(q, g.nz) * nxy;
    for (int r = ty; r < rows; r += BY) {
      const int jj = wrap<NEAR>(j0 - g.tp + r, g.ny);
      const T* row = src + static_cast<size_t>(jj) * g.nx;
      for (int c = tx; c < cols; c += TX)
        elem_load(dst + r * W + c, row + wrap<NEAR>(i0 - g.lf + c, g.nx));
    }
  };
  for (int q = k0 - g.fr; q <= k0 + g.bk; ++q) issue(q);
  elem_commit();
  for (int a = 1; a <= kAhead; ++a) {
    if (k0 + a < k1) issue(k0 + g.bk + a);
    elem_commit();
  }

  for (int k = k0; k < k1; ++k) {
    elem_wait<kAhead>();  // the planes up to k + bk have landed (this
    __syncthreads();      // thread's), and every thread's
    if (tx < vx && ty < vy) {
      const int s0 = (k - k0) % depth;  // the slot of plane k - fr
      const T* base = ring + ty * W + tx;
      auto get = [&](int c, int a, int b, int rr) {
        int s = s0 + c;
        if (s >= depth) s -= depth;
        return base[s * plane + (a + rr * BY) * W + b];
      };
      T res[R];
      point_values<T, P, R>(res, get, taps, coeffs, sz * sy * sx, sy, sx);
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const int j = j0 + ty + rr * BY, i = i0 + tx;
        if (ty + rr * BY >= vy) break;
        const size_t idx = k * nxy + static_cast<size_t>(j) * g.nx + i;
        if (!PERIODIC && !g.interior(k, j, i))
          out[idx] = out_init != nullptr ? out_init[idx] : T(0);
        else
          out[idx] = res[rr];
      }
    }
    __syncthreads();  // the slot of plane k - fr is read out
    if (k + kAhead + 1 < k1) issue(k + g.bk + kAhead + 1);
    elem_commit();
  }
}

// Direct route: one point a thread, its windows read from device memory
// with each index wrapped on its own; blockDim (TX, BY), block x + nbx y
// of grid.x, the planes [kb, ke) in a loop over grid.y.
template <typename T, typename P, bool PERIODIC>
__global__ void __launch_bounds__(TX * BY) stencil3d_direct_kernel(
    const T* __restrict__ data, const T* __restrict__ coeffs,
    const T* __restrict__ out_init, T* __restrict__ out, const Box g, int kb,
    int ke, const __grid_constant__ Taps taps) {
  const int nbx = (g.nx + TX - 1) / TX;
  const int i = blockIdx.x % nbx * TX + threadIdx.x;
  const int j = blockIdx.x / nbx * BY + threadIdx.y;
  if (i >= g.nx || j >= g.ny) return;
  const int sz = g.fr + g.bk + 1, sy = g.tp + g.bt + 1, sx = g.lf + g.rt + 1;
  for (int k = kb + blockIdx.y; k < ke; k += gridDim.y) {
    const size_t idx = (static_cast<size_t>(k) * g.ny + j) * g.nx + i;
    if (!PERIODIC && !g.interior(k, j, i)) {
      out[idx] = out_init != nullptr ? out_init[idx] : T(0);
      continue;
    }
    auto get = [&](int c, int a, int b, int) {
      int kk = k - g.fr + c, jj = j - g.tp + a, ii = i - g.lf + b;
      if (PERIODIC) {
        kk = wrap_index(kk, g.nz);
        jj = wrap_index(jj, g.ny);
        ii = wrap_index(ii, g.nx);
      }
      return __ldg(data + (static_cast<size_t>(kk) * g.ny + jj) * g.nx + ii);
    };
    T res[1];
    point_values<T, P, 1>(res, get, taps, coeffs, sz * sy * sx, sy, sx);
    out[idx] = res[0];
  }
}

template <typename T, typename P>
int launch(int periodic, const void* data, const void* coeffs,
           const void* out_init, void* out, const Box& g, int kb, int ke,
           int zc, int smem, const Taps& taps, cudaStream_t stream) {
  if constexpr (P::kGeneral) {
    if (P::kWindows !=
        (g.fr + g.bk + 1) * (g.tp + g.bt + 1) * (g.lf + g.rt + 1))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const T* d = static_cast<const T*>(data);
  const T* c = static_cast<const T*>(coeffs);
  const T* init = static_cast<const T*>(out_init);
  T* o = static_cast<T*>(out);
  const dim3 block(TX, BY);
  if (zc == 0) {  // the direct route
    const int planes = ke - kb;
    const dim3 grid((g.nx + TX - 1) / TX * ((g.ny + BY - 1) / BY),
                    planes < 65535 ? planes : 65535);
    if (periodic)
      stencil3d_direct_kernel<T, P, true>
          <<<grid, block, 0, stream>>>(d, c, init, o, g, kb, ke, taps);
    else
      stencil3d_direct_kernel<T, P, false>
          <<<grid, block, 0, stream>>>(d, c, init, o, g, kb, ke, taps);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((g.nx + TX - 1) / TX * ((g.ny + TY - 1) / TY),
                  (ke - kb + zc - 1) / zc);
  const bool near = g.fr <= g.nz && g.bk <= g.nz && g.tp <= g.ny &&
                    g.bt <= g.ny && g.lf <= g.nx && g.rt <= g.nx;
  auto go = [&](auto kernel, int* smem_set) {
    cudaError_t e = allow_smem(kernel, smem, smem_set);
    if (e != cudaSuccess) return static_cast<int>(e);
    kernel<<<grid, block, smem, stream>>>(d, c, init, o, g, kb, ke, zc,
                                          taps);
    return static_cast<int>(cudaGetLastError());
  };
  static int set[4] = {0, 0, 0, 0};
  if (periodic)
    return near ? go(stencil3d_tile_kernel<T, P, true, true>, set)
                : go(stencil3d_tile_kernel<T, P, true, false>, set + 1);
  return near ? go(stencil3d_tile_kernel<T, P, false, true>, set + 2)
              : go(stencil3d_tile_kernel<T, P, false, false>, set + 3);
}

}  // namespace

// dtype: 0 float32, 1 float64.  point_fn: 0 weighted, 1 cube (C^3 - C),
// 2 the user's (in a user build, whose NWIN must be the window count).
// periodic: 1 periodic, 0 np.  out_init may be null (np zeros).  Computes
// the output planes [k0, k1), 0 <= k0 < k1 <= nz.  zc: planes a block on
// the tile route, 0 for the direct route; smem: the tile route's dynamic
// shared memory, bytes.  The taps (n, then the window
// coordinates c, a, b and the weights of n taps, n <= 32) may be null:
// every window, weights from coeffs.
RT_EXPORT int stencil3d(int dtype, int point_fn, int periodic, void* data,
                        void* coeffs, void* out_init, void* out, int nz,
                        int ny, int nx, int fr, int bk, int tp, int bt,
                        int lf, int rt, int k0, int k1, int zc, int smem,
                        const int* tap_n,
                        const int* tap_cab, const double* tap_w,
                        void* stream) {
  Taps taps;
  if (zc < 0 || k0 < 0 || k1 > nz || k0 >= k1 ||
      !read_taps(tap_n, tap_cab, tap_w, &taps))
    return static_cast<int>(cudaErrorInvalidValue);
  const Box g{nz, ny, nx, fr, bk, tp, bt, lf, rt};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_point_fn(point_fn, [&](auto p) {
    using P = decltype(p);
    return dtype == 1 ? launch<double, P>(periodic, data, coeffs, out_init,
                                          out, g, k0, k1, zc, smem, taps, s)
                      : launch<float, P>(periodic, data, coeffs, out_init,
                                         out, g, k0, k1, zc, smem, taps, s);
  });
}
