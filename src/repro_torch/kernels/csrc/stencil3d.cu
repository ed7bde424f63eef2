// 3D box stencil on an (nz, ny, nx) field: the paper's section VI.A
// extension.
//
// Replaces the TPU kernel repro/kernels/stencil3d.py:stencil3d_pallas
// (body _kernel).  Halos (front, back) along z, (top, bottom) along y,
// (left, right) along x; bc periodic wraps every index, bc np computes the
// interior (fr <= k < nz-bk, tp <= j < ny-bt, lf <= i < nx-rt) and copies
// the other cells from out_init (zero when it is null).  Weighted or
// function-pointer mode through the device point functions of common.cuh.
// Windows are enumerated z-major, then row-major over (y, x), as in
// repro/kernels/ref.py:stencil3d_ref; the coefficient of window (c, a, b)
// is coeffs[(c * sy + a) * sx + b].
//
// The TPU kernel tiles (z, y) with 3x3 neighbour tiles and carries full x
// rows so the x halo is an in-VMEM roll; that shape comes from the TPU's
// sequential grid and large VMEM.  Here blocks run in parallel and in no
// order, so each thread owns one output point, wraps or masks its own
// indices (any extent, no tile rule, no padding), and a warp covers 32
// consecutive x so every tap's load is coalesced.
//
// What bounds it on the card: device-memory bandwidth (each input read
// once, each output written once; 2 flops per tap).  Every tap is loaded,
// zero weights included (the 7-point Laplacian is a 27-tap box, as in the
// reference), and the re-reads of neighbouring planes are served from
// L1/L2; staging a halo tile in shared memory is left to a later pass.
#include "common.cuh"

namespace {

template <typename T, typename P, bool PERIODIC>
__global__ void __launch_bounds__(256) stencil3d_kernel(
    const T* __restrict__ data, const T* __restrict__ coeffs,
    const T* __restrict__ out_init, T* __restrict__ out, int nz, int ny,
    int nx, int fr, int bk, int tp, int bt, int lf, int rt) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int j = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int sz = fr + bk + 1, sy = tp + bt + 1, sx = lf + rt + 1;
  for (int k = blockIdx.z; k < nz; k += gridDim.z) {
    const size_t idx = (static_cast<size_t>(k) * ny + j) * nx + i;
    if (!PERIODIC && (i < lf || i >= nx - rt || j < tp || j >= ny - bt ||
                      k < fr || k >= nz - bk)) {
      out[idx] = out_init != nullptr ? out_init[idx] : T(0);
      continue;
    }
    T acc = T(0);
    for (int c = 0; c < sz; ++c) {
      int kk = k - fr + c;
      if (PERIODIC) kk = wrap_index(kk, nz);
      for (int a = 0; a < sy; ++a) {
        int jj = j - tp + a;
        if (PERIODIC) jj = wrap_index(jj, ny);
        const T* row = data + (static_cast<size_t>(kk) * ny + jj) * nx;
        const T* w = coeffs + (c * sy + a) * sx;
        for (int b = 0; b < sx; ++b) {
          int ii = i - lf + b;
          if (PERIODIC) ii = wrap_index(ii, nx);
          const T t = P::term(__ldg(w + b), __ldg(row + ii));
          acc = (c == 0 && a == 0 && b == 0) ? t : acc + t;
        }
      }
    }
    out[idx] = acc;
  }
}

template <typename T, typename P>
int launch(int periodic, const void* data, const void* coeffs,
           const void* out_init, void* out, int nz, int ny, int nx, int fr,
           int bk, int tp, int bt, int lf, int rt, cudaStream_t stream) {
  const dim3 block(32, 8);
  const dim3 grid((nx + block.x - 1) / block.x, (ny + block.y - 1) / block.y,
                  nz < 65535 ? nz : 65535);
  const T* d = static_cast<const T*>(data);
  const T* c = static_cast<const T*>(coeffs);
  const T* init = static_cast<const T*>(out_init);
  T* o = static_cast<T*>(out);
  if (periodic)
    stencil3d_kernel<T, P, true><<<grid, block, 0, stream>>>(
        d, c, init, o, nz, ny, nx, fr, bk, tp, bt, lf, rt);
  else
    stencil3d_kernel<T, P, false><<<grid, block, 0, stream>>>(
        d, c, init, o, nz, ny, nx, fr, bk, tp, bt, lf, rt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64.  point_fn: 0 weighted, 1 cube (C^3 - C).
// periodic: 1 periodic, 0 np.  out_init may be null (np zeros).
RT_EXPORT int stencil3d(int dtype, int point_fn, int periodic, void* data,
                        void* coeffs, void* out_init, void* out, int nz,
                        int ny, int nx, int fr, int bk, int tp, int bt,
                        int lf, int rt, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_point_fn(point_fn, [&](auto p) {
    using P = decltype(p);
    return dtype == 1
               ? launch<double, P>(periodic, data, coeffs, out_init, out, nz,
                                   ny, nx, fr, bk, tp, bt, lf, rt, s)
               : launch<float, P>(periodic, data, coeffs, out_init, out, nz,
                                  ny, nx, fr, bk, tp, bt, lf, rt, s);
  });
}
