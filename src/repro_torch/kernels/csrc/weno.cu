// WENO5 upwind advection RHS: the paper's 2d_xyADVWENO_p variant.
//
// Replaces the TPU kernel repro/kernels/weno.py:weno5_advect_pallas (body
// _weno_kernel): the RHS of dq/dt = -(u q_x + v q_y) on a periodic (ny, nx)
// field with upwinded Hamilton–Jacobi WENO5 derivatives (halo 3), the
// velocities u and v as two extra operands.  The arithmetic is that of
// repro/kernels/ref.py:_weno5_phi, operation for operation: the
// differences as (a - b) / h, a_k = c_k / (eps + s_k)^2 and
// (a1 p1 + a2 p2 + a3 p3) / w, with true divisions.  nvcc contracts
// multiply-adds into FMAs, which moves an output by a few ulp.
//
// The TPU kernel assembles x- and y-bands from its left/right/up/down
// neighbour tiles and so needs tiles that divide the field and are at
// least 3 wide.  Here a block of 32 x 8 threads owns a 32 x 8 tile, one
// output per thread, and stages q for the tile plus a 3-wide strip on each
// side in x and in y in shared memory (no corners: the scheme is
// dimension by dimension).  Every index is wrapped on its own, so any
// extent works, including extents below 7 where a +-3 offset wraps more
// than half a line.  Offsets lie in [-3, n + 3), so for n >= 3 one compare
// and one add or subtract wraps them; only smaller extents take the
// general modulo (a template flag, so the common case carries none).
// u and v are read coalesced straight from device memory.
//
// jnp.where evaluates both one-sided derivatives; here each direction
// picks its five upwind differences first (u > 0: left-biased, else
// right-biased, so u == 0 takes the plus branch as in the reference) and
// evaluates _weno5_phi once: 2 phi a point instead of 4, the same value,
// and no divergence inside a warp whatever the velocity's sign.
//
// What bounds it on the card: by the data-sheet count, bytes (q, u, v
// read and the output written: 32 bytes a point in float64) against about
// 170 flops a point.  In float64 each point does 12 divisions by h and 13
// in each phi (3 weights, 1 normalisation, 9 by the constants 3 and 6),
// and each double division is a multi-instruction sequence on the FP64
// pipe, which is the likely real limit.
#include "common.cuh"

namespace {

constexpr int TX = 32;  // tile width: one warp along x, coalesced
constexpr int TY = 8;   // tile height
constexpr int H = 3;    // WENO5 halo

// Wrap an index in [-H, n + H) onto [0, n).
template <bool NEAR>
__device__ __forceinline__ int wrap3(int a, int n) {
  if (NEAR) return a < 0 ? a + n : (a >= n ? a - n : a);
  return wrap_index(a, n);
}

template <typename T>
__device__ __forceinline__ T sq(T x) {
  return x * x;
}

// repro/kernels/ref.py:_weno5_phi, in the reference's expression order.
template <typename T>
__device__ __forceinline__ T weno5_phi(T v1, T v2, T v3, T v4, T v5) {
  const T eps = T(1e-6);
  const T s1 = T(13.0 / 12.0) * sq(v1 - T(2) * v2 + v3) +
               T(0.25) * sq(v1 - T(4) * v2 + T(3) * v3);
  const T s2 =
      T(13.0 / 12.0) * sq(v2 - T(2) * v3 + v4) + T(0.25) * sq(v2 - v4);
  const T s3 = T(13.0 / 12.0) * sq(v3 - T(2) * v4 + v5) +
               T(0.25) * sq(T(3) * v3 - T(4) * v4 + v5);
  const T a1 = T(0.1) / sq(eps + s1);
  const T a2 = T(0.6) / sq(eps + s2);
  const T a3 = T(0.3) / sq(eps + s3);
  const T w = a1 + a2 + a3;
  const T p1 = v1 / T(3) - T(7) * v2 / T(6) + T(11) * v3 / T(6);
  const T p2 = -v2 / T(6) + T(5) * v3 / T(6) + v4 / T(3);
  const T p3 = v3 / T(3) + T(5) * v4 / T(6) - v5 / T(6);
  return (a1 * p1 + a2 * p2 + a3 * p3) / w;
}

// The upwind derivative from the six differences d[k] = (q_{i+k-2} -
// q_{i+k-3}) / h, k = 0..5 (the reference's d[-3..2]): left-biased
// phi(d0..d4) when up is true, right-biased phi(d5, d4, d3, d2, d1) else.
template <typename T>
__device__ __forceinline__ T upwind(const T (&d)[6], bool up) {
  return weno5_phi(up ? d[0] : d[5], up ? d[1] : d[4], up ? d[2] : d[3],
                   up ? d[3] : d[2], up ? d[4] : d[1]);
}

template <typename T, bool NEAR>
__global__ void __launch_bounds__(TX * TY) weno5_kernel(
    const T* __restrict__ q, const T* __restrict__ u,
    const T* __restrict__ v, T* __restrict__ out, int ny, int nx, T dx,
    T dy) {
  // s[r][c] holds q at row j0 - H + r, column i0 - H + c (wrapped)
  __shared__ T s[TY + 2 * H][TX + 2 * H];
  const int i0 = blockIdx.x * TX;
  const int j0 = blockIdx.y * TY;
  const int vx = min(TX, nx - i0);  // the tile's valid columns
  const int vy = min(TY, ny - j0);  // and rows
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  // the x band: the tile's rows, H columns either side
  if (ty < vy) {
    const T* row = q + static_cast<size_t>(j0 + ty) * nx;
    for (int c = tx; c < vx + 2 * H; c += TX)
      s[H + ty][c] = row[wrap3<NEAR>(i0 - H + c, nx)];
  }
  // the y strips: H rows above (slots 0..H-1) and below (H+vy..2H+vy-1)
  if (ty < 2 * H && tx < vx) {
    const int r = ty < H ? ty : vy + ty;
    s[r][H + tx] =
        q[static_cast<size_t>(wrap3<NEAR>(j0 - H + r, ny)) * nx + i0 + tx];
  }
  __syncthreads();
  if (tx >= vx || ty >= vy) return;

  T d[6];
#pragma unroll
  for (int k = 0; k < 6; ++k)
    d[k] = (s[H + ty][tx + k + 1] - s[H + ty][tx + k]) / dx;
  const size_t idx = static_cast<size_t>(j0 + ty) * nx + i0 + tx;
  const T uu = u[idx];
  const T qx = upwind(d, uu > T(0));
#pragma unroll
  for (int k = 0; k < 6; ++k)
    d[k] = (s[ty + k + 1][H + tx] - s[ty + k][H + tx]) / dy;
  const T vv = v[idx];
  const T qy = upwind(d, vv > T(0));
  out[idx] = -(uu * qx + vv * qy);
}

template <typename T>
int launch(const void* q, const void* u, const void* v, void* out, int ny,
           int nx, double dx, double dy, cudaStream_t stream) {
  const dim3 block(TX, TY);
  const dim3 grid((nx + TX - 1) / TX, (ny + TY - 1) / TY);
  const T* qq = static_cast<const T*>(q);
  const T* uu = static_cast<const T*>(u);
  const T* vv = static_cast<const T*>(v);
  T* o = static_cast<T*>(out);
  if (nx >= H && ny >= H)
    weno5_kernel<T, true><<<grid, block, 0, stream>>>(
        qq, uu, vv, o, ny, nx, static_cast<T>(dx), static_cast<T>(dy));
  else
    weno5_kernel<T, false><<<grid, block, 0, stream>>>(
        qq, uu, vv, o, ny, nx, static_cast<T>(dx), static_cast<T>(dy));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64.  q, u, v, out: contiguous (ny, nx), any
// extent (periodic wrap per index).
RT_EXPORT int weno5_advect(int dtype, void* q, void* u, void* v, void* out,
                           int ny, int nx, double dx, double dy,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<double>(q, u, v, out, ny, nx, dx, dy, s)
                    : launch<float>(q, u, v, out, ny, nx, dx, dy, s);
}
