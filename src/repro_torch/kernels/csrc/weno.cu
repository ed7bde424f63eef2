// WENO5 upwind advection RHS: the paper's 2d_xyADVWENO_p variant.
//
// Replaces the TPU kernel repro/kernels/weno.py:weno5_advect_pallas (body
// _weno_kernel): the RHS of dq/dt = -(u q_x + v q_y) on a periodic (ny, nx)
// field with upwinded Hamilton–Jacobi WENO5 derivatives (halo 3), the
// velocities u and v as two extra operands.
//
// The TPU kernel assembles x- and y-bands from its left/right/up/down
// neighbour tiles and so needs tiles that divide the field and are at
// least 3 wide.  Here a block of 32 x 8 threads owns a 32 x 16 tile, two
// outputs a thread (rows ty and ty + 8), and works in three phases:
// 1. q of the tile plus a 3-wide strip on each side in x and in y (no
//    corners: the scheme is dimension by dimension) into shared memory;
// 2. the tile's one-sided differences, each computed once: (q_m - q_{m-1})
//    times 1/dx along each row (37 a row) and times 1/dy down each column
//    (21 a column), into shared memory;
// 3. each output reads its six differences a direction and evaluates the
//    upwind phi.
// Every index is wrapped on its own, so any extent works, including
// extents below 7 where a +-3 offset wraps more than half a line.  Offsets
// lie in [-3, n + 3), so for n >= 3 one compare and one add or subtract
// wraps them; only smaller extents take the general modulo (a template
// flag, so the common case carries none).  u and v are read coalesced
// straight from device memory.
//
// jnp.where evaluates both one-sided derivatives; here each direction
// picks its five upwind differences first (u > 0: left-biased, else
// right-biased, so u == 0 takes the plus branch as in the reference) and
// evaluates phi once: 2 phi a point instead of 4, the same value, and no
// divergence inside a warp whatever the velocity's sign.
//
// The arithmetic is that of repro/kernels/ref.py:_weno5_phi up to rounding:
// the differences multiply by 1/h (from the host) instead of dividing by
// h; the candidate stencils p_k are summed as 6 p_k with integer weights
// and the 1/6 goes into the normalisation, (sum a_k 6 p_k) / (6 w); the
// weights a_k = c_k / (eps + s_k)^2 and the normalisation take 4
// reciprocals, in float64 the hardware's approximation refined by two
// Newton steps.  So a point does no division where it did 38 (12 by h, 13
// in each of two phi); nvcc contracts multiply-adds into FMAs.  Results
// move by rounding only.  Each thread loads its two points' u and v before
// the staging, so those loads overlap it.
//
// What bounds it on the card: by the data-sheet count, bytes (q, u, v
// read and the output written: 32 bytes a point in float64) against about
// 170 flops a point.  The first design (one thread a point, six
// differences a direction recomputed by every point, 38 float64 divisions
// a point, each a multi-instruction sequence on the FP64 pipe) ran at 4.5x
// the byte bound at 1024^2; the divisions and the FP64 instruction count
// are what this design cuts.
#include "common.cuh"

namespace {

constexpr int TX = 32;      // tile width: one warp along x, coalesced
constexpr int BY = 8;       // thread rows of a block
constexpr int R = 2;        // outputs a thread, rows ty and ty + BY
constexpr int TY = R * BY;  // tile height
constexpr int H = 3;        // WENO5 halo

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

// 1 / x for the positive normal x a phi divides by: in float64 the
// hardware's approximate reciprocal refined by two Newton steps (within an
// ulp of 1 / x, and no branch to a slow path as a true division has), in
// float32 the correctly rounded reciprocal.
__device__ __forceinline__ double recip(double x) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  r = fma(r, fma(-x, r, 1.0), r);
  return fma(r, fma(-x, r, 1.0), r);
}

__device__ __forceinline__ float recip(float x) { return __frcp_rn(x); }

// repro/kernels/ref.py:_weno5_phi with 4 reciprocals and no division: the
// smoothness indicators as the reference writes them, the weights a_k =
// c_k (1 / (eps + s_k)^2), the candidate stencils times 6 (q_k = 6 p_k)
// and the 1/6 in the normalisation.
template <typename T>
__device__ __forceinline__ T weno5_phi(T v1, T v2, T v3, T v4, T v5) {
  const T eps = T(1e-6);
  const T s1 = T(13.0 / 12.0) * sq(v1 - T(2) * v2 + v3) +
               T(0.25) * sq(v1 - T(4) * v2 + T(3) * v3);
  const T s2 =
      T(13.0 / 12.0) * sq(v2 - T(2) * v3 + v4) + T(0.25) * sq(v2 - v4);
  const T s3 = T(13.0 / 12.0) * sq(v3 - T(2) * v4 + v5) +
               T(0.25) * sq(T(3) * v3 - T(4) * v4 + v5);
  const T a1 = T(0.1) * recip(sq(eps + s1));
  const T a2 = T(0.6) * recip(sq(eps + s2));
  const T a3 = T(0.3) * recip(sq(eps + s3));
  const T q1 = T(2) * v1 - T(7) * v2 + T(11) * v3;
  const T q2 = -v2 + T(5) * v3 + T(2) * v4;
  const T q3 = T(2) * v3 + T(5) * v4 - v5;
  return (a1 * q1 + a2 * q2 + a3 * q3) * recip(T(6) * (a1 + a2 + a3));
}

// The upwind derivative from the six differences d(k) = (q_{i+k-2} -
// q_{i+k-3}) / h, k = 0..5 (the reference's d[-3..2]): left-biased
// phi(d0..d4) when up is true, right-biased phi(d5, d4, d3, d2, d1) else.
template <typename T, typename D>
__device__ __forceinline__ T upwind(const D& d, bool up) {
  return weno5_phi<T>(up ? d(0) : d(5), up ? d(1) : d(4), up ? d(2) : d(3),
                      up ? d(3) : d(2), up ? d(4) : d(1));
}

template <typename T, bool NEAR>
__global__ void __launch_bounds__(TX * BY) weno5_kernel(
    const T* __restrict__ q, const T* __restrict__ u,
    const T* __restrict__ v, T* __restrict__ out, int ny, int nx, T inv_dx,
    T inv_dy) {
  // s[r][c] holds q at row j0 - H + r, column i0 - H + c (wrapped)
  __shared__ T s[TY + 2 * H][TX + 2 * H];
  // ex[r][m] = (s[H + r][m + 1] - s[H + r][m]) / dx,
  // ey[m][c] = (s[m + 1][H + c] - s[m][H + c]) / dy
  __shared__ T ex[TY][TX + 2 * H - 1];
  __shared__ T ey[TY + 2 * H - 1][TX];
  // tile x + nbx y of a one-dimensional grid (any number of rows fits)
  const int nbx = (nx + TX - 1) / TX;
  const int i0 = blockIdx.x % nbx * TX;
  const int j0 = blockIdx.x / nbx * TY;
  const int vx = min(TX, nx - i0);  // the tile's valid columns
  const int vy = min(TY, ny - j0);  // and rows
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  // this thread's velocities first, so their loads overlap the staging
  T uu[R], vv[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = ty + k * BY;
    if (tx < vx && r < vy) {
      const size_t idx = static_cast<size_t>(j0 + r) * nx + i0 + tx;
      uu[k] = u[idx];
      vv[k] = v[idx];
    }
  }
  // the x band: the tile's rows, H columns either side
  for (int r = ty; r < vy; r += BY) {
    const T* row = q + static_cast<size_t>(j0 + r) * nx;
    for (int c = tx; c < vx + 2 * H; c += TX)
      s[H + r][c] = row[wrap3<NEAR>(i0 - H + c, nx)];
  }
  // the y strips: H rows above (slots 0..H-1) and below (H+vy..2H+vy-1)
  if (ty < 2 * H && tx < vx) {
    const int r = ty < H ? ty : vy + ty;
    s[r][H + tx] =
        q[static_cast<size_t>(wrap3<NEAR>(j0 - H + r, ny)) * nx + i0 + tx];
  }
  __syncthreads();
  for (int r = ty; r < vy; r += BY)
    for (int m = tx; m < vx + 2 * H - 1; m += TX)
      ex[r][m] = (s[H + r][m + 1] - s[H + r][m]) * inv_dx;
  if (tx < vx)
    for (int m = ty; m < vy + 2 * H - 1; m += BY)
      ey[m][tx] = (s[m + 1][H + tx] - s[m][H + tx]) * inv_dy;
  __syncthreads();
  if (tx >= vx) return;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = ty + k * BY;
    if (r >= vy) break;
    const T qx = upwind<T>([&](int m) { return ex[r][tx + m]; }, uu[k] > T(0));
    const T qy = upwind<T>([&](int m) { return ey[r + m][tx]; }, vv[k] > T(0));
    out[static_cast<size_t>(j0 + r) * nx + i0 + tx] =
        -(uu[k] * qx + vv[k] * qy);
  }
}

template <typename T>
int launch(const void* q, const void* u, const void* v, void* out, int ny,
           int nx, double inv_dx, double inv_dy, cudaStream_t stream) {
  const dim3 block(TX, BY);
  const dim3 grid((nx + TX - 1) / TX * ((ny + TY - 1) / TY));
  const T* qq = static_cast<const T*>(q);
  const T* uu = static_cast<const T*>(u);
  const T* vv = static_cast<const T*>(v);
  T* o = static_cast<T*>(out);
  if (nx >= H && ny >= H)
    weno5_kernel<T, true><<<grid, block, 0, stream>>>(
        qq, uu, vv, o, ny, nx, static_cast<T>(inv_dx),
        static_cast<T>(inv_dy));
  else
    weno5_kernel<T, false><<<grid, block, 0, stream>>>(
        qq, uu, vv, o, ny, nx, static_cast<T>(inv_dx),
        static_cast<T>(inv_dy));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 float64.  q, u, v, out: contiguous (ny, nx), any
// extent (periodic wrap per index).  inv_dx, inv_dy: 1/dx and 1/dy.
RT_EXPORT int weno5_advect(int dtype, void* q, void* u, void* v, void* out,
                           int ny, int nx, double inv_dx, double inv_dy,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<double>(q, u, v, out, ny, nx, inv_dx, inv_dy, s)
                    : launch<float>(q, u, v, out, ny, nx, inv_dx, inv_dy, s);
}
