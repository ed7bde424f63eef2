// Shared pieces of the repro_torch CUDA kernels: the C export macro, the
// error-string and device-query entry points every library carries, the
// periodic index wrap, the device point functions of the stencil kernels
// (stencil2d.cu, stencil1d_batch.cu, stencil3d.cu) with their Create-time
// taps and the evaluation of a point from its windows, and the pentadiagonal
// substitution of a line held in memory, substitute_segmented: one warp
// splits the line into 32 segments and runs it as a segmented recurrence.
// Every sweep runs it (fused_ch.cu:ch_rhs_xsweep, the fused RHS + x-sweep;
// penta.cu:penta_cols, penta_rows and penta_mid, the column, row and plane
// sweeps), and solve_line_global runs it, with the cyclic closure, on a
// line in device memory (the routes of lines that fit no block).  It
// computes the reference's substitution
// (repro/kernels/penta.py:rows_substitute_refs) to rounding, not bit for
// bit, since it combines carries across segments.
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
// point_fn into the kernel body; here each one is a compile-time device
// point function P, selected by id (DEVICE_POINT_FNS in
// kernels/stencil2d.py).  The two the library knows are sums of terms,
// a window's contribution P::term(coefficient, value), summed in window
// order as the point functions do:
//   0 WeightedPoint  c w            (repro weighted_point_fn)
//   1 CubePoint      c (w^3 - w)    (cahn_hilliard.py cube_laplacian_point_fn)
// A user's point function (id 2) is CUDA C++ source given at Create,
//   template <typename T> __device__ T point_fn(const T* w, const T* c),
// that kernels/_build.py compiles into its own copy of the three stencil
// libraries with REPRO_USER_POINT_FN and REPRO_NWIN (the plan's window
// count) defined: the general path gathers the NWIN windows, in the
// reference's window order, into registers and returns point_fn(w, c).
struct WeightedPoint {
  static constexpr bool kGeneral = false;
  template <typename T>
  static __device__ __forceinline__ T term(T c, T w) {
    return c * w;
  }
};

struct CubePoint {
  static constexpr bool kGeneral = false;
  template <typename T>
  static __device__ __forceinline__ T term(T c, T w) {
    return c * (w * w * w - w);
  }
};

#ifdef REPRO_USER_POINT_FN
struct UserPoint {
  static constexpr bool kGeneral = true;
  static constexpr int kWindows = REPRO_NWIN;
  template <typename T>
  static __device__ __forceinline__ T apply(const T (&w)[kWindows],
                                            const T* c) {
    return point_fn<T>(w, c);
  }
};
#endif

// Call f(P{}) with the device point function of id `point_fn`: 0 and 1 in
// the library's own build, 2 (the user's) in a user build; any other id
// is cudaErrorInvalidValue.
template <typename F>
inline int with_point_fn(int point_fn, F&& f) {
#ifdef REPRO_USER_POINT_FN
  if (point_fn == 2) return f(UserPoint{});
#else
  switch (point_fn) {
    case 0:
      return f(WeightedPoint{});
    case 1:
      return f(CubePoint{});
  }
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

// Wrap an index in [-n, 2n) onto [0, n) by a compare and an add (NEAR:
// every halo no wider than its extent), or any index by the modulo.
template <bool NEAR>
__device__ __forceinline__ int wrap(int q, int n) {
  if (NEAR) return q < 0 ? q + n : (q >= n ? q - n : q);
  return wrap_index(q, n);
}

// The non-zero taps of a weighted or cube plan, in window order
// (kernels/taps.py:nonzero_taps, reduced at Create): window (c[t], a[t],
// b[t]) of the (z, y, x) box and its weight w[t]; a 2D window (a, b) is
// (0, a, b), a 1D window k is (0, 0, k).  n < 0: not reduced (the dense
// path).  Kernels take it by value as a __grid_constant__ parameter, read
// through the constant cache.
constexpr int kMaxTaps = 32;  // kernels/taps.py:MAX_TAPS

struct Taps {
  int n;
  int c[kMaxTaps];
  int a[kMaxTaps];
  int b[kMaxTaps];
  double w[kMaxTaps];
};

// The taps of a C entry point's arguments (n, then the window coordinates
// c, a, b and the weights of n taps), or n = -1 when tap_n is null.
// False when n exceeds kMaxTaps.
inline bool read_taps(const int* tap_n, const int* tap_cab,
                      const double* tap_w, Taps* taps) {
  *taps = Taps{};
  taps->n = -1;
  if (tap_n == nullptr) return true;
  if (*tap_n > kMaxTaps) return false;
  taps->n = *tap_n;
  for (int t = 0; t < taps->n; ++t) {
    taps->c[t] = tap_cab[3 * t];
    taps->a[t] = tap_cab[3 * t + 1];
    taps->b[t] = tap_cab[3 * t + 2];
    taps->w[t] = tap_w[t];
  }
  return true;
}

// The NR outputs of one thread from their windows: get(c, a, b, rr) is the
// value of window (c, a, b) of output rr, for a box of sy rows of sx
// windows a plane and nwin windows in all.  Three ways, in the reference's
// window order (z-major, then row-major over (y, x)):
// - general: a user's point function on its NWIN windows, gathered into
//   registers;
// - taps: the sum of the non-zero taps' terms (skipping an exact-zero term
//   changes no finite result, only the sign of an all-zero sum);
// - dense: every window's term, its coefficient read from device memory.
// Each tap's parameters and coefficient serve the NR outputs.
template <typename T, typename P, int NR, typename Get>
__device__ __forceinline__ void point_values(T (&res)[NR], const Get& get,
                                             const Taps& taps,
                                             const T* __restrict__ coeffs,
                                             int nwin, int sy, int sx) {
  if constexpr (P::kGeneral) {
#pragma unroll
    for (int rr = 0; rr < NR; ++rr) {
      T w[P::kWindows];
      int c = 0, a = 0, b = 0;
#pragma unroll
      for (int t = 0; t < P::kWindows; ++t) {
        w[t] = get(c, a, b, rr);
        if (++b == sx) {
          b = 0;
          if (++a == sy) {
            a = 0;
            ++c;
          }
        }
      }
      res[rr] = P::apply(w, coeffs);
    }
  } else {
#pragma unroll
    for (int rr = 0; rr < NR; ++rr) res[rr] = T(0);
    if (taps.n >= 0) {
      for (int t = 0; t < taps.n; ++t) {
        const T wt = static_cast<T>(taps.w[t]);
        const int c = taps.c[t], a = taps.a[t], b = taps.b[t];
#pragma unroll
        for (int rr = 0; rr < NR; ++rr) {
          const T term = P::term(wt, get(c, a, b, rr));
          res[rr] = t == 0 ? term : res[rr] + term;
        }
      }
      return;
    }
    int c = 0, a = 0, b = 0;
    for (int t = 0; t < nwin; ++t) {
      const T wt = __ldg(coeffs + t);
#pragma unroll
      for (int rr = 0; rr < NR; ++rr) {
        const T term = P::term(wt, get(c, a, b, rr));
        res[rr] = t == 0 ? term : res[rr] + term;
      }
      if (++b == sx) {
        b = 0;
        if (++a == sy) {
          a = 0;
          ++c;
        }
      }
    }
  }
}

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;

// Affine map of a two-term recurrence over one segment: the state after the
// segment is A s + p for the state s before it.  A depends only on the
// factors; p is the segment's end state from a zero start.
template <typename T>
struct SegmentMap {
  T a00, a01, a10, a11, p0, p1;
};

// Inclusive scan of the 32 lanes' segment maps, lane order (kReverse:
// from lane 31 down), Hillis-Steele with warp shuffles: after it, each
// lane's m is the composition of its own map after those of all the lanes
// before it.
template <typename T, bool kReverse>
__device__ __forceinline__ void segment_scan(SegmentMap<T>& m, int lane) {
#pragma unroll
  for (int d = 1; d < kWarp; d <<= 1) {
    T b00, b01, b10, b11, q0, q1;
    if (kReverse) {
      b00 = __shfl_down_sync(kFullMask, m.a00, d);
      b01 = __shfl_down_sync(kFullMask, m.a01, d);
      b10 = __shfl_down_sync(kFullMask, m.a10, d);
      b11 = __shfl_down_sync(kFullMask, m.a11, d);
      q0 = __shfl_down_sync(kFullMask, m.p0, d);
      q1 = __shfl_down_sync(kFullMask, m.p1, d);
    } else {
      b00 = __shfl_up_sync(kFullMask, m.a00, d);
      b01 = __shfl_up_sync(kFullMask, m.a01, d);
      b10 = __shfl_up_sync(kFullMask, m.a10, d);
      b11 = __shfl_up_sync(kFullMask, m.a11, d);
      q0 = __shfl_up_sync(kFullMask, m.p0, d);
      q1 = __shfl_up_sync(kFullMask, m.p1, d);
    }
    if (kReverse ? lane + d < kWarp : lane >= d) {
      // this map after that one: A <- A B, p <- A q + p
      const T p0 = m.a00 * q0 + m.a01 * q1 + m.p0;
      const T p1 = m.a10 * q0 + m.a11 * q1 + m.p1;
      const T a00 = m.a00 * b00 + m.a01 * b10;
      const T a01 = m.a00 * b01 + m.a01 * b11;
      const T a10 = m.a10 * b00 + m.a11 * b10;
      const T a11 = m.a10 * b01 + m.a11 * b11;
      m = SegmentMap<T>{a00, a01, a10, a11, p0, p1};
    }
  }
}

// The carry of a line held by one warp: segment_scan, then, in (s0, s1),
// the state entering the lane's segment: the previous lane's composed end
// state, zero for the first lane.
template <typename T, bool kReverse>
__device__ __forceinline__ void segment_carry(SegmentMap<T> m, int lane,
                                              T& s0, T& s1) {
  segment_scan<T, kReverse>(m, lane);
  s0 = kReverse ? __shfl_down_sync(kFullMask, m.p0, 1)
                : __shfl_up_sync(kFullMask, m.p0, 1);
  s1 = kReverse ? __shfl_down_sync(kFullMask, m.p1, 1)
                : __shfl_up_sync(kFullMask, m.p1, 1);
  if (lane == (kReverse ? kWarp - 1 : 0)) s0 = s1 = T(0);
}

// Step B of substitute_segmented for a line that one warp holds whole:
// segment_carry in each direction.  (penta.cu's ClusterCarry is the step for
// a line split across the blocks of a cluster.)
template <typename T>
struct WarpCarry {
  __device__ __forceinline__ void forward(SegmentMap<T> m, int lane, T& s0,
                                          T& s1) const {
    segment_carry<T, false>(m, lane, s0, s1);
  }
  __device__ __forceinline__ void backward(SegmentMap<T> m, int lane, T& s0,
                                           T& s1) const {
    segment_carry<T, true>(m, lane, s0, s1);
  }
};

// The in-place forward/backward substitution of a line of length M with
// the Create-time LU factors of the band (sub = e_i, low = l_i,
// imu = 1/mu_i, al = alpha_i, be = beta_i),
//   z_i = (r_i - e_i z_{i-2} - l_i z_{i-1}) / mu_i,
//   x_i = z_i - alpha_i x_{i+1} - beta_i x_{i+2},
// as a segmented recurrence, run by all 32 lanes of one warp (lane = threadIdx.x % 32, the warp converged) on a
// line of length M: element i is read at in[i * ld] and the result
// written at v[i * ld] (in may equal v: each lane touches only its own
// segment).  Lane k owns the segment [k L, min((k + 1) L, M)); L is odd
// and 32 L >= M (kernels/penta.py:segment_length), so the lanes of a warp
// touch 32 different shared-memory banks.  For each direction:
//
//   A. each lane runs its segment from a zero state (the map's p) and, in
//      the same loop, from the unit states (1, 0) and (0, 1) with a zero
//      right-hand side (the columns of A): three independent chains;
//   B. `carry` combines the 32 maps into each segment's true incoming
//      state (WarpCarry: segment_carry, 5 shuffle rounds);
//   C. each lane reruns its segment from that state and writes it.
//
// Forward z_i = (r_i - e_i z_{i-2} - l_i z_{i-1}) / mu_i over the state
// (z_{i-1}, z_{i-2}); backward x_i = z_i - alpha_i x_{i+1} - beta_i x_{i+2}
// over (x_{i+1}, x_{i+2}).  Pass C is the true recurrence, so the result
// differs from one thread walking the whole line only through the rounding
// of the 32 carries.
// The caller syncs the warp (or block) before reading other lanes' output.
template <typename T, typename Carry = WarpCarry<T>>
__device__ __forceinline__ void substitute_segmented(
    const T* in, T* v, long long ld, const T* __restrict__ sub,
    const T* __restrict__ low, const T* __restrict__ imu,
    const T* __restrict__ al, const T* __restrict__ be, int M, int L,
    int lane, const Carry& carry = Carry{}) {
  const int a = min(lane * L, M);
  const int b = min(a + L, M);
  T s0, s1;
  {  // forward, pass A
    T p1 = T(0), p2 = T(0), u1 = T(1), u2 = T(0), w1 = T(0), w2 = T(1);
#pragma unroll 4
    for (int i = a; i < b; ++i) {
      const T e = sub[i], l = low[i], m = imu[i];
      const T pz = (in[i * ld] - e * p2 - l * p1) * m;
      const T uz = -(e * u2 + l * u1) * m;
      const T wz = -(e * w2 + l * w1) * m;
      p2 = p1;
      p1 = pz;
      u2 = u1;
      u1 = uz;
      w2 = w1;
      w1 = wz;
    }
    carry.forward(SegmentMap<T>{u1, w1, u2, w2, p1, p2}, lane, s0, s1);
  }
  {  // forward, pass C
    T z1 = s0, z2 = s1;
#pragma unroll 4
    for (int i = a; i < b; ++i) {
      const T z = (in[i * ld] - sub[i] * z2 - low[i] * z1) * imu[i];
      v[i * ld] = z;
      z2 = z1;
      z1 = z;
    }
  }
  {  // backward, pass A
    T p1 = T(0), p2 = T(0), u1 = T(1), u2 = T(0), w1 = T(0), w2 = T(1);
#pragma unroll 4
    for (int i = b - 1; i >= a; --i) {
      const T f = al[i], g = be[i];
      const T px = v[i * ld] - f * p1 - g * p2;
      const T ux = -(f * u1 + g * u2);
      const T wx = -(f * w1 + g * w2);
      p2 = p1;
      p1 = px;
      u2 = u1;
      u1 = ux;
      w2 = w1;
      w1 = wx;
    }
    carry.backward(SegmentMap<T>{u1, w1, u2, w2, p1, p2}, lane, s0, s1);
  }
  {  // backward, pass C
    T x1 = s0, x2 = s1;
#pragma unroll 4
    for (int i = b - 1; i >= a; --i) {
      const T x = v[i * ld] - al[i] * x1 - be[i] * x2;
      v[i * ld] = x;
      x2 = x1;
      x1 = x;
    }
  }
}

// One line of length M in device memory (element i at r[i * ld], result
// at o[i * ld]) solved by the calling warp, then, when w is not null, the
// cyclic rank-4 closure x_i = y_i - (W[i,0] y[M-2] + W[i,1] y[M-1] +
// W[i,2] y[0] + W[i,3] y[1]), each lane on its own segment.
template <typename T>
__device__ __forceinline__ void solve_line_global(
    const T* __restrict__ sub, const T* __restrict__ low,
    const T* __restrict__ imu, const T* __restrict__ al,
    const T* __restrict__ be, const T* __restrict__ w, const T* r, T* o,
    long long ld, int M, int L, int lane) {
  substitute_segmented(r, o, ld, sub, low, imu, al, be, M, L, lane);
  if (w == nullptr) return;
  __syncwarp();
  const T ym2 = o[(M - 2) * ld], ym1 = o[(M - 1) * ld], y0 = o[0], y1 = o[ld];
  __syncwarp();
  const int a = min(lane * L, M), b = min(a + L, M);
  for (int i = a; i < b; ++i) {
    const T* wi = w + 4 * i;
    o[i * ld] -= __ldg(wi) * ym2 + __ldg(wi + 1) * ym1 + __ldg(wi + 2) * y0 +
                 __ldg(wi + 3) * y1;
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

// -- asynchronous copies into shared memory (PTX) ----------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One element from device to shared memory (cp.async of 4 or 8 bytes).
template <typename T>
__device__ __forceinline__ void elem_load(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_u32(dst)),
               "l"(__cvta_generic_to_global(src)), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void elem_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void elem_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
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
