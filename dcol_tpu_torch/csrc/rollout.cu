// A system's rollout: every RK4 step of a trajectory in one launch.
//
//     u_t     = U_t - K_t (x_t - X_t) - alpha k_t        (closed loop)
//     x_{t+1} = RK4(x_t, u_t)                             t = 0 .. N-2
//
// Replaces no TPU kernel: the JAX package runs this rollout as a lax.scan
// (dcol_tpu/solver/altro.py, rollout and initial_rollout), which XLA
// compiles into one loop on the device.  The port's plain version is a
// Python loop over knots (dcol_tpu_torch/solver/altro.py::rollout_loop),
// a few hundred ATen launches a knot; this kernel is the scan.
//
// The system is a compile-time parameter (-DDCOL_SYSTEM=<struct below>):
// its nx, nu, constants and continuous dynamics f(x, u).
//   * Quadrotor: Quadrotor.dynamics (dcol_tpu_torch/systems/quadrotor.py):
//     the rotor-force clamp, the thrust direction (the third column of the
//     MRP direction cosine matrix), the MRP kinematics and
//     omega' = (tau - omega x J omega) / J;
//   * PianoMover: PianoMover.dynamics (systems/piano_mover.py), the planar
//     double integrator f = [x2, x3, u0, u1, x5, u2 / OMEGA_CONTROL_SCALE].
// Each computes in the operand type (DCOL_T), with IEEE divisions and no
// fast math.  The results are not bitwise the loop's: products are
// contracted into FMAs and sums taken in another order than ATen's
// separate kernels and cuBLAS's bmm.
//
// One lane (thread) runs one (scenario, candidate) through the whole
// trajectory.  Operands, row-major, contiguous and 16-byte aligned:
//   x0 (S, nx) with a stride of x0_stride elements between scenarios
//   X (S, N, nx), U (S, N-1, nu), K (S, N-1, nu, nx), k (S, N-1, nu),
//   alpha (S, C); results Xn (S, C, N, nx) and Un (S, C, N-1, nu).
// The open loop (K null) reads only x0 and U, and writes no Un where it is
// null.
//
// What bounds it on the card: latency.  A quadrotor rollout of S = 1024,
// C = 4, N = 100 moves ~54 MB (10-16 us at 3.35 TB/s) and ~0.3 GFLOP, but
// each lane runs 99 dependent RK4 steps of ~4 x 70 dependent operations,
// divisions among them.  What the design does about it:
//   * the C candidates of a scenario are adjacent lanes, so one load of
//     K_t, X_t, U_t and k_t serves them all;
//   * every row a lane reads or writes (x, u, a row of K) is read and
//     written with the widest vector that divides it: 16 bytes where it
//     can (every row of the quadrotor: 17 loads and 4 stores a knot in
//     float32 instead of 68 and 16), else 8 (the piano's float32 x and K
//     rows), else the scalar (the piano's u and k rows).  The lanes of a
//     warp touch up to 32 scenarios' rows, and each access to them costs
//     the load/store unit a pass per row;
//   * knot t+1's operands are loaded into the registers that knot t's have
//     just left, before knot t integrates, so their latency hides behind
//     the RK4 step;
//   * blocks of one warp, so 1,024-16,384 lanes spread over 32-132 SMs;
//   * nx and nu are compile-time constants: every per-lane vector is a
//     register array with constant indices.

#include <cuda_runtime.h>

#if !defined(DCOL_T) || !defined(DCOL_SYSTEM)
#error "build with -DDCOL_T=float|double -DDCOL_SYSTEM=Quadrotor|PianoMover"
#endif

namespace {

typedef DCOL_T Real;
constexpr int kBlock = 32;

// Vectors of B bytes of T: the widest load or store a row allows.
template <typename T, int B> struct Vec;
template <> struct Vec<float, 16> {
  typedef float4 type;
  static __device__ __forceinline__ void unpack(float4 v, float* d) {
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  static __device__ __forceinline__ float4 pack(const float* d) {
    return make_float4(d[0], d[1], d[2], d[3]);
  }
};
template <> struct Vec<float, 8> {
  typedef float2 type;
  static __device__ __forceinline__ void unpack(float2 v, float* d) {
    d[0] = v.x;
    d[1] = v.y;
  }
  static __device__ __forceinline__ float2 pack(const float* d) {
    return make_float2(d[0], d[1]);
  }
};
template <> struct Vec<double, 16> {
  typedef double2 type;
  static __device__ __forceinline__ void unpack(double2 v, double* d) {
    d[0] = v.x;
    d[1] = v.y;
  }
  static __device__ __forceinline__ double2 pack(const double* d) {
    return make_double2(d[0], d[1]);
  }
};
template <typename T> struct Scalar {
  typedef T type;
  static __device__ __forceinline__ void unpack(T v, T* d) { d[0] = v; }
  static __device__ __forceinline__ T pack(const T* d) { return d[0]; }
};
template <> struct Vec<float, 4> : Scalar<float> {};
template <> struct Vec<double, 8> : Scalar<double> {};

// The widest of 16, 8 and sizeof(Real) bytes that divides a row of M
// values: every row starts at a multiple of its own length from a 16-byte
// aligned base, so it is aligned to that width too.
template <int M> struct Row {
  static constexpr int kBytes = M * (int)sizeof(Real);
  static constexpr int kWidth = kBytes % 16 == 0  ? 16
                                : kBytes % 8 == 0 ? 8
                                                  : (int)sizeof(Real);
  typedef Vec<Real, kWidth> V;
  static constexpr int kLen = kWidth / (int)sizeof(Real);
};

// dst[0 .. M) = src[0 .. M)
template <int M>
__device__ __forceinline__ void load_row(Real* dst,
                                         const Real* __restrict__ src) {
  typedef Row<M> R;
  const typename R::V::type* v =
      reinterpret_cast<const typename R::V::type*>(src);
#pragma unroll
  for (int i = 0; i < M / R::kLen; ++i)
    R::V::unpack(__ldg(v + i), dst + i * R::kLen);
}

template <int M>
__device__ __forceinline__ void store_row(Real* __restrict__ dst,
                                          const Real* src) {
  typedef Row<M> R;
  typename R::V::type* v = reinterpret_cast<typename R::V::type*>(dst);
#pragma unroll
  for (int i = 0; i < M / R::kLen; ++i) v[i] = R::V::pack(src + i * R::kLen);
}

// -- the systems --------------------------------------------------------

struct Quadrotor {
  static constexpr int kNX = 12;
  static constexpr int kNU = 4;
  // mass, J (3), gravity, arm length, KF, KM, dt
  static constexpr int kNConsts = 9;
  struct Consts {
    Real mass, jx, jy, jz, g, arm, kf, km, dt;
  };
  static Consts consts(const double* c) {
    return Consts{(Real)c[0], (Real)c[1], (Real)c[2], (Real)c[3], (Real)c[4],
                  (Real)c[5], (Real)c[6], (Real)c[7], (Real)c[8]};
  }

  // f = Quadrotor.dynamics(x, u)
  static __device__ __forceinline__ void dynamics(const Consts& c,
                                                  const Real* x,
                                                  const Real* u, Real* f) {
    const Real px = x[6], py = x[7], pz = x[8];
    const Real wx = x[9], wy = x[10], wz = x[11];
    // rotor forces clamp to >= 0; NaN passes as torch.maximum passes it
    Real F[kNU];
#pragma unroll
    for (int i = 0; i < kNU; ++i) {
      const Real v = c.kf * u[i];
      F[i] = v < Real(0) ? Real(0) : v;
    }
    const Real tx = c.arm * (F[1] - F[3]);
    const Real ty = c.arm * (F[2] - F[0]);
    const Real tz = ((c.km * u[0] - c.km * u[1]) + c.km * u[2]) - c.km * u[3];
    const Real thrust = ((F[0] + F[1]) + F[2]) + F[3];
    // third column of R(p) = I + (8 [p]x^2 + 4 (1 - p'p) [p]x) / (1 + p'p)^2
    const Real pp = (px * px + py * py) + pz * pz;
    const Real one_pp = Real(1) + pp;
    const Real den = one_pp * one_pp;
    const Real s4 = Real(4) * (Real(1) - pp);
    const Real q0 = (Real(8) * (px * pz) + s4 * py) / den;
    const Real q1 = (Real(8) * (py * pz) - s4 * px) / den;
    const Real q2 = Real(1) + Real(8) * (pz * pz - pp) / den;
    f[0] = x[3];
    f[1] = x[4];
    f[2] = x[5];
    f[3] = (q0 * thrust) / c.mass;
    f[4] = (q1 * thrust) / c.mass;
    f[5] = (c.mass * -c.g + q2 * thrust) / c.mass;
    // pdot = ((1 + p'p) / 4)
    //        (omega + 2 ([p]x^2 omega + p x omega) / (1 + p'p))
    const Real pw = (px * wx + py * wy) + pz * wz;
    const Real quarter = one_pp / Real(4);
    f[6] = quarter * (wx + Real(2) *
                               ((px * pw - pp * wx) + (py * wz - pz * wy)) /
                               one_pp);
    f[7] = quarter * (wy + Real(2) *
                               ((py * pw - pp * wy) + (pz * wx - px * wz)) /
                               one_pp);
    f[8] = quarter * (wz + Real(2) *
                               ((pz * pw - pp * wz) + (px * wy - py * wx)) /
                               one_pp);
    // omega' = (tau - omega x J omega) / J
    const Real hx = c.jx * wx, hy = c.jy * wy, hz = c.jz * wz;
    f[9] = (tx - (wy * hz - wz * hy)) / c.jx;
    f[10] = (ty - (wz * hx - wx * hz)) / c.jy;
    f[11] = (tz - (wx * hy - wy * hx)) / c.jz;
  }
};

struct PianoMover {
  static constexpr int kNX = 6;
  static constexpr int kNU = 3;
  // dt, OMEGA_CONTROL_SCALE
  static constexpr int kNConsts = 2;
  struct Consts {
    Real dt, omega_scale;
  };
  static Consts consts(const double* c) {
    return Consts{(Real)c[0], (Real)c[1]};
  }

  // f = PianoMover.dynamics(x, u)
  static __device__ __forceinline__ void dynamics(const Consts& c,
                                                  const Real* x,
                                                  const Real* u, Real* f) {
    f[0] = x[2];
    f[1] = x[3];
    f[2] = u[0];
    f[3] = u[1];
    f[4] = x[5];
    f[5] = u[2] / c.omega_scale;
  }
};

typedef DCOL_SYSTEM Sys;
typedef Sys::Consts Consts;
constexpr int kNX = Sys::kNX;
constexpr int kNU = Sys::kNU;

// One knot's operands of a scenario.
struct Knot {
  Real X[kNX], U[kNU], K[kNU * kNX], k[kNU];
};

template <bool FB>
__device__ __forceinline__ void load_knot(Knot& d, const Real* __restrict__ X,
                                          const Real* __restrict__ U,
                                          const Real* __restrict__ K,
                                          const Real* __restrict__ k,
                                          long long s, int t, int N) {
  const long long st = s * (N - 1) + t;
  load_row<kNU>(d.U, U + st * kNU);
  if (FB) {
    load_row<kNX>(d.X, X + (s * N + t) * kNX);
    load_row<kNU * kNX>(d.K, K + st * kNU * kNX);
    load_row<kNU>(d.k, k + st * kNU);
  }
}

// x <- RK4(x, u), as System.discrete_dynamics takes it
__device__ __forceinline__ void rk4(const Consts& c, Real* x, const Real* u) {
  Real kk[kNX], xs[kNX], acc[kNX];
  Sys::dynamics(c, x, u, kk);
#pragma unroll
  for (int i = 0; i < kNX; ++i) {
    kk[i] = c.dt * kk[i];
    acc[i] = kk[i];
    xs[i] = x[i] + Real(0.5) * kk[i];
  }
  Sys::dynamics(c, xs, u, kk);
#pragma unroll
  for (int i = 0; i < kNX; ++i) {
    kk[i] = c.dt * kk[i];
    acc[i] = acc[i] + Real(2) * kk[i];
    xs[i] = x[i] + Real(0.5) * kk[i];
  }
  Sys::dynamics(c, xs, u, kk);
#pragma unroll
  for (int i = 0; i < kNX; ++i) {
    kk[i] = c.dt * kk[i];
    acc[i] = acc[i] + Real(2) * kk[i];
    xs[i] = x[i] + kk[i];
  }
  Sys::dynamics(c, xs, u, kk);
#pragma unroll
  for (int i = 0; i < kNX; ++i) {
    acc[i] = acc[i] + c.dt * kk[i];
    x[i] = x[i] + acc[i] / Real(6);
  }
}

template <bool FB>
__global__ void __launch_bounds__(kBlock)
rollout_kernel(const Real* __restrict__ x0, long long x0_stride,
               const Real* __restrict__ X, const Real* __restrict__ U,
               const Real* __restrict__ K, const Real* __restrict__ k,
               const Real* __restrict__ alpha, Real* __restrict__ Xn,
               Real* __restrict__ Un, int S, int C, int N, Consts c) {
  const long long lane = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (lane >= (long long)S * C) return;
  const long long s = lane / C;
  Real x[kNX];
  load_row<kNX>(x, x0 + s * x0_stride);
  const Real a = FB ? __ldg(alpha + lane) : Real(0);
  Real* xo = Xn + lane * N * kNX;
  Real* uo = Un == nullptr ? nullptr : Un + lane * (N - 1) * kNU;
  store_row<kNX>(xo, x);
  Knot d;
  if (N > 1) load_knot<FB>(d, X, U, K, k, s, 0, N);
#pragma unroll 1
  for (int t = 0; t < N - 1; ++t) {
    Real u[kNU];
#pragma unroll
    for (int i = 0; i < kNU; ++i) {
      if (FB) {
        Real kdx = Real(0);
#pragma unroll
        for (int j = 0; j < kNX; ++j)
          kdx = kdx + d.K[i * kNX + j] * (x[j] - d.X[j]);
        u[i] = (d.U[i] - kdx) - a * d.k[i];
      } else {
        u[i] = d.U[i];
      }
    }
    // knot t+1's operands are in flight while knot t integrates
    if (t + 1 < N - 1) load_knot<FB>(d, X, U, K, k, s, t + 1, N);
    rk4(c, x, u);
    store_row<kNX>(xo + (t + 1) * kNX, x);
    if (uo != nullptr) store_row<kNU>(uo + t * kNU, u);
  }
}

}  // namespace

extern "C" {

// sizeof(Real), nx, nu and the number of constants of the system, so the
// wrapper can check the library it loaded
int dcol_rollout_layout(int* out) {
  out[0] = (int)sizeof(Real);
  out[1] = kNX;
  out[2] = kNU;
  out[3] = Sys::kNConsts;
  return 0;
}

// Roll S x C lanes out over N knots (see the top of this file); K null is
// the open loop, which reads neither X, k nor alpha.  consts: the system's
// kNConsts constants in its order (Quadrotor: mass, J (3), gravity, arm
// length, KF, KM, dt; PianoMover: dt, OMEGA_CONTROL_SCALE).  Returns
// cudaGetLastError() after the launch.
int dcol_rollout(const void* x0, long long x0_stride, const void* X,
                 const void* U, const void* K, const void* k,
                 const void* alpha, void* Xn, void* Un, int S, int C, int N,
                 const double* consts, void* stream) {
  const long long lanes = (long long)S * C;
  if (lanes <= 0 || N <= 0) return 0;
  const Consts c = Sys::consts(consts);
  const unsigned blocks = (unsigned)((lanes + kBlock - 1) / kBlock);
  cudaStream_t st = (cudaStream_t)stream;
  if (K != nullptr) {
    rollout_kernel<true><<<blocks, kBlock, 0, st>>>(
        (const Real*)x0, x0_stride, (const Real*)X, (const Real*)U,
        (const Real*)K, (const Real*)k, (const Real*)alpha, (Real*)Xn,
        (Real*)Un, S, C, N, c);
  } else {
    rollout_kernel<false><<<blocks, kBlock, 0, st>>>(
        (const Real*)x0, x0_stride, nullptr, (const Real*)U, nullptr,
        nullptr, nullptr, (Real*)Xn, (Real*)Un, S, C, N, c);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
