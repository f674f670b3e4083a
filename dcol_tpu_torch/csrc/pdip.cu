// Batched PDIP conic solver for NVIDIA Hopper: a team of lanes per problem.
//
//     min c'x   s.t.   G x + s = h,   s in R^NORT_+ x SOC(S1) x SOC(S2)
//
// Replaces the TPU kernel dcol_tpu/ops/pdip_pallas.py::_make_kernel
// (launched by solve_socp_pallas).  Same algorithm as the plain PyTorch
// version dcol_tpu_torch/ops/pdip.py::solve_socp: Mehrotra predictor-corrector
// with closed-form Nesterov-Todd scaling and a normal-equations Cholesky with
// jitter * mean(diag) on the diagonal; cold start (least squares +
// bring2cone) or warm start (previous s, z shifted inward by `margin`, then
// bring2cone); skip lanes start done and return the warm-initialised iterate.
//
// Two types.  Operands and results are in the storage type S (DCOL_T, the
// caller's dtype); the iteration runs in the arithmetic type T (DCOL_A).
// The wrapper picks T from the dtype and the layout
// (ops/pdip_cuda.py::arith_dtype): double for a float problem with a
// second-order-cone block, otherwise S itself.  Near contact, where a
// collision constraint is active, the scaled Newton system of such a
// problem is ill-conditioned near tol in float.  Iterating in float, this
// kernel stopped far from tol on 1 of the 1.69 M near-contact problems of
// the main path's seeds 1-6, and a variant that rounds the NT scaling as
// the plain version does on 3 others: which lanes is a matter of rounding
// (PERF.md §6).  In double, from the same float operands, all 3.66 M of
// seeds 0-12 converge.
// So a mixed launch solves the caller's float problem to the same tol and
// returns float x, s and z; the converged flag comes from the double mu.
// Double arithmetic runs at half the float rate on this card, and a
// double iterate takes twice the registers:
//   * G, h and c stay in registers as read, in S, and are widened where
//     they are used (exactly; see widen), so no widened copy of G is held;
//     the columns of W^{-1} G are formed where the Newton solves use them,
//     not held between them; the iterate and everything derived from it
//     are in T;
//   * the warm start (the shift and bring2cone) runs in S before the
//     iterate is widened, so a skipped problem returns, bit for bit, the
//     float iterate the plain version returns; cold starts run in T.
//
// What bounds it on the card.  A problem is nv <= 6 columns by nr <= 18
// rows, read once (429 B for the float 5/4/4/4 layout cold, 546 B warm) and
// then iterated on: one Mehrotra iteration is ~4 kFLOP, much of it in
// dependent chains (two Cholesky solves, ~10 scaling applies, four cone
// line searches, ~50 divides and square roots).  On the main path's
// launches (B = 12,800-102,400, 1-15 iterations) the bound is double
// arithmetic for cold launches and memory for warm ones, a few
// microseconds either way; what the kernel actually waits on is latency
// and issue slots.
//
// What the design does about it:
//   * a team of TEAM lanes (a power of two from 2 to 32) solves one problem,
//     so a launch has TEAM times the threads.  Rows are dealt so that a
//     cone block never straddles lanes: lane l holds orthant rows l,
//     l + TEAM, ... and second-order-cone block l whole (see Team below).
//     Each cone operation then runs on the lane that holds the block, with
//     no exchange; the two blocks run side by side on lanes 0 and 1.  x, c
//     and dx are replicated on every lane; the Cholesky factor, the same
//     on every lane, is kept once per team in shared memory (Team::share);
//   * sums over all rows (dot products, G'z, the Gram matrix of W^{-1}G)
//     are __shfl_xor_sync butterflies over the team, which leave the same
//     bits on every lane; the line search's minimum and bring2cone's
//     maximum are butterflies too, then taken from lane 0.  So every lane
//     takes the same branch at every exit and step test, and the team
//     leaves its loop together;
//   * a block's sums are taken on its lane in sequence, in the order of the
//     one-thread version (the warm start's bring2cone stays bit-identical
//     to the plain version's);
//   * every shuffle names the team's own lanes, never the whole warp: the
//     teams of one warp leave their loops at different iterations;
//   * operands are read where they lie, row-major: c (B, nv), G (B, nr, nv),
//     h (B, nr), warm x (B, nv), s and z (B, nr); a team reads its problem's
//     contiguous block and writes x, s and z back the same way, so the
//     wrapper copies nothing;
//   * a skipped problem returns its warm-initialised iterate and reads
//     neither G, h nor c;
//   * x0^2 - |x1|^2 and the SOC line search round as the plain version
//     does (see soc_quad);
//   * the layout, both types and TEAM are template parameters fixed by -D
//     defines at build time, so every loop unrolls and every per-lane vector
//     is a register array with constant indices.

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#if !defined(DCOL_T) || !defined(DCOL_A) || !defined(DCOL_NV) || \
    !defined(DCOL_NORT) || !defined(DCOL_S1) || !defined(DCOL_S2) ||   \
    !defined(DCOL_TEAM)
#error "build with -DDCOL_T=float|double -DDCOL_A=float|double -DDCOL_NV= -DDCOL_NORT= -DDCOL_S1= -DDCOL_S2= -DDCOL_TEAM="
#endif

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float dsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dsqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float dpow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double dpow(double a, double b) { return pow(a, b); }
__device__ __forceinline__ bool dfinite(float v) { return isfinite(v); }
__device__ __forceinline__ bool dfinite(double v) { return isfinite(v); }

// min / max that propagate NaN like jnp.minimum / torch.minimum (fmin would
// drop it and let a broken step through)
template <typename T> __device__ __forceinline__ T vmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}
template <typename T> __device__ __forceinline__ T vmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}

// a * b rounded on its own: nvcc never contracts it with the add that
// follows into an FMA
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// u widened to T.  Where T is wider than u's type the conversion is an
// instruction the compiler may neither merge with another nor hoist (asm
// volatile): each use of an operand held in the narrower type converts it
// anew (exactly), so G stays in registers at its own width instead of as a
// widened copy held through the loop, and the columns of W^{-1} G formed
// from it are not merged into one array held through the Newton solves.
template <typename T, typename U>
__device__ __forceinline__ T widen(U u) {
  if constexpr (std::is_same<T, U>::value) {
    return u;
  } else {
    static_assert(std::is_same<T, double>::value &&
                      std::is_same<U, float>::value,
                  "widen: float to double only");
    double d;
    asm volatile("cvt.f64.f32 %0, %1;" : "=d"(d) : "f"(u));
    return d;
  }
}

// ---- one SOC block, in slots OFF .. OFF+S-1 of a lane's row array --------
// A lane holds its rows in one register array; a block it owns lies whole in
// it, head first.  A block shorter than S is padded with zeros, which add
// exact zeros to every sum below.
//
// soc_quad and soc_ls compute what the plain version computes
// (ops/cones.py: soc_quad and _soc_linesearch), in its order: its sums in
// its order, its divisions, and each product rounded on its own (mul_rn,
// never contracted into an FMA).  Near the cone's boundary, where a
// collision constraint is active, x0^2 - |x1|^2, zeta and rn - rho0
// cancel, and how they round decides how a near-contact lane ends; in the
// plain version's order the kernel's iteration counts follow plain's.
// These blocks are only ever computed in double (see the header).
template <int S, int OFF, typename T, int N>
__device__ __forceinline__ T soc_quad(const T (&x)[N]) {
  T t = T(0);
#pragma unroll
  for (int i = 1; i < S; ++i) t += mul_rn(x[OFF + i], x[OFF + i]);
  return mul_rn(x[OFF], x[OFF]) - t;
}

template <int S, int OFF, typename T, int N>
__device__ __forceinline__ T soc_tail_norm(const T (&x)[N]) {
  T t = T(0);
#pragma unroll
  for (int i = 1; i < S; ++i) t += x[OFF + i] * x[OFF + i];
  return dsqrt(t);
}

// Nesterov-Todd scaling of one SOC block: eta, 1/eta, wbar (wbar' J wbar =
// 1) and 1/(1 + wbar0)
template <typename T, int S>
struct SocScale {
  T eta, ieta, iw, wb[S];
};

template <int S, int OFF, typename T, int N>
__device__ __forceinline__ void soc_nt(const T (&s)[N], const T (&z)[N],
                                       SocScale<T, S>& W) {
  const T tiny = T(1e-25);
  const T js = vmax(soc_quad<S, OFF>(s), tiny);
  const T jz = vmax(soc_quad<S, OFF>(z), tiny);
  const T rs = T(1) / dsqrt(js), rz = T(1) / dsqrt(jz);
  T d = T(0);
#pragma unroll
  for (int i = 0; i < S; ++i) d += (s[OFF + i] * rs) * (z[OFF + i] * rz);
  const T half_ig = T(1) / (T(2) * dsqrt((T(1) + d) / T(2)));
  W.wb[0] = (s[OFF] * rs + z[OFF] * rz) * half_ig;
#pragma unroll
  for (int i = 1; i < S; ++i)
    W.wb[i] = (s[OFF + i] * rs - z[OFF + i] * rz) * half_ig;
  W.eta = dpow(js / jz, T(0.25));
  W.ieta = T(1) / W.eta;
  W.iw = T(1) / (T(1) + W.wb[0]);
}

// o = eta Wbar v (INV = false) or its inverse, on the block's slots; v may
// be held in a narrower type than T (a row of G), widened here
template <bool INV, int S, int OFF, typename T, typename U, int N>
__device__ __forceinline__ void soc_apply(const SocScale<T, S>& W,
                                          const U (&v)[N], T (&o)[N]) {
  T w1v1 = T(0);
#pragma unroll
  for (int i = 1; i < S; ++i) w1v1 += W.wb[i] * widen<T>(v[OFF + i]);
  const T sg = INV ? T(-1) : T(1);
  const T sc = INV ? W.ieta : W.eta;
  const T v0 = widen<T>(v[OFF]);
  const T coef = sg * v0 + w1v1 * W.iw;
  const T head = W.wb[0] * v0 + sg * w1v1;
#pragma unroll
  for (int i = 1; i < S; ++i)
    o[OFF + i] = (widen<T>(v[OFF + i]) + coef * W.wb[i]) * sc;
  o[OFF] = head * sc;
}

template <int S, int OFF, typename T, int N>
__device__ __forceinline__ void soc_prod(const T (&u)[N], const T (&v)[N],
                                         T (&o)[N]) {
  T head = T(0);
#pragma unroll
  for (int i = 0; i < S; ++i) head += u[OFF + i] * v[OFF + i];
#pragma unroll
  for (int i = 1; i < S; ++i)
    o[OFF + i] = u[OFF] * v[OFF + i] + v[OFF] * u[OFF + i];
  o[OFF] = head;
}

// the inverse Jordan product's factors that depend on lambda only
template <typename T>
struct SocInv {
  T irho, iu, rho;
};

template <int S, int OFF, typename T, int N>
__device__ __forceinline__ void soc_inv_pre(const T (&u)[N], SocInv<T>& P) {
  P.rho = soc_quad<S, OFF>(u);
  P.irho = T(1) / P.rho;
  P.iu = T(1) / u[OFF];
}

// o with u o o = w on the block's slots, u the cached lambda
template <int S, int OFF, typename T, int N>
__device__ __forceinline__ void soc_inv(const T (&u)[N], const SocInv<T>& P,
                                        const T (&w)[N], T (&o)[N]) {
  T nu = T(0);
#pragma unroll
  for (int i = 1; i < S; ++i) nu += u[OFF + i] * w[OFF + i];
  const T a = nu * P.iu - w[OFF];
  const T b = P.rho * P.iu;
  const T head = u[OFF] * w[OFF] - nu;
#pragma unroll
  for (int i = 1; i < S; ++i)
    o[OFF + i] = (a * u[OFF + i] + b * w[OFF + i]) * P.irho;
  o[OFF] = head * P.irho;
}

// largest step in [0, 1] keeping y + a d in the SOC block, as
// ops/cones.py::_soc_linesearch computes it (see soc_quad)
template <int S, int OFF, typename T, int N>
__device__ __forceinline__ T soc_ls(const T (&y)[N], const T (&d)[N]) {
  const T tiny = T(1e-25);
  const T nu = vmax(soc_quad<S, OFF>(y), tiny);
  const T sq = dsqrt(nu);
  T yd = T(0);
#pragma unroll
  for (int i = 1; i < S; ++i) yd += mul_rn(y[OFF + i], d[OFF + i]);
  const T zeta = mul_rn(y[OFF], d[OFF]) - yd;
  const T rho0 = zeta / nu;
  const T coef = (zeta / sq + d[OFF]) / (y[OFF] / sq + T(1));
  T rn = T(0);
#pragma unroll
  for (int i = 1; i < S; ++i) {
    const T r = d[OFF + i] / sq - mul_rn(coef, y[OFF + i]) / nu;
    rn += mul_rn(r, r);
  }
  rn = dsqrt(rn);
  const T lim = T(1) / vmax(rn - rho0, tiny);
  return rn > rho0 ? vmin(T(1), lim) : T(1);
}

// ---- the team -------------------------------------------------------------
// Rows of the problem are dealt to the TEAM lanes so that a cone block never
// straddles two lanes: lane l holds orthant rows l, l + TEAM, ... (RO of
// them) in slots 0 .. RO-1, and SOC block l (block 1 or 2 of those present)
// whole in the next SMAX slots.  Slots a lane does not fill hold zeros.
template <typename T, int NV, int NORT, int S1, int S2, int TEAM>
struct Team {
  static_assert(TEAM >= 2 && TEAM <= 32 && (TEAM & (TEAM - 1)) == 0,
                "TEAM must be a power of two from 2 to 32");
  static constexpr int NR = NORT + S1 + S2;
  static constexpr int NSOC = (S1 > 0) + (S2 > 0);
  static constexpr int DEG = NORT + NSOC;
  static constexpr int NL = NV * (NV + 1) / 2;
  static constexpr int RO = (NORT + TEAM - 1) / TEAM;  // orthant slots
  static constexpr int NB = NSOC > 0;  // blocks a lane can hold
  static constexpr int SMAX = S1 > S2 ? S1 : S2;
  static constexpr int RS = RO + NB * SMAX;  // slots a lane holds
  static constexpr int RS_ = RS > 0 ? RS : 1;
  // the present SOC blocks: row offset and size of the first and second
  static constexpr int BO0 = S1 > 0 ? NORT : NORT + S1;
  static constexpr int BS0 = S1 > 0 ? S1 : S2;
  static constexpr int BO1 = NORT + S1;
  static constexpr int BS1 = S2;
  static constexpr int NB_ = NB > 0 ? NB : 1;
  static constexpr int SM_ = SMAX > 0 ? SMAX : 1;

  typedef T Rows[RS_];  // a row-indexed vector: the rows this lane holds
  typedef T Col[NV];    // replicated on every lane

  struct Scaling {
    T w[RO > 0 ? RO : 1], wi[RO > 0 ? RO : 1];  // orthant: sqrt(s/z), 1/that
    SocScale<T, SM_> k[NB_];
  };
  struct InvPre {
    T ol[RO > 0 ? RO : 1];  // orthant: 1/lambda
    SocInv<T> k[NB_];
  };

  unsigned mask;  // the team's lanes within the warp
  int lane;       // 0 .. TEAM-1

  // block slot offset of the lane's j-th block
  static __host__ __device__ constexpr int boff(int j) { return RO + j * SMAX; }
  // whether the lane holds a block (its j-th, j = 0): lane l holds present
  // block l
  __device__ __forceinline__ bool has(int j) const {
    return NB > 0 && lane < NSOC;
  }
  __device__ __forceinline__ bool ort(int q) const {
    return q < RO && lane + TEAM * q < NORT;
  }
  // the problem row held in slot q, and whether the slot holds one
  __device__ __forceinline__ int row(int q) const {
    if (q < RO) return lane + TEAM * q;
    const int j = (q - RO) / SM_, i = (q - RO) % SM_;
    return (lane == 0 ? BO0 : BO1) + i;
  }
  __device__ __forceinline__ bool valid(int q) const {
    if (q < RO) return ort(q);
    const int j = (q - RO) / SM_, i = (q - RO) % SM_;
    return has(j) && i < (lane == 0 ? BS0 : BS1);
  }

  static __device__ __forceinline__ int li(int i, int j) {
    return i * (i + 1) / 2 + j;
  }
  // f(std::integral_constant<int, j>) for each block j the lane can hold
  template <class F>
  static __device__ __forceinline__ void blocks(F&& f) {
    if constexpr (NB > 0) f(std::integral_constant<int, 0>());
  }

  // ---- reductions over the team -----------------------------------------
  template <int N>
  __device__ __forceinline__ void sum_n(T (&v)[N]) const {
#pragma unroll
    for (int o = TEAM / 2; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < N; ++i) v[i] += __shfl_xor_sync(mask, v[i], o, TEAM);
  }
  __device__ __forceinline__ T sum(T v) const {
    T a[1] = {v};
    sum_n(a);
    return a[0];
  }
  // min / max: a butterfly, then lane 0's result, so that every lane holds
  // the same bits even where +0 and -0 tie
  __device__ __forceinline__ T min(T v) const {
#pragma unroll
    for (int o = TEAM / 2; o > 0; o >>= 1)
      v = vmin(v, __shfl_xor_sync(mask, v, o, TEAM));
    return __shfl_sync(mask, v, 0, TEAM);
  }
  __device__ __forceinline__ T max(T v) const {
#pragma unroll
    for (int o = TEAM / 2; o > 0; o >>= 1)
      v = vmax(v, __shfl_xor_sync(mask, v, o, TEAM));
    return __shfl_sync(mask, v, 0, TEAM);
  }
  __device__ __forceinline__ bool all(bool p) const {
    return __all_sync(mask, p) != 0;
  }

  // zero the slots the lane does not fill (a block shorter than SMAX, or no
  // block): they must stay zero through every operation
  __device__ __forceinline__ void clean(Rows& o) const {
#pragma unroll
    for (int q = RO; q < RS; ++q)
      if (!valid(q)) o[q] = T(0);
  }

  // ---- composite-cone operations ----------------------------------------
  __device__ __forceinline__ void nt(const Rows& s, const Rows& z,
                                     Scaling& W) const {
#pragma unroll
    for (int k = 0; k < RO; ++k) {
      W.w[k] = ort(k) ? dsqrt(s[k] / z[k]) : T(1);
      W.wi[k] = T(1) / W.w[k];
    }
    blocks([&](auto J) {
      constexpr int j = decltype(J)::value;
      soc_nt<SMAX, boff(j)>(s, z, W.k[j]);
    });
  }

  // o = W v (INV = false) or W^{-1} v (INV = true); o may not alias v,
  // which may be held in a narrower type (a column of G)
  template <bool INV, typename U>
  __device__ __forceinline__ void wapply(const Scaling& W, const U (&v)[RS_],
                                         Rows& o) const {
#pragma unroll
    for (int k = 0; k < RO; ++k)
      o[k] = ort(k) ? widen<T>(v[k]) * (INV ? W.wi[k] : W.w[k]) : T(0);
    blocks([&](auto J) {
      constexpr int j = decltype(J)::value;
      soc_apply<INV, SMAX, boff(j)>(W.k[j], v, o);
    });
    clean(o);
  }

  __device__ __forceinline__ void prod(const Rows& u, const Rows& v,
                                       Rows& o) const {
#pragma unroll
    for (int k = 0; k < RO; ++k) o[k] = ort(k) ? u[k] * v[k] : T(0);
    blocks([&](auto J) { soc_prod<SMAX, boff(decltype(J)::value)>(u, v, o); });
    clean(o);
  }

  __device__ __forceinline__ void inv_pre(const Rows& lam, InvPre& P) const {
#pragma unroll
    for (int k = 0; k < RO; ++k) P.ol[k] = ort(k) ? T(1) / lam[k] : T(0);
    blocks([&](auto J) {
      constexpr int j = decltype(J)::value;
      soc_inv_pre<SMAX, boff(j)>(lam, P.k[j]);
    });
  }

  __device__ __forceinline__ void inv_prod(const Rows& lam, const InvPre& P,
                                           const Rows& v, Rows& o) const {
#pragma unroll
    for (int k = 0; k < RO; ++k) o[k] = ort(k) ? v[k] * P.ol[k] : T(0);
    blocks([&](auto J) {
      constexpr int j = decltype(J)::value;
      soc_inv<SMAX, boff(j)>(lam, P.k[j], v, o);
    });
    clean(o);
  }

  // sum over rows of u * v (unfilled slots hold zeros)
  __device__ __forceinline__ T dot(const Rows& u, const Rows& v) const {
    T t = T(0);
#pragma unroll
    for (int q = 0; q < RS; ++q) t += u[q] * v[q];
    return sum(t);
  }

  // largest step in [0, 1] keeping y + a d in the cone
  __device__ __forceinline__ T linesearch(const Rows& y, const Rows& d) const {
    T a = T(1);
#pragma unroll
    for (int k = 0; k < RO; ++k)
      if (ort(k) && d[k] < T(0)) a = vmin(a, -y[k] / d[k]);
    blocks([&](auto J) {
      constexpr int j = decltype(J)::value;
      if (has(j)) a = vmin(a, soc_ls<SMAX, boff(j)>(y, d));
    });
    return min(a);
  }

  __device__ __forceinline__ void add_e(Rows& r, T m) const {
#pragma unroll
    for (int k = 0; k < RO; ++k)
      if (ort(k)) r[k] += m;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (has(j)) r[boff(j)] += m;
  }

  // shift r along the cone identity until strictly feasible
  __device__ __forceinline__ void bring2cone(Rows& r) const {
    T a = -INFINITY;
#pragma unroll
    for (int k = 0; k < RO; ++k)
      if (ort(k)) a = vmax(a, -r[k]);
    blocks([&](auto J) {
      constexpr int j = decltype(J)::value;
      if (has(j))
        a = vmax(a, -(r[boff(j)] - soc_tail_norm<SMAX, boff(j)>(r)));
    });
    a = max(a);
    if (!(a < T(0))) add_e(r, T(1) + a);
  }

  // ---- dense algebra on the (nr x nv) columns ---------------------------
  // A column array (G, or W^{-1} G) and a row vector may be held in a
  // narrower type U than T; each entry is widened where it is used.
  template <typename U>
  __device__ __forceinline__ void matvec(const U (&g)[NV][RS_], const Col& x,
                                         Rows& o) const {
#pragma unroll
    for (int q = 0; q < RS; ++q) {
      T t = T(0);
#pragma unroll
      for (int v = 0; v < NV; ++v) t += widen<T>(g[v][q]) * x[v];
      o[q] = t;
    }
  }

  template <typename U, typename V>
  __device__ __forceinline__ void rmatvec(const U (&g)[NV][RS_],
                                          const V (&z)[RS_], Col& o) const {
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      T t = T(0);
#pragma unroll
      for (int q = 0; q < RS; ++q) t += widen<T>(g[v][q]) * widen<T>(z[q]);
      o[v] = t;
    }
    sum_n(o);
  }
  // L L' = A'A + jitter * mean(diag) I; also the reciprocal diagonal
  template <typename U>
  __device__ __forceinline__ void gram_chol(const U (&a)[NV][RS_], T jitter,
                                            T (&L)[NL], Col& rd) const {
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T t = T(0);
#pragma unroll
        for (int q = 0; q < RS; ++q)
          t += widen<T>(a[i][q]) * widen<T>(a[j][q]);
        L[li(i, j)] = t;
      }
    sum_n(L);
    if (jitter != T(0)) {
      T tr = T(0);
#pragma unroll
      for (int i = 0; i < NV; ++i) tr += L[li(i, i)];
      const T eps = jitter * (tr / T(NV));
#pragma unroll
      for (int i = 0; i < NV; ++i) L[li(i, i)] += eps;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T s = L[li(i, j)];
#pragma unroll
        for (int k = 0; k < j; ++k) s -= L[li(i, k)] * L[li(j, k)];
        if (i == j) {
          L[li(i, i)] = dsqrt(s);
          rd[i] = T(1) / L[li(i, i)];
        } else {
          L[li(i, j)] = s * rd[j];
        }
      }
    }
  }

  // The factor as chol_solve reads it: l(i, k) below the diagonal and
  // r(i) = 1 / L(i, i).  Held in registers (the cold start's), or once per
  // team in shared memory with r in the diagonal's slots (the loop's: the
  // factor is the same on every lane, and eight copies of it in registers
  // would not leave room for a float64 iterate).  The shared copy is read
  // through a volatile pointer, so the compiler reloads it at each use
  // instead of holding it in registers between the two Newton solves.
  struct RegFactor {
    const T (&L)[NL];
    const Col& rd;
    __device__ __forceinline__ T l(int i, int k) const { return L[li(i, k)]; }
    __device__ __forceinline__ T r(int i) const { return rd[i]; }
  };
  struct SharedFactor {
    volatile T* p;
    __device__ __forceinline__ T l(int i, int k) const { return p[li(i, k)]; }
    __device__ __forceinline__ T r(int i) const { return p[li(i, i)]; }
  };

  // write the factor to the team's slot p (lane 0 writes it for the team)
  __device__ __forceinline__ SharedFactor share(const T (&L)[NL],
                                                const Col& rd,
                                                volatile T* p) const {
    __syncwarp(mask);  // every lane is done with the previous factor
    if (lane == 0) {
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int j = 0; j <= i; ++j)
          p[li(i, j)] = i == j ? rd[i] : L[li(i, j)];
    }
    __syncwarp(mask);
    return SharedFactor{p};
  }

  template <class F>
  static __device__ __forceinline__ void chol_solve(const F& f, const Col& b,
                                                    Col& x) {
    Col y;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      T s = b[i];
#pragma unroll
      for (int k = 0; k < i; ++k) s -= f.l(i, k) * y[k];
      y[i] = s * f.r(i);
    }
#pragma unroll
    for (int i = NV - 1; i >= 0; --i) {
      T s = y[i];
#pragma unroll
      for (int k = i + 1; k < NV; ++k) s -= f.l(k, i) * x[k];
      x[i] = s * f.r(i);
    }
  }

  // one Newton solve of the scaled KKT system for right-hand side lam_ds.
  // (W^{-1} G)' bz and (W^{-1} G) dx are taken a column of W^{-1} G at a
  // time, each formed from G where it is used, in the sums' order of
  // rmatvec and matvec: the same values as from W^{-1} G held whole (which
  // the compiler does where G is held in T)
  template <typename U, class F>
  __device__ __forceinline__ void newton(
      const U (&g)[NV][RS_], const F& fac, const Scaling& W, const Col& rx,
      const Rows& rz, const Rows& lam_ds, Col& dx, Rows& ds,
      Rows& dz) const {
    Rows t, bz, col;
    wapply<false>(W, lam_ds, t);
#pragma unroll
    for (int q = 0; q < RS; ++q) t[q] = -rz[q] - t[q];
    wapply<true>(W, t, bz);
    Col bv;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      wapply<true>(W, g[v], col);
      T a = T(0);
#pragma unroll
      for (int q = 0; q < RS; ++q) a += col[q] * bz[q];
      bv[v] = a;
    }
    sum_n(bv);
#pragma unroll
    for (int v = 0; v < NV; ++v) bv[v] = -rx[v] + bv[v];
    chol_solve(fac, bv, dx);
#pragma unroll
    for (int q = 0; q < RS; ++q) t[q] = T(0);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      wapply<true>(W, g[v], col);
#pragma unroll
      for (int q = 0; q < RS; ++q) t[q] += col[q] * dx[v];
    }
#pragma unroll
    for (int q = 0; q < RS; ++q) t[q] -= bz[q];
    wapply<true>(W, t, dz);
    wapply<false>(W, dz, t);
#pragma unroll
    for (int q = 0; q < RS; ++q) t[q] = lam_ds[q] - t[q];
    wapply<false>(W, t, ds);
  }
};

// S: the storage type of operands and results; T: the arithmetic type
template <typename S, typename T, int NV, int NORT, int S1, int S2, int TEAM,
          bool WARM, bool SKIP>
__global__ void __launch_bounds__(kThreads)
pdip_kernel(const S* __restrict__ Gg, const S* __restrict__ hg,
            const S* __restrict__ cg, const S* __restrict__ xw,
            const S* __restrict__ sw, const S* __restrict__ zw,
            const bool* __restrict__ skip, S* __restrict__ xo,
            S* __restrict__ so, S* __restrict__ zo, int* __restrict__ it_o,
            bool* __restrict__ conv_o, int B, T tol, T jitter, T margin,
            int max_iters) {
  typedef Team<T, NV, NORT, S1, S2, TEAM> P;   // iterates in T
  typedef Team<S, NV, NORT, S1, S2, TEAM> PS;  // the warm start, in S
  constexpr int NR = P::NR, RS = P::RS;
  // each team's Cholesky factor of the current iterate (Team::share)
  __shared__ T factors[kThreads / TEAM][P::NL];
  const int b = (blockIdx.x * kThreads + threadIdx.x) / TEAM;
  if (b >= B) return;  // the whole team leaves together
  P tm;
  tm.lane = threadIdx.x % TEAM;
  const int wl = threadIdx.x % 32;
  tm.mask = TEAM == 32 ? 0xffffffffu
                       : ((1u << (TEAM % 32)) - 1u) << (wl & ~(TEAM - 1));
  const size_t bv = (size_t)b * NV, br = (size_t)b * NR;
  // a skipped problem returns its warm-initialised iterate: it reads only
  // the warm x, s and z, not G, h or c (the flag is the same on every lane)
  const bool skipped = SKIP && skip[b];

  // G, h and c as read, in S (see the header)
  typename PS::Rows g[NV], h;
  typename PS::Col c;
#pragma unroll
  for (int q = 0; q < RS; ++q) {
    const bool ok = !skipped && tm.valid(q);
    const size_t r = br + (ok ? tm.row(q) : 0);
#pragma unroll
    for (int v = 0; v < NV; ++v) g[v][q] = ok ? Gg[r * NV + v] : S(0);
    h[q] = ok ? hg[r] : S(0);
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) c[v] = skipped ? S(0) : cg[bv + v];

  typename P::Rows s, z;
  typename P::Col x;
  if (WARM) {
    PS tw;
    tw.lane = tm.lane;
    tw.mask = tm.mask;
    typename PS::Rows ws, wz;
#pragma unroll
    for (int v = 0; v < NV; ++v) x[v] = T(xw[bv + v]);
#pragma unroll
    for (int q = 0; q < RS; ++q) {
      const bool ok = tm.valid(q);
      const size_t r = br + (ok ? tm.row(q) : 0);
      ws[q] = ok ? sw[r] : S(0);
      wz[q] = ok ? zw[r] : S(0);
    }
    tw.add_e(ws, S(margin));
    tw.add_e(wz, S(margin));
    tw.bring2cone(ws);
    tw.bring2cone(wz);
#pragma unroll
    for (int q = 0; q < RS; ++q) {
      s[q] = T(ws[q]);
      z[q] = T(wz[q]);
    }
  } else {
    // least-squares start: x = (G'G)^{-1} G'h, s = G x - h, z = G (G'G)^{-1}(-c)
    T L[P::NL];
    typename P::Col rd, t, xd;
    tm.gram_chol(g, jitter, L, rd);
    tm.rmatvec(g, h, t);
    P::chol_solve(typename P::RegFactor{L, rd}, t, x);
    tm.matvec(g, x, s);
#pragma unroll
    for (int q = 0; q < RS; ++q) s[q] -= widen<T>(h[q]);
    tm.bring2cone(s);
#pragma unroll
    for (int v = 0; v < NV; ++v) t[v] = -widen<T>(c[v]);
    P::chol_solve(typename P::RegFactor{L, rd}, t, xd);
    tm.matvec(g, xd, z);
    tm.bring2cone(z);
  }

  int iters = 0;
  bool done = skipped;
  const T inv_deg = T(1) / T(P::DEG);
  for (int it = 0; it < max_iters && !done; ++it) {
    // done test on the entry iterate, before the step
    const T sz = tm.dot(s, z);
    const T mu = sz * inv_deg;
    if (!dfinite(mu) || mu < tol) break;

    typename P::Scaling W;
    tm.nt(s, z, W);
    typename P::Rows lam, lamlam, rz, t;
    tm.template wapply<false>(W, z, lam);
    tm.prod(lam, lam, lamlam);
    typename P::Col rx;
    tm.rmatvec(g, z, rx);
#pragma unroll
    for (int v = 0; v < NV; ++v) rx[v] += widen<T>(c[v]);
    tm.matvec(g, x, rz);
#pragma unroll
    for (int q = 0; q < RS; ++q) rz[q] += s[q] - widen<T>(h[q]);

    typename P::SharedFactor fac;
    {
      typename P::Rows gt[NV];  // W^{-1} G, for its Gram matrix
#pragma unroll
      for (int v = 0; v < NV; ++v) tm.template wapply<true>(W, g[v], gt[v]);
      T L[P::NL];
      typename P::Col rd;
      tm.gram_chol(gt, jitter, L, rd);
      fac = tm.share(L, rd, factors[threadIdx.x / TEAM]);
    }

    typename P::InvPre ip;
    tm.inv_pre(lam, ip);

    // affine (predictor) step
    typename P::Rows lam_ds, ds_a, dz_a;
    typename P::Col dx;
#pragma unroll
    for (int q = 0; q < RS; ++q) t[q] = -lamlam[q];
    tm.inv_prod(lam, ip, t, lam_ds);
    tm.newton(g, fac, W, rx, rz, lam_ds, dx, ds_a, dz_a);
    const T a_aff = vmin(tm.linesearch(s, ds_a), tm.linesearch(z, dz_a));
    T num = T(0);
#pragma unroll
    for (int q = 0; q < RS; ++q)
      num += (s[q] + a_aff * ds_a[q]) * (z[q] + a_aff * dz_a[q]);
    const T rho = tm.sum(num) / sz;
    // clip(rho, 0, 1)^3 with NaN passed through
    const T rc = rho < T(0) ? T(0) : (rho > T(1) ? T(1) : rho);
    const T sm = rc * rc * rc * mu;

    // centering + corrector step
    typename P::Rows u, v2;
    tm.template wapply<true>(W, ds_a, u);
    tm.template wapply<false>(W, dz_a, v2);
    tm.prod(u, v2, t);
#pragma unroll
    for (int q = 0; q < RS; ++q) t[q] = -lamlam[q] - t[q];
    tm.add_e(t, sm);
    tm.inv_prod(lam, ip, t, lam_ds);
    typename P::Rows ds, dz;
    tm.newton(g, fac, W, rx, rz, lam_ds, dx, ds, dz);
    const T a = vmin(T(1), T(0.99) * vmin(tm.linesearch(s, ds),
                                          tm.linesearch(z, dz)));

    // apply only a finite candidate; otherwise freeze for good
    bool good = true;
    typename P::Col xn;
    typename P::Rows sn, zn;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      xn[v] = x[v] + a * dx[v];
      good = good && dfinite(xn[v]);
    }
#pragma unroll
    for (int q = 0; q < RS; ++q) {
      sn[q] = s[q] + a * ds[q];
      zn[q] = z[q] + a * dz[q];
      good = good && dfinite(sn[q]) && dfinite(zn[q]);
    }
    if (!tm.all(good)) break;
#pragma unroll
    for (int v = 0; v < NV; ++v) x[v] = xn[v];
#pragma unroll
    for (int q = 0; q < RS; ++q) {
      s[q] = sn[q];
      z[q] = zn[q];
    }
    ++iters;
  }

  // the flag from the final iterate in T; x, s and z rounded to S
  const T mu_f = tm.dot(s, z) * inv_deg;
#pragma unroll
  for (int v = 0; v < NV; ++v)
    if (v % TEAM == tm.lane) xo[bv + v] = S(x[v]);
#pragma unroll
  for (int q = 0; q < RS; ++q)
    if (tm.valid(q)) {
      so[br + tm.row(q)] = S(s[q]);
      zo[br + tm.row(q)] = S(z[q]);
    }
  if (tm.lane == 0) {
    it_o[b] = iters;
    conv_o[b] = dfinite(mu_f) && mu_f < tol;
  }
}

typedef DCOL_T Real;  // storage
typedef DCOL_A Acc;   // arithmetic
static_assert(sizeof(Acc) >= sizeof(Real),
              "the arithmetic type is at least as wide as the storage type");
constexpr int kNV = DCOL_NV, kNORT = DCOL_NORT, kS1 = DCOL_S1, kS2 = DCOL_S2;
constexpr int kTeam = DCOL_TEAM;

template <bool WARM, bool SKIP>
void launch(const void* G, const void* h, const void* c, const void* xw,
            const void* sw, const void* zw, const void* skip, void* x, void* s,
            void* z, void* iters, void* conv, int B, double tol, double jitter,
            double margin, int max_iters, cudaStream_t stream) {
  const long long threads = (long long)B * kTeam;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  pdip_kernel<Real, Acc, kNV, kNORT, kS1, kS2, kTeam, WARM, SKIP>
      <<<blocks, kThreads, 0, stream>>>(
          (const Real*)G, (const Real*)h, (const Real*)c, (const Real*)xw,
          (const Real*)sw, (const Real*)zw, (const bool*)skip, (Real*)x,
          (Real*)s, (Real*)z, (int*)iters, (bool*)conv, B, (Acc)tol,
          (Acc)jitter, (Acc)margin, max_iters);
}

}  // namespace

extern "C" {

// What this library was built for: {sizeof(storage type), sizeof(arithmetic
// type), NV, NORT, S1, S2}.
int dcol_pdip_layout(int* out) {
  out[0] = (int)sizeof(Real);
  out[1] = (int)sizeof(Acc);
  out[2] = kNV;
  out[3] = kNORT;
  out[4] = kS1;
  out[5] = kS2;
  return 0;
}

// The lanes of the team that solves one problem.
int dcol_pdip_team() { return kTeam; }

// Solve B problems.  Operands are row-major and contiguous, as the solver's
// callers hold them: G (B, nr, nv); h, s, z (B, nr); c, x (B, nv); skip,
// iters, conv (B).  xw/sw/zw null = cold start; skip null = no skip lanes
// (skip needs the warm operands).  Returns cudaGetLastError() after the
// launch.
int dcol_pdip_solve(const void* G, const void* h, const void* c,
                    const void* xw, const void* sw, const void* zw,
                    const void* skip, void* x, void* s, void* z, void* iters,
                    void* conv, int B, double tol, double jitter,
                    double margin, int max_iters, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (xw == nullptr) {
    if (skip != nullptr) return (int)cudaErrorInvalidValue;
    launch<false, false>(G, h, c, xw, sw, zw, skip, x, s, z, iters, conv, B,
                         tol, jitter, margin, max_iters, st);
  } else if (skip == nullptr) {
    launch<true, false>(G, h, c, xw, sw, zw, skip, x, s, z, iters, conv, B,
                        tol, jitter, margin, max_iters, st);
  } else {
    launch<true, true>(G, h, c, xw, sw, zw, skip, x, s, z, iters, conv, B,
                       tol, jitter, margin, max_iters, st);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
