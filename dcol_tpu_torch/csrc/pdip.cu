// Batched PDIP conic solver: one tiny SOCP per thread, for NVIDIA Hopper.
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
// What bounds it on the card: arithmetic and registers, not memory.  A
// problem is nv <= 6 columns by nr <= 13 rows; one Mehrotra iteration is a
// few thousand dependent flops (two Cholesky solves, ~10 scaling applies,
// four cone line searches, ~50 divides/square roots) against ~100 values of
// input read once.  The per-problem working set (G, W^{-1}G, L, x, s, z and
// the search directions) is the constraint: G and W^{-1}G alone are 2*nv*nr
// values, 156 for the (6, 13) layout, which is over the 255-register limit
// once everything else is live.
//
// What the design does about it:
//   * one problem per thread, 128 threads a block, grid = ceil(B/128), the
//     ragged edge masked; problems never talk to each other, so there is no
//     shared memory, no synchronisation and no divergence between problems
//     except the data-dependent exit (a thread leaves the loop when its
//     problem is done);
//   * the layout (NV, NORT, S1, S2) and the type are template parameters
//     fixed by -D defines at build time, so every loop unrolls and every
//     per-problem vector is a register array with constant indices;
//   * operands are struct-of-arrays in device memory (G as (nv*nr, B), h as
//     (nr, B), ...), so neighbouring threads read neighbouring addresses and
//     every load and store is coalesced;
//   * divides used more than once are taken once as reciprocals.
// Spills for the widest layouts are accepted in this version (ptxas -v
// reports them); keeping G in shared memory is the next step.

#include <cuda_runtime.h>
#include <math.h>

#if !defined(DCOL_T) || !defined(DCOL_NV) || !defined(DCOL_NORT) || \
    !defined(DCOL_S1) || !defined(DCOL_S2)
#error "build with -DDCOL_T=float|double -DDCOL_NV= -DDCOL_NORT= -DDCOL_S1= -DDCOL_S2="
#endif

namespace {

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

template <typename T, int NV, int NORT, int S1, int S2>
struct Pdip {
  static constexpr int NR = NORT + S1 + S2;
  static constexpr int DEG = NORT + (S1 > 0) + (S2 > 0);
  static constexpr int O1 = NORT;       // row offset of SOC block 1
  static constexpr int O2 = NORT + S1;  // row offset of SOC block 2
  static constexpr int NL = NV * (NV + 1) / 2;
  static constexpr int NO_ = NORT > 0 ? NORT : 1;
  static constexpr int S1_ = S1 > 0 ? S1 : 1;
  static constexpr int S2_ = S2 > 0 ? S2 : 1;

  typedef T Vec[NR];
  typedef T Col[NV];

  static __device__ __forceinline__ T tiny() { return T(1e-25); }

  // Nesterov-Todd scaling: orthant w = sqrt(s/z) (and 1/w); per SOC block
  // eta, 1/eta, wbar (wbar' J wbar = 1) and 1/(1 + wbar0).
  struct Scaling {
    T w[NO_], wi[NO_];
    T eta1, ieta1, iw1, wb1[S1_];
    T eta2, ieta2, iw2, wb2[S2_];
  };

  static __device__ __forceinline__ int li(int i, int j) {
    return i * (i + 1) / 2 + j;
  }

  // ---- SOC helpers (block at row offset O, size S) ----------------------
  template <int O, int S>
  static __device__ __forceinline__ T soc_quad(const Vec& x) {
    T t = T(0);
#pragma unroll
    for (int i = 1; i < S; ++i) t += x[O + i] * x[O + i];
    return x[O] * x[O] - t;
  }

  template <int O, int S>
  static __device__ __forceinline__ T soc_tail_norm(const Vec& x) {
    T t = T(0);
#pragma unroll
    for (int i = 1; i < S; ++i) t += x[O + i] * x[O + i];
    return dsqrt(t);
  }

  template <int O, int S>
  static __device__ __forceinline__ void soc_nt(const Vec& s, const Vec& z,
                                                T& eta, T& ieta, T& iw,
                                                T (&wb)[S]) {
    const T js = vmax(soc_quad<O, S>(s), tiny());
    const T jz = vmax(soc_quad<O, S>(z), tiny());
    const T rs = T(1) / dsqrt(js), rz = T(1) / dsqrt(jz);
    T d = T(0);
#pragma unroll
    for (int i = 0; i < S; ++i) d += (s[O + i] * rs) * (z[O + i] * rz);
    const T half_ig = T(1) / (T(2) * dsqrt((T(1) + d) / T(2)));
    wb[0] = (s[O] * rs + z[O] * rz) * half_ig;
#pragma unroll
    for (int i = 1; i < S; ++i) wb[i] = (s[O + i] * rs - z[O + i] * rz) * half_ig;
    eta = dpow(js / jz, T(0.25));
    ieta = T(1) / eta;
    iw = T(1) / (T(1) + wb[0]);
  }

  template <bool INV, int O, int S>
  static __device__ __forceinline__ void soc_apply(T eta, T ieta, T iw,
                                                   const T (&wb)[S],
                                                   const Vec& v, Vec& o) {
    T w1v1 = T(0);
#pragma unroll
    for (int i = 1; i < S; ++i) w1v1 += wb[i] * v[O + i];
    const T sg = INV ? T(-1) : T(1);
    const T sc = INV ? ieta : eta;
    const T coef = sg * v[O] + w1v1 * iw;
    const T head = wb[0] * v[O] + sg * w1v1;
#pragma unroll
    for (int i = 1; i < S; ++i) o[O + i] = (v[O + i] + coef * wb[i]) * sc;
    o[O] = head * sc;
  }

  // ---- composite-cone operations -----------------------------------------
  static __device__ __forceinline__ void nt(const Vec& s, const Vec& z,
                                            Scaling& W) {
#pragma unroll
    for (int i = 0; i < NORT; ++i) {
      W.w[i] = dsqrt(s[i] / z[i]);
      W.wi[i] = T(1) / W.w[i];
    }
    if constexpr (S1 > 0) soc_nt<O1, S1>(s, z, W.eta1, W.ieta1, W.iw1, W.wb1);
    if constexpr (S2 > 0) soc_nt<O2, S2>(s, z, W.eta2, W.ieta2, W.iw2, W.wb2);
  }

  // o = W v (INV = false) or W^{-1} v (INV = true); o may not alias v
  template <bool INV>
  static __device__ __forceinline__ void wapply(const Scaling& W,
                                                const Vec& v, Vec& o) {
#pragma unroll
    for (int i = 0; i < NORT; ++i) o[i] = v[i] * (INV ? W.wi[i] : W.w[i]);
    if constexpr (S1 > 0)
      soc_apply<INV, O1, S1>(W.eta1, W.ieta1, W.iw1, W.wb1, v, o);
    if constexpr (S2 > 0)
      soc_apply<INV, O2, S2>(W.eta2, W.ieta2, W.iw2, W.wb2, v, o);
  }

  template <int O, int S>
  static __device__ __forceinline__ void soc_prod(const Vec& u, const Vec& v,
                                                  Vec& o) {
    T head = T(0);
#pragma unroll
    for (int i = 0; i < S; ++i) head += u[O + i] * v[O + i];
#pragma unroll
    for (int i = 1; i < S; ++i) o[O + i] = u[O] * v[O + i] + v[O] * u[O + i];
    o[O] = head;
  }

  static __device__ __forceinline__ void prod(const Vec& u, const Vec& v,
                                              Vec& o) {
#pragma unroll
    for (int i = 0; i < NORT; ++i) o[i] = u[i] * v[i];
    if constexpr (S1 > 0) soc_prod<O1, S1>(u, v, o);
    if constexpr (S2 > 0) soc_prod<O2, S2>(u, v, o);
  }

  // reciprocals of the inverse Jordan product that depend on lam only
  struct InvPre {
    T ol[NO_];
    T irho1, iu1, rho1;
    T irho2, iu2, rho2;
  };

  template <int O, int S>
  static __device__ __forceinline__ void soc_inv_pre(const Vec& u, T& irho,
                                                     T& iu, T& rho) {
    rho = soc_quad<O, S>(u);
    irho = T(1) / rho;
    iu = T(1) / u[O];
  }

  static __device__ __forceinline__ void inv_pre(const Vec& lam, InvPre& P) {
#pragma unroll
    for (int i = 0; i < NORT; ++i) P.ol[i] = T(1) / lam[i];
    if constexpr (S1 > 0) soc_inv_pre<O1, S1>(lam, P.irho1, P.iu1, P.rho1);
    if constexpr (S2 > 0) soc_inv_pre<O2, S2>(lam, P.irho2, P.iu2, P.rho2);
  }

  // o with u o o = w (SOC block), u the cached lam
  template <int O, int S>
  static __device__ __forceinline__ void soc_inv(const Vec& u, const Vec& w,
                                                 T irho, T iu, T rho, Vec& o) {
    T nu = T(0);
#pragma unroll
    for (int i = 1; i < S; ++i) nu += u[O + i] * w[O + i];
    const T a = nu * iu - w[O];
    const T b = rho * iu;
    const T head = u[O] * w[O] - nu;
#pragma unroll
    for (int i = 1; i < S; ++i) o[O + i] = (a * u[O + i] + b * w[O + i]) * irho;
    o[O] = head * irho;
  }

  static __device__ __forceinline__ void inv_prod(const Vec& lam,
                                                  const InvPre& P,
                                                  const Vec& v, Vec& o) {
#pragma unroll
    for (int i = 0; i < NORT; ++i) o[i] = v[i] * P.ol[i];
    if constexpr (S1 > 0) soc_inv<O1, S1>(lam, v, P.irho1, P.iu1, P.rho1, o);
    if constexpr (S2 > 0) soc_inv<O2, S2>(lam, v, P.irho2, P.iu2, P.rho2, o);
  }

  static __device__ __forceinline__ T dot(const Vec& u, const Vec& v) {
    T t = T(0);
#pragma unroll
    for (int i = 0; i < NR; ++i) t += u[i] * v[i];
    return t;
  }

  // largest step in [0, 1] keeping y + a d in the SOC block
  template <int O, int S>
  static __device__ __forceinline__ T soc_ls(const Vec& y, const Vec& d) {
    const T nu = vmax(soc_quad<O, S>(y), tiny());
    const T sq = dsqrt(nu);
    const T isq = T(1) / sq, inu = T(1) / nu;
    T zeta = y[O] * d[O];
#pragma unroll
    for (int i = 1; i < S; ++i) zeta -= y[O + i] * d[O + i];
    const T rho0 = zeta * inu;
    const T coef = (zeta * isq + d[O]) / (y[O] * isq + T(1));
    T rn = T(0);
#pragma unroll
    for (int i = 1; i < S; ++i) {
      const T r = d[O + i] * isq - coef * y[O + i] * inu;
      rn += r * r;
    }
    rn = dsqrt(rn);
    const T lim = T(1) / vmax(rn - rho0, tiny());
    return rn > rho0 ? vmin(T(1), lim) : T(1);
  }

  static __device__ __forceinline__ T linesearch(const Vec& y, const Vec& d) {
    T a = T(1);
#pragma unroll
    for (int i = 0; i < NORT; ++i)
      if (d[i] < T(0)) a = vmin(a, -y[i] / d[i]);
    if constexpr (S1 > 0) a = vmin(a, soc_ls<O1, S1>(y, d));
    if constexpr (S2 > 0) a = vmin(a, soc_ls<O2, S2>(y, d));
    return a;
  }

  // shift r along the cone identity until strictly feasible
  static __device__ __forceinline__ void bring2cone(Vec& r) {
    T a = -INFINITY;
#pragma unroll
    for (int i = 0; i < NORT; ++i) a = vmax(a, -r[i]);
    if constexpr (S1 > 0) a = vmax(a, -(r[O1] - soc_tail_norm<O1, S1>(r)));
    if constexpr (S2 > 0) a = vmax(a, -(r[O2] - soc_tail_norm<O2, S2>(r)));
    if (!(a < T(0))) {
      const T sh = T(1) + a;
#pragma unroll
      for (int i = 0; i < NORT; ++i) r[i] += sh;
      if constexpr (S1 > 0) r[O1] += sh;
      if constexpr (S2 > 0) r[O2] += sh;
    }
  }

  static __device__ __forceinline__ void add_e(Vec& r, T m) {
#pragma unroll
    for (int i = 0; i < NORT; ++i) r[i] += m;
    if constexpr (S1 > 0) r[O1] += m;
    if constexpr (S2 > 0) r[O2] += m;
  }

  // ---- dense algebra on the (nr x nv) columns ---------------------------
  static __device__ __forceinline__ void matvec(const Vec (&g)[NV],
                                                const Col& x, Vec& o) {
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      T t = T(0);
#pragma unroll
      for (int v = 0; v < NV; ++v) t += g[v][r] * x[v];
      o[r] = t;
    }
  }

  static __device__ __forceinline__ void rmatvec(const Vec (&g)[NV],
                                                 const Vec& z, Col& o) {
#pragma unroll
    for (int v = 0; v < NV; ++v) o[v] = dot(g[v], z);
  }

  // L L' = A'A + jitter * mean(diag) I; also the reciprocal diagonal
  static __device__ __forceinline__ void gram_chol(const Vec (&a)[NV],
                                                   T jitter, T (&L)[NL],
                                                   Col& rd) {
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j) L[li(i, j)] = dot(a[i], a[j]);
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

  static __device__ __forceinline__ void chol_solve(const T (&L)[NL],
                                                    const Col& rd,
                                                    const Col& b, Col& x) {
    Col y;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      T s = b[i];
#pragma unroll
      for (int k = 0; k < i; ++k) s -= L[li(i, k)] * y[k];
      y[i] = s * rd[i];
    }
#pragma unroll
    for (int i = NV - 1; i >= 0; --i) {
      T s = y[i];
#pragma unroll
      for (int k = i + 1; k < NV; ++k) s -= L[li(k, i)] * x[k];
      x[i] = s * rd[i];
    }
  }

  // one Newton solve of the scaled KKT system for right-hand side lam_ds
  static __device__ __forceinline__ void newton(
      const Vec (&gt)[NV], const T (&L)[NL], const Col& rd,
      const Scaling& W, const Col& rx, const Vec& rz, const Vec& lam_ds,
      Col& dx, Vec& ds, Vec& dz) {
    Vec t, bz;
    wapply<false>(W, lam_ds, t);
#pragma unroll
    for (int r = 0; r < NR; ++r) t[r] = -rz[r] - t[r];
    wapply<true>(W, t, bz);
    Col bv;
#pragma unroll
    for (int v = 0; v < NV; ++v) bv[v] = -rx[v] + dot(gt[v], bz);
    chol_solve(L, rd, bv, dx);
    matvec(gt, dx, t);
#pragma unroll
    for (int r = 0; r < NR; ++r) t[r] -= bz[r];
    wapply<true>(W, t, dz);
    wapply<false>(W, dz, t);
#pragma unroll
    for (int r = 0; r < NR; ++r) t[r] = lam_ds[r] - t[r];
    wapply<false>(W, t, ds);
  }
};

template <typename T, int NV, int NORT, int S1, int S2, bool WARM, bool SKIP>
__global__ void __launch_bounds__(128)
pdip_kernel(const T* __restrict__ Gs, const T* __restrict__ hs,
            const T* __restrict__ cs, const T* __restrict__ xw,
            const T* __restrict__ sw, const T* __restrict__ zw,
            const bool* __restrict__ skip, T* __restrict__ xo,
            T* __restrict__ so, T* __restrict__ zo, int* __restrict__ it_o,
            bool* __restrict__ conv_o, int B, T tol, T jitter, T margin,
            int max_iters) {
  typedef Pdip<T, NV, NORT, S1, S2> P;
  constexpr int NR = P::NR;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t sB = (size_t)B;

  typename P::Vec g[NV], h;
  typename P::Col c, x;
  typename P::Vec s, z;
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int r = 0; r < NR; ++r) g[v][r] = Gs[(v * NR + r) * sB + b];
#pragma unroll
  for (int r = 0; r < NR; ++r) h[r] = hs[r * sB + b];
#pragma unroll
  for (int v = 0; v < NV; ++v) c[v] = cs[v * sB + b];

  if (WARM) {
#pragma unroll
    for (int v = 0; v < NV; ++v) x[v] = xw[v * sB + b];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      s[r] = sw[r * sB + b];
      z[r] = zw[r * sB + b];
    }
    P::add_e(s, margin);
    P::add_e(z, margin);
    P::bring2cone(s);
    P::bring2cone(z);
  } else {
    // least-squares start: x = (G'G)^{-1} G'h, s = G x - h, z = G (G'G)^{-1}(-c)
    T L[P::NL];
    typename P::Col rd, t, xd;
    P::gram_chol(g, jitter, L, rd);
    P::rmatvec(g, h, t);
    P::chol_solve(L, rd, t, x);
    P::matvec(g, x, s);
#pragma unroll
    for (int r = 0; r < NR; ++r) s[r] -= h[r];
    P::bring2cone(s);
#pragma unroll
    for (int v = 0; v < NV; ++v) t[v] = -c[v];
    P::chol_solve(L, rd, t, xd);
    P::matvec(g, xd, z);
    P::bring2cone(z);
  }

  int iters = 0;
  bool done = SKIP ? skip[b] : false;
  const T inv_deg = T(1) / T(P::DEG);
  for (int it = 0; it < max_iters && !done; ++it) {
    // done test on the entry iterate, before the step
    const T mu = P::dot(s, z) * inv_deg;
    if (!dfinite(mu) || mu < tol) break;

    typename P::Scaling W;
    P::nt(s, z, W);
    typename P::Vec lam, lamlam, rz, t;
    P::template wapply<false>(W, z, lam);
    P::prod(lam, lam, lamlam);
    typename P::Col rx;
    P::rmatvec(g, z, rx);
#pragma unroll
    for (int v = 0; v < NV; ++v) rx[v] += c[v];
    P::matvec(g, x, rz);
#pragma unroll
    for (int r = 0; r < NR; ++r) rz[r] += s[r] - h[r];

    typename P::Vec gt[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) P::template wapply<true>(W, g[v], gt[v]);
    T L[P::NL];
    typename P::Col rd;
    P::gram_chol(gt, jitter, L, rd);

    typename P::InvPre ip;
    P::inv_pre(lam, ip);

    // affine (predictor) step
    typename P::Vec lam_ds, ds_a, dz_a;
    typename P::Col dx;
#pragma unroll
    for (int r = 0; r < NR; ++r) t[r] = -lamlam[r];
    P::inv_prod(lam, ip, t, lam_ds);
    P::newton(gt, L, rd, W, rx, rz, lam_ds, dx, ds_a, dz_a);
    const T a_aff = vmin(P::linesearch(s, ds_a), P::linesearch(z, dz_a));
    T num = T(0);
#pragma unroll
    for (int r = 0; r < NR; ++r)
      num += (s[r] + a_aff * ds_a[r]) * (z[r] + a_aff * dz_a[r]);
    const T rho = num / P::dot(s, z);
    // clip(rho, 0, 1)^3 with NaN passed through
    const T rc = rho < T(0) ? T(0) : (rho > T(1) ? T(1) : rho);
    const T sm = rc * rc * rc * mu;

    // centering + corrector step
    typename P::Vec u, v2;
    P::template wapply<true>(W, ds_a, u);
    P::template wapply<false>(W, dz_a, v2);
    P::prod(u, v2, t);
#pragma unroll
    for (int r = 0; r < NR; ++r) t[r] = -lamlam[r] - t[r];
    P::add_e(t, sm);
    P::inv_prod(lam, ip, t, lam_ds);
    typename P::Vec ds, dz;
    P::newton(gt, L, rd, W, rx, rz, lam_ds, dx, ds, dz);
    const T a = vmin(T(1), T(0.99) * vmin(P::linesearch(s, ds),
                                          P::linesearch(z, dz)));

    // apply only a finite candidate; otherwise freeze for good
    bool good = true;
    typename P::Col xn;
    typename P::Vec sn, zn;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      xn[v] = x[v] + a * dx[v];
      good = good && dfinite(xn[v]);
    }
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      sn[r] = s[r] + a * ds[r];
      zn[r] = z[r] + a * dz[r];
      good = good && dfinite(sn[r]) && dfinite(zn[r]);
    }
    if (!good) break;
#pragma unroll
    for (int v = 0; v < NV; ++v) x[v] = xn[v];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      s[r] = sn[r];
      z[r] = zn[r];
    }
    ++iters;
  }

  const T mu_f = P::dot(s, z) * inv_deg;
#pragma unroll
  for (int v = 0; v < NV; ++v) xo[v * sB + b] = x[v];
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    so[r * sB + b] = s[r];
    zo[r * sB + b] = z[r];
  }
  it_o[b] = iters;
  conv_o[b] = dfinite(mu_f) && mu_f < tol;
}

typedef DCOL_T Real;
constexpr int kNV = DCOL_NV, kNORT = DCOL_NORT, kS1 = DCOL_S1, kS2 = DCOL_S2;

template <bool WARM, bool SKIP>
void launch(const void* G, const void* h, const void* c, const void* xw,
            const void* sw, const void* zw, const void* skip, void* x, void* s,
            void* z, void* iters, void* conv, int B, double tol, double jitter,
            double margin, int max_iters, cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  pdip_kernel<Real, kNV, kNORT, kS1, kS2, WARM, SKIP>
      <<<blocks, threads, 0, stream>>>(
          (const Real*)G, (const Real*)h, (const Real*)c, (const Real*)xw,
          (const Real*)sw, (const Real*)zw, (const bool*)skip, (Real*)x,
          (Real*)s, (Real*)z, (int*)iters, (bool*)conv, B, (Real)tol,
          (Real)jitter, (Real)margin, max_iters);
}

}  // namespace

extern "C" {

// The layout this library was built for: {sizeof(T), NV, NORT, S1, S2}.
int dcol_pdip_layout(int* out) {
  out[0] = (int)sizeof(Real);
  out[1] = kNV;
  out[2] = kNORT;
  out[3] = kS1;
  out[4] = kS2;
  return 0;
}

// Solve B problems.  Operands are struct-of-arrays: G (nv*nr, B) with row
// v*nr + r holding G[:, r, v]; h, s, z (nr, B); c, x (nv, B); skip, iters,
// conv (B).  xw/sw/zw null = cold start; skip null = no skip lanes (skip
// needs the warm operands).  Returns cudaGetLastError() after the launch.
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
