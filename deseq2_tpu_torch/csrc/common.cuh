// Device helpers shared by the three per-gene solver kernels
// (irls.cu, disp_ls.cu, disp_grid.cu): warp reductions, the NB special
// functions with their float32 large-c series branches, unrolled p x p
// Cholesky routines for p = 1..8, the weighted Cox-Reid masks, the wide
// kernels' tile pass and shared-memory algebra for 8 < p <= 16, and the
// block kernels' for 16 < p <= 64 (the last two sections).
//
// One layout for p <= 8: a warp's lanes stride over a gene's samples,
// warp_allsum leaves the sums on every lane, and every lane runs the same
// p x p algebra on the same values, so no barrier or broadcast follows a
// sum.
// K1 and K2 (irls.cu, disp_ls.cu) give each persistent warp its next gene
// from a per-launch counter (next_gene); K3 (disp_grid.cu) gives each
// block one gene and each of its warps some of the gene's grid points.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <type_traits>

namespace dk {

template <typename T>
struct Eps;
template <>
struct Eps<float> {
  static constexpr float value = 1.1920928955078125e-07f;
};
template <>
struct Eps<double> {
  static constexpr double value = 2.220446049250313e-16;
};

template <typename T>
__host__ __device__ constexpr bool is_f32() {
  return std::is_same<T, float>::value;
}

__device__ __forceinline__ float d_exp(float v) { return expf(v); }
__device__ __forceinline__ double d_exp(double v) { return exp(v); }
__device__ __forceinline__ float d_log(float v) { return logf(v); }
__device__ __forceinline__ double d_log(double v) { return log(v); }
__device__ __forceinline__ float d_log1p(float v) { return log1pf(v); }
__device__ __forceinline__ double d_log1p(double v) { return log1p(v); }
__device__ __forceinline__ float d_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double d_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float d_lgamma(float v) { return lgammaf(v); }
__device__ __forceinline__ double d_lgamma(double v) { return lgamma(v); }
__device__ __forceinline__ float d_abs(float v) { return fabsf(v); }
__device__ __forceinline__ double d_abs(double v) { return fabs(v); }

// digamma(z) for z > 0: 8 recurrence shifts psi(z) = psi(z+1) - 1/z onto
// z >= 8, then the Stirling series through z^-8 (|err| < 8e-12 at z = 8).
template <typename T>
__device__ __forceinline__ T digamma_pos(T z) {
  T acc = T(0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (z < T(8)) {
      acc -= T(1) / z;
      z += T(1);
    }
  }
  const T inv = T(1) / z;
  const T inv2 = inv * inv;
  const T series =
      d_log(z) - T(0.5) * inv -
      inv2 * (T(1.0 / 12.0) -
              inv2 * (T(1.0 / 120.0) - inv2 * (T(1.0 / 252.0) - inv2 / T(240))));
  return acc + series;
}

// float32 only: c > 16 max(y, 1) selects the power-sum series of
// sum_{j<y} log(1 + j/c) (or 1/(c+j)), where the direct difference of two
// large lgamma/digamma values cancels.  float64 keeps the direct form.
template <typename T>
__device__ __forceinline__ bool large_c(T y, T c) {
  return is_f32<T>() && c > T(16) * (y > T(1) ? y : T(1));
}

// sum_{j<y} j^k for k = 1..4 (closed forms): the coefficients of the
// float32 large-c series
template <typename T>
struct PowerSums {
  T s1, s2, s3, s4;
};

template <typename T>
__device__ __forceinline__ PowerSums<T> power_sums(T y) {
  const T s1 = y * (y - T(1)) / T(2);
  const T s2 = (y - T(1)) * y * (T(2) * y - T(1)) / T(6);
  return {s1, s2, s1 * s1, s2 * (T(3) * y * y - T(3) * y - T(1)) / T(5)};
}

// the series of sum_{j<y} log(1 + j/c) in ci = 1/c
template <typename T>
__device__ __forceinline__ T lgamma_series(const PowerSums<T>& s, T ci) {
  return ci *
         (s.s1 - ci * (s.s2 / T(2) - ci * (s.s3 / T(3) - ci * s.s4 / T(4))));
}

// The constants of one point c = 1/alpha that lgamma(y + c) - lgamma(c)
// - y log(c) needs, shared by every sample of the gene: computed once per
// point instead of once per sample.
template <typename T>
struct LgConst {
  T c, ci, lgc, logc;
};

template <typename T>
__device__ __forceinline__ LgConst<T> lg_const(T c) {
  return {c, T(1) / c, d_lgamma(c), d_log(c)};
}

// lgamma(y + c) - lgamma(c) - y log(c) with the point's constants k: the
// per-sample difference form, or in float32 past large_c the power-sum
// series in 1/c (the same values as computing lgamma(c), log(c) and 1/c
// per sample, so the same bits)
template <typename T>
__device__ __forceinline__ T lg_diff(T y, const LgConst<T>& k) {
  if (large_c(y, k.c)) return lgamma_series(power_sums(y), k.ci);
  return d_lgamma(y + k.c) - k.lgc - y * k.logc;
}

// LgConst and digamma(c), for the line search's derivative
template <typename T>
struct NbConst : LgConst<T> {
  T dgc;
};

template <typename T>
__device__ __forceinline__ NbConst<T> nb_const(T c) {
  NbConst<T> k;
  static_cast<LgConst<T>&>(k) = lg_const(c);
  k.dgc = digamma_pos(c);
  return k;
}

// lg_diff and digamma(y + c) - digamma(c) (or its float32 large-c series)
// with the point's constants k, on one branch.
template <typename T>
__device__ __forceinline__ void nb_diffs(T y, const NbConst<T>& k, T& lgd,
                                         T& dgd) {
  if (large_c(y, k.c)) {
    const PowerSums<T> s = power_sums(y);
    const T ci = k.ci;
    lgd = lgamma_series(s, ci);
    dgd = ci * (y - ci * (s.s1 - ci * (s.s2 - ci * (s.s3 - ci * s.s4))));
  } else {
    lgd = d_lgamma(y + k.c) - k.lgc - y * k.logc;
    dgd = digamma_pos(y + k.c) - k.dgc;
  }
}

// lgamma(z) and digamma(z) for z > 0 from one shift: z is shifted up by
// ones to zs >= kShift (8 in float64; 3 in float32, below which Stirling's
// series no longer reaches float32's precision), and the shifts'
// reciprocals 1/z + 1/(z+1) + ... are summed as one fraction num/den built
// by multiply-adds (den the product of the shifted arguments: below
// kShift^kShift, and at least 4.5e-5 for the line search's c = 1/alpha >=
// e^-10, so no float32 overflow).  Then
//   digamma(z) = log zs - 1/(2 zs) - (Stirling's series in 1/zs^2)
//                - num/den,
//   lgamma(z)  = (zs - 1/2)(log zs - 1) + log(2 pi)/2 - 1/2
//                + Stirling's series in 1/zs - log den,
// each series through its zs^-14 or zs^-13 term: two logs and two
// divisions a call, where lgammaf and digamma_pos take a lgamma, up to
// nine divisions and a log.  Near lgamma's roots (z = 1, 2) the result is
// the difference of two terms of about log Gamma(zs), so a smaller zs
// rounds less: with zs >= 8 float32 read 28 float32 epsilons there, with
// zs >= 3 about 4 (tests/test_torch_k3k2_emulation.py), and float64 with
// zs >= 8 stays within 1e-13 of the functions.  The float32 wide K2 takes
// its digamma only: with this lgamma in place of lgammaf its float32
// searches stopped far from the optimum on a gene of two of phase 3's S =
// 24 readings, at either zs (PERF.md section 6).
template <typename T>
struct LgDg {
  T lg, dg;
};

// Stirling's series in inv = 1/zs (inv2 = inv^2): digamma(zs) = log zs -
// inv/2 - stirling_dg(inv2), lgamma(zs) = (zs - 1/2)(log zs - 1) +
// kLgStirling + stirling_lg(inv, inv2)
template <typename T>
__device__ __forceinline__ T stirling_dg(T inv2) {
  return inv2 *
         (T(1.0 / 12.0) -
          inv2 * (T(1.0 / 120.0) -
                  inv2 * (T(1.0 / 252.0) -
                          inv2 * (T(1.0 / 240.0) -
                                  inv2 * (T(1.0 / 132.0) -
                                          inv2 * (T(691.0 / 32760.0) -
                                                  inv2 * T(1.0 / 12.0)))))));
}

template <typename T>
__device__ __forceinline__ T stirling_lg(T inv, T inv2) {
  return inv * (T(1.0 / 12.0) -
                inv2 * (T(1.0 / 360.0) -
                        inv2 * (T(1.0 / 1260.0) -
                                inv2 * (T(1.0 / 1680.0) -
                                        inv2 * (T(1.0 / 1188.0) -
                                                inv2 * (T(691.0 / 360360.0) -
                                                        inv2 / T(156)))))));
}

// log(2 pi)/2 - 1/2
constexpr double kLgStirling = 0.41893853320467274178;

template <typename T>
__device__ __forceinline__ LgDg<T> lgamma_digamma(T z) {
  constexpr int kShift = is_f32<T>() ? 3 : 8;
  T num = T(0), den = T(1);
#pragma unroll
  for (int i = 0; i < kShift; ++i) {
    if (z < T(kShift)) {
      num = num * z + den;
      den = den * z;
      z += T(1);
    }
  }
  const T inv = T(1) / z;
  const T inv2 = inv * inv;
  const T lz = d_log(z);
  const T sd = stirling_dg(inv2);
  const T sl = stirling_lg(inv, inv2);
  LgDg<T> f;
  f.dg = lz - T(0.5) * inv - sd - num / den;
  f.lg = (z - T(0.5)) * (lz - T(1)) + T(kLgStirling) + sl - d_log(den);
  return f;
}

// nb_const with digamma(c) from lgamma_digamma (the float32 wide K2's
// constants; the other kernels keep nb_const)
template <typename T>
__device__ __forceinline__ NbConst<T> nb_const_shift(T c) {
  NbConst<T> k;
  static_cast<LgConst<T>&>(k) = lg_const(c);
  k.dgc = lgamma_digamma(c).dg;
  return k;
}

// nb_diffs with digamma(y + c) from lgamma_digamma, so that both sides of
// the difference carry the same approximation; lgamma and the float32
// large-c series branch are nb_diffs'.
template <typename T>
__device__ __forceinline__ void nb_diffs_shift(T y, const NbConst<T>& k,
                                               T& lgd, T& dgd) {
  if (large_c(y, k.c)) {
    nb_diffs(y, k, lgd, dgd);
  } else {
    lgd = d_lgamma(y + k.c) - k.lgc - y * k.logc;
    dgd = lgamma_digamma(y + k.c).dg - k.dgc;
  }
}

// ---------------------------------------------------------------------------
// The narrow float64 K2's special functions (disp_ls.cu: ls_kernel<double>)
// ---------------------------------------------------------------------------
//
// A trial point's terms lgamma(y + c) - lgamma(c) - y log c and digamma(y +
// c) - digamma(c), c = 1/alpha, come from lgamma_digamma's shift and
// Stirling series (float64, zs >= 8) in one of two forms, chosen per point
// (so the same on every lane of the warp):
// - c < kLargeC: the point's lgamma(c) and digamma(c) from one
//   lgamma_digamma call and its log c; per sample the routine on y + c,
//   its two divisions (1/zs and num/den) and the sample's 1/(1 + mu alpha)
//   taken from one reciprocal of their product, and log(den) only where y
//   + c was shifted (ls_terms64);
// - c >= kLargeC (no shift for c, nor for y + c): the difference of the two
//   Stirling forms, with t = log1p(y alpha) = log((y + c)/c),
//     lgamma(y+c) - lgamma(c) - y log c = (y + c - 1/2) t - y
//                                         + stirling_lg(y+c) - stirling_lg(c),
//     digamma(y+c) - digamma(c) = t + y alpha / (2 (y + c))
//                                 - stirling_dg(y+c) + stirling_dg(c),
//   a log1p and one reciprocal a sample, and no difference of two large
//   values: lgamma(c) ~ c log c (2.1e10 at c = 1e9, the line search's
//   smallest alpha) is never formed, where the direct form loses the
//   difference's digits to its rounding.
// nb_const / nb_diffs (the float32, wide and block kernels') stay as they
// were.
constexpr double kLargeC = 8.0;

struct LsPoint64 {
  double alpha, c;
  bool large;               // c >= kLargeC
  double lgc, dgc, logc;    // c < kLargeC
  double slc, sdc;          // c >= kLargeC: the series at c
};

__device__ __forceinline__ LsPoint64 ls_point64(double alpha) {
  LsPoint64 k;
  k.alpha = alpha;
  k.c = 1.0 / alpha;
  k.large = k.c >= kLargeC;
  if (k.large) {
    const double inv2 = alpha * alpha;
    k.slc = stirling_lg(alpha, inv2);
    k.sdc = stirling_dg(inv2);
  } else {
    const LgDg<double> f = lgamma_digamma(k.c);
    k.lgc = f.lg;
    k.dgc = f.dg;
    k.logc = log(k.c);
  }
  return k;
}

// Sample (y, mua = mu alpha)'s terms at point k: l1p = log1p(mua), r = 1 /
// (1 + mua), lgd = lgamma(y + c) - lgamma(c) - y log c and dgd = digamma(y
// + c) - digamma(c), every division from one reciprocal.
__device__ __forceinline__ void ls_terms64(double y, double mua,
                                           const LsPoint64& k, double& l1p,
                                           double& r, double& lgd,
                                           double& dgd) {
  l1p = log1p(mua);
  const double opm = 1.0 + mua;
  if (k.large) {
    const double z = y + k.c;
    const double t = log1p(y * k.alpha);
    const double q = 1.0 / (z * opm);
    r = z * q;
    const double inv = opm * q;
    const double inv2 = inv * inv;
    lgd = (z - 0.5) * t - y + (stirling_lg(inv, inv2) - k.slc);
    dgd = t + 0.5 * y * k.alpha * inv - (stirling_dg(inv2) - k.sdc);
  } else {
    double z = y + k.c, num = 0.0, den = 1.0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (z < 8.0) {
        num = num * z + den;
        den = den * z;
        z += 1.0;
      }
    }
    // q = 1 / (zs den (1 + mua)): 1/zs, 1/den and r are its products
    const double zd = z * den;
    const double q = 1.0 / (zd * opm);
    r = zd * q;
    const double inv = den * opm * q;
    const double inv2 = inv * inv;
    const double lz = log(z);
    dgd = lz - 0.5 * inv - stirling_dg(inv2) - num * (z * opm * q) - k.dgc;
    lgd = (z - 0.5) * (lz - 1.0) + kLgStirling + stirling_lg(inv, inv2) -
          k.lgc - y * k.logc;
    // log(den) only where a lane shifted (y + c < 8)
    if (den != 1.0) lgd -= log(den);
  }
}

// Fill the full symmetric matrix from its packed upper triangle (row-major
// order: (0,0), (0,1), ..., (0,P-1), (1,1), ...).
template <typename T, int P>
__device__ __forceinline__ void unpack_sym(const T* tri, T (&a)[P][P]) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = i; j < P; ++j) {
      a[i][j] = tri[k];
      a[j][i] = tri[k];
      ++k;
    }
  }
}

// Lower Cholesky factor of an SPD matrix; the pivot is floored at 1e-30
// (as in the TPU kernels) so a singular system yields huge, not NaN,
// values.  Returns log det(a).
template <typename T, int P>
__device__ __forceinline__ T cholesky(const T (&a)[P][P], T (&L)[P][P]) {
  T logdet = T(0);
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      T s = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[i][k] * L[j][k];
      if (i == j) {
        const T d = d_sqrt(s > T(1e-30) ? s : T(1e-30));
        L[i][i] = d;
        logdet += T(2) * d_log(d);
      } else {
        L[i][j] = s / L[j][j];
      }
    }
#pragma unroll
    for (int j = i + 1; j < P; ++j) L[i][j] = T(0);
  }
  return logdet;
}

// x = a^-1 rhs given the Cholesky factor of a.
template <typename T, int P>
__device__ __forceinline__ void chol_solve(const T (&L)[P][P], const T (&rhs)[P],
                                           T (&x)[P]) {
  T w[P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
    T s = rhs[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[i][k] * w[k];
    w[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = P - 1; i >= 0; --i) {
    T s = w[i];
#pragma unroll
    for (int k = i + 1; k < P; ++k) s -= L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// a^-1 = L^-T L^-1 given the Cholesky factor of a.
template <typename T, int P>
__device__ __forceinline__ void chol_inverse(const T (&L)[P][P], T (&inv)[P][P]) {
  T Li[P][P];
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j < P; ++j) Li[i][j] = T(0);
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    Li[i][i] = T(1) / L[i][i];
#pragma unroll
    for (int j = i - 1; j >= 0; --j) {
      T s = T(0);
#pragma unroll
      for (int k = j; k < i; ++k) s += L[i][k] * Li[k][j];
      Li[i][j] = -s * Li[i][i];
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      T s = T(0);
#pragma unroll
      for (int k = i; k < P; ++k) s += Li[k][i] * Li[k][j];
      inv[i][j] = s;
      inv[j][i] = s;
    }
  }
}

// Accumulate w * (x_i x_j) into the packed upper triangle acc[0..NT).
template <typename T, int P>
__device__ __forceinline__ void acc_outer(T* acc, T w, const T (&xs)[P]) {
  int k = 0;
#pragma unroll
  for (int i = 0; i < P; ++i) {
#pragma unroll
    for (int j = i; j < P; ++j) {
      acc[k] += w * (xs[i] * xs[j]);
      ++k;
    }
  }
}

// v times sample s's observation weight wr[s] in the weighted mode, v
// untouched otherwise: the unweighted instantiations keep the statement
// order (and so the code) of a kernel without weights.
template <bool UseW, typename T>
__device__ __forceinline__ T wscale(T v, const T* wr, int s) {
  if constexpr (UseW) return v * wr[s];
  return v;
}

// The weighted Cox-Reid term keeps the rows whose weight exceeds the
// launch's threshold thr (src/DESeq2.cpp:38-44, the reference's
// weightThreshold; 1e-2 by default, ops/disp.py's CR_WEIGHT_THRESHOLD).
template <typename T>
__device__ __forceinline__ bool cr_keeps(T w, T thr) {
  return w > thr;
}

// Column-mask the Cox-Reid matrix b (and its derivative db, when given)
// with warp_cr_col_mask's bits: dropped rows and columns
// are zeroed, and b gets a unit diagonal there so the kept submatrix's log
// determinant survives.
template <typename T, int P>
__device__ __forceinline__ void cr_apply_mask(unsigned cm, T (&b)[P][P],
                                              T (*db)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const T ci = (cm >> i) & 1u ? T(1) : T(0);
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const T m = ci * ((cm >> j) & 1u ? T(1) : T(0));
      b[i][j] *= m;
      if (db != nullptr) db[i][j] *= m;
    }
    b[i][i] += T(1) - ci;
  }
}

// ---------------------------------------------------------------------------
// Warps (irls.cu, disp_ls.cu, disp_grid.cu)
// ---------------------------------------------------------------------------

// threads of a persistent block: kWarpBlock / 32 independent warps, which
// share only the block's staged copy of the design
constexpr int kWarpBlock = 128;
constexpr int kBlockWarps = kWarpBlock / 32;
constexpr unsigned kFullMask = 0xffffffffu;
// stage the design x (S x p values, and irls.cu's shared size-factor row
// and its logs) in the block's shared memory when it takes at most this many bytes; the
// gene rows are read through L1/L2 (PERF.md section 6: staging them per
// warp measured slower, its shared memory cutting the resident warps)
constexpr size_t kBlockStageBytes = 16384;

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// A barrier over the Warps warps that share the work: the block's, or one
// warp's.
template <int Warps>
__device__ __forceinline__ void warps_sync() {
  if constexpr (Warps == 1) {
    __syncwarp();
  } else {
    __syncthreads();
  }
}

// The warp's next gene from the launch's work counter (one atomic per
// gene; the lanes get it by shuffle).  Which warp takes which gene does
// not change any gene's result.
__device__ __forceinline__ int next_gene(int* counter) {
  int g = 0;
  if (lane_id() == 0) g = atomicAdd(counter, 1);
  return __shfl_sync(kFullMask, g, 0);
}

// Sum N per-lane values over the warp by an xor butterfly.  Every lane
// ends with the totals, bit for bit the same on every lane: at each step
// lanes i and i^o add the same two values (addition commutes).
template <typename T, int N>
__device__ __forceinline__ void warp_allsum(T (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[i] += __shfl_xor_sync(kFullMask, v[i], o);
  }
}

// Copy n values into the block's shared memory (every thread of the block
// calls it); a __syncthreads must follow.
template <typename T>
__device__ __forceinline__ void block_stage(T* dst, const T* __restrict__ src,
                                            int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
}

template <typename T, int P>
__device__ __forceinline__ void x_row(const T* xr, int s, T (&xs)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k) xs[k] = xr[s * P + k];
}

// Weighted Cox-Reid column mask (src/DESeq2.cpp:38-44) of one gene, on
// every lane of its warp: column k stays when some kept row has x_k != 0.
template <typename T, int P>
__device__ __forceinline__ unsigned warp_cr_col_mask(const T* wr, const T* xr,
                                                     int S, T thr) {
  T acc[P];
#pragma unroll
  for (int k = 0; k < P; ++k) acc[k] = T(0);
  for (int s = lane_id(); s < S; s += 32) {
    if (cr_keeps(wr[s], thr)) {
      T xs[P];
      x_row<T, P>(xr, s, xs);
#pragma unroll
      for (int k = 0; k < P; ++k) acc[k] += xs[k] * xs[k];
    }
  }
  warp_allsum<T, P>(acc);
  unsigned cm = 0u;
#pragma unroll
  for (int k = 0; k < P; ++k) cm |= acc[k] > T(0) ? (1u << k) : 0u;
  return cm;
}

// Dynamic shared memory of a launch of K1, K2 or K3: the block's staged
// values (stage_vals per sample), or 0 bytes (read from global memory)
// when they take more than kBlockStageBytes.
template <typename T>
inline size_t block_stage_bytes(int S, int stage_vals) {
  const size_t b = (size_t)S * stage_vals * sizeof(T);
  return b <= kBlockStageBytes ? b : 0;
}

// Resident blocks per SM of a kernel launched with `threads` threads a
// block and `smem` bytes of dynamic shared memory (the occupancy
// calculator).  Returns 0 and sets *err on a refusal.
template <typename K>
inline int blocks_per_sm(K kernel, size_t smem, int* err,
                         int threads = kWarpBlock) {
  int per_sm = 0;
  *err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, threads, smem);
  return *err ? 0 : per_sm;
}

// Persistent blocks for a warp-per-gene kernel: as many as fit on the
// card at once, but no more than the genes need.  Returns 0 and sets *err
// on a refusal.
template <typename K>
inline int persistent_blocks(K kernel, size_t smem, int G, int* err) {
  const int per_sm = blocks_per_sm(kernel, smem, err);
  if (*err) return 0;
  int dev = 0, sms = 0;
  if ((*err = (int)cudaGetDevice(&dev))) return 0;
  if ((*err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                          dev)))
    return 0;
  if (per_sm < 1) {
    *err = (int)cudaErrorInvalidConfiguration;
    return 0;
  }
  const int need = (G + kBlockWarps - 1) / kBlockWarps;
  return per_sm * sms < need ? per_sm * sms : need;
}

// ---------------------------------------------------------------------------
// Wide designs, kPNarrow < p <= kPWide (the *_wide kernels of irls.cu,
// disp_ls.cu and disp_grid.cu)
// ---------------------------------------------------------------------------
//
// The templated kernels above keep a gene's p x p system in every lane's
// registers; at P = 16 that spilled (PERF.md section 6).  The wide kernels
// take p at run time and keep no p x p matrix in any thread:
// - a warp walks its gene's samples in tiles of kTile = 32, one sample a
//   lane.  Each lane computes its sample's weight and likelihood terms and
//   writes its design row x_s and u_s = w_s x_s into the warp's shared
//   tile buffers, column k of a tile at k * kTileStride;
// - the warp then adds the tile's outer products to a p x p gram whose
//   entries the lanes own (gram_map, gram_add): each lane owns a 4 x 4
//   block of the upper triangle in one of several groups, and the groups
//   take turns over the tile's samples; after the last tile the groups'
//   partial blocks are added in group order (gram_reduce).  Every entry is
//   summed in one fixed order, so two launches give the same bits and a
//   gene's result does not depend on the genes beside it;
// - the p x p algebra (Cholesky, solve, inverse, log determinant) runs on
//   matrices in the warp's shared memory, lanes owning rows or columns
//   (warp_cholesky, warp_chol_solve, warp_chol_inverse).

// the templated kernels' widest design and the wide kernels'
constexpr int kPNarrow = 8;
constexpr int kPWide = 16;
// samples per tile (one per lane), a tile column's stride (33: the lanes'
// column-major writes and the gram's reads fall in distinct banks), the
// values of one tile buffer, and of one p x p matrix (row stride kPWide)
constexpr int kTile = 32;
constexpr int kTileStride = kTile + 1;
constexpr int kTileVals = kPWide * kTileStride;
constexpr int kMat = kPWide * kPWide;

// Opt a kernel in to `smem` bytes of dynamic shared memory (needed past
// 48 KB); returns the CUDA error.
template <typename K>
inline int allow_smem(K kernel, size_t smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The gram's block map (gram_map): the p columns fall into nbr =
// ceil(p / 4) blocks of 4, whose nb = nbr (nbr + 1) / 2 upper blocks (row
// block <= column block) the lanes share out: lane l owns block l % nb in
// group l / nb, and the ng = 32 / nb groups take every ng-th sample of a
// tile (9-12 columns: 6 blocks in 5 groups; 13-16: 10 blocks in 3 groups;
// the lanes past ng nb idle).  Only the upper blocks of the p columns are
// summed, and each group sums its samples in increasing order.
struct GramMap {
  int nb, ng, grp, r0, c0;   // the map, this lane's group and block
  bool active, diag;         // a lane of a group; a diagonal block
};

__device__ __forceinline__ GramMap gram_map(int p) {
  GramMap m;
  const int nbr = (p + 3) >> 2;
  m.nb = nbr * (nbr + 1) / 2;
  m.ng = 32 / m.nb;
  const int l = lane_id();
  m.grp = l / m.nb;
  m.active = m.grp < m.ng;
  int b = l - m.grp * m.nb, rq = 0;
  while (b >= nbr - rq) {
    b -= nbr - rq;
    ++rq;
  }
  m.r0 = rq * 4;
  m.c0 = (rq + b) * 4;
  m.diag = b == 0;
  return m;
}

// A lane's share of a gram over the tiles: its 4 x 4 block.
template <typename T>
struct GramBlock {
  T a[4][4];
};

template <typename T>
__device__ __forceinline__ void gram_zero(GramBlock<T>& g) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) g.a[i][j] = T(0);
  }
}

// One sample t of a tile into the lane's blocks (gram_add).
template <typename T, bool D2, bool Rz>
__device__ __forceinline__ void gram_add_one(const GramMap& m,
                                             GramBlock<T>& g1,
                                             GramBlock<T>& g2, T (&rz)[4],
                                             const T* u, const T* v,
                                             const T* z, int t) {
  T ur[4], vc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ur[i] = u[(m.r0 + i) * kTileStride + t];
    vc[i] = v[(m.c0 + i) * kTileStride + t];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) g1.a[i][j] += ur[i] * vc[j];
  }
  if constexpr (D2) {
    T uc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) uc[j] = u[(m.c0 + j) * kTileStride + t];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) g2.a[i][j] += ur[i] * uc[j];
    }
  }
  if constexpr (Rz) {
    // a diagonal block's rows of X'Wz (v = x, so vc holds x at its rows)
    if (m.diag) {
      const T zt = z[t];
#pragma unroll
      for (int j = 0; j < 4; ++j) rz[j] += zt * vc[j];
    }
  }
}

// Add a tile's first n samples to the lane's blocks (its group's samples
// t = group, group + ng, ..., in that order): g1 += u_t v_t'; with D2, g2
// += u_t u_t' (K2's derivative gram); with Rz, rz += z_t v_t at a diagonal
// block's rows (K1's X'Wz).  u and v are tile buffers; z one value per
// sample.  Two samples an iteration, so that the second's loads overlap
// the first's multiply-adds.
template <typename T, bool D2, bool Rz>
__device__ __forceinline__ void gram_add(const GramMap& m, GramBlock<T>& g1,
                                         GramBlock<T>& g2, T (&rz)[4],
                                         const T* u, const T* v, const T* z,
                                         int n) {
  if (!m.active) return;
  int t = m.grp;
  for (; t + m.ng < n; t += 2 * m.ng) {
    gram_add_one<T, D2, Rz>(m, g1, g2, rz, u, v, z, t);
    gram_add_one<T, D2, Rz>(m, g1, g2, rz, u, v, z, t + m.ng);
  }
  if (t < n) gram_add_one<T, D2, Rz>(m, g1, g2, rz, u, v, z, t);
}

// Sum the groups' partial blocks (N values a lane: a block's 16, or K1's
// 4 X'Wz entries) into group 0's lanes, in group order, through the
// warp's shared scratch `red` (32 N values, slot e of lane l at e * 32 +
// l).  Ends with a __syncwarp.
template <typename T, int N>
__device__ __forceinline__ void gram_reduce(const GramMap& m, T* vals,
                                            T* red) {
  const int l = lane_id();
  __syncwarp();
  if (m.active) {
#pragma unroll
    for (int e = 0; e < N; ++e) red[e * 32 + l] = vals[e];
  }
  __syncwarp();
  if (m.grp == 0) {
    for (int k = 1; k < m.ng; ++k) {
#pragma unroll
      for (int e = 0; e < N; ++e) vals[e] += red[e * 32 + k * m.nb + l];
    }
  }
  __syncwarp();
}

template <typename T>
__device__ __forceinline__ void gram_reduce(const GramMap& m, GramBlock<T>& g,
                                            T* red) {
  gram_reduce<T, 16>(m, &g.a[0][0], red);
}

// Write the reduced gram's p x p entries into M (row stride kPWide), both
// triangles from group 0's upper blocks, each times the column-mask bits
// cm of its row and column (~0u: no mask), as cr_apply_mask does: with
// unit_diag a dropped column gets 1 on the diagonal; `diag`, when given
// (K1's ridge), is added to the diagonal.  Ends with a __syncwarp.
template <typename T>
__device__ __forceinline__ void gram_store(const GramMap& m,
                                           const GramBlock<T>& g, T* M, int p,
                                           unsigned cm, bool unit_diag,
                                           const T* diag) {
  if (m.grp == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = m.r0 + i, c = m.c0 + j;
        if (r <= c && c < p) {
          const T cr = (cm >> r) & 1u ? T(1) : T(0);
          const T cc = (cm >> c) & 1u ? T(1) : T(0);
          T v = g.a[i][j] * (cr * cc);
          if (r == c) {
            if (unit_diag) v += T(1) - cr;
            if (diag != nullptr) v += diag[r];
          }
          M[r * kPWide + c] = v;
          M[c * kPWide + r] = v;
        }
      }
    }
  }
  __syncwarp();
}

// In-place lower Cholesky factor of the p x p SPD matrix a (row stride
// kPWide, both triangles or the lower one given) in the warp's shared
// memory, lane i owning row i: on return a's lower triangle holds L.  The
// pivot is floored at 1e-30 as in cholesky<T, P>, and each entry is
// reduced in the same order (a_ij - L_i0 L_j0 - L_i1 L_j1 - ...).  With
// LogDet returns log det(a) on every lane (0 otherwise).  Every lane of
// the warp calls it.
template <typename T, bool LogDet>
__device__ __forceinline__ T warp_cholesky(T* a, int p) {
  const int i = lane_id();
  T logdet = T(0);
  for (int j = 0; j < p; ++j) {
    const T s = a[j * kPWide + j];
    const T d = d_sqrt(s > T(1e-30) ? s : T(1e-30));
    if (LogDet) logdet += T(2) * d_log(d);
    __syncwarp();
    T lij = T(0);
    if (i == j) {
      a[j * kPWide + j] = d;
    } else if (i > j && i < p) {
      lij = a[i * kPWide + j] / d;
      a[i * kPWide + j] = lij;
    }
    __syncwarp();
    if (i > j && i < p) {
      for (int k = j + 1; k <= i; ++k)
        a[i * kPWide + k] -= lij * a[k * kPWide + j];
    }
    __syncwarp();
  }
  return logdet;
}

// x = a^-1 r given warp_cholesky's factor L of a: lane k < p holds r_k on
// entry and x_k on return (the other lanes' values are meaningless).
template <typename T>
__device__ __forceinline__ T warp_chol_solve(const T* L, int p, T r) {
  const int k = lane_id();
  for (int i = 0; i < p; ++i) {
    const T wi = __shfl_sync(kFullMask, r, i) / L[i * kPWide + i];
    if (k == i) {
      r = wi;
    } else if (k > i && k < p) {
      r -= L[k * kPWide + i] * wi;
    }
  }
  for (int i = p - 1; i >= 0; --i) {
    const T xi = __shfl_sync(kFullMask, r, i) / L[i * kPWide + i];
    if (k == i) {
      r = xi;
    } else if (k < i) {
      r -= L[i * kPWide + k] * xi;
    }
  }
  return r;
}

// a^-1 = L^-T L^-1 given warp_cholesky's factor L: lane j computes column
// j of L^-1 into li, as chol_inverse computes it, then the lanes share out
// the entries of a^-1, written to both triangles of `out` (which may be
// L's own buffer).  Ends with a __syncwarp.
template <typename T>
__device__ __forceinline__ void warp_chol_inverse(const T* L, T* li, T* out,
                                                  int p) {
  const int j = lane_id();
  if (j < p) {
    li[j * kPWide + j] = T(1) / L[j * kPWide + j];
    for (int i = j + 1; i < p; ++i) {
      T s = T(0);
      for (int k = j; k < i; ++k) s += L[i * kPWide + k] * li[k * kPWide + j];
      li[i * kPWide + j] = -s * (T(1) / L[i * kPWide + i]);
    }
  }
  __syncwarp();
  const int nt = p * (p + 1) / 2;
  for (int e = lane_id(); e < nt; e += 32) {
    int r = 0;
    while ((r + 1) * (r + 2) / 2 <= e) ++r;
    const int c = e - r * (r + 1) / 2;  // c <= r
    T s = T(0);
    for (int k = r; k < p; ++k) s += li[k * kPWide + r] * li[k * kPWide + c];
    out[r * kPWide + c] = s;
    out[c * kPWide + r] = s;
  }
  __syncwarp();
}

// sum_ij a_ij b_ji over p x p matrices in the warp's shared memory, on
// every lane (lanes share out the entries in a fixed order, then
// warp_allsum).
template <typename T>
__device__ __forceinline__ T warp_trace_product(const T* a, const T* b,
                                                int p) {
  T t[1] = {T(0)};
  for (int e = lane_id(); e < p * p; e += 32) {
    const int i = e / p, j = e - (e / p) * p;
    t[0] += a[i * kPWide + j] * b[j * kPWide + i];
  }
  warp_allsum<T, 1>(t);
  return t[0];
}

// The largest of the lanes' values, on every lane.
template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T u = __shfl_xor_sync(kFullMask, v, o);
    v = u > v ? u : v;
  }
  return v;
}

// The wide kernels read the design transposed, xt (p x S): a warp's lanes
// then read column k of consecutive samples in one coalesced access.

// warp_cr_col_mask at a run-time p: column k stays when some kept row has
// x_k != 0, as the plain version's make_cr_masks decides.
template <typename T>
__device__ __forceinline__ unsigned warp_cr_col_mask_wide(const T* wr,
                                                          const T* xt, int S,
                                                          int p, T thr) {
  unsigned cm = 0u;
  for (int s = lane_id(); s < S; s += 32) {
    if (cr_keeps(wr[s], thr)) {
      for (int k = 0; k < p; ++k)
        cm |= __ldg(xt + (size_t)k * S + s) != T(0) ? (1u << k) : 0u;
    }
  }
  return __reduce_or_sync(kFullMask, cm);
}

// Lane l writes its sample's design row x_s and w x_s into column-major
// tile buffers (slot l of each column).
template <typename T>
__device__ __forceinline__ void tile_put(T* xb, T* ub, const T* xt, int S,
                                         int s, int p, T w) {
  const int l = lane_id();
  for (int k = 0; k < p; ++k) {
    const T v = __ldg(xt + (size_t)k * S + s);
    xb[k * kTileStride + l] = v;
    ub[k * kTileStride + l] = w * v;
  }
}

// ---------------------------------------------------------------------------
// Block-per-gene designs, kPWide < p <= kPBlock (the *_block kernels of
// irls.cu, disp_ls.cu and disp_grid.cu)
// ---------------------------------------------------------------------------
//
// Past 16 columns a warp's share of shared memory cannot hold a gene's
// p x p matrices (one float64 64 x 64 matrix is 32 KB), and the wide
// kernels' map (4 x 4 upper blocks over 32 lanes) holds at most 28
// columns.  The block kernels give each gene a thread block of
// kBlockThreads threads:
// - the block walks its gene's samples in tiles of tw = 32 k samples (k
//   warps, block_tile picks k from p and the type), one sample a thread:
//   each thread computes its sample's terms and writes x_s and w x_s into
//   the block's column-major tile buffers (column stride tw + 1);
// - the block's threads own the 4 x 4 upper blocks of the p x p gram
//   (block_gram_map: at p = 64 its 136 blocks, one a thread; at fewer
//   columns the threads form groups that take turns over a tile's
//   samples), and after the last tile the groups' partial blocks are
//   added in group order (block_gram_reduce).  Every entry is summed in
//   one fixed order, so two launches give the same bits and a gene's
//   result does not depend on the genes beside it.  K1 and K2 in float64
//   take their grams to the FP64 tensor cores instead (the float64 gram
//   section below; K3 and float32 keep these blocks);
// - the p x p algebra (Cholesky, solve, inverse, log determinant) runs on
//   matrices of row stride p in the block's dynamic shared memory, with a
//   __syncthreads between columns (block_cholesky, block_chol_inverse),
//   each entry reduced in the wide kernels' order;
// - the gene's sums are reduced by warp butterflies and then over the
//   warps in warp order (block_allsum), on every thread, so the solver
//   control runs on the same values in every thread.
// The weighted Cox-Reid column mask is a 64-bit set of kept columns.

// the block kernels' widest design: the gram's 4 x 4 upper blocks at p =
// 64, 136 of them, are at most one a thread, and a block's two float64
// matrices (64 KB) and tile buffers fit the SM's shared memory beside a
// second block's (block_tile).  ops/cuda_ls.py's P_BLOCK mirrors it.
constexpr int kPBlock = 64;
constexpr int kBlockThreads = 256;
constexpr int kBlockWarpsN = kBlockThreads / 32;
// shared memory a block's layout may take: half the SM's 227 KB, so that
// two blocks can be resident.  A study build may set another
// (-DDK_BLOCK_SMEM_TARGET=232448: one block an SM, wider tiles), and may
// let the block launches take designs from DK_BLOCK_MIN_P + 1 columns
// (`python -m deseq2_tpu_torch.ops.studies variant`); the library's own
// build sets neither.
#ifndef DK_BLOCK_SMEM_TARGET
#define DK_BLOCK_SMEM_TARGET 116224
#endif
#ifndef DK_BLOCK_MIN_P
#define DK_BLOCK_MIN_P kPWide
#endif
constexpr size_t kBlockSmemTarget = DK_BLOCK_SMEM_TARGET;
constexpr int kBlockMinP = DK_BLOCK_MIN_P;
// the block's small values, in values of T: two p-vectors (K1's
// coefficients and right-hand side), then the block sums' scratch (4 sums
// a warp) at kBlockRed, then the slots of the gene index and the 64-bit
// column mask at kBlockSlots (an even offset: 8-byte aligned in float)
constexpr int kBlockRed = 2 * kPBlock;
constexpr int kBlockSlots = kBlockRed + 4 * kBlockWarpsN;
constexpr int kBlockVecVals = kBlockSlots + 4;

// The gram's block map over the block (gram_map's over a warp): nbr =
// ceil(p / 4) row blocks, nb = nbr (nbr + 1) / 2 upper blocks, ng =
// kBlockThreads / nb groups; thread t owns block t % nb in group t / nb.
__host__ __device__ inline int block_gram_blocks(int p) {
  const int nbr = (p + 3) >> 2;
  return nbr * (nbr + 1) / 2;
}

__host__ __device__ inline int block_gram_groups(int p) {
  return kBlockThreads / block_gram_blocks(p);
}

__device__ __forceinline__ GramMap block_gram_map(int p) {
  GramMap m;
  const int nbr = (p + 3) >> 2;
  m.nb = block_gram_blocks(p);
  m.ng = kBlockThreads / m.nb;
  const int t = threadIdx.x;
  m.grp = t / m.nb;
  m.active = m.grp < m.ng;
  int b = t - m.grp * m.nb, rq = 0;
  while (b >= nbr - rq) {
    b -= nbr - rq;
    ++rq;
  }
  m.r0 = rq * 4;
  m.c0 = (rq + b) * 4;
  m.diag = b == 0;
  return m;
}

// The shared-memory layout of a block kernel's launch, in values of T:
// nmat p x p matrices (row stride p), the vectors, then the tile buffers
// x (pr x ts), w x (pr x ts) and one value a sample (K1's w z), which the
// groups' partial blocks reuse as their scratch between passes (so the
// region is at least (ng - 1) nb 16 values).  pr = p rounded up to the
// gram's blocks of 4: the last blocks read rows past p, whose products
// land only in entries past p, which are never stored.
struct BlockLayout {
  int p, pr, tw, ts;
  size_t mat, vec, tile, vals;
};

__host__ __device__ inline BlockLayout block_layout(int p, int tw, int nmat,
                                                    bool tiles) {
  BlockLayout l;
  l.p = p;
  l.pr = (p + 3) & ~3;
  l.tw = tw;
  l.ts = tw + 1;
  // an even number of values, so that the vectors' 64-bit slot stays
  // 8-byte aligned in float
  l.mat = ((size_t)p * p + 1) / 2 * 2;
  l.vec = kBlockVecVals;
  const size_t scratch =
      (size_t)(block_gram_groups(p) - 1) * block_gram_blocks(p) * 16;
  const size_t buf = 2 * (size_t)l.pr * l.ts + l.ts;
  l.tile = tiles ? (buf > scratch ? buf : scratch) : 0;
  l.vals = nmat * l.mat + l.vec + l.tile;
  return l;
}

// The tile width of a block kernel at p with nmat matrices: the most
// warps' samples (up to the block's) whose layout stays within
// kBlockSmemTarget.  It depends on p, the type and the kernel alone, never
// on the gene count, so that a gene's sums run in the same order in any
// launch.
template <typename T>
inline int block_tile(int p, int nmat, bool tiles) {
  int tw = kBlockThreads;
  while (tw > 32 &&
         block_layout(p, tw, nmat, tiles).vals * sizeof(T) > kBlockSmemTarget)
    tw -= 32;
  return tw;
}

// The block's next gene from the launch's work counter (one atomic per
// gene), on every thread; slot is a shared int.
__device__ __forceinline__ int block_next_gene(int* counter, int* slot) {
  __syncthreads();
  if (threadIdx.x == 0) *slot = atomicAdd(counter, 1);
  __syncthreads();
  return *slot;
}

// Sum N per-thread values over the block, in a fixed order (each warp's
// butterfly, then the warps' totals in warp order), leaving the totals on
// every thread.  red: N kBlockWarpsN values of shared scratch.
template <typename T, int N>
__device__ __forceinline__ void block_allsum(T (&v)[N], T* red) {
  warp_allsum<T, N>(v);
  const int w = threadIdx.x >> 5;
  if (lane_id() == 0) {
#pragma unroll
    for (int e = 0; e < N; ++e) red[e * kBlockWarpsN + w] = v[e];
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < N; ++e) {
    T s = T(0);
    for (int k = 0; k < kBlockWarpsN; ++k) s += red[e * kBlockWarpsN + k];
    v[e] = s;
  }
  __syncthreads();
}

// The largest of the threads' values, on every thread.
template <typename T>
__device__ __forceinline__ T block_max(T v, T* red) {
  v = warp_max(v);
  if (lane_id() == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int k = 1; k < kBlockWarpsN; ++k) v = red[k] > v ? red[k] : v;
  __syncthreads();
  return v;
}

// Add a tile's first n samples to the thread's block, g += u_t v_t', as
// gram_add does over a warp (ts the tile buffers' column stride).
template <typename T>
__device__ __forceinline__ void block_gram_add(const GramMap& m,
                                               GramBlock<T>& g, const T* u,
                                               const T* v, int ts, int n) {
  if (!m.active) return;
  for (int t = m.grp; t < n; t += m.ng) {
    T ur[4], vc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ur[i] = u[(m.r0 + i) * ts + t];
      vc[i] = v[(m.c0 + i) * ts + t];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) g.a[i][j] += ur[i] * vc[j];
    }
  }
}

// Sum the groups' partial values (N a thread) into group 0's threads, in
// group order, through the block's shared scratch `red` ((ng - 1) nb N
// values).  Every thread of the block calls it; it ends with a
// __syncthreads.
template <typename T, int N>
__device__ __forceinline__ void block_gram_reduce(const GramMap& m, T* vals,
                                                  T* red) {
  __syncthreads();
  if (m.active && m.grp > 0) {
    const int slot = (m.grp - 1) * m.nb + (threadIdx.x - m.grp * m.nb);
#pragma unroll
    for (int e = 0; e < N; ++e) red[(size_t)slot * N + e] = vals[e];
  }
  __syncthreads();
  if (m.grp == 0) {
    for (int k = 1; k < m.ng; ++k) {
      const int slot = (k - 1) * m.nb + threadIdx.x;
#pragma unroll
      for (int e = 0; e < N; ++e) vals[e] += red[(size_t)slot * N + e];
    }
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ void block_gram_reduce(const GramMap& m,
                                                  GramBlock<T>& g, T* red) {
  block_gram_reduce<T, 16>(m, &g.a[0][0], red);
}

// Write the reduced gram into M (row stride p), as gram_store does, with
// the 64-bit column mask cm.  Ends with a __syncthreads.
template <typename T>
__device__ __forceinline__ void block_gram_store(const GramMap& m,
                                                 const GramBlock<T>& g, T* M,
                                                 int p,
                                                 unsigned long long cm,
                                                 bool unit_diag,
                                                 const T* diag) {
  if (m.grp == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = m.r0 + i, c = m.c0 + j;
        if (r <= c && c < p) {
          const T cr = (cm >> r) & 1ull ? T(1) : T(0);
          const T cc = (cm >> c) & 1ull ? T(1) : T(0);
          T v = g.a[i][j] * (cr * cc);
          if (r == c) {
            if (unit_diag) v += T(1) - cr;
            if (diag != nullptr) v += diag[r];
          }
          M[r * p + c] = v;
          M[c * p + r] = v;
        }
      }
    }
  }
  __syncthreads();
}

// In-place lower Cholesky factor of the p x p SPD matrix a (row stride p)
// in the block's shared memory: warp_cholesky's steps, pivot floor and
// order of reduction, with the rows below a column's pivot and the
// trailing entries shared out over the block.  With LogDet returns log
// det(a) on every thread (0 otherwise).  Every thread of the block calls
// it; it ends with a __syncthreads.
template <typename T, bool LogDet>
__device__ __forceinline__ T block_cholesky(T* a, int p) {
  const int t = threadIdx.x;
  T logdet = T(0);
  __syncthreads();
  for (int j = 0; j < p; ++j) {
    const T s = a[j * p + j];
    const T d = d_sqrt(s > T(1e-30) ? s : T(1e-30));
    if (LogDet) logdet += T(2) * d_log(d);
    __syncthreads();
    for (int i = j + 1 + t; i < p; i += kBlockThreads) a[i * p + j] /= d;
    if (t == 0) a[j * p + j] = d;
    __syncthreads();
    // the trailing lower triangle, rows i > j, columns j < k <= i
    const int m = p - j - 1;
    for (int e = t; e < m * m; e += kBlockThreads) {
      const int i = j + 1 + e / m, k = j + 1 + e % m;
      if (k <= i) a[i * p + k] -= a[i * p + j] * a[k * p + j];
    }
    __syncthreads();
  }
  return logdet;
}

// a^-1 = L^-T L^-1 given block_cholesky's factor L: thread j < p computes
// column j of L^-1 into li, as warp_chol_inverse does, then the threads
// share out the entries of a^-1, written to both triangles of `out` (which
// may be L's own buffer).  Every thread of the block calls it; it ends
// with a __syncthreads.
template <typename T>
__device__ __forceinline__ void block_chol_inverse(const T* L, T* li, T* out,
                                                   int p) {
  const int j = threadIdx.x;
  if (j < p) {
    li[j * p + j] = T(1) / L[j * p + j];
    for (int i = j + 1; i < p; ++i) {
      T s = T(0);
      for (int k = j; k < i; ++k) s += L[i * p + k] * li[k * p + j];
      li[i * p + j] = -s * (T(1) / L[i * p + i]);
    }
  }
  __syncthreads();
  const int nt = p * (p + 1) / 2;
  for (int e = threadIdx.x; e < nt; e += kBlockThreads) {
    int r = 0;
    while ((r + 1) * (r + 2) / 2 <= e) ++r;
    const int c = e - r * (r + 1) / 2;  // c <= r
    T s = T(0);
    for (int k = r; k < p; ++k) s += li[k * p + r] * li[k * p + c];
    out[r * p + c] = s;
    out[c * p + r] = s;
  }
  __syncthreads();
}

// sum_ij a_ij b_ji over p x p matrices (row stride p) in the block's
// shared memory, on every thread (the threads share out the entries in a
// fixed order, then block_allsum).
template <typename T>
__device__ __forceinline__ T block_trace_product(const T* a, const T* b,
                                                 int p, T* red) {
  T t[1] = {T(0)};
  for (int e = threadIdx.x; e < p * p; e += kBlockThreads) {
    const int i = e / p, j = e - (e / p) * p;
    t[0] += a[i * p + j] * b[j * p + i];
  }
  block_allsum<T, 1>(t, red);
  return t[0];
}

// The float32 block K2's tiles (ls_block_kernel<float>; the other block
// kernels keep the column-major tiles above), sample-major: sample
// t's design row x_t and u_t = w_t x_t at t ld of two buffers, pr rows
// (p rounded up to the gram's blocks of 4, zero past p).  ld = rows_ld(pr)
// is a multiple of 4, so that a lane reads its 4 x 4 block's four rows or
// columns of a sample in one 128-bit load (three a sample for its 32
// multiply-adds, where the column-major tiles take twelve), and 4 mod 8,
// so that eight consecutive samples' quads fall in distinct banks.
__host__ __device__ constexpr int rows_ld(int pr) {
  return pr % 8 ? pr : pr + 4;
}

// Slot t of the tile takes sample s: x_s and w x_s, four rows a 128-bit
// store (xt the design transposed, p x S).
__device__ __forceinline__ void rows_put(float* xb, float* ub, const float* xt,
                                         int S, int s, int p, int pr, int ld,
                                         int t, float w) {
  for (int k = 0; k < pr; k += 4) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = k + e < p ? __ldg(xt + (size_t)(k + e) * S + s) : 0.f;
    *reinterpret_cast<float4*>(xb + t * ld + k) =
        make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(ub + t * ld + k) =
        make_float4(w * v[0], w * v[1], w * v[2], w * v[3]);
  }
}

// block_gram_add's sums on sample-major tiles (u the tile of w x, v of x),
// with a second gram: the thread's group adds its samples t = group, group +
// ng, ... < n in that order to g1 (u_t v_t') and g2 (u_t u_t')
// (block_gram_map's map).
__device__ __forceinline__ void gram_add_rows(const GramMap& m,
                                              GramBlock<float>& g1,
                                              GramBlock<float>& g2,
                                              const float* u, const float* v,
                                              int ld, int n) {
  if (!m.active) return;
#pragma unroll 2
  for (int t = m.grp; t < n; t += m.ng) {
    const float4 a = *reinterpret_cast<const float4*>(u + t * ld + m.r0);
    const float4 b = *reinterpret_cast<const float4*>(v + t * ld + m.c0);
    const float4 c = *reinterpret_cast<const float4*>(u + t * ld + m.c0);
    const float ur[4] = {a.x, a.y, a.z, a.w};
    const float vc[4] = {b.x, b.y, b.z, b.w};
    const float uc[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) g1.a[i][j] += ur[i] * vc[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) g2.a[i][j] += ur[i] * uc[j];
    }
  }
}

// Slot t of the tile takes sample s's design row, four values a 128-bit
// store (rows_put's x half; xt the design transposed, p x S): each thread
// its own sample, so a warp reads a column's consecutive samples (the
// float32 K3s': the block K3's tiles, the wide K3's staged design; the
// float32 K1's k1_stage, a warp a quad, measured 1.15-1.21x slower in the
// block K3).
__device__ __forceinline__ void x_row_put(float* xb, const float* xt, int S,
                                          int s, int p, int pr, int ld,
                                          int t) {
  for (int k = 0; k < pr; k += 4) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = k + e < p ? __ldg(xt + (size_t)(k + e) * S + s) : 0.f;
    *reinterpret_cast<float4*>(xb + t * ld + k) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Add a tile's first n samples to the thread's blocks of two points'
// grams, ga += (wa_t x_t[r]) x_t[c]' and gb += (wb_t x_t[r]) x_t[c]' (its
// group's samples t = group, group + ng, ... < n in that order; xb the
// tile's design rows, wa and wb its weights at the two points; the map
// over a block or a warp): each design quad loaded once for both, the
// products w x of a tile of w x (rows_put's), so each gram's bits are a
// one-point pass's.
__device__ __forceinline__ void pair_add_rows(const GramMap& m,
                                              GramBlock<float>& ga,
                                              GramBlock<float>& gb,
                                              const float* xb,
                                              const float* wa,
                                              const float* wb, int ld,
                                              int n) {
  if (!m.active) return;
#pragma unroll 2
  for (int t = m.grp; t < n; t += m.ng) {
    const float4 a = *reinterpret_cast<const float4*>(xb + t * ld + m.r0);
    const float4 b = *reinterpret_cast<const float4*>(xb + t * ld + m.c0);
    const float w0 = wa[t], w1 = wb[t];
    const float xr[4] = {a.x, a.y, a.z, a.w};
    const float xc[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float u0 = w0 * xr[i], u1 = w1 * xr[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ga.a[i][j] += u0 * xc[j];
        gb.a[i][j] += u1 * xc[j];
      }
    }
  }
}

// The float32 block K2's p x p algebra (ls_block_kernel<float>, row stride
// p <= 64): the same operations on every entry in the same order as
// block_cholesky and block_chol_inverse (so the same bits), laid out for
// fewer cycles: the factor on one warp (lane l owns rows l and l + 32),
// one __syncwarp a column, against block_cholesky's three block barriers;
// the inverse's sums with four loads in flight.

// The lower Cholesky factor L of the p x p SPD matrix a (both triangles
// given), written to a's lower triangle and its transpose to the upper
// one, returning log det(a) on every lane (0 without LogDet).
// Left-looking, a column at a time: lane l computes entries i = j + l and
// (Rows = 2, p <= 64) j + l + 32 of column j as a_ij - L_i0 L_j0 - L_i1
// L_j1 - ... (the order in which block_cholesky's updates reach a_ij),
// reading the earlier columns from the upper copy (row k of L',
// consecutive lanes on consecutive values); the pivot comes by shuffle.
// Rows = 1 takes p <= 32.  Every lane of the warp calls it.
template <typename T, int Rows = 2, bool LogDet = true>
__device__ __forceinline__ T warp_cholesky_ll(T* a, int p) {
  const int lane = lane_id();
  T logdet = T(0);
  for (int j = 0; j < p; ++j) {
    const int i0 = j + lane, i1 = i0 + 32;
    T s0 = i0 < p ? a[j * p + i0] : T(1);
    T s1 = Rows == 2 && i1 < p ? a[j * p + i1] : T(1);
    const T* uj = a + j;
    int k = 0;
    for (; k + 4 <= j; k += 4) {
      T lj[4], l0[4], l1[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lj[e] = uj[(k + e) * p];
        l0[e] = i0 < p ? a[(k + e) * p + i0] : T(0);
        if constexpr (Rows == 2) l1[e] = i1 < p ? a[(k + e) * p + i1] : T(0);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s0 -= l0[e] * lj[e];
        if constexpr (Rows == 2) s1 -= l1[e] * lj[e];
      }
    }
    for (; k < j; ++k) {
      const T lj = uj[k * p];
      if (i0 < p) s0 -= a[k * p + i0] * lj;
      if constexpr (Rows == 2) {
        if (i1 < p) s1 -= a[k * p + i1] * lj;
      }
    }
    const T piv = __shfl_sync(kFullMask, s0, 0);
    const T d = d_sqrt(piv > T(1e-30) ? piv : T(1e-30));
    if constexpr (LogDet) logdet += T(2) * d_log(d);
    if (lane == 0) {
      a[j * p + j] = d;
    } else if (i0 < p) {
      const T l = s0 / d;
      a[j * p + i0] = l;
      a[i0 * p + j] = l;
    }
    if constexpr (Rows == 2) {
      if (i1 < p) {
        const T l = s1 / d;
        a[j * p + i1] = l;
        a[i1 * p + j] = l;
      }
    }
    __syncwarp();
  }
  return logdet;
}

// sum_k a[k] b[k * ld] over k in [k0, k1), in increasing k, onto s (four
// loads of each in flight)
template <typename T>
__device__ __forceinline__ T dot_ld(const T* a, const T* b, int ld, int k0,
                                    int k1, T s) {
  int k = k0;
  for (; k + 4 <= k1; k += 4) {
    T x[4], y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = a[k + e];
      y[e] = b[(k + e) * ld];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s += x[e] * y[e];
  }
  for (; k < k1; ++k) s += a[k] * b[k * ld];
  return s;
}

// block_chol_inverse's a^-1 = L^-T L^-1 (thread j < p: column j of L^-1
// into li; then the threads share out the entries of a^-1, written to
// both triangles of `out`), each sum in its order, the loops with four
// loads in flight.  Every thread of the block calls it; it ends with a
// __syncthreads.
template <typename T>
__device__ __forceinline__ void block_chol_inverse_ld(const T* L, T* li,
                                                      T* out, int p) {
  const int j = threadIdx.x;
  if (j < p) {
    li[j * p + j] = T(1) / L[j * p + j];
    for (int i = j + 1; i < p; ++i) {
      const T s = dot_ld(L + i * p, li + j, p, j, i, T(0));
      li[i * p + j] = -s * (T(1) / L[i * p + i]);
    }
  }
  __syncthreads();
  const int nt = p * (p + 1) / 2;
  for (int e = threadIdx.x; e < nt; e += kBlockThreads) {
    int r = 0;
    while ((r + 1) * (r + 2) / 2 <= e) ++r;
    const int c = e - r * (r + 1) / 2;  // c <= r
    T s = T(0);
    int k = r;
    for (; k + 4 <= p; k += 4) {
      T x[4], y[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[q] = li[(k + q) * p + r];
        y[q] = li[(k + q) * p + c];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) s += x[q] * y[q];
    }
    for (; k < p; ++k) s += li[k * p + r] * li[k * p + c];
    out[r * p + c] = s;
    out[c * p + r] = s;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The float32 K1's pieces (irls_block_kernel<float> over a block; of
// them irls_wide_kernel<float> takes k1_inverse, over one warp)
// ---------------------------------------------------------------------------
//
// - a pass stages a tile's samples sample-major: x_s at t ld (ld =
//   rows_ld(pr), zero past p), its weight w_s and w_s z_s beside (k1_row
//   a sample, k1_stage a tile over a block), and a gram thread reads a
//   sample's four rows or columns in one 128-bit load, forming w x_r
//   itself (k1_gram_add): the product the column-major tiles stored, so
//   one buffer holds a tile;
// - after the fit the factor's inverse L^-1 is kept, its rows padded to
//   lt = rows_ld(pr) values, zero past the diagonal (k1_inverse), and the
//   hat diagonal is w_s |L^-1 x_s|^2 (k1_hat_part): the lower triangle's
//   p (p + 1) / 2 multiply-adds a sample in 128-bit loads, a dependent
//   chain a row, where x_s' A^-1 x_s took p^2 in one chain;
// - the sandwich's diagonal entry a_t' X'WX a_t (a_t: column t of A^-1) is
//   shared out over k threads (k1_sandwich_part), where one thread ran
//   its p^2 chain.

// Slot t of the tile takes sample s's design row, four values a 128-bit
// store (xt the design transposed, p x S); returns x_s' sb summed in k's
// order (the pass's eta at the coefficients sb).
__device__ __forceinline__ float k1_row(float* xb, const float* xt, int S,
                                        int s, int p, int pr, int ld, int t,
                                        const float* sb) {
  float eta = 0.f;
  for (int k = 0; k < pr; k += 4) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = k + e < p ? __ldg(xt + (size_t)(k + e) * S + s) : 0.f;
      if (k + e < p) eta += sb[k + e] * v[e];
    }
    *reinterpret_cast<float4*>(xb + t * ld + k) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
  return eta;
}

// The n design rows of a tile from sample base on (k1_row's layout,
// rows of ld values, zero past p), their quads shared out over the
// block: warp w the quads w, w + 8, ..., its lanes consecutive samples, so
// that they read a column's consecutive samples.
__device__ __forceinline__ void k1_stage(float* xb, const float* xt, int S,
                                         int base, int n, int p, int pr,
                                         int ld) {
  for (int k = 4 * (threadIdx.x >> 5); k < pr; k += 4 * kBlockWarpsN) {
    for (int i = lane_id(); i < n; i += 32) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = k + e < p ? __ldg(xt + (size_t)(k + e) * S + base + i) : 0.f;
      *reinterpret_cast<float4*>(xb + i * ld + k) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Add a tile's first n samples to the thread's block (a GramMap over the
// block or the warp): its group's samples t = group, group + ng, ... < n
// in that order, g += (w_t x_t[r]) x_t[c]' and rz += (w_t z_t) x_t[c]
// (X'Wz at a diagonal block's rows; wz the tile's w z): the products and
// roundings of gram_add's u = w x and w z tiles.
__device__ __forceinline__ void k1_gram_add(const GramMap& m,
                                            GramBlock<float>& g,
                                            float (&rz)[4], const float* xb,
                                            const float* wb, const float* wz,
                                            int ld, int n) {
  if (!m.active) return;
#pragma unroll 1
  for (int t = m.grp; t < n; t += m.ng) {
    const float w = wb[t], zt = wz[t];
    const float4 a = *reinterpret_cast<const float4*>(xb + t * ld + m.r0);
    const float4 b = *reinterpret_cast<const float4*>(xb + t * ld + m.c0);
    const float ur[4] = {w * a.x, w * a.y, w * a.z, w * a.w};
    const float vc[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) g.a[i][j] += ur[i] * vc[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) rz[j] += zt * vc[j];
  }
}

// From the lower factor L (row stride lda) of A: L^-1 into li (rows of lt
// values, zero above the diagonal and in the columns p..pr-1) and A^-1 =
// L^-T L^-1 into out (both triangles, row stride lda; out may be L), each
// value as block_chol_inverse_ld computes it.  The reciprocals of L's
// diagonal go first to rd (p values of scratch), then thread j < pr of the
// Warps warps (the block's, or the wide kernel's one) computes column j of
// L^-1, and they share out A^-1's entries.  Ends with their barrier.
template <int Warps>
__device__ __forceinline__ void k1_inverse(const float* L, int lda,
                                           float* li, int lt, float* out,
                                           int p, int pr, float* rd) {
  const int j = Warps == 1 ? lane_id() : (int)threadIdx.x;
  if (j < p) rd[j] = 1.f / L[j * lda + j];
  warps_sync<Warps>();
  if (j < pr) {
    for (int i = 0; i < p && i < j; ++i) li[i * lt + j] = 0.f;
    if (j < p) {
      li[j * lt + j] = rd[j];
      for (int i = j + 1; i < p; ++i) {
        const float s = dot_ld(L + i * lda, li + j, lt, j, i, 0.f);
        li[i * lt + j] = -s * rd[i];
      }
    }
  }
  warps_sync<Warps>();
  const int nt = p * (p + 1) / 2;
  for (int e = j; e < nt; e += 32 * Warps) {
    int r = 0;
    while ((r + 1) * (r + 2) / 2 <= e) ++r;
    const int c = e - r * (r + 1) / 2;  // c <= r
    float s = 0.f;
    int k = r;
    for (; k + 4 <= p; k += 4) {
      float x[4], y[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        x[q] = li[(k + q) * lt + r];
        y[q] = li[(k + q) * lt + c];
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) s += x[q] * y[q];
    }
    for (; k < p; ++k) s += li[k * lt + r] * li[k * lt + c];
    out[r * lda + c] = s;
    out[c * lda + r] = s;
  }
  warps_sync<Warps>();
}

// The share j of k of |L^-1 x|^2 for a staged row xr: the rows i = j,
// j + k, ... < p of L^-1 (k1_inverse's li), each (L^-1 x)_i over the
// quads up to its diagonal's, squared and added in i's order.
__device__ __forceinline__ float k1_hat_part(const float* li, int lt,
                                             const float* xr, int p, int j,
                                             int k) {
  float q = 0.f;
  for (int i = j; i < p; i += k) {
    const float* lr = li + i * lt;
    float y = 0.f;
    for (int c = 0; c <= i; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(lr + c);
      const float4 b = *reinterpret_cast<const float4*>(xr + c);
      y += a.x * b.x;
      y += a.y * b.y;
      y += a.z * b.z;
      y += a.w * b.w;
    }
    q += y * y;
  }
  return q;
}

// The share sub of k of the sandwich's diagonal entry col: the rows m =
// sub, sub + k, ... < p of A^-1[col][m] (X'WX[m] . A^-1[col]) (both p x p,
// row stride lda; A^-1's row col read as its column), in m's order.
__device__ __forceinline__ float k1_sandwich_part(const float* ainv,
                                                  const float* xw, int lda,
                                                  int p, int col, int sub,
                                                  int k) {
  const float* ac = ainv + col * lda;
  float s = 0.f;
  for (int m = sub; m < p; m += k)
    s += ac[m] * dot_ld(xw + m * lda, ac, 1, 0, p, 0.f);
  return s;
}

// Sum v over the k consecutive lanes of a group (k a power of 2 dividing
// 32) by an xor butterfly: the same bits on each of them.
__device__ __forceinline__ float lanes_sum(float v, int k) {
  for (int o = 1; o < k; o <<= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// The weighted Cox-Reid column mask at p <= 64 columns, a 64-bit word on
// every thread: column k stays when some kept row has x_k != 0
// (ops/disp.py:make_cr_masks); xt is the design transposed (p x S).
template <typename T>
__device__ __forceinline__ unsigned long long block_cr_col_mask(
    const T* wr, const T* xt, int S, int p, T thr, unsigned long long* slot) {
  unsigned long long cm = 0ull;
  for (int s = threadIdx.x; s < S; s += kBlockThreads) {
    if (cr_keeps(wr[s], thr)) {
      for (int k = 0; k < p; ++k)
        cm |= __ldg(xt + (size_t)k * S + s) != T(0) ? (1ull << k) : 0ull;
    }
  }
  const unsigned lo = __reduce_or_sync(kFullMask, (unsigned)cm);
  const unsigned hi = __reduce_or_sync(kFullMask, (unsigned)(cm >> 32));
  __syncthreads();
  if (threadIdx.x == 0) *slot = 0ull;
  __syncthreads();
  if (lane_id() == 0)
    atomicOr(slot, ((unsigned long long)hi << 32) | (unsigned long long)lo);
  __syncthreads();
  cm = *slot;
  __syncthreads();
  return cm;
}

// Thread t < tw writes its sample's design row x_s and w x_s into the
// block's column-major tile buffers (slot t of each column, stride ts).
template <typename T>
__device__ __forceinline__ void block_tile_put(T* xb, T* ub, const T* xt,
                                               int S, int s, int p, int ts,
                                               T w) {
  const int t = threadIdx.x;
  for (int k = 0; k < p; ++k) {
    const T v = __ldg(xt + (size_t)k * S + s);
    xb[k * ts + t] = v;
    ub[k * ts + t] = w * v;
  }
}

// ---------------------------------------------------------------------------
// The float64 grams on the FP64 tensor cores (irls_block.cu,
// disp_ls_block.cu, and disp_ls.cu's wide K2 on one warp; float32 keeps
// the 4 x 4 blocks above)
// ---------------------------------------------------------------------------
//
// In float64 K1's and K2's grams are mma.sync m8n8k4 products (D = C + A B
// over 8 x 8 x 4 tiles; lane l holds A[l / 4][l % 4], B[l % 4][l / 4] and
// C[l / 4][2 (l % 4) + e], e = 0, 1):
// - a kernel first computes every sample's terms, each thread some
//   samples, and writes the weights w (and K1's working response z) to
//   global scratch; then a pass walks the samples in tiles of tw
//   (gram_mma_pass): the design's rows x_k by cp.async (pr x ts values, pr
//   = 8 x the gram's column tiles; the rows past p and the last tile's
//   samples past S are zero; K1's row p is z) and w (one row of ts after
//   them).  ts = tw + 4 = 4 mod 16 values: a fragment's 8-byte loads at r
//   ts + c (r < 4, c < 4 a half-warp) fall on 16 distinct slots of the
//   banks.  No gram accumulator is live while the special functions run,
//   which keeps the kernels at two blocks an SM without spills;
// - a pass sums b = sum_s (w_s x_s) x_s' (K1's column p: X'Wz) or K2's
//   second gram, sum_s (w_s x_s) (w_s x_s)', in a pass of its own: the
//   upper 8 x 8 tiles (i <= j), row by row, are cut into kBlockWarpsN runs
//   of consecutive tiles, one a warp (mma_run).  A warp keeps its run's
//   accumulators in registers over the pass; at each k-step (4 samples)
//   it loads one B fragment a tile (x's rows of column tile j) and takes
//   A (w x of row tile i) from the run's first tile or, at a row's start,
//   from the diagonal tile's B;
// - every entry is summed by one warp over the k-steps in ascending
//   order: two launches give the same bits, and a gene's result does not
//   depend on the genes beside it.  The warps store their tiles into the
//   shared matrices by block_gram_store's rules (gram_mma_store).

// D = C + A B over one 8 x 8 x 4 float64 tile, C and D in c (sm_80 and
// later)
__device__ __forceinline__ void mma_f64(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, "
      "{%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

// Copy one value from global to shared memory without a register (8
// bytes; zeros where !valid, reading nothing), and wait for the thread's
// copies.  A __syncthreads after the wait shows every thread's copies.
__device__ __forceinline__ void cp_async8(double* dst, const double* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}


// The float64 block kernels' shared-memory layout (BlockLayout's fields):
// nmat p x p matrices, the vectors, then the tile buffer of pr = 8 cols
// design rows and `extra` rows more (the weights; K1's hat pass, the
// warps' partial sums), each of ts = tw + 4 values, and at least min_tile
// values (K1's second matrix after the fit).
__host__ __device__ inline BlockLayout block_mma_layout(int p, int tw,
                                                        int nmat, int cols,
                                                        int extra,
                                                        int min_tile) {
  BlockLayout l;
  l.p = p;
  l.pr = 8 * cols;
  l.tw = tw;
  l.ts = tw + 4;
  l.mat = (size_t)p * p;
  l.vec = kBlockVecVals;
  l.tile = (size_t)(l.pr + extra) * l.ts;
  if (l.tile < (size_t)min_tile) l.tile = min_tile;
  l.vals = nmat * l.mat + l.vec + l.tile;
  return l;
}

// block_tile for block_mma_layout: the widest tile (a multiple of 32
// samples, at most the block's) within kBlockSmemTarget, set by p and the
// kernel alone.
inline int block_mma_tile(int p, int nmat, int cols, int extra,
                          int min_tile) {
  int tw = kBlockThreads;
  while (tw > 32 &&
         block_mma_layout(p, tw, nmat, cols, extra, min_tile).vals *
                 sizeof(double) >
             kBlockSmemTarget)
    tw -= 32;
  return tw;
}

// Stage a tile's design rows into xb (row k at k ts): x_k of the tile's n
// samples from `base`, zeros past n (up to tw) and in the rows p..pr-1,
// but row zrow (K1's z, which its sample threads write; -1: none).  The
// Warps warps of the caller (the block's, or one: the wide kernel's warp
// per gene) take rows in turn, lanes consecutive samples; the copies land
// by cp_async_wait_all.
template <int Warps = kBlockWarpsN>
__device__ __forceinline__ void mma_stage(double* xb, const double* x, int S,
                                          int base, int n, int p, int pr,
                                          int ts, int tw, int zrow) {
  const int lane = lane_id();
  for (int k = Warps == 1 ? 0 : threadIdx.x >> 5; k < pr; k += Warps) {
    if (k == zrow) continue;
    const bool row = k < p;
    const double* src = x + (size_t)(row ? k : 0) * S + base;
    for (int c = lane; c < tw; c += 32) {
      const bool valid = row && c < n;
      cp_async8(xb + k * ts + c, valid ? src + c : x, valid);
    }
  }
}

// the most tiles in a warp's run (p = 64): K1's 44 (the 36 upper tiles and
// the 8 of the column tile holding X'Wz) and K2's 36 over kBlockWarpsN
// warps; the wide K2's 3 (8 < p <= 16: two column tiles) on its one warp
constexpr int kMmaRunK1 = 6;
constexpr int kMmaRunK2 = 5;
constexpr int kMmaRunWide = 3;

// A warp's run of the gram's tile list (i < nr, i <= j < nc, row by row),
// the list cut into Warps runs (the block's warps, or one warp's whole
// list): its first tile and length, the lane's offsets of the first tile's
// A and B rows, (8 i + l / 4) ts + l % 4 and (8 j + l / 4) ts + l % 4, the
// step from a tile's B rows to the next column's (8 ts), and which tiles
// start a row (their A and B rows are the row's diagonal tile's).  Set by
// p and the layout alone.
template <int N>
struct MmaRun {
  int i0, j0, n, nc;
  int offa, offb, step;
  unsigned rowstart;
};

template <int N, int Warps = kBlockWarpsN>
__device__ __forceinline__ MmaRun<N> mma_run(int nr, int nc, int ts) {
  MmaRun<N> m;
  const int w = Warps == 1 ? 0 : threadIdx.x >> 5, lane = lane_id();
  const int lo = (lane >> 2) * ts + (lane & 3);
  int total = 0;
  for (int i = 0; i < nr; ++i) total += nc - i;
  const int per = total / Warps, more = total % Warps;
  const int start = w * per + (w < more ? w : more);
  m.n = per + (w < more ? 1 : 0);
  m.nc = nc;
  int i = 0, j = 0;
  for (int k = 0; k < start; ++k) {
    if (++j == nc) j = ++i;
  }
  m.i0 = i;
  m.j0 = j;
  m.step = 8 * ts;
  m.offa = 8 * i * ts + lo;
  m.offb = 8 * j * ts + lo;
  m.rowstart = 0u;
  for (int q = 1; q < N; ++q) {
    if (++j == nc) j = ++i;
    if (j == i) m.rowstart |= 1u << q;
  }
  return m;
}

// The warp's accumulators: a 8 x 8 tile's two values a lane, for each of
// its run's tiles.
template <int N>
__device__ __forceinline__ void gram_mma_zero(double (&acc)[N][2]) {
#pragma unroll
  for (int q = 0; q < N; ++q) acc[q][0] = acc[q][1] = 0.0;
}

// Add a tile's first n samples to the warp's run: xb the tile's design
// rows, wb its weights (the samples past n, up to a multiple of 4, are
// zero); the gram is sum_s (w_s x_s) x_s', or with Sq sum_s (w_s x_s)
// (w_s x_s)'.  With Both, acc takes the first and sq the second from the
// same fragments (the wide K2's b and X'W^2X in one pass).  The run's
// length L is a template argument (gram_mma_add picks it), so that no
// mma.sync sits under a predicate.
template <int L, int N, bool Sq, bool Both = false>
__device__ __forceinline__ void gram_mma_add_len(const MmaRun<N>& m,
                                                 double (&acc)[N][2],
                                                 const double* xb,
                                                 const double* wb, int n,
                                                 double (*sq)[2] = nullptr) {
  const int c = lane_id() & 3;
  for (int k0 = 0; k0 < n; k0 += 4) {
    const double wk = wb[k0 + c];
    const double* xk = xb + k0;
    int oa = m.offa, ob = m.offb;
    double a = xk[oa] * wk;
#pragma unroll
    for (int q = 0; q < L; ++q) {
      const bool rs = (m.rowstart >> q) & 1u;
      if (q > 0) {
        oa = rs ? oa + m.step : oa;
        ob = rs ? oa : ob + m.step;
      }
      const double b = xk[ob];
      if (rs) a = b * wk;
      mma_f64(acc[q], a, Sq ? b * wk : b);
      if constexpr (Both) mma_f64(sq[q], a, b * wk);
    }
  }
}

template <int N, bool Sq, int L = N, bool Both = false>
__device__ __forceinline__ void gram_mma_add(const MmaRun<N>& m,
                                             double (&acc)[N][2],
                                             const double* xb,
                                             const double* wb, int n,
                                             double (*sq)[2] = nullptr) {
  if constexpr (L > 0) {
    if (m.n == L)
      gram_mma_add_len<L, N, Sq, Both>(m, acc, xb, wb, n, sq);
    else
      gram_mma_add<N, Sq, L - 1, Both>(m, acc, xb, wb, n, sq);
  }
}

// Add a tile's first n samples to the warp's runs of two points' grams,
// ga += (wa x) x' and gb += (wb x) x' (the float64 K3s': the block's runs,
// or the wide kernel's one warp's): the design's fragments loaded once
// for both (gram_mma_add_len's order and products, so each gram's bits are
// a one-point pass's).  pair_add picks the run's length L.
template <int L, int N>
__device__ __forceinline__ void pair_add_len(const MmaRun<N>& m,
                                             double (&ga)[N][2],
                                             double (&gb)[N][2],
                                             const double* xb,
                                             const double* wa,
                                             const double* wb, int n) {
  const int c = lane_id() & 3;
  for (int k0 = 0; k0 < n; k0 += 4) {
    const double wka = wa[k0 + c], wkb = wb[k0 + c];
    const double* xk = xb + k0;
    int oa = m.offa, ob = m.offb;
    double xa = xk[oa];
#pragma unroll
    for (int q = 0; q < L; ++q) {
      const bool rs = (m.rowstart >> q) & 1u;
      if (q > 0) {
        oa = rs ? oa + m.step : oa;
        ob = rs ? oa : ob + m.step;
      }
      const double b = xk[ob];
      if (rs) xa = b;
      mma_f64(ga[q], xa * wka, b);
      mma_f64(gb[q], xa * wkb, b);
    }
  }
}

template <int N, int L = N>
__device__ __forceinline__ void pair_add(const MmaRun<N>& m,
                                         double (&ga)[N][2],
                                         double (&gb)[N][2],
                                         const double* xb, const double* wa,
                                         const double* wb, int n) {
  if constexpr (L > 0) {
    if (m.n == L)
      pair_add_len<L, N>(m, ga, gb, xb, wa, wb, n);
    else
      pair_add<N, L - 1>(m, ga, gb, xb, wa, wb, n);
  }
}

// One pass of a gene's samples through the gram: per tile, the design rows
// by cp.async (mma_stage), the weights from wg (global, S values) and,
// with zg, K1's working response from zg as row p; then the warp's run
// (acc, zeroed first; with Both also sq, gram_mma_add_len's).  Every
// thread of the Warps warps that share the tile calls it (the block's, or
// the wide K2's one warp, whose tile is 32 samples: tw = 32).
template <int N, bool Sq, int Warps = kBlockWarpsN, bool Both = false>
__device__ __forceinline__ void gram_mma_pass(const MmaRun<N>& m,
                                              double (&acc)[N][2],
                                              double* tile,
                                              const BlockLayout& lay,
                                              const double* x, int S,
                                              const double* wg,
                                              const double* zg,
                                              double (*sq)[2] = nullptr) {
  const int t = Warps == 1 ? lane_id() : (int)threadIdx.x, p = lay.p,
            tw = lay.tw, ts = lay.ts;
  double* wb = tile + (size_t)lay.pr * ts;
  double* zb = tile + (size_t)p * ts;
  gram_mma_zero(acc);
  if constexpr (Both) {
#pragma unroll
    for (int q = 0; q < N; ++q) sq[q][0] = sq[q][1] = 0.0;
  }
  for (int base = 0; base < S; base += tw) {
    const int n = S - base < tw ? S - base : tw;
    warps_sync<Warps>();
    mma_stage<Warps>(tile, x, S, base, n, p, lay.pr, ts, tw, zg ? p : -1);
    if (t < tw) {
      wb[t] = t < n ? wg[base + t] : 0.0;
      if (zg) zb[t] = t < n ? zg[base + t] : 0.0;
    }
    cp_async_wait_all();
    warps_sync<Warps>();
    gram_mma_add<N, Sq, N, Both>(m, acc, tile, wb, n, sq);
  }
}

// Write the warps' runs (negated with neg) into M (row stride p, or Ld
// when given: the wide kernels' kPWide) by block_gram_store's rules: both
// triangles of the upper entries r <= c < p, times the 64-bit column
// mask's bits, the unit diagonal of dropped columns, the diagonal `diag`.
// With rhs, the entries (r, p) of K1's X'Wz column go to rhs[r].  Every
// thread of the Warps warps calls it; it ends with their barrier.
template <int N, int Warps = kBlockWarpsN, int Ld = 0>
__device__ __forceinline__ void gram_mma_store(const MmaRun<N>& m,
                                               const double (&acc)[N][2],
                                               bool neg, double* M, int p,
                                               unsigned long long cm,
                                               bool unit_diag,
                                               const double* diag,
                                               double* rhs) {
  const int lane = lane_id(), r8 = lane >> 2, c8 = 2 * (lane & 3);
  const int ld = Ld ? Ld : p;
  int i = m.i0, j = m.j0;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    if (q < m.n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = 8 * i + r8, c = 8 * j + c8 + e;
        const double g = neg ? -acc[q][e] : acc[q][e];
        if (r <= c && c < p) {
          const double cr = (cm >> r) & 1ull ? 1.0 : 0.0;
          const double cc = (cm >> c) & 1ull ? 1.0 : 0.0;
          double v = g * (cr * cc);
          if (r == c) {
            if (unit_diag) v += 1.0 - cr;
            if (diag != nullptr) v += diag[r];
          }
          M[r * ld + c] = v;
          M[c * ld + r] = v;
        } else if (rhs != nullptr && c == p && r < p) {
          rhs[r] = g;
        }
      }
      if (++j == m.nc) j = ++i;
    }
  }
  warps_sync<Warps>();
}

// block_cholesky's factor, with the same operations on every entry in
// the same order (so the same bits), laid out for fewer cycles: the
// trailing update's rows go to the warps and its columns to the lanes (no
// index division, only the lower triangle visited), column j's scaled
// values are kept in col (p values of shared scratch) so that the lanes
// read them without bank conflicts, a[jj] is written in the update phase
// (two barriers a column), and the factor's transpose fills the upper
// triangle.  Then the solution by warp 0 (warp_chol_solve's order of
// reduction) with r in its registers (lane l: r_l and r_{l+32}), each
// step's value broadcast by shuffle and multiplied by the pivot's
// reciprocal (computed first), the forward steps reading L's columns as the
// upper triangle's rows.  K1's float64 path (irls_block_mma).
__device__ __forceinline__ void block_cholesky_rows(double* a, int p,
                                                    double* col) {
  const int lane = lane_id(), w = threadIdx.x >> 5;
  __syncthreads();
  for (int j = 0; j < p; ++j) {
    const double s = a[j * p + j];
    const double d = d_sqrt(s > 1e-30 ? s : 1e-30);
    for (int i = j + 1 + threadIdx.x; i < p; i += kBlockThreads) {
      const double l = a[i * p + j] / d;
      a[i * p + j] = l;
      a[j * p + i] = l;
      col[i] = l;
    }
    __syncthreads();
    if (threadIdx.x == 0) a[j * p + j] = d;
    for (int i = j + 1 + w; i < p; i += kBlockWarpsN) {
      const double lij = col[i];
      for (int k = j + 1 + lane; k <= i; k += 32)
        a[i * p + k] -= lij * col[k];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void block_chol_solve_rows(const double* L, int p,
                                                      double* r) {
  if (threadIdx.x < 32) {
    const int lane = lane_id();
    const bool in0 = lane < p, in1 = lane + 32 < p;
    double r0 = in0 ? r[lane] : 0.0, r1 = in1 ? r[lane + 32] : 0.0;
    const double d0 = in0 ? 1.0 / L[lane * (p + 1)] : 0.0;
    const double d1 = in1 ? 1.0 / L[(lane + 32) * (p + 1)] : 0.0;
    // L w = r: w_i from its lane, then r_k -= L[k][i] w_i (the upper copy's
    // row i)
    for (int i = 0; i < p; ++i) {
      const double wi =
          __shfl_sync(kFullMask, i < 32 ? r0 * d0 : r1 * d1, i & 31);
      const double* li = L + i * p;
      if (lane == i) r0 = wi;
      if (lane + 32 == i) r1 = wi;
      if (lane > i && in0) r0 -= li[lane] * wi;
      if (lane + 32 > i && in1) r1 -= li[lane + 32] * wi;
    }
    // L' x = w: x_i from its lane, then r_k -= L[i][k] x_i for k < i
    for (int i = p - 1; i >= 0; --i) {
      const double xi =
          __shfl_sync(kFullMask, i < 32 ? r0 * d0 : r1 * d1, i & 31);
      const double* li = L + i * p;
      if (lane == i) r0 = xi;
      if (lane + 32 == i) r1 = xi;
      if (lane < i) r0 -= li[lane] * xi;
      if (lane + 32 < i) r1 -= li[lane + 32] * xi;
    }
    if (in0) r[lane] = r0;
    if (in1) r[lane + 32] = r1;
  }
  __syncthreads();
}

// Resident blocks per SM of a block kernel with `smem` bytes of dynamic
// shared memory, and the persistent launch's block count: as many as fit
// on the card at once, no more than the genes.  Returns 0 and sets *err
// on a refusal.
template <typename K>
inline int persistent_gene_blocks(K kernel, size_t smem, int G, int* err) {
  const int per_sm = blocks_per_sm(kernel, smem, err, kBlockThreads);
  if (*err) return 0;
  int dev = 0, sms = 0;
  if ((*err = (int)cudaGetDevice(&dev))) return 0;
  if ((*err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                          dev)))
    return 0;
  if (per_sm < 1) {
    *err = (int)cudaErrorInvalidConfiguration;
    return 0;
  }
  return per_sm * sms < G ? per_sm * sms : G;
}

}  // namespace dk

// Dispatch a templated launch on the run-time design width p = 1..8.
#define DK_DISPATCH_P(p, ...) \
  switch (p) {                 \
    case 1: { constexpr int P = 1; __VA_ARGS__; } break; \
    case 2: { constexpr int P = 2; __VA_ARGS__; } break; \
    case 3: { constexpr int P = 3; __VA_ARGS__; } break; \
    case 4: { constexpr int P = 4; __VA_ARGS__; } break; \
    case 5: { constexpr int P = 5; __VA_ARGS__; } break; \
    case 6: { constexpr int P = 6; __VA_ARGS__; } break; \
    case 7: { constexpr int P = 7; __VA_ARGS__; } break; \
    case 8: { constexpr int P = 8; __VA_ARGS__; } break; \
    default: return (int)cudaErrorInvalidValue;   \
  }
