// Device helpers shared by the three per-gene solver kernels
// (irls.cu, disp_ls.cu, disp_grid.cu): warp reductions, the NB special
// functions with their float32 large-c series branches, unrolled p x p
// Cholesky routines for p = 1..8, and the weighted Cox-Reid masks.
//
// One layout: a warp's lanes stride over a gene's samples, warp_allsum
// leaves the sums on every lane, and every lane runs the same p x p
// algebra on the same values, so no barrier or broadcast follows a sum.
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

}  // namespace dk

// A wide build compiles one more width with -DDK_WIDE_P=n (and, with
// -DDK_WIDE_ONLY, that width alone); the kernels' own builds define
// neither.
#ifdef DK_WIDE_P
#define DK_WIDE_CASE(...) \
  case DK_WIDE_P: { constexpr int P = DK_WIDE_P; __VA_ARGS__; } break;
#else
#define DK_WIDE_CASE(...)
#endif

#ifdef DK_WIDE_ONLY
#define DK_DISPATCH_P(p, ...)        \
  switch (p) {                       \
    DK_WIDE_CASE(__VA_ARGS__)        \
    default: return (int)cudaErrorInvalidValue; \
  }
#else
// Dispatch a templated launch on the runtime design width p = 1..8.
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
    DK_WIDE_CASE(__VA_ARGS__)                             \
    default: return (int)cudaErrorInvalidValue;   \
  }
#endif
