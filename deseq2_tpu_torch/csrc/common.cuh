// Device helpers shared by the three per-gene solver kernels
// (irls.cu, disp_ls.cu, disp_grid.cu): warp reductions, the NB special
// functions with their float32 large-c series branches, unrolled p x p
// Cholesky routines for p = 1..8, the weighted Cox-Reid masks, and the
// wide kernels' tile pass and shared-memory algebra for 8 < p <= 16 (the
// last section).
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
