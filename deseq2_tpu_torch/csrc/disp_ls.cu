// K2: dispersion line search, one warp per gene (fitDisp contract).
//
// Replaces the TPU kernel deseq2_tpu/ops/pallas_ls.py:
// fit_disp_line_search_pallas (_ls_kernel).  Armijo backtracking ascent in
// a = log(alpha) on the Cox-Reid adjusted NB log posterior:
//
//   lp(a)  = sum_s [lgamma(y+c) - lgamma(c) - y log c - (y+c) log1p(mu alpha)]
//            - 1/2 logdet(X' W X) [- (a - m)^2 / (2 v)],  c = 1/alpha,
//            W = 1/(1/mu + alpha)
//   dlp(a) = alpha * (s1 / alpha^2 - 1/2 tr(b^-1 db)) [- (a - m)/v]
//
// with the reference's step rules: the step keeps a in [-30, 10]; accept
// when -lp_new <= -lp - kappa 1e-4 dlp^2; kappa x1.1 (capped at kappa_0)
// after an accepted step and halved on every 5th one; halved after a
// rejected step; stop on an lp change < max(tol, 50 eps |lp0|), on
// a < min_log_alpha, or (float32 only) when a rejected step's best-case
// gain is below that tolerance.
//
// What bounds it on the H100: the special functions, not bytes.  Each
// trial point costs, per sample, an lgamma, a digamma (its recurrence and
// series), a log1p and a reciprocal, against 2 values read; genes take
// 1-100 trial points.  The design:
// - one warp per gene, persistent warps taking the next gene from a
//   per-launch counter, so a warp leaves a converged gene at once and no
//   block waits for its slowest gene;
// - the gene's sums reduced by a warp butterfly that leaves them on every
//   lane; every lane runs the Cholesky, the log determinant, the trace and
//   the step control on the same values, so the search loop has no
//   barrier and no broadcast;
// - the trial point's constants lgamma(c), log(c), digamma(c) and 1/c
//   computed once per point, not per sample (nb_const; the per-sample
//   difference form and the float32 large-c series stay as they were), and
//   one reciprocal r = 1/(1 + mu alpha) per sample for w = mu r,
//   mu alpha/(1 + mu alpha) = mu alpha r and y/(mu + 1/alpha) = y alpha r;
// - the design x staged once per block in shared memory (when S p values
//   fit in kBlockStageBytes); the gene's rows (y, mu, the weights) read
//   through L1/L2 at every trial point: staged per warp in shared memory
//   they measured slower (PERF.md section 6);
// - in float64 (deseq()'s default dtype) the terms come from common.cuh's
//   narrow float64 K2 section (ls_point64, ls_terms64): below c = 8 the
//   point's lgamma(c), digamma(c) from one lgamma_digamma and per sample
//   the routine on y + c, its two divisions and 1/(1 + mu alpha) from one
//   reciprocal; from c = 8 on the difference of the two Stirling forms
//   in t = log1p(y alpha), a log1p and a reciprocal a sample, which forms
//   no lgamma(c), where CUDA's lgamma, digamma_pos (up to nine divisions
//   and a log) and a reciprocal took 1.5x the time at p = 2 (PERF.md
//   section 6).
//
// Weighted mode (UseW; pallas_ls.py:152-247 use_w): the likelihood terms of
// lp and of s1 are multiplied by the gene's weights.  The Cox-Reid term is
// not weighted: it keeps the rows with weight > 1e-2 (src/DESeq2.cpp:38-44,
// cr_keeps) and drops, per gene, the columns left without support on those
// rows (b_kk <- 1 and its off-diagonals 0, so the kept submatrix's log
// determinant survives; db's rows and columns 0).  The column mask depends
// on the weights only: each warp computes it once per gene.  The row
// threshold is the launch's `thr` (the reference's weightThreshold, 1e-2
// by default).
//
// Without the Cox-Reid term (UseCR false, a template parameter;
// pallas_ls.py's use_cr, the reference's useCR = FALSE): lp and dlp are
// the likelihood terms (and the prior) alone, and the warp accumulates no
// p x p matrix.  The default instantiations (UseCR true) keep the code of
// a kernel without this mode.
//
// Designs wider than 8 columns (8 < p <= 16, ls_wide_kernel, p a launch
// argument, every mode above): the same contract and control, one warp per
// gene from the same counter, but no lane holds the Cox-Reid matrices
// (NV = 2 + 2 NT accumulators a lane would be 274 at p = 16).  Each trial
// point walks the samples in tiles of 32 (common.cuh's wide section): in
// float32 a lane computes its sample's likelihood terms and Cox-Reid
// weight w and writes x_s and w x_s into the warp's tile buffers, and the
// lanes add the tile to b = X'WX and to X'W^2X (db's negation) in 4 x 4
// blocks they own.  The float32 terms take digamma of y + c, and the
// point's of c, from common.cuh's lgamma_digamma (one shift to z >= 3 as
// a single fraction: a log and two divisions, wide_const, wide_diffs),
// where digamma_pos's up to eight divisions a sample took much of the
// half of a trial point its terms took; lgammaf and the large-c series
// branch are nb_diffs'.  In
// float64 (lp_dlp_wide_mma) the warp first computes every sample's terms,
// the weights w to a global scratch row of its own, then walks 32-sample
// tiles staged by cp.async and sums both grams as
// mma.sync m8n8k4 products on the FP64 tensor cores, the warp's run of the
// three upper 8 x 8 tiles in registers (common.cuh's float64 gram section
// on one warp), so that no accumulator is live across the special
// functions (0 spill bytes).  What bounds a float64 trial point there
// (`studies phases`, PERF.md section 6): the per-sample special functions
// (0.54 of it before the tensor cores, 0.61 after), which no gram layout
// reaches; at p = 10 the three tiles' products are 55 of 192 entries, so
// the tensor cores only level the FFMA blocks' time.  b is factored,
// inverted and traced against db in the warp's shared memory.
// The weighted column mask is a 32-bit set of kept columns, as the plain
// version decides it (a kept row with x_k != 0).
#include "common.cuh"

namespace {

using namespace dk;

constexpr double kArmijo = 1.0e-4;

// A trial point's constants: float32's nb_const, float64's ls_point64
// (common.cuh's narrow float64 K2 section)
__device__ __forceinline__ NbConst<float> ls_point(float alpha) {
  return nb_const(1.0f / alpha);
}

__device__ __forceinline__ LsPoint64 ls_point(double alpha) {
  return ls_point64(alpha);
}

// lp and dlp at log-alpha `la`, on every lane of the gene's warp.  wr,
// cm (the column-mask bits) and thr are read in the weighted mode only.
template <typename T, int P, bool UseW, bool UseCR>
__device__ __forceinline__ void lp_dlp(const T* yr, const T* mr, const T* wr,
                                       unsigned cm, T thr, const T* xr, int S,
                                       T la, T pm, T prior_var, int use_prior,
                                       T& lp, T& dlp) {
  constexpr int NT = P * (P + 1) / 2;
  constexpr int NV = UseCR ? 2 + 2 * NT : 2;
  const T alpha = d_exp(la);
  const auto k = ls_point(alpha);
  T acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = T(0);
  for (int s = lane_id(); s < S; s += 32) {
    const T yv = yr[s];
    const T m = mr[s];
    const T mua = m * alpha;
    T l1p, r, lgd, dgd;
    if constexpr (is_f32<T>()) {
      l1p = d_log1p(mua);
      r = T(1) / (T(1) + mua);
      nb_diffs(yv, k, lgd, dgd);
    } else {
      ls_terms64(yv, mua, k, l1p, r, lgd, dgd);
    }
    acc[0] += wscale<UseW>(lgd - (yv + k.c) * l1p, wr, s);
    acc[1] += wscale<UseW>(l1p - mua * r + yv * alpha * r - dgd, wr, s);
    if constexpr (UseCR) {
      T w = m * r;
      if constexpr (UseW) {
        if (!cr_keeps(wr[s], thr)) w = T(0);
      }
      T xs[P];
      x_row<T, P>(xr, s, xs);
      acc_outer<T, P>(acc + 2, w, xs);
      acc_outer<T, P>(acc + 2 + NT, -w * w, xs);
    }
  }
  warp_allsum<T, NV>(acc);
  if constexpr (UseCR) {
    T b[P][P], db[P][P], L[P][P], binv[P][P];
    unpack_sym<T, P>(acc + 2, b);
    unpack_sym<T, P>(acc + 2 + NT, db);
    if constexpr (UseW) cr_apply_mask<T, P>(cm, b, db);
    const T logdet = cholesky<T, P>(b, L);
    chol_inverse<T, P>(L, binv);
    T tr = T(0);
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
      for (int j = 0; j < P; ++j) tr += binv[i][j] * db[j][i];
    }
    lp = acc[0] - T(0.5) * logdet;
    dlp = (acc[1] / (alpha * alpha) - T(0.5) * tr) * alpha;
  } else {
    lp = acc[0];
    dlp = (acc[1] / (alpha * alpha)) * alpha;
  }
  if (use_prior) {
    lp -= T(0.5) * (la - pm) * (la - pm) / prior_var;
    dlp -= (la - pm) / prior_var;
  }
}

template <typename T, int P, bool UseW, bool UseCR>
__global__ void __launch_bounds__(kWarpBlock)
    ls_kernel(const T* __restrict__ y, const T* __restrict__ mu,
              const T* __restrict__ wts, const T* __restrict__ x,
              const T* __restrict__ la0, const T* __restrict__ prior_mean,
              int G, int S, T prior_var, T kappa_0, T tol, T min_la,
              int maxit, int use_prior, int stage_x,
              T* __restrict__ out_la, T* __restrict__ out_lp0,
              T* __restrict__ out_dlp0, T* __restrict__ out_lp,
              T* __restrict__ out_dlp, T* __restrict__ out_change,
              int* __restrict__ out_iter, int* __restrict__ out_accept,
              int* __restrict__ counter, T thr) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const T* xr = x;
  if (stage_x) {
    T* sx = reinterpret_cast<T*>(smem_raw);
    block_stage(sx, x, S * P);
    xr = sx;
    __syncthreads();
  }
  const T eps = Eps<T>::value;

  for (;;) {
    const int g = next_gene(counter);
    if (g >= G) break;
    const T* yr = y + (size_t)g * S;
    const T* mr = mu + (size_t)g * S;
    const T* wr = UseW ? wts + (size_t)g * S : nullptr;
    unsigned cm = ~0u;
    if constexpr (UseW && UseCR) cm = warp_cr_col_mask<T, P>(wr, xr, S, thr);
    const T pm = prior_mean[g];
    const T a0 = la0[g];
    T lp0, dlp0;
    lp_dlp<T, P, UseW, UseCR>(yr, mr, wr, cm, thr, xr, S, a0, pm, prior_var,
                              use_prior, lp0, dlp0);

    // control state: the same values on every lane
    const T tol_eff =
        tol > d_abs(lp0) * T(50) * eps ? tol : d_abs(lp0) * T(50) * eps;
    T a = a0, kappa = kappa_0, lp = lp0, dlp = dlp0, change = T(-1);
    int iters = 0, iter_accept = 0;
    for (int t = 0; t < maxit; ++t) {
      ++iters;
      const T a_propose = a + kappa * dlp;
      if (a_propose < T(-30)) kappa = (T(-30) - a) / dlp;
      if (a_propose > T(10)) kappa = (T(10) - a) / dlp;
      const T a_new = a + kappa * dlp;
      T lp_new, dlp_next;
      lp_dlp<T, P, UseW, UseCR>(yr, mr, wr, cm, thr, xr, S, a_new, pm,
                                prior_var, use_prior, lp_new, dlp_next);
      const bool accept = -lp_new <= -lp - kappa * T(kArmijo) * dlp * dlp;
      if (accept) ++iter_accept;
      const T change_new = lp_new - lp;
      const bool conv = change_new < tol_eff;
      const bool under = a_new < min_la;
      if (accept) {
        a = a_new;
        change = change_new;
        if (conv || !under) lp = lp_new;
      }
      const bool stalled =
          is_f32<T>() && !accept && kappa * dlp * dlp < tol_eff;
      const bool cont_accept = accept && !conv && !under;
      if (cont_accept) {
        dlp = dlp_next;
        T kn = kappa * T(1.1);
        kn = kn < kappa_0 ? kn : kappa_0;
        if (iter_accept % 5 == 0) kn = kn / T(2);
        kappa = kn;
      } else if (!accept) {
        kappa = kappa / T(2);
      }
      if ((accept && (conv || under)) || stalled) break;
    }
    if (lane_id() == 0) {
      out_la[g] = a;
      out_lp0[g] = lp0;
      out_dlp0[g] = dlp0;
      out_lp[g] = lp;
      out_dlp[g] = dlp;
      out_change[g] = change;
      out_iter[g] = iters;
      out_accept[g] = iter_accept;
    }
  }
}

template <typename T, int P, bool UseW, bool UseCR>
int launch_p(const T* y, const T* mu, const T* w, const T* x, const T* la0,
             const T* pm, int G, int S, T prior_var, T kappa_0, T tol,
             T min_la, int maxit, int use_prior, T* out_la, T* out_lp0,
             T* out_dlp0, T* out_lp, T* out_dlp, T* out_change, int* out_iter,
             int* out_accept, int* counter, T thr, cudaStream_t st) {
  const size_t smem = block_stage_bytes<T>(S, P);
  auto kernel = ls_kernel<T, P, UseW, UseCR>;
  int err = 0;
  const int blocks = persistent_blocks(kernel, smem, G, &err);
  if (err) return err;
  kernel<<<blocks, kWarpBlock, smem, st>>>(
      y, mu, w, x, la0, pm, G, S, prior_var, kappa_0, tol, min_la, maxit,
      use_prior, smem > 0, out_la, out_lp0, out_dlp0, out_lp, out_dlp,
      out_change, out_iter, out_accept, counter, thr);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 8 < p <= kPWide
// ---------------------------------------------------------------------------

// shared values per warp (float32 with the Cox-Reid term): the tile
// buffers of x and w x; after a trial point's last tile b (then its
// inverse) and db take the x buffer's room and b's factor inverse the
// other's
constexpr int kWideWarpVals = 2 * kTileVals;
// in float64 with the Cox-Reid term (lp_dlp_wide_mma): the tile of the
// design's 16 rows (zero past p) and the weights, 32 samples of ts = 36
// values each, then b (then its inverse), db and b's factor inverse
constexpr int kWideMmaTile = kTile;
constexpr int kWideMmaVals = 3 * kMat;
static_assert((kPWide + 1) * (kWideMmaTile + 4) <= kWideMmaVals,
              "the tile fits the matrices' room");

// the wide kernel's shared values per warp, and whether it takes the
// tensor-core path (and a global scratch row of S weights per warp)
template <typename T, bool UseCR>
__host__ __device__ constexpr bool wide_mma() {
  return !is_f32<T>() && UseCR;
}

template <typename T, bool UseCR>
__host__ __device__ constexpr int wide_warp_vals() {
  return wide_mma<T, UseCR>() ? kWideMmaVals : kWideWarpVals;
}

// The wide K2's special functions (the header): float32 takes
// lgamma_digamma's (nb_const_shift, nb_diffs_shift), float64 keeps
// nb_const and nb_diffs.
template <typename T>
__device__ __forceinline__ NbConst<T> wide_const(T c) {
  if constexpr (is_f32<T>()) {
    return nb_const_shift(c);
  } else {
    return nb_const(c);
  }
}

template <typename T>
__device__ __forceinline__ void wide_diffs(T y, const NbConst<T>& k, T& lgd,
                                           T& dgd) {
  if constexpr (is_f32<T>()) {
    nb_diffs_shift(y, k, lgd, dgd);
  } else {
    nb_diffs(y, k, lgd, dgd);
  }
}

// lp_dlp at a run-time p: x the design transposed (p x S), wv the warp's
// shared values.
template <typename T, bool UseW, bool UseCR>
__device__ __forceinline__ void lp_dlp_wide(const T* yr, const T* mr,
                                            const T* wr, unsigned cm, T thr,
                                            const T* x, int S, int p, T la,
                                            T pm, T prior_var, int use_prior,
                                            T* wv, T& lp, T& dlp) {
  const int lane = lane_id();
  const GramMap gm = gram_map(p);
  const T alpha = d_exp(la);
  const NbConst<T> k = wide_const(T(1) / alpha);
  T acc[2] = {T(0), T(0)};
  GramBlock<T> gb, gd;
  T rz[4];
  if constexpr (UseCR) {
    gram_zero(gb);
    gram_zero(gd);
  }
  T* xb = wv;
  T* ub = wv + kTileVals;
  __syncwarp();
  for (int base = 0; base < S; base += kTile) {
    const int s = base + lane;
    if (s < S) {
      const T yv = yr[s];
      const T m = mr[s];
      const T mua = m * alpha;
      const T l1p = d_log1p(mua);
      const T r = T(1) / (T(1) + mua);
      T lgd, dgd;
      wide_diffs(yv, k, lgd, dgd);
      acc[0] += wscale<UseW>(lgd - (yv + k.c) * l1p, wr, s);
      acc[1] += wscale<UseW>(l1p - mua * r + yv * alpha * r - dgd, wr, s);
      if constexpr (UseCR) {
        T w = m * r;
        if constexpr (UseW) {
          if (!cr_keeps(wr[s], thr)) w = T(0);
        }
        tile_put(xb, ub, x, S, s, p, w);
      }
    }
    if constexpr (UseCR) {
      const int n = S - base < kTile ? S - base : kTile;
      __syncwarp();
      gram_add<T, true, false>(gm, gb, gd, rz, ub, xb,
                               static_cast<const T*>(nullptr), n);
      __syncwarp();
    }
  }
  warp_allsum<T, 2>(acc);
  if constexpr (UseCR) {
    T* bm = wv;
    T* dm = wv + kMat;
    T* li = wv + kTileVals;
    // the tile buffers are the reductions' scratch
    gram_reduce(gm, gb, wv);
    gram_reduce(gm, gd, wv + kTileVals);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) gd.a[i][j] = -gd.a[i][j];
    }
    gram_store(gm, gb, bm, p, cm, true, static_cast<const T*>(nullptr));
    gram_store(gm, gd, dm, p, cm, false, static_cast<const T*>(nullptr));
    const T logdet = warp_cholesky<T, true>(bm, p);
    warp_chol_inverse(bm, li, bm, p);
    const T tr = warp_trace_product(bm, dm, p);
    lp = acc[0] - T(0.5) * logdet;
    dlp = (acc[1] / (alpha * alpha) - T(0.5) * tr) * alpha;
  } else {
    lp = acc[0];
    dlp = (acc[1] / (alpha * alpha)) * alpha;
  }
  if (use_prior) {
    lp -= T(0.5) * (la - pm) * (la - pm) / prior_var;
    dlp -= (la - pm) / prior_var;
  }
}

// lp_dlp_wide in float64 with the Cox-Reid term: the grams on the FP64
// tensor cores (common.cuh's float64 gram section on one warp).  The warp
// first sums every sample's likelihood terms, each lane its samples (as
// lp_dlp_wide sums them), writing the weights w to wscr (the warp's S
// values of global scratch); then one pass over tiles of 32 samples
// stages the design's rows (zero past p and past S) and the weights in
// the warp's shared values and adds both grams, b = X'WX and X'W^2X, to
// the warp's run of the three upper 8 x 8 tiles (12 accumulators a lane),
// k-steps in ascending order.  So no accumulator is live while the special
// functions run.  The column mask, the algebra and the prior are
// lp_dlp_wide's.
template <bool UseW>
__device__ __forceinline__ void lp_dlp_wide_mma(
    const double* yr, const double* mr, const double* wr, unsigned cm,
    double thr, const double* x, int S, int p, double la, double pm,
    double prior_var, int use_prior, double* wv, double* wscr, double& lp,
    double& dlp) {
  using T = double;
  const T alpha = d_exp(la);
  T acc[2] = {T(0), T(0)};
  {
    const NbConst<T> k = nb_const(T(1) / alpha);
    for (int s = lane_id(); s < S; s += kTile) {
      const T yv = yr[s];
      const T m = mr[s];
      const T mua = m * alpha;
      const T l1p = d_log1p(mua);
      const T r = T(1) / (T(1) + mua);
      T lgd, dgd;
      nb_diffs(yv, k, lgd, dgd);
      acc[0] += wscale<UseW>(lgd - (yv + k.c) * l1p, wr, s);
      acc[1] += wscale<UseW>(l1p - mua * r + yv * alpha * r - dgd, wr, s);
      T w = m * r;
      if constexpr (UseW) {
        if (!cr_keeps(wr[s], thr)) w = T(0);
      }
      wscr[s] = w;
    }
  }
  warp_allsum<T, 2>(acc);
  const BlockLayout lay =
      block_mma_layout(p, kWideMmaTile, 0, kPWide / 8, 1, 0);
  const MmaRun<kMmaRunWide> run = mma_run<kMmaRunWide, 1>(2, 2, lay.ts);
  T gb[kMmaRunWide][2], gd[kMmaRunWide][2];
  gram_mma_pass<kMmaRunWide, false, 1, true>(run, gb, wv, lay, x, S, wscr,
                                             nullptr, gd);
  T* bm = wv;
  T* dm = wv + kMat;
  T* li = wv + 2 * kMat;
  // every lane's last fragment loads are done before the matrices take
  // the tile's room
  __syncwarp();
  gram_mma_store<kMmaRunWide, 1, kPWide>(run, gb, false, bm, p, cm, true,
                                         nullptr, nullptr);
  gram_mma_store<kMmaRunWide, 1, kPWide>(run, gd, true, dm, p, cm, false,
                                         nullptr, nullptr);
  const T logdet = warp_cholesky<T, true>(bm, p);
  warp_chol_inverse(bm, li, bm, p);
  const T tr = warp_trace_product(bm, dm, p);
  lp = acc[0] - T(0.5) * logdet;
  dlp = (acc[1] / (alpha * alpha) - T(0.5) * tr) * alpha;
  if (use_prior) {
    lp -= T(0.5) * (la - pm) * (la - pm) / prior_var;
    dlp -= (la - pm) / prior_var;
  }
}

// the wide evaluation at a point: float64 with the Cox-Reid term on the
// tensor cores, else lp_dlp_wide
template <typename T, bool UseW, bool UseCR>
__device__ __forceinline__ void lp_dlp_wide_at(
    const T* yr, const T* mr, const T* wr, unsigned cm, T thr, const T* x,
    int S, int p, T la, T pm, T prior_var, int use_prior, T* wv, T* wscr,
    T& lp, T& dlp) {
  if constexpr (wide_mma<T, UseCR>()) {
    lp_dlp_wide_mma<UseW>(yr, mr, wr, cm, thr, x, S, p, la, pm, prior_var,
                          use_prior, wv, wscr, lp, dlp);
  } else {
    lp_dlp_wide<T, UseW, UseCR>(yr, mr, wr, cm, thr, x, S, p, la, pm,
                                prior_var, use_prior, wv, lp, dlp);
  }
}

// The minimum of one block an SM lets ptxas give the float64
// instantiations the registers they need: without it they spilled 80-124
// bytes (PERF.md section 6), with it none.
template <typename T, bool UseW, bool UseCR>
__global__ void __launch_bounds__(kWarpBlock, 1)
    ls_wide_kernel(const T* __restrict__ y, const T* __restrict__ mu,
                   const T* __restrict__ wts, const T* __restrict__ x,
                   const T* __restrict__ la0, const T* __restrict__ prior_mean,
                   int G, int S, int p, T prior_var, T kappa_0, T tol,
                   T min_la, int maxit, int use_prior,
                   T* __restrict__ out_la, T* __restrict__ out_lp0,
                   T* __restrict__ out_dlp0, T* __restrict__ out_lp,
                   T* __restrict__ out_dlp, T* __restrict__ out_change,
                   int* __restrict__ out_iter, int* __restrict__ out_accept,
                   int* __restrict__ counter, T thr,
                   T* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int warp = threadIdx.x >> 5;
  T* wv = reinterpret_cast<T*>(smem_raw) +
          (UseCR ? (size_t)warp * wide_warp_vals<T, UseCR>() : 0);
  T* wscr = wide_mma<T, UseCR>()
                ? scratch + ((size_t)blockIdx.x * kBlockWarps + warp) * S
                : nullptr;
  const T eps = Eps<T>::value;

  for (;;) {
    const int g = next_gene(counter);
    if (g >= G) break;
    const T* yr = y + (size_t)g * S;
    const T* mr = mu + (size_t)g * S;
    const T* wr = UseW ? wts + (size_t)g * S : nullptr;
    unsigned cm = ~0u;
    if constexpr (UseW && UseCR) cm = warp_cr_col_mask_wide<T>(wr, x, S, p, thr);
    const T pm = prior_mean[g];
    const T a0 = la0[g];
    T lp0, dlp0;
    lp_dlp_wide_at<T, UseW, UseCR>(yr, mr, wr, cm, thr, x, S, p, a0, pm,
                                   prior_var, use_prior, wv, wscr, lp0,
                                   dlp0);

    // control state: the same values on every lane (ls_kernel's)
    const T tol_eff =
        tol > d_abs(lp0) * T(50) * eps ? tol : d_abs(lp0) * T(50) * eps;
    T a = a0, kappa = kappa_0, lp = lp0, dlp = dlp0, change = T(-1);
    int iters = 0, iter_accept = 0;
    for (int t = 0; t < maxit; ++t) {
      ++iters;
      const T a_propose = a + kappa * dlp;
      if (a_propose < T(-30)) kappa = (T(-30) - a) / dlp;
      if (a_propose > T(10)) kappa = (T(10) - a) / dlp;
      const T a_new = a + kappa * dlp;
      T lp_new, dlp_next;
      lp_dlp_wide_at<T, UseW, UseCR>(yr, mr, wr, cm, thr, x, S, p, a_new,
                                     pm, prior_var, use_prior, wv, wscr,
                                     lp_new, dlp_next);
      const bool accept = -lp_new <= -lp - kappa * T(kArmijo) * dlp * dlp;
      if (accept) ++iter_accept;
      const T change_new = lp_new - lp;
      const bool conv = change_new < tol_eff;
      const bool under = a_new < min_la;
      if (accept) {
        a = a_new;
        change = change_new;
        if (conv || !under) lp = lp_new;
      }
      const bool stalled =
          is_f32<T>() && !accept && kappa * dlp * dlp < tol_eff;
      const bool cont_accept = accept && !conv && !under;
      if (cont_accept) {
        dlp = dlp_next;
        T kn = kappa * T(1.1);
        kn = kn < kappa_0 ? kn : kappa_0;
        if (iter_accept % 5 == 0) kn = kn / T(2);
        kappa = kn;
      } else if (!accept) {
        kappa = kappa / T(2);
      }
      if ((accept && (conv || under)) || stalled) break;
    }
    if (lane_id() == 0) {
      out_la[g] = a;
      out_lp0[g] = lp0;
      out_dlp0[g] = dlp0;
      out_lp[g] = lp;
      out_dlp[g] = dlp;
      out_change[g] = change;
      out_iter[g] = iters;
      out_accept[g] = iter_accept;
    }
  }
}

// dynamic shared memory of a wide launch (none without the Cox-Reid term)
template <typename T, bool UseCR>
inline size_t wide_smem() {
  return UseCR ? (size_t)kBlockWarps * wide_warp_vals<T, UseCR>() * sizeof(T)
               : 0;
}

template <typename T, bool UseW, bool UseCR>
int launch_wide(const T* y, const T* mu, const T* w, const T* x, const T* la0,
                const T* pm, int G, int S, int p, T prior_var, T kappa_0,
                T tol, T min_la, int maxit, int use_prior, T* out_la,
                T* out_lp0, T* out_dlp0, T* out_lp, T* out_dlp,
                T* out_change, int* out_iter, int* out_accept, int* counter,
                T thr, T* scratch, int scratch_rows, cudaStream_t st) {
  const size_t smem = wide_smem<T, UseCR>();
  auto kernel = ls_wide_kernel<T, UseW, UseCR>;
  int err = allow_smem(kernel, smem);
  if (err) return err;
  const int blocks = persistent_blocks(kernel, smem, G, &err);
  if (err) return err;
  if (wide_mma<T, UseCR>() && blocks * kBlockWarps > scratch_rows)
    return (int)cudaErrorInvalidValue;
  kernel<<<blocks, kWarpBlock, smem, st>>>(
      y, mu, w, x, la0, pm, G, S, p, prior_var, kappa_0, tol, min_la, maxit,
      use_prior, out_la, out_lp0, out_dlp0, out_lp, out_dlp, out_change,
      out_iter, out_accept, counter, thr, scratch);
  return (int)cudaGetLastError();
}

// Rows of global scratch (S values each) a wide launch needs: one a
// resident warp on the tensor-core path (lp_dlp_wide_mma's weights), else
// 0; -1 on a refusal.
template <typename T, bool UseW, bool UseCR>
int scratch_rows_wide(int G) {
  if (!wide_mma<T, UseCR>()) return 0;
  const size_t smem = wide_smem<T, UseCR>();
  auto kernel = ls_wide_kernel<T, UseW, UseCR>;
  int err = allow_smem(kernel, smem);
  const int blocks = err ? 0 : persistent_blocks(kernel, smem, G, &err);
  return err ? -1 : blocks * kBlockWarps;
}

template <typename T, bool UseW, bool UseCR>
int occupancy_wide() {
  const size_t smem = wide_smem<T, UseCR>();
  auto kernel = ls_wide_kernel<T, UseW, UseCR>;
  int err = allow_smem(kernel, smem);
  const int n = err ? 0 : blocks_per_sm(kernel, smem, &err);
  return err ? -1 : n;
}

// w == nullptr selects the unweighted instantiations, use_cr == 0 the ones
// without the Cox-Reid term, 8 < p <= 16 the wide kernel; `counter` is one
// zeroed int of device memory (the warps' gene counter); scratch holds
// scratch_rows rows of S values (the wide kernel's tensor-core path, as
// many as scratch_rows_mode says; else unread)
template <typename T>
int launch(const T* y, const T* mu, const T* w, const T* x, const T* la0,
           const T* pm, int G, int S, int p, T prior_var, T kappa_0, T tol,
           T min_la, int maxit, int use_prior, int use_cr, T thr, T* out_la,
           T* out_lp0, T* out_dlp0, T* out_lp, T* out_dlp, T* out_change,
           int* out_iter, int* out_accept, int* counter, T* scratch,
           int scratch_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p > kPNarrow && p <= kPWide) {
#define DK_LS_WIDE(W, CR)                                                     \
  return launch_wide<T, W, CR>(y, mu, w, x, la0, pm, G, S, p, prior_var,     \
                               kappa_0, tol, min_la, maxit, use_prior, out_la, \
                               out_lp0, out_dlp0, out_lp, out_dlp, out_change, \
                               out_iter, out_accept, counter, thr, scratch, \
                               scratch_rows, st)
    if (w != nullptr) {
      if (use_cr) DK_LS_WIDE(true, true);
      DK_LS_WIDE(true, false);
    }
    if (use_cr) DK_LS_WIDE(false, true);
    DK_LS_WIDE(false, false);
#undef DK_LS_WIDE
  }
#define DK_LS_LAUNCH(W, CR)                                                  \
  DK_DISPATCH_P(p, return launch_p<T, P, W, CR>(                             \
                       y, mu, w, x, la0, pm, G, S, prior_var, kappa_0, tol,  \
                       min_la, maxit, use_prior, out_la, out_lp0, out_dlp0,  \
                       out_lp, out_dlp, out_change, out_iter, out_accept,    \
                       counter, thr, st))
  if (w != nullptr) {
    if (use_cr) {
      DK_LS_LAUNCH(true, true)
    } else {
      DK_LS_LAUNCH(true, false)
    }
  } else {
    if (use_cr) {
      DK_LS_LAUNCH(false, true)
    } else {
      DK_LS_LAUNCH(false, false)
    }
  }
#undef DK_LS_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// resident blocks per SM of the instantiation a launch would take (-1 on
// a refusal or an unsupported p)
template <typename T, bool UseW, bool UseCR>
int occupancy(int p, int S) {
  int err = 0;
  DK_DISPATCH_P(p, {
    const int n = blocks_per_sm(ls_kernel<T, P, UseW, UseCR>,
                                block_stage_bytes<T>(S, P), &err);
    return err ? -1 : n;
  })
  return -1;
}

template <typename T>
int scratch_rows_mode(int weighted, int use_cr, int p, int G) {
  if (p <= kPNarrow || p > kPWide) return 0;
  if (weighted) {
    return use_cr ? scratch_rows_wide<T, true, true>(G)
                  : scratch_rows_wide<T, true, false>(G);
  }
  return use_cr ? scratch_rows_wide<T, false, true>(G)
                : scratch_rows_wide<T, false, false>(G);
}

template <typename T>
int occupancy_mode(int weighted, int use_cr, int p, int S) {
  if (p > kPNarrow && p <= kPWide) {
    if (weighted) {
      return use_cr ? occupancy_wide<T, true, true>()
                    : occupancy_wide<T, true, false>();
    }
    return use_cr ? occupancy_wide<T, false, true>()
                  : occupancy_wide<T, false, false>();
  }
  if (weighted) {
    return use_cr ? occupancy<T, true, true>(p, S)
                  : occupancy<T, true, false>(p, S);
  }
  return use_cr ? occupancy<T, false, true>(p, S)
                : occupancy<T, false, false>(p, S);
}

}  // namespace

extern "C" {

int ls_blocks_per_sm(int f64, int weighted, int p, int S, int use_cr) {
  return f64 ? occupancy_mode<double>(weighted, use_cr, p, S)
             : occupancy_mode<float>(weighted, use_cr, p, S);
}

// rows of S values of global scratch the launch takes (`scratch`,
// `scratch_rows`: the wide kernel's float64 path with the Cox-Reid term;
// 0 otherwise, -1 on a refusal)
int ls_scratch_rows(int f64, int weighted, int p, int use_cr, int G) {
  return f64 ? scratch_rows_mode<double>(weighted, use_cr, p, G)
             : scratch_rows_mode<float>(weighted, use_cr, p, G);
}

int ls_launch_f32(const float* y, const float* mu, const float* w,
                  const float* x, const float* la0, const float* pm, int G,
                  int S, int p, float prior_var, float kappa_0, float tol,
                  float min_la, int maxit, int use_prior, int use_cr,
                  float thr, float* out_la, float* out_lp0, float* out_dlp0,
                  float* out_lp, float* out_dlp, float* out_change,
                  int* out_iter, int* out_accept, int* counter,
                  float* scratch, int scratch_rows, void* stream) {
  return launch<float>(y, mu, w, x, la0, pm, G, S, p, prior_var, kappa_0, tol,
                       min_la, maxit, use_prior, use_cr, thr, out_la, out_lp0,
                       out_dlp0, out_lp, out_dlp, out_change, out_iter,
                       out_accept, counter, scratch, scratch_rows, stream);
}

int ls_launch_f64(const double* y, const double* mu, const double* w,
                  const double* x, const double* la0, const double* pm, int G,
                  int S, int p, double prior_var, double kappa_0, double tol,
                  double min_la, int maxit, int use_prior, int use_cr,
                  double thr, double* out_la, double* out_lp0,
                  double* out_dlp0, double* out_lp, double* out_dlp,
                  double* out_change, int* out_iter, int* out_accept,
                  int* counter, double* scratch, int scratch_rows,
                  void* stream) {
  return launch<double>(y, mu, w, x, la0, pm, G, S, p, prior_var, kappa_0,
                        tol, min_la, maxit, use_prior, use_cr, thr, out_la,
                        out_lp0, out_dlp0, out_lp, out_dlp, out_change,
                        out_iter, out_accept, counter, scratch, scratch_rows,
                        stream);
}

}  // extern "C"
