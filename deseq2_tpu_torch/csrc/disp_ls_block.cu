// K2 for designs of kPWide < p <= kPBlock columns (16 < p <= 64): the
// dispersion line search with a thread block per gene (fitDisp contract,
// disp_ls.cu's).
//
// Replaces the TPU kernel deseq2_tpu/ops/pallas_ls.py:
// fit_disp_line_search_pallas (_ls_kernel) past 16 columns, where the JAX
// package runs its XLA core (pallas_ls.py:320-335, the `p > 8` gate).  The
// log posterior, its derivative, the Armijo step control and its stopping
// rules (the float32-only stall exit included), the prior, the weighted
// mode with its row cut, and the mode without the Cox-Reid term are
// ls_wide_kernel's (disp_ls.cu).  The weighted Cox-Reid column mask is a
// 64-bit word (block_cr_col_mask), decided as ops/disp.py:make_cr_masks
// decides it.
//
// What bounds it on the H100: past 16 columns, the grams.  Each trial
// point sums b = X'WX and X'W^2X, p (p + 1) multiply-adds a sample (4,160
// at p = 64), against the per-sample lgamma, digamma, log1p and
// reciprocal (~150 operations); then b is factored, inverted and traced
// against db (~p^3 / 2).  The design (common.cuh's block section):
// persistent blocks of 256 threads, each taking its next gene from the
// launch's counter (one atomic per gene), every thread running the same
// step control on the same block-wide sums; a trial point walks the
// samples in tiles of up to 256 (one sample a thread), the threads own
// the grams' 4 x 4 upper blocks and reduce them in group order, and the
// p x p algebra runs in the block's shared memory.  Every sum runs in one
// fixed order: two launches give the same bits, and a gene's result does
// not depend on its neighbours.  Without the Cox-Reid term a block only
// sums the likelihood terms.  In float64 with the Cox-Reid term
// (lp_dlp_mma) the per-sample terms come first, the weights to a global
// scratch row of the block's, and the two grams run on the FP64 tensor
// cores in a pass each (common.cuh's float64 gram section: each warp's
// run of 8 x 8 tiles in registers), the design tiles coming in by
// cp.async.  In float32 with the Cox-Reid term (lp_dlp_rows) a trial
// point's latency, not the SM's throughput, set the time at two blocks an
// SM: its p x p algebra took half of it at p = 25 (`studies phases`,
// PERF.md section 6: a Cholesky with three block barriers a column).  So
// the per-sample terms come first (the weights to the block's global
// scratch row), the grams' tiles are sample-major so that a thread's 4 x 4
// blocks read a sample's four rows in one 128-bit load (gram_add_rows),
// warp 0 factors (warp_cholesky_ll, one __syncwarp a column) while the
// other warps wait, the inverse's loops keep four loads in flight
// (block_chol_inverse_ld), and the kernel runs four blocks an SM (64
// registers a thread, spills and all: at p = 33-64 faster than two or
// three with their wider tiles).  Every sum runs in one fixed order; the
// tile width, set by the four blocks' shared memory (224 samples at p =
// 25, 32 at p = 64), sets which samples a group takes.
#include "common.cuh"

namespace {

using namespace dk;

constexpr double kArmijo = 1.0e-4;

// the block kernel's p x p matrices (with the Cox-Reid term): b (then its
// factor and inverse) and b's factor inverse (then db)
constexpr int kBlockMats = 2;

// K2's float32 layout with the Cox-Reid term (block_layout's, its tile
// buffers sample-major: common.cuh's rows_put, lay.ts = rows_ld(pr) the
// row stride), and its tile width (block_tile's rule)
__host__ __device__ inline BlockLayout ls_rows_layout(int p, int tw) {
  BlockLayout l = block_layout(p, tw, kBlockMats, true);
  l.ts = rows_ld(l.pr);
  const size_t buf = 2 * (size_t)tw * l.ts;
  const size_t scratch =
      (size_t)(block_gram_groups(p) - 1) * block_gram_blocks(p) * 16;
  l.tile = buf > scratch ? buf : scratch;
  l.vals = kBlockMats * l.mat + l.vec + l.tile;
  return l;
}

// the float32 kernel's resident blocks an SM (its launch bounds: 64
// registers a thread) and the shared memory each may take for them (the
// SM's 228 KB less the 1 KB a block the card keeps).  Four blocks an SM,
// spills and all, measured faster at p = 33-64 than two or three there
// with their wider tiles (`studies k2`, PERF.md section 6).
constexpr int kRowsBlocks = 4;
constexpr size_t kRowsSmemTarget = 233472 / kRowsBlocks - 1024;

inline int ls_rows_tile(int p) {
  int tw = kBlockThreads;
  while (tw > 32 && ls_rows_layout(p, tw).vals * sizeof(float) >
                        kRowsSmemTarget)
    tw -= 32;
  return tw;
}

// lp_dlp at a run-time p over a thread block (common.cuh's block
// section): x the design transposed (p x S); mats, red and tile the
// block's shared matrices, block sums' scratch and tile buffers.  Without
// the Cox-Reid term (both dtypes) a block only sums the likelihood terms;
// with it float32 takes lp_dlp_rows and float64 lp_dlp_mma.
template <typename T, bool UseW, bool UseCR>
__device__ __forceinline__ void lp_dlp_block(const GramMap& gm, const T* yr,
                                             const T* mr, const T* wr,
                                             unsigned long long cm, T thr,
                                             const T* x, int S,
                                             const BlockLayout& lay, T la,
                                             T pm, T prior_var, int use_prior,
                                             T* mats, T* red, T* tile, T& lp,
                                             T& dlp) {
  static_assert(!UseCR, "the Cox-Reid term takes lp_dlp_rows / lp_dlp_mma");
  const int t = threadIdx.x;
  const int tw = lay.tw;
  const T alpha = d_exp(la);
  const NbConst<T> k = nb_const(T(1) / alpha);
  T acc[2] = {T(0), T(0)};
  for (int base = 0; base < S; base += tw) {
    const int s = base + t;
    if (t < tw && s < S) {
      const T yv = yr[s];
      const T m = mr[s];
      const T mua = m * alpha;
      const T l1p = d_log1p(mua);
      const T r = T(1) / (T(1) + mua);
      T lgd, dgd;
      nb_diffs(yv, k, lgd, dgd);
      acc[0] += wscale<UseW>(lgd - (yv + k.c) * l1p, wr, s);
      acc[1] += wscale<UseW>(l1p - mua * r + yv * alpha * r - dgd, wr, s);
    }
  }
  block_allsum<T, 2>(acc, red);
  lp = acc[0];
  dlp = (acc[1] / (alpha * alpha)) * alpha;
  if (use_prior) {
    lp -= T(0.5) * (la - pm) * (la - pm) / prior_var;
    dlp -= (la - pm) / prior_var;
  }
}

// lp_dlp_block in float32 with the Cox-Reid term.  The block first sums
// every sample's likelihood terms, thread t its samples t, t + 256, ...
// (every thread, whatever the tile width), writing the weights w to wscr
// (the block's S values of global scratch; block_allsum's barrier makes
// them visible to the block); then it walks the tiles, each thread
// staging its sample's x_s and w x_s sample-major (rows_put) and adding
// the tile to its 4 x 4 blocks of both grams with 128-bit loads
// (gram_add_rows), in the tiles' order.  So no gram accumulator is live
// while the special functions run.
template <bool UseW>
__device__ __forceinline__ void lp_dlp_rows(const GramMap& gm,
                                            const float* yr, const float* mr,
                                            const float* wr,
                                            unsigned long long cm, float thr,
                                            const float* x, int S,
                                            const BlockLayout& lay, float la,
                                            float pm, float prior_var,
                                            int use_prior, float* mats,
                                            float* red, float* tile,
                                            float* wscr, float& lp,
                                            float& dlp) {
  using T = float;
  const int t = threadIdx.x;
  const int p = lay.p, tw = lay.tw, ts = lay.ts;
  const T alpha = d_exp(la);
  T acc[2] = {T(0), T(0)};
  {
    const NbConst<T> k = nb_const(T(1) / alpha);
    for (int s = t; s < S; s += kBlockThreads) {
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
  block_allsum<T, 2>(acc, red);
  GramBlock<T> gb, gd;
  gram_zero(gb);
  gram_zero(gd);
  T* xb = tile;
  T* ub = tile + (size_t)tw * ts;
  for (int base = 0; base < S; base += tw) {
    const int s = base + t;
    __syncthreads();
    if (t < tw && s < S) rows_put(xb, ub, x, S, s, p, lay.pr, ts, t, wscr[s]);
    const int n = S - base < tw ? S - base : tw;
    __syncthreads();
    gram_add_rows(gm, gb, gd, ub, xb, ts, n);
  }
  T* bm = mats;
  T* dm = mats + lay.mat;
  // the tile buffers are the reductions' scratch
  block_gram_reduce(gm, gb, tile);
  block_gram_reduce(gm, gd, tile);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) gd.a[i][j] = -gd.a[i][j];
  }
  block_gram_store(gm, gb, bm, p, cm, true, static_cast<const T*>(nullptr));
  // the factor on warp 0 (block_cholesky's bits), its log determinant to
  // every thread through the sums' scratch
  if (t < 32) {
    const T ldet = warp_cholesky_ll(bm, p);
    if (t == 0) red[0] = ldet;
  }
  __syncthreads();
  const T logdet = red[0];
  block_chol_inverse_ld(bm, dm, bm, p);
  block_gram_store(gm, gd, dm, p, cm, false, static_cast<const T*>(nullptr));
  const T tr = block_trace_product(bm, dm, p, red);
  lp = acc[0] - T(0.5) * logdet;
  dlp = (acc[1] / (alpha * alpha) - T(0.5) * tr) * alpha;
  if (use_prior) {
    lp -= T(0.5) * (la - pm) * (la - pm) / prior_var;
    dlp -= (la - pm) / prior_var;
  }
}

// K2's float64 layout with the Cox-Reid term: the design rows (p
// columns), then the weights' row
__host__ __device__ inline BlockLayout ls_mma_layout(int p, int tw) {
  return block_mma_layout(p, tw, kBlockMats, (p + 7) >> 3, 1, 0);
}

// lp_dlp_block in float64 with the Cox-Reid term: b and X'W^2X on the
// tensor cores (common.cuh's float64 gram section).  The block first sums
// every sample's likelihood terms, each thread some samples, writing the
// weights to wscr (the block's S values of global scratch); then b's
// pass over the tiles (gram_mma_pass), its factor and inverse, then
// X'W^2X's pass with the same warp runs.  So no gram accumulator is live
// while the special functions run, and one gram's at a time.  The
// per-sample terms, the column mask, the algebra and the prior are
// lp_dlp_block's.
template <bool UseW>
__device__ __forceinline__ void lp_dlp_mma(const double* yr,
                                           const double* mr,
                                           const double* wr,
                                           unsigned long long cm, double thr,
                                           const double* x, int S,
                                           const BlockLayout& lay, double la,
                                           double pm, double prior_var,
                                           int use_prior, double* mats,
                                           double* red, double* tile,
                                           double* wscr, double& lp,
                                           double& dlp) {
  using T = double;
  const int p = lay.p;
  const T alpha = d_exp(la);
  T acc[2] = {T(0), T(0)};
  {
    const NbConst<T> k = nb_const(T(1) / alpha);
    for (int s = threadIdx.x; s < S; s += kBlockThreads) {
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
  block_allsum<T, 2>(acc, red);
  const MmaRun<kMmaRunK2> run =
      mma_run<kMmaRunK2>((p + 7) >> 3, lay.pr >> 3, lay.ts);
  T g[kMmaRunK2][2];
  T* bm = mats;
  T* dm = mats + lay.mat;
  gram_mma_pass<kMmaRunK2, false>(run, g, tile, lay, x, S, wscr,
                                   nullptr);
  gram_mma_store(run, g, false, bm, p, cm, true, nullptr, nullptr);
  const T logdet = block_cholesky<T, true>(bm, p);
  block_chol_inverse(bm, dm, bm, p);
  gram_mma_pass<kMmaRunK2, true>(run, g, tile, lay, x, S, wscr,
                                  nullptr);
  gram_mma_store(run, g, true, dm, p, cm, false, nullptr, nullptr);
  const T tr = block_trace_product(bm, dm, p, red);
  lp = acc[0] - T(0.5) * logdet;
  dlp = (acc[1] / (alpha * alpha) - T(0.5) * tr) * alpha;
  if (use_prior) {
    lp -= T(0.5) * (la - pm) * (la - pm) / prior_var;
    dlp -= (la - pm) / prior_var;
  }
}

// the launch's layout and its evaluation at a point: float64 with the
// Cox-Reid term on the tensor cores, else lp_dlp_block
template <typename T, bool UseCR>
__host__ __device__ inline BlockLayout ls_layout(int p, int tw) {
  if constexpr (!is_f32<T>() && UseCR) return ls_mma_layout(p, tw);
  if constexpr (UseCR) return ls_rows_layout(p, tw);
  return block_layout(p, tw, 0, false);
}

template <typename T, bool UseW, bool UseCR>
__device__ __forceinline__ void lp_dlp(const GramMap& gm, const T* yr,
                                       const T* mr, const T* wr,
                                       unsigned long long cm, T thr,
                                       const T* x, int S,
                                       const BlockLayout& lay, T la, T pm,
                                       T prior_var, int use_prior, T* mats,
                                       T* red, T* tile, T* wscr, T& lp,
                                       T& dlp) {
  if constexpr (!is_f32<T>() && UseCR) {
    lp_dlp_mma<UseW>(yr, mr, wr, cm, thr, x, S, lay, la, pm, prior_var,
                     use_prior, mats, red, tile, wscr, lp, dlp);
  } else if constexpr (UseCR) {
    lp_dlp_rows<UseW>(gm, yr, mr, wr, cm, thr, x, S, lay, la, pm, prior_var,
                      use_prior, mats, red, tile, wscr, lp, dlp);
  } else {
    lp_dlp_block<T, UseW, UseCR>(gm, yr, mr, wr, cm, thr, x, S, lay, la, pm,
                                 prior_var, use_prior, mats, red, tile, lp,
                                 dlp);
  }
}

// ls_wide_kernel with a thread block per gene, the kernels' body
template <typename T, bool UseW, bool UseCR>
__device__ __forceinline__ void ls_block_genes(
    T* sm, const T* __restrict__ y, const T* __restrict__ mu,
    const T* __restrict__ wts, const T* __restrict__ x,
    const T* __restrict__ la0, const T* __restrict__ prior_mean, int G,
    int S, int p, int tw, T prior_var, T kappa_0, T tol, T min_la, int maxit,
    int use_prior, T* __restrict__ out_la, T* __restrict__ out_lp0,
    T* __restrict__ out_dlp0, T* __restrict__ out_lp, T* __restrict__ out_dlp,
    T* __restrict__ out_change, int* __restrict__ out_iter,
    int* __restrict__ out_accept, int* __restrict__ counter, T thr,
    T* __restrict__ scratch) {
  const BlockLayout lay = ls_layout<T, UseCR>(p, tw);
  T* wscr = scratch + (size_t)blockIdx.x * S;
  T* mats = sm;
  T* vec = sm + (UseCR ? kBlockMats * lay.mat : 0);
  T* red = vec + kBlockRed;
  int* slot = reinterpret_cast<int*>(vec + kBlockSlots);
  unsigned long long* mslot =
      reinterpret_cast<unsigned long long*>(vec + kBlockSlots + 2);
  T* tile = vec + lay.vec;
  const GramMap gm = block_gram_map(p);
  const T eps = Eps<T>::value;

  for (;;) {
    const int g = block_next_gene(counter, slot);
    if (g >= G) break;
    const T* yr = y + (size_t)g * S;
    const T* mr = mu + (size_t)g * S;
    const T* wr = UseW ? wts + (size_t)g * S : nullptr;
    unsigned long long cm = ~0ull;
    if constexpr (UseW && UseCR)
      cm = block_cr_col_mask<T>(wr, x, S, p, thr, mslot);
    const T pm = prior_mean[g];
    const T a0 = la0[g];
    T lp0, dlp0;
    lp_dlp<T, UseW, UseCR>(gm, yr, mr, wr, cm, thr, x, S, lay, a0, pm,
                           prior_var, use_prior, mats, red, tile, wscr, lp0,
                           dlp0);

    // control state: the same values on every thread (ls_kernel's)
    const T tol_eff =
        tol > d_abs(lp0) * T(50) * eps ? tol : d_abs(lp0) * T(50) * eps;
    T a = a0, kappa = kappa_0, lp = lp0, dlp = dlp0, change = T(-1);
    // the tensor-core path writes the starting point's values now, so that
    // they hold no registers through the search
    constexpr bool kEarly = !is_f32<T>() && UseCR;
    if constexpr (kEarly) {
      if (threadIdx.x == 0) {
        out_lp0[g] = lp0;
        out_dlp0[g] = dlp0;
      }
    }
    int iters = 0, iter_accept = 0;
    for (int it = 0; it < maxit; ++it) {
      ++iters;
      const T a_propose = a + kappa * dlp;
      if (a_propose < T(-30)) kappa = (T(-30) - a) / dlp;
      if (a_propose > T(10)) kappa = (T(10) - a) / dlp;
      const T a_new = a + kappa * dlp;
      T lp_new, dlp_next;
      lp_dlp<T, UseW, UseCR>(gm, yr, mr, wr, cm, thr, x, S, lay, a_new, pm,
                             prior_var, use_prior, mats, red, tile, wscr,
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
    if (threadIdx.x == 0) {
      out_la[g] = a;
      if constexpr (!kEarly) {
        out_lp0[g] = lp0;
        out_dlp0[g] = dlp0;
      }
      out_lp[g] = lp;
      out_dlp[g] = dlp;
      out_change[g] = change;
      out_iter[g] = iters;
      out_accept[g] = iter_accept;
    }
  }
}

#define DK_LS_BLOCK_PARAMS(T)                                                 \
  const T *__restrict__ y, const T *__restrict__ mu,                          \
      const T *__restrict__ wts, const T *__restrict__ x,                     \
      const T *__restrict__ la0, const T *__restrict__ prior_mean, int G,     \
      int S, int p, int tw, T prior_var, T kappa_0, T tol, T min_la,          \
      int maxit, int use_prior, T *__restrict__ out_la,                       \
      T *__restrict__ out_lp0, T *__restrict__ out_dlp0,                      \
      T *__restrict__ out_lp, T *__restrict__ out_dlp,                        \
      T *__restrict__ out_change, int *__restrict__ out_iter,                 \
      int *__restrict__ out_accept, int *__restrict__ counter, T thr,       \
      T *__restrict__ scratch
#define DK_LS_BLOCK_BODY(T, W, CR)                                            \
  extern __shared__ __align__(16) unsigned char smem_raw[];                   \
  ls_block_genes<T, W, CR>(reinterpret_cast<T*>(smem_raw), y, mu, wts, x,     \
                           la0, prior_mean, G, S, p, tw, prior_var, kappa_0,  \
                           tol, min_la, maxit, use_prior, out_la, out_lp0,    \
                           out_dlp0, out_lp, out_dlp, out_change, out_iter,   \
                           out_accept, counter, thr, scratch);

template <typename T, bool UseW, bool UseCR>
__global__ void __launch_bounds__(kBlockThreads)
    ls_block_kernel(DK_LS_BLOCK_PARAMS(T)) {
  DK_LS_BLOCK_BODY(T, UseW, UseCR)
}

// The float64 instantiations with the Cox-Reid term take the tensor-core
// path (lp_dlp_mma).
template <>
__global__ void __launch_bounds__(kBlockThreads)
    ls_block_kernel<double, false, true>(DK_LS_BLOCK_PARAMS(double)) {
  DK_LS_BLOCK_BODY(double, false, true)
}

template <>
__global__ void __launch_bounds__(kBlockThreads)
    ls_block_kernel<double, true, true>(DK_LS_BLOCK_PARAMS(double)) {
  DK_LS_BLOCK_BODY(double, true, true)
}

// The float32 instantiations with the Cox-Reid term: kRowsBlocks resident
// blocks an SM
template <>
__global__ void __launch_bounds__(kBlockThreads, kRowsBlocks)
    ls_block_kernel<float, false, true>(DK_LS_BLOCK_PARAMS(float)) {
  DK_LS_BLOCK_BODY(float, false, true)
}

template <>
__global__ void __launch_bounds__(kBlockThreads, kRowsBlocks)
    ls_block_kernel<float, true, true>(DK_LS_BLOCK_PARAMS(float)) {
  DK_LS_BLOCK_BODY(float, true, true)
}
#undef DK_LS_BLOCK_PARAMS
#undef DK_LS_BLOCK_BODY

// dynamic shared memory and tile width of a block launch (the vectors
// alone without the Cox-Reid term)
template <typename T>
inline size_t block_smem(int p, bool use_cr, int* tw) {
  if (!is_f32<T>() && use_cr) {
    *tw = block_mma_tile(p, kBlockMats, (p + 7) >> 3, 1, 0);
    return ls_mma_layout(p, *tw).vals * sizeof(T);
  }
  if (use_cr) {
    *tw = ls_rows_tile(p);
    return ls_rows_layout(p, *tw).vals * sizeof(T);
  }
  *tw = kBlockThreads;
  return block_layout(p, *tw, 0, false).vals * sizeof(T);
}

template <typename T, bool UseW, bool UseCR>
int launch_block(const T* y, const T* mu, const T* w, const T* x,
                 const T* la0, const T* pm, int G, int S, int p, T prior_var,
                 T kappa_0, T tol, T min_la, int maxit, int use_prior,
                 T* out_la, T* out_lp0, T* out_dlp0, T* out_lp, T* out_dlp,
                 T* out_change, int* out_iter, int* out_accept, int* counter,
                 T thr, T* scratch, int scratch_rows, cudaStream_t st) {
  int tw = 0;
  const size_t smem = block_smem<T>(p, UseCR, &tw);
  auto kernel = ls_block_kernel<T, UseW, UseCR>;
  int err = allow_smem(kernel, smem);
  if (err) return err;
  const int blocks = persistent_gene_blocks(kernel, smem, G, &err);
  if (err) return err;
  if (UseCR && blocks > scratch_rows) return (int)cudaErrorInvalidValue;
  kernel<<<blocks, kBlockThreads, smem, st>>>(
      y, mu, w, x, la0, pm, G, S, p, tw, prior_var, kappa_0, tol, min_la,
      maxit, use_prior, out_la, out_lp0, out_dlp0, out_lp, out_dlp,
      out_change, out_iter, out_accept, counter, thr, scratch);
  return (int)cudaGetLastError();
}

// Rows of global scratch (S values each) a launch needs: one a resident
// block with the Cox-Reid term (the weights of lp_dlp_mma and
// lp_dlp_rows), else 0; -1 on a refusal.
template <typename T, bool UseW, bool UseCR>
int scratch_rows_block(int p, int G) {
  if (!UseCR) return 0;
  int tw = 0;
  const size_t smem = block_smem<T>(p, UseCR, &tw);
  auto kernel = ls_block_kernel<T, UseW, UseCR>;
  int err = allow_smem(kernel, smem);
  const int blocks = err ? 0 : persistent_gene_blocks(kernel, smem, G, &err);
  return err ? -1 : blocks;
}

template <typename T, bool UseW, bool UseCR>
int occupancy_block(int p) {
  int tw = 0;
  const size_t smem = block_smem<T>(p, UseCR, &tw);
  auto kernel = ls_block_kernel<T, UseW, UseCR>;
  int err = allow_smem(kernel, smem);
  const int n = err ? 0 : blocks_per_sm(kernel, smem, &err, kBlockThreads);
  return err ? -1 : n;
}

// w == nullptr selects the unweighted instantiations, use_cr == 0 the ones
// without the Cox-Reid term; `counter` is one zeroed int of device memory
// (the blocks' gene counter)
template <typename T>
int launch(const T* y, const T* mu, const T* w, const T* x, const T* la0,
           const T* pm, int G, int S, int p, T prior_var, T kappa_0, T tol,
           T min_la, int maxit, int use_prior, int use_cr, T thr, T* out_la,
           T* out_lp0, T* out_dlp0, T* out_lp, T* out_dlp, T* out_change,
           int* out_iter, int* out_accept, int* counter, T* scratch,
           int scratch_rows, void* stream) {
  if (p <= kBlockMinP || p > kPBlock) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DK_LS_BLOCK(W, CR)                                                    \
  return launch_block<T, W, CR>(y, mu, w, x, la0, pm, G, S, p, prior_var,    \
                                kappa_0, tol, min_la, maxit, use_prior,      \
                                out_la, out_lp0, out_dlp0, out_lp, out_dlp,  \
                                out_change, out_iter, out_accept, counter,   \
                                thr, scratch, scratch_rows, st)
  if (w != nullptr) {
    if (use_cr) DK_LS_BLOCK(true, true);
    DK_LS_BLOCK(true, false);
  }
  if (use_cr) DK_LS_BLOCK(false, true);
  DK_LS_BLOCK(false, false);
#undef DK_LS_BLOCK
}

template <typename T>
int occupancy_mode(int weighted, int use_cr, int p) {
  if (p <= kBlockMinP || p > kPBlock) return -1;
  if (weighted) {
    return use_cr ? occupancy_block<T, true, true>(p)
                  : occupancy_block<T, true, false>(p);
  }
  return use_cr ? occupancy_block<T, false, true>(p)
                : occupancy_block<T, false, false>(p);
}

template <typename T>
int scratch_rows_mode(int weighted, int use_cr, int p, int G) {
  if (p <= kBlockMinP || p > kPBlock) return -1;
  if (weighted) {
    return use_cr ? scratch_rows_block<T, true, true>(p, G)
                  : scratch_rows_block<T, true, false>(p, G);
  }
  return use_cr ? scratch_rows_block<T, false, true>(p, G)
                : scratch_rows_block<T, false, false>(p, G);
}

}  // namespace

extern "C" {

// resident blocks per SM of the instantiation a launch would take (-1 on
// a refusal or an unsupported p)
int ls_block_blocks_per_sm(int f64, int weighted, int p, int use_cr) {
  return f64 ? occupancy_mode<double>(weighted, use_cr, p)
             : occupancy_mode<float>(weighted, use_cr, p);
}

// rows of S values of global scratch the launch takes (`scratch`,
// `scratch_rows`; 0 in float32 and without the Cox-Reid term, -1 on a
// refusal)
int ls_block_scratch_rows(int f64, int weighted, int p, int use_cr, int G) {
  return f64 ? scratch_rows_mode<double>(weighted, use_cr, p, G)
             : scratch_rows_mode<float>(weighted, use_cr, p, G);
}

int ls_block_launch_f32(const float* y, const float* mu, const float* w,
                        const float* x, const float* la0, const float* pm,
                        int G, int S, int p, float prior_var, float kappa_0,
                        float tol, float min_la, int maxit, int use_prior,
                        int use_cr, float thr, float* out_la, float* out_lp0,
                        float* out_dlp0, float* out_lp, float* out_dlp,
                        float* out_change, int* out_iter, int* out_accept,
                        int* counter, float* scratch, int scratch_rows,
                        void* stream) {
  return launch<float>(y, mu, w, x, la0, pm, G, S, p, prior_var, kappa_0, tol,
                       min_la, maxit, use_prior, use_cr, thr, out_la, out_lp0,
                       out_dlp0, out_lp, out_dlp, out_change, out_iter,
                       out_accept, counter, scratch, scratch_rows, stream);
}

int ls_block_launch_f64(const double* y, const double* mu, const double* w,
                        const double* x, const double* la0, const double* pm,
                        int G, int S, int p, double prior_var, double kappa_0,
                        double tol, double min_la, int maxit, int use_prior,
                        int use_cr, double thr, double* out_la,
                        double* out_lp0, double* out_dlp0, double* out_lp,
                        double* out_dlp, double* out_change, int* out_iter,
                        int* out_accept, int* counter, double* scratch,
                        int scratch_rows, void* stream) {
  return launch<double>(y, mu, w, x, la0, pm, G, S, p, prior_var, kappa_0,
                        tol, min_la, maxit, use_prior, use_cr, thr, out_la,
                        out_lp0, out_dlp0, out_lp, out_dlp, out_change,
                        out_iter, out_accept, counter, scratch, scratch_rows,
                        stream);
}

}  // extern "C"
