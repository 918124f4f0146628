// K3: two-stage dispersion grid search, one gene per thread block, the
// grid points of a stage spread over the block's warps (fitDispGrid
// contract).
//
// Replaces the TPU kernel deseq2_tpu/ops/pallas_disp.py:fit_disp_grid_pallas
// (_grid_kernel).  Evaluates the Cox-Reid adjusted NB log posterior (plus
// the optional log-normal prior) at the n shared coarse log-alpha points,
// takes the gene's argmax (the first maximum wins), then evaluates n fine
// points spanning a_hat +- delta and takes the argmax again.
//
// What bounds it on the H100: the special functions.  2n = 40 posterior
// evaluations per gene, each an lgamma, a log1p and a reciprocal per
// sample, against 2 values read per sample.  The design:
// - the n points of a stage are independent (only the fine grid depends on
//   the coarse argmax; the Pallas kernel scans them in order only to bound
//   its VMEM): warp w of the block's W = kGridWarps evaluates points w,
//   w + W, ..., its lanes striding over the samples; warp_allsum
//   leaves the sums on every lane and every lane runs the p x p log
//   determinant and the prior, so an evaluation has no barrier.  Each warp
//   keeps the first maximum of its own points, and the stage's pick is the
//   largest of the W candidates, the smallest index on a tie: the plain
//   version's strict `>` scan in index order, whatever W.  Barriers per
//   gene: one after staging the design, one after each stage, whatever n
//   is;
// - each point's lgamma(c), log(c) and 1/c computed once per point, not
//   per sample (lg_const; the per-sample difference form and the float32
//   large-c series unchanged), and one reciprocal r = 1/(1 + mu alpha) per
//   sample for the Cox-Reid weight w = mu r;
// - the design x staged in the block's shared memory (when it fits in
//   kBlockStageBytes), the gene's rows (y, mu, the weights) read 2n times
//   through L1/L2 (staging them too measured no faster at S = 1,024,
//   PERF.md section 6);
// - the fine grid's offsets j/(n-1) computed in the kernel, as the plain
//   version's grid_fractions computes them (a float64 product, rounded to
//   T), and the fine points without a fused multiply-add, so they are the
//   plain version's points bit for bit.
//
// Weighted mode (UseW, a template parameter): the posterior of the line
// search's weighted mode (disp_ls.cu), weighted likelihood terms and the
// masked Cox-Reid term.  This is an extension of the TPU kernel, whose JAX
// pipeline runs the weighted grid on its XLA core (fused.py:583); the port
// runs no plain version on the card, so the weighted grid is a kernel too.
// Its row threshold is the launch's `thr` (the reference's weightThreshold,
// 1e-2 by default).
//
// Without the Cox-Reid term (UseCR false, a template parameter;
// pallas_disp.py's use_cr, the reference's useCR = FALSE): the posterior
// is the likelihood terms (and the prior) alone, and no p x p matrix is
// accumulated.  The default instantiations (UseCR true) keep the code of a
// kernel without this mode.
//
// Designs wider than 8 columns (8 < p <= 16, grid_wide_kernel, p a launch
// argument, every mode above): the same grid, stages and first-maximum
// rule.  There the Cox-Reid gram, p (p + 1) / 2 multiply-adds a sample,
// weighs as much as the special functions, and a point a pass read each
// sample's y and mu, and loaded, stored and reloaded its design row, for
// every point.  So each warp takes its points of a stage two at a time in
// one pass over the samples (log_post_wide_pair): the block stages the
// design in its shared memory (once a gene while S fits a chunk, else a
// chunk at a time), each lane computes its sample's terms at both points,
// and the warp adds the tile to both grams from the staged design, each
// design value loaded once for both (float32: 4 x 4 blocks on sample-major
// rows; float64: the FP64 tensor cores), then factors each in its shared
// memory for the log determinant (warp_cholesky).
#include "common.cuh"

namespace {

using namespace dk;

// warps per block: 10 measured fastest of 4, 5, 7, 8 and 10 at S = 1,024
// and 3,000 (PERF.md section 6)
constexpr int kGridWarps = 10;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// log posterior at log-alpha `la`, on every lane of the calling warp.  wr,
// cm (the column-mask bits) and thr are read in the weighted mode only.
template <typename T, int P, bool UseW, bool UseCR>
__device__ __forceinline__ T log_post(const T* yr, const T* mr, const T* wr,
                                      unsigned cm, T thr, const T* xr, int S,
                                      T la, T pm, T prior_var, int use_prior) {
  constexpr int NV = UseCR ? 1 + P * (P + 1) / 2 : 1;
  const T alpha = d_exp(la);
  const LgConst<T> k = lg_const(T(1) / alpha);
  T acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = T(0);
  for (int s = lane_id(); s < S; s += 32) {
    const T yv = yr[s];
    const T m = mr[s];
    const T mua = m * alpha;
    const T r = T(1) / (T(1) + mua);
    acc[0] += wscale<UseW>(lg_diff(yv, k) - (yv + k.c) * d_log1p(mua), wr, s);
    if constexpr (UseCR) {
      T w = m * r;
      if constexpr (UseW) {
        if (!cr_keeps(wr[s], thr)) w = T(0);
      }
      T xs[P];
      x_row<T, P>(xr, s, xs);
      acc_outer<T, P>(acc + 1, w, xs);
    }
  }
  warp_allsum<T, NV>(acc);
  T lp = acc[0];
  if constexpr (UseCR) {
    T b[P][P], L[P][P];
    unpack_sym<T, P>(acc + 1, b);
    if constexpr (UseW) cr_apply_mask<T, P>(cm, b, nullptr);
    lp = acc[0] - T(0.5) * cholesky<T, P>(b, L);
  }
  if (use_prior) lp -= T(0.5) * (la - pm) * (la - pm) / prior_var;
  return lp;
}

// The stage's first maximum over the warps' candidates (lp, j): the
// largest lp, the smallest j on a tie; -1 when no point won (every point
// -inf or NaN).
template <typename T>
__device__ __forceinline__ int first_max(const T* cand_lp,
                                         const int* cand_j) {
  T best_lp = T(0);
  int best_j = -1;
  for (int w = 0; w < kGridWarps; ++w) {
    const int j = cand_j[w];
    const T lp = cand_lp[w];
    if (j >= 0 &&
        (best_j < 0 || lp > best_lp || (lp == best_lp && j < best_j))) {
      best_lp = lp;
      best_j = j;
    }
  }
  return best_j;
}

// The templated kernel's body (DK_GRID_KERNEL_BODY, over T, P, UseW and
// UseCR and the parameters DK_GRID_KERNEL_PARAMS names): each warp keeps
// its candidate (lp, j) per stage (0 coarse, 1 fine) in shared memory; its
// points j = warp, warp + kGridWarps, ... of a stage run in increasing j,
// strict > (the first maximum wins, a NaN or -inf never does); the coarse
// stage runs over the shared grid and every thread reads its pick, then
// the fine stage over a_hat +- delta.  One macro, so that the
// instantiations with other launch bounds (below) run the same code.
#define DK_GRID_KERNEL_PARAMS(T)                                             \
  const T *__restrict__ y, const T *__restrict__ mu,                         \
      const T *__restrict__ x, const T *__restrict__ grid,                   \
      const T *__restrict__ prior_mean, int S, int n, T prior_var,           \
      int use_prior, int stage_x, T *__restrict__ out,                       \
      const T *__restrict__ wts, T thr
#define DK_GRID_KERNEL_BODY                                                   \
  __shared__ T cand_lp[2][kGridWarps];                                        \
  __shared__ int cand_j[2][kGridWarps];                                       \
  extern __shared__ __align__(16) unsigned char smem_raw[];                   \
                                                                              \
  const int g = blockIdx.x;                                                   \
  const int warp = threadIdx.x >> 5;                                          \
  const T* yr = y + (size_t)g * S;                                            \
  const T* mr = mu + (size_t)g * S;                                           \
  const T* wr = UseW ? wts + (size_t)g * S : nullptr;                         \
  const T* xr = x;                                                            \
  if (stage_x) {                                                              \
    T* sx = reinterpret_cast<T*>(smem_raw);                                   \
    block_stage(sx, x, S * P);                                                \
    xr = sx;                                                                  \
    __syncthreads();                                                          \
  }                                                                           \
  unsigned cm = ~0u;                                                          \
  if constexpr (UseW && UseCR) cm = warp_cr_col_mask<T, P>(wr, xr, S, thr);   \
  const T pm = prior_mean[g];                                                 \
                                                                              \
  auto stage_max = [&](auto point, int st) {                                  \
    T best_lp = -INFINITY;                                                    \
    int best_j = -1;                                                          \
    for (int j = warp; j < n; j += kGridWarps) {                              \
      const T lp = log_post<T, P, UseW, UseCR>(yr, mr, wr, cm, thr, xr, S,    \
                                               point(j), pm, prior_var,       \
                                               use_prior);                    \
      if (lp > best_lp) {                                                     \
        best_lp = lp;                                                         \
        best_j = j;                                                           \
      }                                                                       \
    }                                                                         \
    if (lane_id() == 0) {                                                     \
      cand_lp[st][warp] = best_lp;                                            \
      cand_j[st][warp] = best_j;                                              \
    }                                                                         \
  };                                                                          \
                                                                              \
  stage_max([&](int j) { return grid[j]; }, 0);                               \
  __syncthreads();                                                            \
  const int jc = first_max(cand_lp[0], cand_j[0]);                            \
  const T a_hat = jc < 0 ? T(0) : grid[jc];                                   \
  const T delta = grid[1] - grid[0];                                          \
  const T lo = a_hat - delta;                                                 \
  const T span = T(2) * delta;                                                \
  const double step = 1.0 / (double)(n - 1);                                  \
  auto fine = [&](int j) { return lo + mul_rn(span, (T)((double)j * step)); }; \
                                                                              \
  stage_max(fine, 1);                                                         \
  __syncthreads();                                                            \
  if (threadIdx.x == 0) {                                                     \
    const int jf = first_max(cand_lp[1], cand_j[1]);                          \
    out[g] = jf < 0 ? T(0) : fine(jf);                                        \
  }

// The weighted mode's parameter comes last, as in the other kernels.
template <typename T, int P, bool UseW, bool UseCR>
__global__ void __launch_bounds__(32 * kGridWarps)
    grid_kernel(DK_GRID_KERNEL_PARAMS(T)) {
  DK_GRID_KERNEL_BODY
}

// The float64 instantiations with the Cox-Reid term at P = 3-6, and
// unweighted at P = 1, ask for three resident blocks an SM (64 registers a
// thread, spills and all).  A point is its special functions (CUDA's
// lgamma, log1p and a reciprocal a sample: 0.86-0.90 of its time at p <=
// 2), each warp a long chain of them, and at two blocks an SM (74-134
// registers) their latency showed: three took 0.65-0.93 of the time
// there (`studies k3`, PERF.md section 6).  Elsewhere three blocks
// measured no faster (weighted P = 1, without the Cox-Reid term) or
// slower (P = 7, 8: their grams spill kilobytes), and P = 2 keeps its
// unspilled registers (chip_smoke.py phase 2 gates them).
constexpr int kGridOccBlocks = 3;
#define DK_GRID_OCC(PV, W)                                                   \
  template <>                                                                \
  __global__ void __launch_bounds__(32 * kGridWarps, kGridOccBlocks)         \
      grid_kernel<double, PV, W, true>(DK_GRID_KERNEL_PARAMS(double)) {      \
    using T = double;                                                        \
    constexpr int P = PV;                                                    \
    constexpr bool UseW = W, UseCR = true;                                   \
    DK_GRID_KERNEL_BODY                                                      \
  }
DK_GRID_OCC(1, false)
DK_GRID_OCC(3, false)
DK_GRID_OCC(3, true)
DK_GRID_OCC(4, false)
DK_GRID_OCC(4, true)
DK_GRID_OCC(5, false)
DK_GRID_OCC(5, true)
DK_GRID_OCC(6, false)
DK_GRID_OCC(6, true)
#undef DK_GRID_OCC

template <typename T, int P, bool UseW, bool UseCR>
int launch_p(const T* y, const T* mu, const T* w, const T* x, const T* grid,
             const T* pm, int G, int S, int n, T prior_var, int use_prior,
             T thr, T* out, cudaStream_t st) {
  const size_t smem = block_stage_bytes<T>(S, P);
  grid_kernel<T, P, UseW, UseCR><<<G, 32 * kGridWarps, smem, st>>>(
      y, mu, x, grid, pm, S, n, prior_var, use_prior, smem > 0, out, w, thr);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 8 < p <= kPWide
// ---------------------------------------------------------------------------

// The samples of the design's chunk in the block's shared memory: the
// whole design (staged once a gene) while S fits, else a chunk at a time,
// staged anew for each pass (so any S runs).  float32: the samples'
// design rows, sample-major, rows_ld(pr) values a sample (x_row_put: 80 KB
// at p = 16); float64: the tensor cores' layout, the 16 design rows (zero
// past p) of cw + 4 values each (mma_stage: 66 KB).
constexpr int kWideChunkF32 = 1024;
constexpr int kWideChunkF64 = 512;

// a warp's shared values besides the design: the gram's reduction
// scratch (float32: gram_reduce's 16 values a lane) or its tensor-core
// store (float64), in whose room the p x p matrix is factored, then the
// two points' weights of a tile, then (float32) the points' LgConsts
template <typename T>
__host__ __device__ constexpr int wide_warp_vals() {
  return (is_f32<T>() ? 16 * kTile + 2 * 4 : kMat) + 2 * kTile;
}

// The shared-memory layout of a wide launch with the Cox-Reid term, in
// values of T: the design's chunk (cw samples, row stride ld: float32 a
// sample's values, float64 a design row's), then each warp's values.
struct WideLayout {
  int cw, ld;
  size_t design, vals;
};

template <typename T>
__host__ __device__ inline WideLayout wide_layout(int p, int S) {
  WideLayout l;
  const int chunk = is_f32<T>() ? kWideChunkF32 : kWideChunkF64;
  const int s32 = (S + kTile - 1) / kTile * kTile;
  l.cw = s32 < chunk ? s32 : chunk;
  l.ld = is_f32<T>() ? rows_ld((p + 3) & ~3) : l.cw + 4;
  l.design = (size_t)(is_f32<T>() ? l.cw : kPWide) * l.ld;
  l.vals = l.design + (size_t)kGridWarps * wide_warp_vals<T>();
  return l;
}

// The design's n samples from `base` into the block's chunk xs (every
// thread of the block calls it; a __syncthreads must follow): float32 a
// sample-major row a thread (x_row_put), float64 the design rows by
// cp.async (mma_stage over the block's warps, zeros past n and p).
template <typename T>
__device__ __forceinline__ void wide_stage(T* xs, const T* x, int S, int base,
                                           int n, int p,
                                           const WideLayout& lay) {
  if constexpr (is_f32<T>()) {
    for (int t = threadIdx.x; t < n; t += 32 * kGridWarps)
      x_row_put(xs, x, S, base + t, p, (p + 3) & ~3, lay.ld, t);
  } else {
    mma_stage<kGridWarps>(xs, x, S, base, n, p, kPWide, lay.ld, lay.cw, -1);
    cp_async_wait_all();
  }
}

// log_post at two points la[0], la[1] of a stage, at a run-time p, on
// every lane of the calling warp (x the design transposed, p x S; xs the
// block's design chunk, wv the warp's shared values; nchunks the chunks of
// S: past one, every pass stages them, between block barriers).  Each
// lane takes sample s of a 32-sample tile: its y, mu (and weight) read
// once for both points, the likelihood terms of both summed on the lane,
// the Cox-Reid weights w = mu / (1 + mu alpha) (0 on a row the weighted
// mode cuts) written to the warp's two weight rows; then the warp adds
// the tile to both points' grams X'WX from the staged design, each design
// value loaded once for both:
// - float32: the lanes' 4 x 4 blocks (gram_map) on the sample-major
//   design, quads in 128-bit loads (pair_add_rows), then each gram's
//   groups reduced in group order and stored with the column mask;
// - float64: the FP64 tensor cores, the warp's run of the three upper
//   8 x 8 tiles (mma_run on one warp, pair_add: k-steps in ascending
//   order), stored by gram_mma_store.
// warp_cholesky factors each gram in turn for its log determinant.  The
// terms, the mask, the pivot floor and the prior are log_post's; the
// float32 grams' products and order are the parent design's (a point a
// pass, column-major tiles of x and w x), so their bits too.  Without the
// Cox-Reid term a point is its likelihood terms (and prior) alone.
template <typename T, bool UseW, bool UseCR>
__device__ __forceinline__ void log_post_wide_pair(
    const T* yr, const T* mr, const T* wr, unsigned cm, T thr, const T* x,
    int S, int p, const WideLayout& lay, int nchunks, const T (&la)[2],
    T pm, T prior_var, int use_prior, T* xs, T* wv, T (&lp)[2]) {
  const int lane = lane_id();
  const T alpha[2] = {d_exp(la[0]), d_exp(la[1])};
  T acc[2] = {T(0), T(0)};
  T* wa = wv + (is_f32<T>() ? 16 * kTile : kMat);
  T* wb = wa + kTile;
  // float32 with the Cox-Reid term: the points' constants in the warp's
  // shared memory, read where a sample's terms use them (in registers
  // they spilled at two blocks an SM, PERF.md section 6)
  constexpr bool kShared = is_f32<T>() && UseCR;
  LgConst<T>* kc = reinterpret_cast<LgConst<T>*>(wb + kTile);
  LgConst<T> k0{}, k1{};
  if constexpr (kShared) {
    if (lane < 2) kc[lane] = lg_const(T(1) / (lane ? alpha[1] : alpha[0]));
    __syncwarp();
  } else {
    k0 = lg_const(T(1) / alpha[0]);
    k1 = lg_const(T(1) / alpha[1]);
  }
  using Gram =
      std::conditional_t<is_f32<T>(), GramBlock<float>, double[kMmaRunWide][2]>;
  Gram ga, gb;
  const GramMap gm = gram_map(p);
  const MmaRun<kMmaRunWide> run = mma_run<kMmaRunWide, 1>(2, 2, lay.ld);
  if constexpr (UseCR) {
    if constexpr (is_f32<T>()) {
      gram_zero(ga);
      gram_zero(gb);
    } else {
      gram_mma_zero(ga);
      gram_mma_zero(gb);
    }
  }
  for (int base = 0; base < S; base += lay.cw) {
    const int cn = S - base < lay.cw ? S - base : lay.cw;
    if (UseCR && nchunks > 1) {
      __syncthreads();
      wide_stage(xs, x, S, base, cn, p, lay);
      __syncthreads();
    }
    for (int t0 = 0; t0 < cn; t0 += kTile) {
      const int s = base + t0 + lane;
      T w[2] = {T(0), T(0)};
      if (s < S) {
        const T yv = yr[s];
        const T m = mr[s];
        const bool keep = !UseW || cr_keeps(wr[s], thr);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const LgConst<T>& k = kShared ? kc[e] : e ? k1 : k0;
          const T mua = m * alpha[e];
          const T r = T(1) / (T(1) + mua);
          acc[e] += wscale<UseW>(lg_diff(yv, k) - (yv + k.c) * d_log1p(mua),
                                 wr, s);
          w[e] = keep ? m * r : T(0);
        }
      }
      if constexpr (UseCR) {
        const int n = cn - t0 < kTile ? cn - t0 : kTile;
        wa[lane] = w[0];
        wb[lane] = w[1];
        __syncwarp();
        if constexpr (is_f32<T>()) {
          pair_add_rows(gm, ga, gb, xs + (size_t)t0 * lay.ld, wa, wb, lay.ld,
                        n);
        } else {
          pair_add<kMmaRunWide>(run, ga, gb, xs + t0, wa, wb, n);
        }
        __syncwarp();
      }
    }
  }
  warp_allsum<T, 2>(acc);
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    lp[e] = acc[e];
    if constexpr (UseCR) {
      if constexpr (is_f32<T>()) {
        // the reduction's scratch, then the matrix, at wv
        gram_reduce(gm, e ? gb : ga, wv);
        gram_store(gm, e ? gb : ga, wv, p, cm, true,
                   static_cast<const T*>(nullptr));
      } else {
        gram_mma_store<kMmaRunWide, 1, kPWide>(run, e ? gb : ga, false, wv, p,
                                               cm, true, nullptr, nullptr);
      }
      lp[e] -= T(0.5) * warp_cholesky<T, true>(wv, p);
    }
    if (use_prior) lp[e] -= T(0.5) * (la[e] - pm) * (la[e] - pm) / prior_var;
  }
}

// resident blocks an SM the wide kernel's launch bounds ask for: float32
// two (96 registers a thread, no spill; faster than three at 68 and than
// one), float64 one (two spilled 16-384 bytes; `studies k3`, PERF.md
// section 6)
template <typename T>
__host__ __device__ constexpr int wide_grid_blocks() {
  return is_f32<T>() ? 2 : 1;
}

// grid_kernel at a run-time p: each warp takes its points of a stage two
// at a time, j and j + kGridWarps (then j + 2 kGridWarps and j + 3
// kGridWarps, ...), in one pass over the samples (log_post_wide_pair),
// and keeps their first maximum in increasing j; every warp takes the
// same number of passes (a point past n is the stage's first, its lp
// unread), so that the passes' chunk barriers match.  With the Cox-Reid
// term the block first stages the design while S fits its chunk.
template <typename T, bool UseW, bool UseCR>
__global__ void __launch_bounds__(32 * kGridWarps, wide_grid_blocks<T>())
    grid_wide_kernel(const T* __restrict__ y, const T* __restrict__ mu,
                     const T* __restrict__ x, const T* __restrict__ grid,
                     const T* __restrict__ prior_mean, int S, int p, int n,
                     T prior_var, int use_prior, T* __restrict__ out,
                     const T* __restrict__ wts, T thr) {
  __shared__ T cand_lp[2][kGridWarps];
  __shared__ int cand_j[2][kGridWarps];
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const T* yr = y + (size_t)g * S;
  const T* mr = mu + (size_t)g * S;
  const T* wr = UseW ? wts + (size_t)g * S : nullptr;
  const WideLayout lay = wide_layout<T>(p, S);
  const int nchunks = (S + lay.cw - 1) / lay.cw;
  T* xs = reinterpret_cast<T*>(smem_raw);
  T* wv = xs + lay.design + (size_t)warp * wide_warp_vals<T>();
  unsigned cm = ~0u;
  if constexpr (UseW && UseCR) cm = warp_cr_col_mask_wide<T>(wr, x, S, p, thr);
  const T pm = prior_mean[g];
  if (UseCR && nchunks == 1) {
    wide_stage(xs, x, S, 0, S, p, lay);
    __syncthreads();
  }

  auto stage_max = [&](auto point, int st) {
    T best_lp = -INFINITY;
    int best_j = -1;
    for (int q = 0; q < n; q += 2 * kGridWarps) {
      const int j = q + warp, j2 = j + kGridWarps;
      const T la[2] = {point(j < n ? j : 0), point(j2 < n ? j2 : 0)};
      T lp[2];
      log_post_wide_pair<T, UseW, UseCR>(yr, mr, wr, cm, thr, x, S, p, lay,
                                         nchunks, la, pm, prior_var,
                                         use_prior, xs, wv, lp);
      if (j < n && lp[0] > best_lp) {
        best_lp = lp[0];
        best_j = j;
      }
      if (j2 < n && lp[1] > best_lp) {
        best_lp = lp[1];
        best_j = j2;
      }
    }
    if (lane_id() == 0) {
      cand_lp[st][warp] = best_lp;
      cand_j[st][warp] = best_j;
    }
  };

  stage_max([&](int j) { return grid[j]; }, 0);
  __syncthreads();
  const int jc = first_max(cand_lp[0], cand_j[0]);
  const T a_hat = jc < 0 ? T(0) : grid[jc];
  const T delta = grid[1] - grid[0];
  const T lo = a_hat - delta;
  const T span = T(2) * delta;
  const double step = 1.0 / (double)(n - 1);
  auto fine = [&](int j) { return lo + mul_rn(span, (T)((double)j * step)); };

  stage_max(fine, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int jf = first_max(cand_lp[1], cand_j[1]);
    out[g] = jf < 0 ? T(0) : fine(jf);
  }
}

// dynamic shared memory of a wide launch (none without the Cox-Reid term)
template <typename T>
inline size_t wide_smem(bool use_cr, int p, int S) {
  return use_cr ? wide_layout<T>(p, S).vals * sizeof(T) : 0;
}

template <typename T, bool UseW, bool UseCR>
int launch_wide(const T* y, const T* mu, const T* w, const T* x, const T* grid,
                const T* pm, int G, int S, int p, int n, T prior_var,
                int use_prior, T thr, T* out, cudaStream_t st) {
  const size_t smem = wide_smem<T>(UseCR, p, S);
  auto kernel = grid_wide_kernel<T, UseW, UseCR>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<G, 32 * kGridWarps, smem, st>>>(y, mu, x, grid, pm, S, p, n,
                                           prior_var, use_prior, out, w, thr);
  return (int)cudaGetLastError();
}

template <typename T, bool UseW, bool UseCR>
int occupancy_wide(int p, int S) {
  const size_t smem = wide_smem<T>(UseCR, p, S);
  auto kernel = grid_wide_kernel<T, UseW, UseCR>;
  int err = allow_smem(kernel, smem);
  const int n = err ? 0 : blocks_per_sm(kernel, smem, &err, 32 * kGridWarps);
  return err ? -1 : n;
}

// w == nullptr selects the unweighted instantiations, use_cr == 0 the ones
// without the Cox-Reid term, 8 < p <= 16 the wide kernel
template <typename T>
int launch(const T* y, const T* mu, const T* w, const T* x, const T* grid,
           const T* pm, int G, int S, int p, int n, T prior_var,
           int use_prior, int use_cr, T thr, T* out, void* stream) {
  if (n < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p > kPNarrow && p <= kPWide) {
#define DK_GRID_WIDE(W, CR)                                                 \
  return launch_wide<T, W, CR>(y, mu, w, x, grid, pm, G, S, p, n, prior_var, \
                               use_prior, thr, out, st)
    if (w != nullptr) {
      if (use_cr) DK_GRID_WIDE(true, true);
      DK_GRID_WIDE(true, false);
    }
    if (use_cr) DK_GRID_WIDE(false, true);
    DK_GRID_WIDE(false, false);
#undef DK_GRID_WIDE
  }
#define DK_GRID_LAUNCH(W, CR)                                              \
  DK_DISPATCH_P(p, return launch_p<T, P, W, CR>(y, mu, w, x, grid, pm, G, \
                                                S, n, prior_var, use_prior,\
                                                thr, out, st))
  if (w != nullptr) {
    if (use_cr) {
      DK_GRID_LAUNCH(true, true)
    } else {
      DK_GRID_LAUNCH(true, false)
    }
  } else {
    if (use_cr) {
      DK_GRID_LAUNCH(false, true)
    } else {
      DK_GRID_LAUNCH(false, false)
    }
  }
#undef DK_GRID_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// resident blocks per SM of the instantiation a launch would take (-1 on
// a refusal or an unsupported p)
template <typename T, bool UseW, bool UseCR>
int occupancy(int p, int S) {
  int err = 0;
  DK_DISPATCH_P(p, {
    const int n = blocks_per_sm(grid_kernel<T, P, UseW, UseCR>,
                                block_stage_bytes<T>(S, P), &err,
                                32 * kGridWarps);
    return err ? -1 : n;
  })
  return -1;
}

template <typename T>
int occupancy_mode(int weighted, int use_cr, int p, int S) {
  if (p > kPNarrow && p <= kPWide) {
    if (weighted) {
      return use_cr ? occupancy_wide<T, true, true>(p, S)
                    : occupancy_wide<T, true, false>(p, S);
    }
    return use_cr ? occupancy_wide<T, false, true>(p, S)
                  : occupancy_wide<T, false, false>(p, S);
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

int grid_blocks_per_sm(int f64, int weighted, int p, int S, int use_cr) {
  return f64 ? occupancy_mode<double>(weighted, use_cr, p, S)
             : occupancy_mode<float>(weighted, use_cr, p, S);
}

int grid_launch_f32(const float* y, const float* mu, const float* w,
                    const float* x, const float* grid, const float* pm, int G,
                    int S, int p, int n, float prior_var, int use_prior,
                    int use_cr, float thr, float* out, void* stream) {
  return launch<float>(y, mu, w, x, grid, pm, G, S, p, n, prior_var,
                       use_prior, use_cr, thr, out, stream);
}

int grid_launch_f64(const double* y, const double* mu, const double* w,
                    const double* x, const double* grid, const double* pm,
                    int G, int S, int p, int n, double prior_var,
                    int use_prior, int use_cr, double thr, double* out,
                    void* stream) {
  return launch<double>(y, mu, w, x, grid, pm, G, S, p, n, prior_var,
                        use_prior, use_cr, thr, out, stream);
}

}  // extern "C"
