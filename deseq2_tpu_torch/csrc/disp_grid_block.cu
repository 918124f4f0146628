// K3 for designs of kPWide < p <= kPBlock columns (16 < p <= 64): the
// two-stage dispersion grid search with a thread block per gene
// (fitDispGrid contract, disp_grid.cu's).
//
// Replaces the TPU kernel deseq2_tpu/ops/pallas_disp.py:
// fit_disp_grid_pallas (_grid_kernel) past 16 columns, where the JAX
// package runs its XLA core (pallas_disp.py:195-205, the `p > 8` gate).
// The coarse grid, the fine grid's points (the plain version's
// grid_fractions, without a fused multiply-add), the first-maximum rule,
// the prior and the modes (weighted with the row cut and a 64-bit
// column mask; without the Cox-Reid term) are grid_wide_kernel's
// (disp_grid.cu).
//
// What bounds it on the H100: past 16 columns, the gram.  Each of the 2n
// = 40 points sums X'WX, p (p + 1) / 2 multiply-adds a sample, against the
// per-sample lgamma, log1p and reciprocal, then factors it (~p^3 / 6).
// Every design evaluates a gene's points with the whole block of 256
// threads and keeps the first maximum by the plain version's strict `>`
// scan; every sum runs in one fixed order, so two launches give the same
// bits and a gene's result does not depend on the genes beside it.
// Without the Cox-Reid term (both dtypes, a block a gene) a point is the
// likelihood terms' block sum alone.
//
// With the Cox-Reid term the blocks are persistent, each taking its next
// gene from the launch's counter, and every one of the 256 threads first
// computes its samples' terms (the lgamma difference, the log1p term and
// the Cox-Reid weight w, which goes to the block's global scratch rows),
// so that no gram accumulator is live while the special functions run;
// then one pass over the tiles sums X'WX, and warp 0 factors it with its
// log determinant (warp_cholesky_ll: block_cholesky's operations and
// order, one __syncwarp a column, where block_cholesky took three block
// barriers a column and a third of the point, PERF.md section 6).
// - float64 (grid_block_genes_mma, log_post_pair): the gram on the FP64
//   tensor cores, as the float64 block K2's (common.cuh's float64 gram
//   section), two points of a stage a pass (a stage's points are
//   independent: the scan needs only their lp), tiles staged by cp.async
//   and each design fragment loaded once for both grams (each warp a run
//   of the upper 8 x 8 tiles in registers, k-steps in ascending order);
// - float32 (grid_block_genes_rows, log_post_rows): the float32 block K2's
//   design (lp_dlp_rows) with one gram a point, two points of a stage a
//   pass: sample-major design tiles that a thread's 4 x 4 blocks read in
//   128-bit loads, each quad loaded once for both points' grams (the gram
//   threads form w x from the two weight rows beside the tile), the
//   groups' blocks reduced in group order, four blocks an SM (kRowsBlocks,
//   64 registers a thread), the tile width set by their shared memory.
#include "common.cuh"

namespace {

using namespace dk;

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// the block kernel's p x p matrix (with the Cox-Reid term): b, then its
// factor
constexpr int kBlockMats = 1;

// log_post at a run-time p over a thread block without the Cox-Reid term
// (both dtypes; with it float32 takes log_post_rows and float64
// log_post_pair): the likelihood terms alone, each thread its samples of
// the tiles of tw (common.cuh's block section); red the block sums'
// scratch.
template <typename T, bool UseW>
__device__ __forceinline__ T log_post_block(const T* yr, const T* mr,
                                            const T* wr, int S,
                                            const BlockLayout& lay, T la,
                                            T pm, T prior_var, int use_prior,
                                            T* red) {
  const int t = threadIdx.x;
  const int tw = lay.tw;
  const T alpha = d_exp(la);
  const LgConst<T> k = lg_const(T(1) / alpha);
  T acc[1] = {T(0)};
  for (int base = 0; base < S; base += tw) {
    const int s = base + t;
    if (t < tw && s < S) {
      const T yv = yr[s];
      const T m = mr[s];
      const T mua = m * alpha;
      const T r = T(1) / (T(1) + mua);
      acc[0] +=
          wscale<UseW>(lg_diff(yv, k) - (yv + k.c) * d_log1p(mua), wr, s);
    }
  }
  block_allsum<T, 1>(acc, red);
  T lp = acc[0];
  if (use_prior) lp -= T(0.5) * (la - pm) * (la - pm) / prior_var;
  return lp;
}

// K3's float32 layout with the Cox-Reid term: the matrix (its values
// rounded up to a multiple of 4, so that the tile's 128-bit stores stay
// aligned), the vectors, then the sample-major design tile (x_row_put:
// lay.ts = rows_ld(pr) the row stride) and two points' weight rows of tw
// values, which the groups' reduction reuses as its scratch
__host__ __device__ inline BlockLayout grid_rows_layout(int p, int tw) {
  BlockLayout l = block_layout(p, tw, kBlockMats, true);
  l.mat = (l.mat + 3) & ~(size_t)3;
  l.ts = rows_ld(l.pr);
  const size_t buf = (size_t)tw * l.ts + 2 * (size_t)tw;
  const size_t scratch =
      (size_t)(block_gram_groups(p) - 1) * block_gram_blocks(p) * 16;
  l.tile = buf > scratch ? buf : scratch;
  l.vals = kBlockMats * l.mat + l.vec + l.tile;
  return l;
}

// the float32 kernel's resident blocks an SM (its launch bounds: 64
// registers a thread, spills and all) and the shared memory each may take
// for them (the SM's 228 KB less the 1 KB a block the card keeps); the
// tile width follows from them and p alone, never from G, so that a
// gene's sums run in one order in any launch (256 samples up to p = 40,
// 192 at 48, 128 at 64).  Four blocks an SM measured faster than two and three
// at p = 17-40, three at p = 64 (`studies k3`, PERF.md section 6).
constexpr int kRowsBlocks = 4;
constexpr size_t kRowsSmemTarget = 233472 / kRowsBlocks - 1024;

inline int grid_rows_tile(int p) {
  int tw = kBlockThreads;
  while (tw > 32 && grid_rows_layout(p, tw).vals * sizeof(float) >
                        kRowsSmemTarget)
    tw -= 32;
  return tw;
}

// log_post in float32 with the Cox-Reid term at two points la[0], la[1] of
// a stage (the float32 block K2's lp_dlp_rows design with one gram a
// point): every thread first sums its samples t, t + 256, ... (whatever
// the tile width) at both points and writes their weights w to wscr (2 S
// values of the block's global scratch; block_allsum's barrier makes them
// visible to the block); then the block walks the tiles, staging the
// design sample-major (x_row_put) with both points' weights beside it, and
// adds each tile to the threads' 4 x 4 blocks of both grams with 128-bit
// loads (pair_add_rows), in the tiles' order; each gram's blocks are then
// reduced in group order and stored with the column mask, and warp 0
// factors the matrix (warp_cholesky_ll: block_cholesky's operations and
// order, one __syncwarp a column) and hands the log determinant to every
// thread through `ldet` (a shared value of its own: `red` takes the next
// pair's sums).  So no gram accumulator is live while the special
// functions run.  The terms, the mask, the pivot floor and the prior are
// the parent design's (a point at a time, the 4 x 4 blocks on
// column-major tiles, block_cholesky).
template <bool UseW>
__device__ __forceinline__ void log_post_rows(
    const GramMap& gm, const float* yr, const float* mr, const float* wr,
    unsigned long long cm, float thr, const float* x, int S,
    const BlockLayout& lay, const float (&la)[2], float pm, float prior_var,
    int use_prior, float* bm, float* red, float* tile, float* wscr,
    float* ldet, float (&lp)[2]) {
  using T = float;
  const int t = threadIdx.x;
  const int p = lay.p, tw = lay.tw, ts = lay.ts;
  const T alpha[2] = {d_exp(la[0]), d_exp(la[1])};
  T acc[2] = {T(0), T(0)};
  {
    const LgConst<T> k0 = lg_const(T(1) / alpha[0]);
    const LgConst<T> k1 = lg_const(T(1) / alpha[1]);
    for (int s = t; s < S; s += kBlockThreads) {
      const T yv = yr[s];
      const T m = mr[s];
      const bool keep = !UseW || cr_keeps(wr[s], thr);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const LgConst<T>& k = e ? k1 : k0;
        const T mua = m * alpha[e];
        const T r = T(1) / (T(1) + mua);
        acc[e] +=
            wscale<UseW>(lg_diff(yv, k) - (yv + k.c) * d_log1p(mua), wr, s);
        wscr[(size_t)e * S + s] = keep ? m * r : T(0);
      }
    }
  }
  block_allsum<T, 2>(acc, red);
  GramBlock<T> ga, gb;
  gram_zero(ga);
  gram_zero(gb);
  T* xb = tile;
  T* wa = tile + (size_t)tw * ts;
  T* wb = wa + tw;
  for (int base = 0; base < S; base += tw) {
    const int s = base + t;
    __syncthreads();
    if (t < tw && s < S) {
      x_row_put(xb, x, S, s, p, lay.pr, ts, t);
      wa[t] = wscr[s];
      wb[t] = wscr[(size_t)S + s];
    }
    const int n = S - base < tw ? S - base : tw;
    __syncthreads();
    pair_add_rows(gm, ga, gb, xb, wa, wb, ts, n);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    GramBlock<T>& g = e ? gb : ga;
    // the tile buffers are the reduction's scratch
    block_gram_reduce(gm, g, tile);
    block_gram_store(gm, g, bm, p, cm, true, static_cast<const T*>(nullptr));
    if (t < 32) {
      const T d = p <= 32 ? warp_cholesky_ll<T, 1>(bm, p)
                          : warp_cholesky_ll<T, 2>(bm, p);
      if (t == 0) *ldet = d;
    }
    __syncthreads();
    lp[e] = acc[e] - 0.5f * *ldet;
    if (use_prior) lp[e] -= 0.5f * (la[e] - pm) * (la[e] - pm) / prior_var;
  }
}

// K3's float64 layout with the Cox-Reid term: the matrix, the vectors,
// then the design rows (p columns) and the two points' weight rows
__host__ __device__ inline BlockLayout grid_mma_layout(int p, int tw) {
  return block_mma_layout(p, tw, kBlockMats, (p + 7) >> 3, 2, 0);
}

// log_post_block in float64 with the Cox-Reid term at two points la[0],
// la[1] of a stage: every sample's terms at both first, each thread its
// samples t, t + 256, ..., the weights to wscr (2 S values of the block's
// global scratch; block_allsum's barrier makes them visible to the
// block), then one pass over the tiles staging the design once for both
// grams (pair_add), then each gram's store with the column mask and its
// factor with the log determinant on warp 0 in turn (warp_cholesky_ll,
// lane l rows l and l + 32; one row a lane to 32 columns), which reaches
// every thread through `ldet` (a shared value of its own: `red` takes the
// next pair's sums before every thread has read it).  The terms, the
// mask, the pivot floor and the prior are grid_wide_kernel's.
template <bool UseW>
__device__ __forceinline__ void log_post_pair(
    const double* yr, const double* mr, const double* wr,
    unsigned long long cm, double thr, const double* x, int S,
    const BlockLayout& lay, const double (&la)[2], double pm,
    double prior_var, int use_prior, double* bm, double* red, double* tile,
    double* wscr, double* ldet, double (&lp)[2]) {
  using T = double;
  const T alpha[2] = {d_exp(la[0]), d_exp(la[1])};
  T acc[2] = {T(0), T(0)};
  {
    const LgConst<T> k0 = lg_const(T(1) / alpha[0]);
    const LgConst<T> k1 = lg_const(T(1) / alpha[1]);
    for (int s = threadIdx.x; s < S; s += kBlockThreads) {
      const T yv = yr[s];
      const T m = mr[s];
      const bool keep = !UseW || cr_keeps(wr[s], thr);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const LgConst<T>& k = e ? k1 : k0;
        const T mua = m * alpha[e];
        const T r = T(1) / (T(1) + mua);
        acc[e] +=
            wscale<UseW>(lg_diff(yv, k) - (yv + k.c) * d_log1p(mua), wr, s);
        wscr[(size_t)e * S + s] = keep ? m * r : T(0);
      }
    }
  }
  block_allsum<T, 2>(acc, red);
  const int p = lay.p, tw = lay.tw, ts = lay.ts;
  const MmaRun<kMmaRunK2> run =
      mma_run<kMmaRunK2>((p + 7) >> 3, lay.pr >> 3, ts);
  T ga[kMmaRunK2][2], gb[kMmaRunK2][2];
  gram_mma_zero(ga);
  gram_mma_zero(gb);
  T* wa = tile + (size_t)lay.pr * ts;
  T* wb = wa + ts;
  const int t = threadIdx.x;
  for (int base = 0; base < S; base += tw) {
    const int n = S - base < tw ? S - base : tw;
    __syncthreads();
    mma_stage(tile, x, S, base, n, p, lay.pr, ts, tw, -1);
    if (t < tw) {
      wa[t] = t < n ? wscr[base + t] : 0.0;
      wb[t] = t < n ? wscr[(size_t)S + base + t] : 0.0;
    }
    cp_async_wait_all();
    __syncthreads();
    pair_add<kMmaRunK2>(run, ga, gb, tile, wa, wb, n);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    gram_mma_store(run, e ? gb : ga, false, bm, p, cm, true, nullptr,
                   nullptr);
    if (threadIdx.x < 32) {
      const T d = p <= 32 ? warp_cholesky_ll<T, 1>(bm, p)
                          : warp_cholesky_ll<T, 2>(bm, p);
      if (threadIdx.x == 0) *ldet = d;
    }
    __syncthreads();
    lp[e] = acc[e] - T(0.5) * *ldet;
    if (use_prior) lp[e] -= T(0.5) * (la[e] - pm) * (la[e] - pm) / prior_var;
  }
}

// The first maximum of a stage's n points point(0), ..., point(n - 1)
// (strict >, as the plain version scans them in increasing j), their lp
// evaluated two at a time by lp_pair (the last alone, as a pair of itself,
// when n is odd): every thread gets the same index (-1 when no lp beats
// -inf).
template <typename T, typename Point, typename Lp>
__device__ __forceinline__ int stage_first_max_pairs(int n, Point point,
                                                     Lp lp_pair) {
  T best_lp = -INFINITY;
  int best_j = -1;
  for (int j = 0; j < n; j += 2) {
    const int j2 = j + 1 < n ? j + 1 : j;
    const T la[2] = {point(j), point(j2)};
    T lp[2];
    lp_pair(la, lp);
    if (lp[0] > best_lp) {
      best_lp = lp[0];
      best_j = j;
    }
    if (j2 != j && lp[1] > best_lp) {
      best_lp = lp[1];
      best_j = j2;
    }
  }
  return best_j;
}

// grid_block_kernel<double, UseW, true>'s body: persistent blocks, each
// gene's coarse and fine stages as grid_block_kernel runs them, their
// points two at a time by log_post_pair.
template <bool UseW>
__device__ __forceinline__ void grid_block_genes_mma(
    double* sm, const double* __restrict__ y, const double* __restrict__ mu,
    const double* __restrict__ x, const double* __restrict__ grid,
    const double* __restrict__ prior_mean, int G, int S, int p, int n,
    int tw, double prior_var, int use_prior, double* __restrict__ out,
    const double* __restrict__ wts, double thr, int* __restrict__ counter,
    double* __restrict__ scratch) {
  using T = double;
  const BlockLayout lay = grid_mma_layout(p, tw);
  T* bm = sm;
  T* vec = sm + lay.mat;
  T* red = vec + kBlockRed;
  int* slot = reinterpret_cast<int*>(vec + kBlockSlots);
  unsigned long long* mslot =
      reinterpret_cast<unsigned long long*>(vec + kBlockSlots + 2);
  // the log determinant's slot: the vectors' last value (the mask's 64
  // bits take one double)
  T* ldet = vec + kBlockSlots + 3;
  T* tile = vec + lay.vec;
  T* wscr = scratch + (size_t)blockIdx.x * 2 * S;
  const T delta = grid[1] - grid[0];
  const T span = T(2) * delta;
  const double step = 1.0 / (double)(n - 1);
  for (;;) {
    const int g = block_next_gene(counter, slot);
    if (g >= G) break;
    const T* yr = y + (size_t)g * S;
    const T* mr = mu + (size_t)g * S;
    const T* wr = UseW ? wts + (size_t)g * S : nullptr;
    unsigned long long cm = ~0ull;
    if constexpr (UseW) cm = block_cr_col_mask<T>(wr, x, S, p, thr, mslot);
    const T pm = prior_mean[g];
    auto lp_pair = [&](const T (&la)[2], T (&lp)[2]) {
      log_post_pair<UseW>(yr, mr, wr, cm, thr, x, S, lay, la, pm, prior_var,
                          use_prior, bm, red, tile, wscr, ldet, lp);
    };
    const int jc = stage_first_max_pairs<T>(
        n, [&](int j) { return grid[j]; }, lp_pair);
    const T lo = (jc < 0 ? T(0) : grid[jc]) - delta;
    auto fine = [&](int j) {
      return lo + mul_rn(span, (T)((double)j * step));
    };
    const int jf = stage_first_max_pairs<T>(n, fine, lp_pair);
    if (threadIdx.x == 0) out[g] = jf < 0 ? T(0) : fine(jf);
  }
}

// grid_block_kernel<float, UseW, true>'s body: persistent blocks, each
// gene's coarse and fine stages as grid_block_kernel runs them, their
// points two at a time by log_post_rows.
template <bool UseW>
__device__ __forceinline__ void grid_block_genes_rows(
    float* sm, const float* __restrict__ y, const float* __restrict__ mu,
    const float* __restrict__ x, const float* __restrict__ grid,
    const float* __restrict__ prior_mean, int G, int S, int p, int n,
    int tw, float prior_var, int use_prior, float* __restrict__ out,
    const float* __restrict__ wts, float thr, int* __restrict__ counter,
    float* __restrict__ scratch) {
  using T = float;
  const BlockLayout lay = grid_rows_layout(p, tw);
  T* bm = sm;
  T* vec = sm + lay.mat;
  T* red = vec + kBlockRed;
  int* slot = reinterpret_cast<int*>(vec + kBlockSlots);
  // the log determinant's slot: the value beside the gene index (the
  // mask's 64 bits take the next two)
  T* ldet = vec + kBlockSlots + 1;
  unsigned long long* mslot =
      reinterpret_cast<unsigned long long*>(vec + kBlockSlots + 2);
  T* tile = vec + lay.vec;
  T* wscr = scratch + (size_t)blockIdx.x * 2 * S;
  const GramMap gm = block_gram_map(p);
  const T delta = grid[1] - grid[0];
  const T span = T(2) * delta;
  const double step = 1.0 / (double)(n - 1);
  for (;;) {
    const int g = block_next_gene(counter, slot);
    if (g >= G) break;
    const T* yr = y + (size_t)g * S;
    const T* mr = mu + (size_t)g * S;
    const T* wr = UseW ? wts + (size_t)g * S : nullptr;
    unsigned long long cm = ~0ull;
    if constexpr (UseW) cm = block_cr_col_mask<T>(wr, x, S, p, thr, mslot);
    const T pm = prior_mean[g];
    auto lp_pair = [&](const T (&la)[2], T (&lp)[2]) {
      log_post_rows<UseW>(gm, yr, mr, wr, cm, thr, x, S, lay, la, pm,
                          prior_var, use_prior, bm, red, tile, wscr, ldet,
                          lp);
    };
    const int jc = stage_first_max_pairs<T>(
        n, [&](int j) { return grid[j]; }, lp_pair);
    const T lo = (jc < 0 ? T(0) : grid[jc]) - delta;
    auto fine = [&](int j) {
      return lo + mul_rn(span, (T)((double)j * step));
    };
    const int jf = stage_first_max_pairs<T>(n, fine, lp_pair);
    if (threadIdx.x == 0) out[g] = jf < 0 ? T(0) : fine(jf);
  }
}

#define DK_GRID_BLOCK_PARAMS(T)                                              \
  const T *__restrict__ y, const T *__restrict__ mu,                         \
      const T *__restrict__ x, const T *__restrict__ grid,                   \
      const T *__restrict__ prior_mean, int S, int p, int n, int tw,         \
      T prior_var, int use_prior, T *__restrict__ out,                       \
      const T *__restrict__ wts, T thr, int G, int *__restrict__ counter,    \
      T *__restrict__ scratch

// grid_kernel at a run-time p with a thread block per gene, without the
// Cox-Reid term (both dtypes): the block evaluates a stage's points in
// increasing j, each over all its threads, and keeps the first maximum
// (strict >, as the plain version scans).  G, counter and scratch are the
// persistent instantiations' with the Cox-Reid term (below); this body
// reads none of them.
template <typename T, bool UseW, bool UseCR>
__global__ void __launch_bounds__(kBlockThreads)
    grid_block_kernel(DK_GRID_BLOCK_PARAMS(T)) {
  static_assert(!UseCR, "the Cox-Reid term takes the persistent bodies");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const BlockLayout lay = block_layout(p, tw, 0, false);
  T* red = sm + kBlockRed;

  const int g = blockIdx.x;
  const T* yr = y + (size_t)g * S;
  const T* mr = mu + (size_t)g * S;
  const T* wr = UseW ? wts + (size_t)g * S : nullptr;
  const T pm = prior_mean[g];

  auto stage_max = [&](auto point) {
    T best_lp = -INFINITY;
    int best_j = -1;
    for (int j = 0; j < n; ++j) {
      const T lp = log_post_block<T, UseW>(yr, mr, wr, S, lay, point(j), pm,
                                           prior_var, use_prior, red);
      if (lp > best_lp) {
        best_lp = lp;
        best_j = j;
      }
    }
    return best_j;
  };

  const int jc = stage_max([&](int j) { return grid[j]; });
  const T a_hat = jc < 0 ? T(0) : grid[jc];
  const T delta = grid[1] - grid[0];
  const T lo = a_hat - delta;
  const T span = T(2) * delta;
  const double step = 1.0 / (double)(n - 1);
  auto fine = [&](int j) { return lo + mul_rn(span, (T)((double)j * step)); };
  const int jf = stage_max(fine);
  if (threadIdx.x == 0) out[g] = jf < 0 ? T(0) : fine(jf);
}

// The float64 instantiations with the Cox-Reid term: the tensor-core gram
// (grid_block_genes_mma), persistent blocks over the G genes by
// `counter`, each block with its row of `scratch`.
#define DK_GRID_BLOCK_MMA(W)                                                 \
  template <>                                                                \
  __global__ void __launch_bounds__(kBlockThreads)                           \
      grid_block_kernel<double, W, true>(DK_GRID_BLOCK_PARAMS(double)) {     \
    extern __shared__ __align__(16) unsigned char smem_raw[];                \
    grid_block_genes_mma<W>(reinterpret_cast<double*>(smem_raw), y, mu, x,   \
                            grid, prior_mean, G, S, p, n, tw, prior_var,     \
                            use_prior, out, wts, thr, counter, scratch);     \
  }
DK_GRID_BLOCK_MMA(false)
DK_GRID_BLOCK_MMA(true)
#undef DK_GRID_BLOCK_MMA

// The float32 instantiations with the Cox-Reid term: log_post_rows,
// persistent blocks over the G genes by `counter`, kRowsBlocks resident
// blocks an SM, each block with its row of `scratch`.
#define DK_GRID_BLOCK_ROWS(W)                                                \
  template <>                                                                \
  __global__ void __launch_bounds__(kBlockThreads, kRowsBlocks)              \
      grid_block_kernel<float, W, true>(DK_GRID_BLOCK_PARAMS(float)) {       \
    extern __shared__ __align__(16) unsigned char smem_raw[];                \
    grid_block_genes_rows<W>(reinterpret_cast<float*>(smem_raw), y, mu, x,   \
                             grid, prior_mean, G, S, p, n, tw, prior_var,    \
                             use_prior, out, wts, thr, counter, scratch);    \
  }
DK_GRID_BLOCK_ROWS(false)
DK_GRID_BLOCK_ROWS(true)
#undef DK_GRID_BLOCK_ROWS
#undef DK_GRID_BLOCK_PARAMS

// Rows of global scratch (S values each) a resident block takes: with the
// Cox-Reid term the launch's blocks are persistent and write the weights
// of a stage's two points there (log_post_pair, log_post_rows), else
// none.
template <bool UseCR>
__host__ __device__ constexpr int grid_scratch_per_block() {
  return UseCR ? 2 : 0;
}

// dynamic shared memory and tile width of a block launch (the vectors
// alone without the Cox-Reid term)
template <typename T>
inline size_t block_smem(int p, bool use_cr, int* tw) {
  if (!use_cr) {
    *tw = kBlockThreads;
    return block_layout(p, *tw, 0, false).vals * sizeof(T);
  }
  if (is_f32<T>()) {
    *tw = grid_rows_tile(p);
    return grid_rows_layout(p, *tw).vals * sizeof(T);
  }
  *tw = block_mma_tile(p, kBlockMats, (p + 7) >> 3, 2, 0);
  return grid_mma_layout(p, *tw).vals * sizeof(T);
}

template <typename T, bool UseW, bool UseCR>
int launch_block(const T* y, const T* mu, const T* w, const T* x,
                 const T* grid, const T* pm, int G, int S, int p, int n,
                 T prior_var, int use_prior, T thr, T* out, int* counter,
                 T* scratch, int scratch_rows, cudaStream_t st) {
  int tw = 0;
  const size_t smem = block_smem<T>(p, UseCR, &tw);
  auto kernel = grid_block_kernel<T, UseW, UseCR>;
  int err = allow_smem(kernel, smem);
  if (err) return err;
  // a block a gene, or (with the Cox-Reid term) persistent blocks
  int blocks = G;
  if constexpr (UseCR) {
    blocks = persistent_gene_blocks(kernel, smem, G, &err);
    if (err) return err;
    if (grid_scratch_per_block<UseCR>() * blocks > scratch_rows)
      return (int)cudaErrorInvalidValue;
  }
  kernel<<<blocks, kBlockThreads, smem, st>>>(y, mu, x, grid, pm, S, p, n,
                                              tw, prior_var, use_prior, out,
                                              w, thr, G, counter, scratch);
  return (int)cudaGetLastError();
}

// Rows of global scratch (S values each) a launch needs:
// grid_scratch_per_block a resident block, 0 without the Cox-Reid term;
// -1 on a refusal.
template <typename T, bool UseW, bool UseCR>
int scratch_rows_block(int p, int G) {
  if (!UseCR) return 0;
  int tw = 0;
  const size_t smem = block_smem<T>(p, UseCR, &tw);
  auto kernel = grid_block_kernel<T, UseW, UseCR>;
  int err = allow_smem(kernel, smem);
  const int blocks = err ? 0 : persistent_gene_blocks(kernel, smem, G, &err);
  return err ? -1 : grid_scratch_per_block<UseCR>() * blocks;
}

template <typename T, bool UseW, bool UseCR>
int occupancy_block(int p) {
  int tw = 0;
  const size_t smem = block_smem<T>(p, UseCR, &tw);
  auto kernel = grid_block_kernel<T, UseW, UseCR>;
  int err = allow_smem(kernel, smem);
  const int n = err ? 0 : blocks_per_sm(kernel, smem, &err, kBlockThreads);
  return err ? -1 : n;
}

// w == nullptr selects the unweighted instantiations, use_cr == 0 the ones
// without the Cox-Reid term; `counter` is one zeroed int of device memory
// and scratch holds scratch_rows rows of S values (with the Cox-Reid term,
// as many as scratch_rows_mode says; else unread)
template <typename T>
int launch(const T* y, const T* mu, const T* w, const T* x, const T* grid,
           const T* pm, int G, int S, int p, int n, T prior_var,
           int use_prior, int use_cr, T thr, T* out, int* counter,
           T* scratch, int scratch_rows, void* stream) {
  if (n < 2 || p <= kBlockMinP || p > kPBlock) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DK_GRID_BLOCK(W, CR)                                                 \
  return launch_block<T, W, CR>(y, mu, w, x, grid, pm, G, S, p, n,          \
                                prior_var, use_prior, thr, out, counter,    \
                                scratch, scratch_rows, st)
  if (w != nullptr) {
    if (use_cr) DK_GRID_BLOCK(true, true);
    DK_GRID_BLOCK(true, false);
  }
  if (use_cr) DK_GRID_BLOCK(false, true);
  DK_GRID_BLOCK(false, false);
#undef DK_GRID_BLOCK
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

// rows of S values of global scratch the launch takes (`scratch`,
// `scratch_rows`; 0 without the Cox-Reid term, -1 on a refusal)
int grid_block_scratch_rows(int f64, int weighted, int p, int use_cr, int G) {
  return f64 ? scratch_rows_mode<double>(weighted, use_cr, p, G)
             : scratch_rows_mode<float>(weighted, use_cr, p, G);
}

// resident blocks per SM of the instantiation a launch would take (-1 on
// a refusal or an unsupported p)
int grid_block_blocks_per_sm(int f64, int weighted, int p, int use_cr) {
  return f64 ? occupancy_mode<double>(weighted, use_cr, p)
             : occupancy_mode<float>(weighted, use_cr, p);
}

int grid_block_launch_f32(const float* y, const float* mu, const float* w,
                          const float* x, const float* grid, const float* pm,
                          int G, int S, int p, int n, float prior_var,
                          int use_prior, int use_cr, float thr, float* out,
                          int* counter, float* scratch, int scratch_rows,
                          void* stream) {
  return launch<float>(y, mu, w, x, grid, pm, G, S, p, n, prior_var,
                       use_prior, use_cr, thr, out, counter, scratch,
                       scratch_rows, stream);
}

int grid_block_launch_f64(const double* y, const double* mu, const double* w,
                          const double* x, const double* grid,
                          const double* pm, int G, int S, int p, int n,
                          double prior_var, int use_prior, int use_cr,
                          double thr, double* out, int* counter,
                          double* scratch, int scratch_rows, void* stream) {
  return launch<double>(y, mu, w, x, grid, pm, G, S, p, n, prior_var,
                        use_prior, use_cr, thr, out, counter, scratch,
                        scratch_rows, stream);
}

}  // extern "C"
