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
// The design (common.cuh's block section): one block of 256 threads per
// gene evaluates the points of a stage in increasing order, each over all
// its threads (samples in tiles of up to 256, the gram's 4 x 4 upper
// blocks owned by the threads and reduced in group order, the Cholesky in
// shared memory), and keeps the first maximum by the plain version's
// strict `>` scan.  Every sum runs in one fixed order: two launches give
// the same bits.
//
// In float64 with the Cox-Reid term (grid_block_genes_mma) the gram runs
// on the FP64 tensor cores, as the float64 block K2's do (common.cuh's
// float64 gram section): persistent blocks take their next gene from the
// launch's counter and evaluate a stage's points two at a time (a stage's
// points are independent: the scan needs only their lp).  Every one of the
// 256 threads first computes its samples' terms at both points (the lgamma
// difference, the log1p term and the Cox-Reid weight w, which goes to two
// global scratch rows of the block's), then one pass over tiles staged by
// cp.async sums both points' X'WX as mma.sync m8n8k4 products, each
// design fragment loaded once for both (each warp a run of the upper 8 x 8
// tiles in registers, k-steps in ascending order), and warp 0 factors each
// with its log determinant (warp_cholesky_ll: block_cholesky's operations
// and order, one __syncwarp a column, where block_cholesky took three
// block barriers a column and a third of the point, PERF.md section 6).
// So no gram accumulator is live while the special functions run.
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

// log_post at a run-time p over a thread block (common.cuh's block
// section): x the design transposed (p x S); bm, red and tile the block's
// shared matrix, block sums' scratch and tile buffers.
template <typename T, bool UseW, bool UseCR>
__device__ __forceinline__ T log_post_block(const GramMap& gm, const T* yr,
                                            const T* mr, const T* wr,
                                            unsigned long long cm, T thr,
                                            const T* x, int S,
                                            const BlockLayout& lay, T la,
                                            T pm, T prior_var, int use_prior,
                                            T* bm, T* red, T* tile) {
  const int t = threadIdx.x;
  const int p = lay.p, tw = lay.tw, ts = lay.ts;
  const T alpha = d_exp(la);
  const LgConst<T> k = lg_const(T(1) / alpha);
  T acc[1] = {T(0)};
  GramBlock<T> gb;
  if constexpr (UseCR) gram_zero(gb);
  T* xb = tile;
  T* ub = tile + (size_t)lay.pr * ts;
  for (int base = 0; base < S; base += tw) {
    const int s = base + t;
    if constexpr (UseCR) __syncthreads();
    if (t < tw && s < S) {
      const T yv = yr[s];
      const T m = mr[s];
      const T mua = m * alpha;
      const T r = T(1) / (T(1) + mua);
      acc[0] +=
          wscale<UseW>(lg_diff(yv, k) - (yv + k.c) * d_log1p(mua), wr, s);
      if constexpr (UseCR) {
        T w = m * r;
        if constexpr (UseW) {
          if (!cr_keeps(wr[s], thr)) w = T(0);
        }
        block_tile_put(xb, ub, x, S, s, p, ts, w);
      }
    }
    if constexpr (UseCR) {
      const int n = S - base < tw ? S - base : tw;
      __syncthreads();
      block_gram_add(gm, gb, ub, xb, ts, n);
    }
  }
  block_allsum<T, 1>(acc, red);
  T lp = acc[0];
  if constexpr (UseCR) {
    block_gram_reduce(gm, gb, tile);   // the tile buffers are its scratch
    block_gram_store(gm, gb, bm, p, cm, true, static_cast<const T*>(nullptr));
    lp = acc[0] - T(0.5) * block_cholesky<T, true>(bm, p);
  }
  if (use_prior) lp -= T(0.5) * (la - pm) * (la - pm) / prior_var;
  return lp;
}

// K3's float64 layout with the Cox-Reid term: the matrix, the vectors,
// then the design rows (p columns) and the two points' weight rows
__host__ __device__ inline BlockLayout grid_mma_layout(int p, int tw) {
  return block_mma_layout(p, tw, kBlockMats, (p + 7) >> 3, 2, 0);
}

// Add a tile's first n samples to the warp's runs of two points' grams,
// ga += (wa x) x' and gb += (wb x) x': the design's fragments loaded once
// for both (gram_mma_add_len's order and products, so each gram's bits are
// a one-point pass's).
template <int L>
__device__ __forceinline__ void pair_add_len(const MmaRun<kMmaRunK2>& m,
                                             double (&ga)[kMmaRunK2][2],
                                             double (&gb)[kMmaRunK2][2],
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

template <int L>
__device__ __forceinline__ void pair_add(const MmaRun<kMmaRunK2>& m,
                                         double (&ga)[kMmaRunK2][2],
                                         double (&gb)[kMmaRunK2][2],
                                         const double* xb, const double* wa,
                                         const double* wb, int n) {
  if constexpr (L > 0) {
    if (m.n == L)
      pair_add_len<L>(m, ga, gb, xb, wa, wb, n);
    else
      pair_add<L - 1>(m, ga, gb, xb, wa, wb, n);
  }
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
// mask, the pivot floor and the prior are log_post_block's.
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
template <typename Point, typename Lp>
__device__ __forceinline__ int stage_first_max_pairs(int n, Point point,
                                                     Lp lp_pair) {
  double best_lp = -INFINITY;
  int best_j = -1;
  for (int j = 0; j < n; j += 2) {
    const int j2 = j + 1 < n ? j + 1 : j;
    const double la[2] = {point(j), point(j2)};
    double lp[2];
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
    const int jc = stage_first_max_pairs(
        n, [&](int j) { return grid[j]; }, lp_pair);
    const T lo = (jc < 0 ? T(0) : grid[jc]) - delta;
    auto fine = [&](int j) {
      return lo + mul_rn(span, (T)((double)j * step));
    };
    const int jf = stage_first_max_pairs(n, fine, lp_pair);
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

// grid_kernel at a run-time p with a thread block per gene: the block
// evaluates a stage's points in increasing j, each over all its threads,
// and keeps the first maximum (strict >, as the plain version scans).
// G, counter and scratch are the float64 instantiations' with the
// Cox-Reid term (below); this body reads none of them.
template <typename T, bool UseW, bool UseCR>
__global__ void __launch_bounds__(kBlockThreads)
    grid_block_kernel(DK_GRID_BLOCK_PARAMS(T)) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const BlockLayout lay =
      block_layout(p, tw, UseCR ? kBlockMats : 0, UseCR);
  T* bm = sm;
  T* vec = sm + (UseCR ? kBlockMats * lay.mat : 0);
  T* red = vec + kBlockRed;
  unsigned long long* mslot =
      reinterpret_cast<unsigned long long*>(vec + kBlockSlots + 2);
  T* tile = vec + lay.vec;
  const GramMap gm = block_gram_map(p);

  const int g = blockIdx.x;
  const T* yr = y + (size_t)g * S;
  const T* mr = mu + (size_t)g * S;
  const T* wr = UseW ? wts + (size_t)g * S : nullptr;
  unsigned long long cm = ~0ull;
  if constexpr (UseW && UseCR)
    cm = block_cr_col_mask<T>(wr, x, S, p, thr, mslot);
  const T pm = prior_mean[g];

  auto stage_max = [&](auto point) {
    T best_lp = -INFINITY;
    int best_j = -1;
    for (int j = 0; j < n; ++j) {
      const T lp = log_post_block<T, UseW, UseCR>(
          gm, yr, mr, wr, cm, thr, x, S, lay, point(j), pm, prior_var,
          use_prior, bm, red, tile);
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
#undef DK_GRID_BLOCK_PARAMS

// whether a launch takes the tensor-core path (persistent blocks, and a
// global scratch row of S weights per resident block)
template <typename T, bool UseCR>
__host__ __device__ constexpr bool grid_mma() {
  return !is_f32<T>() && UseCR;
}

// dynamic shared memory and tile width of a block launch (the vectors
// alone without the Cox-Reid term)
template <typename T>
inline size_t block_smem(int p, bool use_cr, int* tw) {
  if (!is_f32<T>() && use_cr) {
    *tw = block_mma_tile(p, kBlockMats, (p + 7) >> 3, 2, 0);
    return grid_mma_layout(p, *tw).vals * sizeof(T);
  }
  const int nmat = use_cr ? kBlockMats : 0;
  *tw = use_cr ? block_tile<T>(p, nmat, true) : kBlockThreads;
  return block_layout(p, *tw, nmat, use_cr).vals * sizeof(T);
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
  // a block a gene, or (the tensor-core path) persistent blocks
  int blocks = G;
  if constexpr (grid_mma<T, UseCR>()) {
    blocks = persistent_gene_blocks(kernel, smem, G, &err);
    if (err) return err;
    if (2 * blocks > scratch_rows) return (int)cudaErrorInvalidValue;
  }
  kernel<<<blocks, kBlockThreads, smem, st>>>(y, mu, x, grid, pm, S, p, n,
                                              tw, prior_var, use_prior, out,
                                              w, thr, G, counter, scratch);
  return (int)cudaGetLastError();
}

// Rows of global scratch (S values each) a launch needs: two a resident
// block on the tensor-core path (log_post_pair's weights at its two
// points), else 0; -1 on a refusal.
template <typename T, bool UseW, bool UseCR>
int scratch_rows_block(int p, int G) {
  if (!grid_mma<T, UseCR>()) return 0;
  int tw = 0;
  const size_t smem = block_smem<T>(p, UseCR, &tw);
  auto kernel = grid_block_kernel<T, UseW, UseCR>;
  int err = allow_smem(kernel, smem);
  const int blocks = err ? 0 : persistent_gene_blocks(kernel, smem, G, &err);
  return err ? -1 : 2 * blocks;
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
// and scratch holds scratch_rows rows of S values (the float64 path with
// the Cox-Reid term, as many as scratch_rows_mode says; else unread)
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
// `scratch_rows`; 0 in float32 and without the Cox-Reid term, -1 on a
// refusal)
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
