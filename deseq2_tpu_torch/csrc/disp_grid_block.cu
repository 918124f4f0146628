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

// grid_kernel at a run-time p with a thread block per gene: the block
// evaluates a stage's points in increasing j, each over all its threads,
// and keeps the first maximum (strict >, as the plain version scans).
template <typename T, bool UseW, bool UseCR>
__global__ void __launch_bounds__(kBlockThreads)
    grid_block_kernel(const T* __restrict__ y, const T* __restrict__ mu,
                      const T* __restrict__ x, const T* __restrict__ grid,
                      const T* __restrict__ prior_mean, int S, int p, int n,
                      int tw, T prior_var, int use_prior, T* __restrict__ out,
                      const T* __restrict__ wts, T thr) {
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

// dynamic shared memory and tile width of a block launch (the vectors
// alone without the Cox-Reid term)
template <typename T>
inline size_t block_smem(int p, bool use_cr, int* tw) {
  const int nmat = use_cr ? kBlockMats : 0;
  *tw = use_cr ? block_tile<T>(p, nmat, true) : kBlockThreads;
  return block_layout(p, *tw, nmat, use_cr).vals * sizeof(T);
}

template <typename T, bool UseW, bool UseCR>
int launch_block(const T* y, const T* mu, const T* w, const T* x,
                 const T* grid, const T* pm, int G, int S, int p, int n,
                 T prior_var, int use_prior, T thr, T* out, cudaStream_t st) {
  int tw = 0;
  const size_t smem = block_smem<T>(p, UseCR, &tw);
  auto kernel = grid_block_kernel<T, UseW, UseCR>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<G, kBlockThreads, smem, st>>>(y, mu, x, grid, pm, S, p, n, tw,
                                         prior_var, use_prior, out, w, thr);
  return (int)cudaGetLastError();
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
// without the Cox-Reid term
template <typename T>
int launch(const T* y, const T* mu, const T* w, const T* x, const T* grid,
           const T* pm, int G, int S, int p, int n, T prior_var,
           int use_prior, int use_cr, T thr, T* out, void* stream) {
  if (n < 2 || p <= kBlockMinP || p > kPBlock) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DK_GRID_BLOCK(W, CR)                                                 \
  return launch_block<T, W, CR>(y, mu, w, x, grid, pm, G, S, p, n,          \
                                prior_var, use_prior, thr, out, st)
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

}  // namespace

extern "C" {

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
                          void* stream) {
  return launch<float>(y, mu, w, x, grid, pm, G, S, p, n, prior_var,
                       use_prior, use_cr, thr, out, stream);
}

int grid_block_launch_f64(const double* y, const double* mu, const double* w,
                          const double* x, const double* grid,
                          const double* pm, int G, int S, int p, int n,
                          double prior_var, int use_prior, int use_cr,
                          double thr, double* out, void* stream) {
  return launch<double>(y, mu, w, x, grid, pm, G, S, p, n, prior_var,
                        use_prior, use_cr, thr, out, stream);
}

}  // extern "C"
