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
// rule; each warp evaluates its points with the wide tile pass of
// common.cuh (the line search's, disp_ls.cu) and the log determinant of
// the Cox-Reid matrix factored in the warp's shared memory.
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

// The weighted mode's parameter comes last, as in the other kernels.
template <typename T, int P, bool UseW, bool UseCR>
__global__ void __launch_bounds__(32 * kGridWarps)
    grid_kernel(const T* __restrict__ y, const T* __restrict__ mu,
                const T* __restrict__ x, const T* __restrict__ grid,
                const T* __restrict__ prior_mean, int S, int n, T prior_var,
                int use_prior, int stage_x, T* __restrict__ out,
                const T* __restrict__ wts, T thr) {
  // each warp's candidate (lp, j) per stage: 0 coarse, 1 fine
  __shared__ T cand_lp[2][kGridWarps];
  __shared__ int cand_j[2][kGridWarps];
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const T* yr = y + (size_t)g * S;
  const T* mr = mu + (size_t)g * S;
  const T* wr = UseW ? wts + (size_t)g * S : nullptr;
  const T* xr = x;
  if (stage_x) {
    T* sx = reinterpret_cast<T*>(smem_raw);
    block_stage(sx, x, S * P);
    xr = sx;
    __syncthreads();
  }
  unsigned cm = ~0u;
  if constexpr (UseW && UseCR) cm = warp_cr_col_mask<T, P>(wr, xr, S, thr);
  const T pm = prior_mean[g];

  // this warp's points j = warp, warp + kGridWarps, ... of a stage, in
  // increasing j; strict >: the first maximum wins, a NaN or -inf never
  // does
  auto stage_max = [&](auto point, int st) {
    T best_lp = -INFINITY;
    int best_j = -1;
    for (int j = warp; j < n; j += kGridWarps) {
      const T lp = log_post<T, P, UseW, UseCR>(yr, mr, wr, cm, thr, xr, S,
                                               point(j), pm, prior_var,
                                               use_prior);
      if (lp > best_lp) {
        best_lp = lp;
        best_j = j;
      }
    }
    if (lane_id() == 0) {
      cand_lp[st][warp] = best_lp;
      cand_j[st][warp] = best_j;
    }
  };

  // coarse stage over the shared grid; every thread reads the pick
  stage_max([&](int j) { return grid[j]; }, 0);
  __syncthreads();
  const int jc = first_max(cand_lp[0], cand_j[0]);
  const T a_hat = jc < 0 ? T(0) : grid[jc];
  const T delta = grid[1] - grid[0];
  const T lo = a_hat - delta;
  const T span = T(2) * delta;
  const double step = 1.0 / (double)(n - 1);
  auto fine = [&](int j) { return lo + mul_rn(span, (T)((double)j * step)); };

  // fine stage over a_hat +- delta
  stage_max(fine, 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    const int jf = first_max(cand_lp[1], cand_j[1]);
    out[g] = jf < 0 ? T(0) : fine(jf);
  }
}

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

// shared values per warp: the tile buffers of x and w x; after a point's
// last tile the Cox-Reid matrix takes the x buffer's room
constexpr int kWideWarpVals = 2 * kTileVals;

// log_post at a run-time p: x the design transposed (p x S), wv the warp's
// shared values.
template <typename T, bool UseW, bool UseCR>
__device__ __forceinline__ T log_post_wide(const T* yr, const T* mr,
                                           const T* wr, unsigned cm, T thr,
                                           const T* x, int S, int p, T la,
                                           T pm, T prior_var, int use_prior,
                                           T* wv) {
  const int lane = lane_id();
  const GramMap gm = gram_map(p);
  const T alpha = d_exp(la);
  const LgConst<T> k = lg_const(T(1) / alpha);
  T acc[1] = {T(0)};
  GramBlock<T> gb, unused;
  T rz[4];
  if constexpr (UseCR) gram_zero(gb);
  T* xb = wv;
  T* ub = wv + kTileVals;
  __syncwarp();
  for (int base = 0; base < S; base += kTile) {
    const int s = base + lane;
    if (s < S) {
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
        tile_put(xb, ub, x, S, s, p, w);
      }
    }
    if constexpr (UseCR) {
      const int n = S - base < kTile ? S - base : kTile;
      __syncwarp();
      gram_add<T, false, false>(gm, gb, unused, rz, ub, xb,
                                static_cast<const T*>(nullptr), n);
      __syncwarp();
    }
  }
  warp_allsum<T, 1>(acc);
  T lp = acc[0];
  if constexpr (UseCR) {
    gram_reduce(gm, gb, wv);   // the tile buffer is its scratch
    gram_store(gm, gb, wv, p, cm, true, static_cast<const T*>(nullptr));
    lp = acc[0] - T(0.5) * warp_cholesky<T, true>(wv, p);
  }
  if (use_prior) lp -= T(0.5) * (la - pm) * (la - pm) / prior_var;
  return lp;
}

// grid_kernel at a run-time p, each warp with its own shared values
template <typename T, bool UseW, bool UseCR>
__global__ void __launch_bounds__(32 * kGridWarps)
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
  T* wv = reinterpret_cast<T*>(smem_raw) +
          (UseCR ? (size_t)warp * kWideWarpVals : 0);
  unsigned cm = ~0u;
  if constexpr (UseW && UseCR) cm = warp_cr_col_mask_wide<T>(wr, x, S, p, thr);
  const T pm = prior_mean[g];

  auto stage_max = [&](auto point, int st) {
    T best_lp = -INFINITY;
    int best_j = -1;
    for (int j = warp; j < n; j += kGridWarps) {
      const T lp = log_post_wide<T, UseW, UseCR>(yr, mr, wr, cm, thr, x, S,
                                                 p, point(j), pm, prior_var,
                                                 use_prior, wv);
      if (lp > best_lp) {
        best_lp = lp;
        best_j = j;
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
inline size_t wide_smem(bool use_cr) {
  return use_cr ? (size_t)kGridWarps * kWideWarpVals * sizeof(T) : 0;
}

template <typename T, bool UseW, bool UseCR>
int launch_wide(const T* y, const T* mu, const T* w, const T* x, const T* grid,
                const T* pm, int G, int S, int p, int n, T prior_var,
                int use_prior, T thr, T* out, cudaStream_t st) {
  const size_t smem = wide_smem<T>(UseCR);
  auto kernel = grid_wide_kernel<T, UseW, UseCR>;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<G, 32 * kGridWarps, smem, st>>>(y, mu, x, grid, pm, S, p, n,
                                           prior_var, use_prior, out, w, thr);
  return (int)cudaGetLastError();
}

template <typename T, bool UseW, bool UseCR>
int occupancy_wide() {
  const size_t smem = wide_smem<T>(UseCR);
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
