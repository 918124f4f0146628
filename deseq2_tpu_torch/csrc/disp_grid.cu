// K3: two-stage dispersion grid search, one gene per thread block
// (fitDispGrid contract).
//
// Replaces the TPU kernel deseq2_tpu/ops/pallas_disp.py:fit_disp_grid_pallas
// (_grid_kernel).  Evaluates the Cox-Reid adjusted NB log posterior (plus
// the optional log-normal prior) at the n shared coarse log-alpha points,
// takes the gene's argmax (the first maximum wins), then evaluates n fine
// points spanning a_hat +- delta and takes the argmax again.
//
// What bounds it on the H100: the special functions.  2n = 40 posterior
// evaluations per gene, each two lgammas, a log and a log1p per sample,
// against 2 values read per sample.  The design reads the (y, mu) rows from
// HBM once into shared memory (when 2 S sizeof(T) <= 40 KB) and keeps them
// there for all 40 evaluations; the pipeline launches it only on the genes
// whose line search did not converge.
//
// Weighted mode (UseW, a template parameter, so the unweighted
// instantiations are unchanged): the posterior of the line search's
// weighted mode (disp_ls.cu), weighted likelihood terms and the masked
// Cox-Reid term, with the weight row staged beside (y, mu) when 3 S
// sizeof(T) <= 40 KB.  This is an extension of the TPU kernel, whose JAX
// pipeline runs the weighted grid on its XLA core (fused.py:583); the port
// runs no plain version on the card, so the weighted grid is a kernel too.
#include "common.cuh"

namespace {

using namespace dk;

template <typename T, int P, bool UseW>
__device__ __forceinline__ T log_post(const T* yr, const T* mr, const T* wr,
                                      unsigned cm,
                                      const T* __restrict__ x, int S, T la,
                                      T pm, T prior_var, int use_prior,
                                      T* red) {
  constexpr int NT = P * (P + 1) / 2;
  constexpr int NV = 1 + NT;
  const T alpha = d_exp(la);
  const T inv_a = T(1) / alpha;
  T acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = T(0);
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const T yv = yr[s];
    const T m = mr[s];
    acc[0] += wscale<UseW>(
        lgamma_diff_centered(yv, inv_a) - (yv + inv_a) * d_log1p(m * alpha),
        wr, s);
    T xs[P];
    load_row<T, P>(x, s, xs);
    T w = T(1) / (T(1) / m + alpha);
    if constexpr (UseW) {
      if (!cr_keeps(wr[s])) w = T(0);
    }
    acc_outer<T, P>(acc + 1, w, xs);
  }
  block_sum<T, NV>(acc, red);
  T lp = T(0);
  if (threadIdx.x == 0) {
    T b[P][P], L[P][P];
    unpack_sym<T, P>(acc + 1, b);
    if constexpr (UseW) cr_apply_mask<T, P>(cm, b, nullptr);
    lp = acc[0] - T(0.5) * cholesky<T, P>(b, L);
    if (use_prior) lp -= T(0.5) * (la - pm) * (la - pm) / prior_var;
  }
  return lp;
}

// The weighted mode's parameter comes last, so the unweighted
// instantiations keep the parameter layout, and so the code, of a kernel
// without it.
template <typename T, int P, bool UseW>
__global__ void __launch_bounds__(kThreads)
    grid_kernel(const T* __restrict__ y, const T* __restrict__ mu,
                const T* __restrict__ x,
                const T* __restrict__ grid, const T* __restrict__ frac,
                const T* __restrict__ prior_mean, int S, int n, T prior_var,
                int use_prior, int use_smem, T* __restrict__ out,
                const T* __restrict__ wts) {
  constexpr int NT = P * (P + 1) / 2;
  __shared__ T red[kWarps * (1 + NT)];
  __shared__ T sh_ahat;
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const T* yr = y + (size_t)g * S;
  const T* mr = mu + (size_t)g * S;
  const T* wr = UseW ? wts + (size_t)g * S : nullptr;
  if (use_smem) {
    T* sy = reinterpret_cast<T*>(smem_raw);
    T* sm = sy + S;
    T* sw = sy + 2 * S;
    for (int s = tid; s < S; s += kThreads) {
      sy[s] = yr[s];
      sm[s] = mr[s];
      if constexpr (UseW) sw[s] = wr[s];
    }
    yr = sy;
    mr = sm;
    if constexpr (UseW) wr = sw;
  }
  // each thread reads back only the samples it staged: no barrier needed
  unsigned cm = ~0u;
  if constexpr (UseW) cm = cr_col_mask<T, P>(wr, x, S, red);
  const T pm = prior_mean[g];
  const T delta = grid[1] - grid[0];

  // coarse stage over the shared grid; best_* live on thread 0
  T best_lp = -INFINITY, best_a = T(0);
  for (int j = 0; j < n; ++j) {
    const T a = grid[j];
    const T lp = log_post<T, P, UseW>(yr, mr, wr, cm, x, S, a, pm, prior_var,
                                      use_prior, red);
    if (tid == 0 && lp > best_lp) {
      best_lp = lp;
      best_a = a;
    }
    __syncthreads();
  }
  if (tid == 0) sh_ahat = best_a;
  __syncthreads();
  const T lo = sh_ahat - delta;
  const T span = T(2) * delta;

  // fine stage over a_hat +- delta
  best_lp = -INFINITY;
  best_a = T(0);
  for (int j = 0; j < n; ++j) {
    const T a = lo + span * frac[j];
    const T lp = log_post<T, P, UseW>(yr, mr, wr, cm, x, S, a, pm, prior_var,
                                      use_prior, red);
    if (tid == 0 && lp > best_lp) {
      best_lp = lp;
      best_a = a;
    }
    __syncthreads();
  }
  if (tid == 0) out[g] = best_a;
}

// w == nullptr selects the unweighted instantiations
template <typename T>
int launch(const T* y, const T* mu, const T* w, const T* x, const T* grid,
           const T* frac, const T* pm, int G, int S, int p, int n,
           T prior_var, int use_prior, T* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w != nullptr) {
    const size_t smem = row_smem_bytes<T>(S, 3);
    DK_DISPATCH_P(p, grid_kernel<T, P, true><<<G, kThreads, smem, st>>>(
                          y, mu, x, grid, frac, pm, S, n, prior_var,
                          use_prior, smem > 0, out, w))
  } else {
    const size_t smem = row_smem_bytes<T>(S, 2);
    DK_DISPATCH_P(p, grid_kernel<T, P, false><<<G, kThreads, smem, st>>>(
                          y, mu, x, grid, frac, pm, S, n, prior_var,
                          use_prior, smem > 0, out, w))
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int grid_launch_f32(const float* y, const float* mu, const float* w,
                    const float* x, const float* grid, const float* frac,
                    const float* pm, int G, int S, int p, int n,
                    float prior_var, int use_prior, float* out,
                    void* stream) {
  return launch<float>(y, mu, w, x, grid, frac, pm, G, S, p, n, prior_var,
                       use_prior, out, stream);
}

int grid_launch_f64(const double* y, const double* mu, const double* w,
                    const double* x, const double* grid, const double* frac,
                    const double* pm, int G, int S, int p, int n,
                    double prior_var, int use_prior, double* out,
                    void* stream) {
  return launch<double>(y, mu, w, x, grid, frac, pm, G, S, p, n, prior_var,
                        use_prior, out, stream);
}

}  // extern "C"
