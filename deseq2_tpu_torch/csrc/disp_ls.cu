// K2: dispersion line search, one gene per thread block (fitDisp contract).
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
// What bounds it on the H100: the special functions, not bytes.  Every
// trial point costs, per sample, two lgammas, two digammas (each eight
// recurrence shifts and a series), a log1p and a handful of divisions,
// against 2 values read.  The design reads the (y, mu) rows from HBM once
// per gene into shared memory (when 2 S sizeof(T) <= 40 KB), evaluates lp
// and dlp in one fused pass at each trial point (both are needed at the
// same point once the step is accepted), and lets each block stop as soon
// as its gene converges.  The weighted mode stages the weight row beside
// them (when 3 S sizeof(T) <= 40 KB).
//
// Weighted mode (UseW, a template parameter, so the unweighted
// instantiations are unchanged; pallas_ls.py:152-247 use_w): the
// likelihood terms of lp and of s1 are multiplied by the gene's weights.
// The Cox-Reid term is not weighted: it keeps the rows with weight >
// 1e-2 (src/DESeq2.cpp:38-44, cr_keeps) and drops, per gene, the columns left
// without support on those rows (b_kk <- 1 and its off-diagonals 0, so the
// kept submatrix's log determinant survives; db's rows and columns 0).
// The column mask depends on the weights only, so each block computes it
// once, before the search.
#include "common.cuh"

namespace {

using namespace dk;

constexpr double kArmijo = 1.0e-4;

// lp and dlp at log-alpha `la`; every thread calls it, the results are
// valid on thread 0.  wr and cm (the column-mask bits, on thread 0) are
// read in the weighted mode only.
template <typename T, int P, bool UseW>
__device__ __forceinline__ void lp_dlp(const T* yr, const T* mr, const T* wr,
                                       unsigned cm,
                                       const T* __restrict__ x, int S, T la,
                                       T pm, T prior_var, int use_prior,
                                       T* red, T& lp, T& dlp) {
  constexpr int NT = P * (P + 1) / 2;
  constexpr int NV = 2 + 2 * NT;
  const T alpha = d_exp(la);
  const T inv_a = T(1) / alpha;
  T acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = T(0);
  for (int s = threadIdx.x; s < S; s += kThreads) {
    const T yv = yr[s];
    const T m = mr[s];
    const T mua = m * alpha;
    const T l1p = d_log1p(mua);
    acc[0] += wscale<UseW>(lgamma_diff_centered(yv, inv_a) - (yv + inv_a) * l1p,
                           wr, s);
    acc[1] += wscale<UseW>(l1p - mua / (T(1) + mua) + yv / (m + inv_a) -
                               digamma_diff(yv, inv_a),
                           wr, s);
    T w = T(1) / (T(1) / m + alpha);
    if constexpr (UseW) {
      if (!cr_keeps(wr[s])) w = T(0);
    }
    T xs[P];
    load_row<T, P>(x, s, xs);
    acc_outer<T, P>(acc + 2, w, xs);
    acc_outer<T, P>(acc + 2 + NT, -w * w, xs);
  }
  block_sum<T, NV>(acc, red);
  if (threadIdx.x == 0) {
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
    if (use_prior) {
      lp -= T(0.5) * (la - pm) * (la - pm) / prior_var;
      dlp -= (la - pm) / prior_var;
    }
  }
}

// The weighted mode's parameter comes last, so the unweighted
// instantiations keep the parameter layout, and so the code, of a kernel
// without it.
template <typename T, int P, bool UseW>
__global__ void __launch_bounds__(kThreads)
    ls_kernel(const T* __restrict__ y, const T* __restrict__ mu,
              const T* __restrict__ x,
              const T* __restrict__ la0, const T* __restrict__ prior_mean,
              int S, T prior_var, T kappa_0, T tol, T min_la,
              int maxit, int use_prior, int use_smem, T* __restrict__ out_la,
              T* __restrict__ out_lp0, T* __restrict__ out_dlp0,
              T* __restrict__ out_lp, T* __restrict__ out_dlp,
              T* __restrict__ out_change, int* __restrict__ out_iter,
              int* __restrict__ out_accept, const T* __restrict__ wts) {
  constexpr int NT = P * (P + 1) / 2;
  constexpr int NV = 2 + 2 * NT;
  __shared__ T red[kWarps * NV];
  __shared__ T sh_a;
  __shared__ int sh_done;
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
  const T a0 = la0[g];
  T lp0 = T(0), dlp0 = T(0);
  lp_dlp<T, P, UseW>(yr, mr, wr, cm, x, S, a0, pm, prior_var, use_prior, red,
                     lp0, dlp0);

  // control state, live on thread 0
  const T eps = Eps<T>::value;
  const T tol_eff = tol > d_abs(lp0) * T(50) * eps ? tol : d_abs(lp0) * T(50) * eps;
  T a = a0, kappa = kappa_0, lp = lp0, dlp = dlp0, change = T(-1);
  int iters = 0, iter_accept = 0;
  bool done = false;

  for (int t = 0; t < maxit; ++t) {
    if (tid == 0) {
      sh_done = done ? 1 : 0;
      if (!done) {
        ++iters;
        const T a_propose = a + kappa * dlp;
        if (a_propose < T(-30)) kappa = (T(-30) - a) / dlp;
        if (a_propose > T(10)) kappa = (T(10) - a) / dlp;
        sh_a = a + kappa * dlp;
      }
    }
    __syncthreads();
    if (sh_done) break;
    const T a_new = sh_a;
    T lp_new = T(0), dlp_next = T(0);
    lp_dlp<T, P, UseW>(yr, mr, wr, cm, x, S, a_new, pm, prior_var, use_prior,
                       red, lp_new, dlp_next);
    if (tid == 0) {
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
      if (cont_accept) dlp = dlp_next;
      if (cont_accept) {
        T k = kappa * T(1.1);
        k = k < kappa_0 ? k : kappa_0;
        if (iter_accept % 5 == 0) k = k / T(2);
        kappa = k;
      } else if (!accept) {
        kappa = kappa / T(2);
      }
      done = (accept && (conv || under)) || stalled;
    }
    // the next trip's first __syncthreads orders thread 0's state update
    // before any read of sh_a / sh_done
  }
  if (tid == 0) {
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

// w == nullptr selects the unweighted instantiations
template <typename T>
int launch(const T* y, const T* mu, const T* w, const T* x, const T* la0,
           const T* pm, int G, int S, int p, T prior_var, T kappa_0, T tol,
           T min_la, int maxit, int use_prior, T* out_la,
           T* out_lp0, T* out_dlp0, T* out_lp, T* out_dlp, T* out_change,
           int* out_iter, int* out_accept, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w != nullptr) {
    const size_t smem = row_smem_bytes<T>(S, 3);
    DK_DISPATCH_P(p, ls_kernel<T, P, true><<<G, kThreads, smem, st>>>(
                          y, mu, x, la0, pm, S, prior_var, kappa_0, tol,
                          min_la, maxit, use_prior, smem > 0, out_la,
                          out_lp0, out_dlp0, out_lp, out_dlp, out_change,
                          out_iter, out_accept, w))
  } else {
    const size_t smem = row_smem_bytes<T>(S, 2);
    DK_DISPATCH_P(p, ls_kernel<T, P, false><<<G, kThreads, smem, st>>>(
                          y, mu, x, la0, pm, S, prior_var, kappa_0, tol,
                          min_la, maxit, use_prior, smem > 0, out_la,
                          out_lp0, out_dlp0, out_lp, out_dlp, out_change,
                          out_iter, out_accept, w))
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ls_launch_f32(const float* y, const float* mu, const float* w,
                  const float* x, const float* la0, const float* pm, int G,
                  int S, int p, float prior_var, float kappa_0, float tol,
                  float min_la, int maxit, int use_prior,
                  float* out_la, float* out_lp0, float* out_dlp0,
                  float* out_lp, float* out_dlp, float* out_change,
                  int* out_iter, int* out_accept, void* stream) {
  return launch<float>(y, mu, w, x, la0, pm, G, S, p, prior_var, kappa_0, tol,
                       min_la, maxit, use_prior, out_la, out_lp0,
                       out_dlp0, out_lp, out_dlp, out_change, out_iter,
                       out_accept, stream);
}

int ls_launch_f64(const double* y, const double* mu, const double* w,
                  const double* x, const double* la0, const double* pm, int G,
                  int S, int p, double prior_var, double kappa_0, double tol,
                  double min_la, int maxit, int use_prior,
                  double* out_la, double* out_lp0, double* out_dlp0,
                  double* out_lp, double* out_dlp, double* out_change,
                  int* out_iter, int* out_accept, void* stream) {
  return launch<double>(y, mu, w, x, la0, pm, G, S, p, prior_var, kappa_0,
                        tol, min_la, maxit, use_prior, out_la, out_lp0,
                        out_dlp0, out_lp, out_dlp, out_change, out_iter,
                        out_accept, stream);
}

}  // extern "C"
