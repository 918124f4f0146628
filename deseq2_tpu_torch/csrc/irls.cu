// K1: ridge NB IRLS, one gene per thread block (fitBeta contract).
//
// Replaces the TPU kernel deseq2_tpu/ops/pallas_irls.py:fit_beta_pallas
// (_irls_kernel).  Per gene, until convergence:
//
//   mu   = max(nf exp(X beta), min_mu)
//   W    = mu / (1 + alpha mu),  z = log(mu/nf) + (y - mu)/mu
//   beta <- (X'WX + diag(ridge))^-1 X'Wz
//   stop when |dev - dev_old| / (|dev| + 0.1) < max(tol, 30 eps);
//   |beta| > 30 or a NaN deviance test sets iter := maxit;
//   float32 only: stop once beta moves by < 32 eps (1 + max|beta|).
//
// then the sandwich variance diag((X'WX+R)^-1 X'WX (X'WX+R)^-1), the hat
// diagonal w x' (X'WX+R)^-1 x and the final clamped mu.
//
// What bounds it on the H100: memory traffic if the (y, mu) rows were
// re-read from HBM on every sweep (2 passes x S values per iteration, 10+
// iterations), otherwise the special functions (exp, two logs per sample
// per sweep).  The design keeps the gene's y row and its mu scratch in
// shared memory when 2 S sizeof(T) <= 40 KB, so HBM sees y once and mu/hat
// once; a block exits as soon as its own gene converges, so no gene pays
// for the slowest one.  The p x p solves are unrolled on thread 0.
//
// Weighted mode (UseW, a template parameter, so the unweighted
// instantiations are unchanged; pallas_irls.py:106-124, 156-169, 221-258
// use_w): the gene's observation weights multiply W in the normal
// equations, every deviance term (the mu-independent part included, which
// is summed per sample in both modes, so nothing gene-constant is hoisted
// that a weight would have to scale), the sandwich's X'WX and the hat
// diagonal.  The weight row is staged beside y and mu when 3 S sizeof(T)
// <= 40 KB.
#include "common.cuh"

namespace {

using namespace dk;

// The weight row comes last, so the unweighted instantiations keep the
// parameter layout, and so the code, of a kernel without it.
template <typename T, int P, bool UseW>
__global__ void __launch_bounds__(kThreads)
    irls_kernel(const T* __restrict__ y, const T* __restrict__ nf,
                long long nf_gstride, const T* __restrict__ alpha_in,
                const T* __restrict__ beta0, const T* __restrict__ ridge,
                const T* __restrict__ x, int S, T tol, int maxit, T min_mu,
                int use_smem, T* __restrict__ beta_out,
                T* __restrict__ bvar_out, T* __restrict__ dev_out,
                int* __restrict__ iter_out, T* __restrict__ mu_out,
                T* __restrict__ hat_out, const T* __restrict__ wts) {
  constexpr int NT = P * (P + 1) / 2;
  constexpr int NA = NT + P;
  __shared__ T red[kWarps * NA];
  __shared__ T sh_beta[P];
  __shared__ T sh_ainv[P * P];
  __shared__ int sh_flag[2];
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const T* yr = y + (size_t)g * S;
  const T* nfr = nf + (size_t)g * nf_gstride;
  T* mu_g = mu_out + (size_t)g * S;
  T* hat_g = hat_out + (size_t)g * S;
  T* mur = mu_g;
  const T* wr = UseW ? wts + (size_t)g * S : nullptr;
  if (use_smem) {
    T* sy = reinterpret_cast<T*>(smem_raw);
    T* sw = sy + 2 * S;
    for (int s = tid; s < S; s += kThreads) {
      sy[s] = yr[s];
      if constexpr (UseW) sw[s] = wr[s];
    }
    yr = sy;
    mur = sy + S;
    if constexpr (UseW) wr = sw;
  }
  const T alpha = alpha_in[g];
  const T size = T(1) / alpha;

  T beta[P];
#pragma unroll
  for (int k = 0; k < P; ++k) beta[k] = beta0[(size_t)g * P + k];

  // initial mu and the mu-independent deviance constant
  T acc1[1] = {T(0)};
  for (int s = tid; s < S; s += kThreads) {
    T xs[P];
    load_row<T, P>(x, s, xs);
    T xb = T(0);
#pragma unroll
    for (int k = 0; k < P; ++k) xb += beta[k] * xs[k];
    const T m = nfr[s] * d_exp(xb);
    mur[s] = m > min_mu ? m : min_mu;
    const T yv = yr[s];
    acc1[0] += wscale<UseW>(d_lgamma(yv + size) - d_lgamma(size) -
                                d_lgamma(yv + T(1)) + size * d_log(size),
                            wr, s);
  }
  block_sum<T, 1>(acc1, red);
  const T dev_const = T(-2) * acc1[0];  // valid on thread 0
  const T eps = Eps<T>::value;
  const T tol_eff = tol > T(30) * eps ? tol : T(30) * eps;

  // control state, live on thread 0
  T dev_old = T(0), dev = T(0);
  int iters = 0;
  __syncthreads();

  for (int t = 0; t < maxit; ++t) {
    // normal equations X'WX (packed) and X'Wz at the current mu
    T acc[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] = T(0);
    for (int s = tid; s < S; s += kThreads) {
      T xs[P];
      load_row<T, P>(x, s, xs);
      const T m = mur[s];
      const T w = wscale<UseW>(m / (T(1) + alpha * m), wr, s);
      const T z = d_log(m) - d_log(nfr[s]) + (yr[s] - m) / m;
      acc_outer<T, P>(acc, w, xs);
      const T wz = w * z;
#pragma unroll
      for (int i = 0; i < P; ++i) acc[NT + i] += wz * xs[i];
    }
    block_sum<T, NA>(acc, red);
    if (tid == 0) {
      ++iters;
      T a[P][P], L[P][P], rhs[P], bn[P];
      unpack_sym<T, P>(acc, a);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        a[k][k] += ridge[k];
        rhs[k] = acc[NT + k];
      }
      cholesky<T, P>(a, L);
      chol_solve<T, P>(L, rhs, bn);
      bool diverged = false;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        diverged |= d_abs(bn[k]) > T(30);
        sh_beta[k] = bn[k];
      }
      sh_flag[0] = diverged ? 0 : 1;
    }
    __syncthreads();

    // mu and deviance at the new beta; mu kept only when not diverged
    const bool cont = sh_flag[0] != 0;
    T bn[P];
#pragma unroll
    for (int k = 0; k < P; ++k) bn[k] = sh_beta[k];
    T accd[1] = {T(0)};
    for (int s = tid; s < S; s += kThreads) {
      T xs[P];
      load_row<T, P>(x, s, xs);
      T xb = T(0);
#pragma unroll
      for (int k = 0; k < P; ++k) xb += bn[k] * xs[k];
      T m = nfr[s] * d_exp(xb);
      m = m > min_mu ? m : min_mu;
      const T yv = yr[s];
      const T lsm = d_log(size + m);
      const T tt = yv > T(0) ? yv * (d_log(m) - lsm) : T(0);
      accd[0] += wscale<UseW>(-size * lsm + tt, wr, s);
      if (cont) mur[s] = m;
    }
    block_sum<T, 1>(accd, red);
    if (tid == 0) {
      const T dev_new = dev_const + T(-2) * accd[0];
      if (cont) dev = dev_new;
      const T conv_test = d_abs(dev_new - dev_old) / (d_abs(dev_new) + T(0.1));
      const bool bad = isnan(conv_test);
      bool converged = t > 0 && conv_test < tol_eff;
      if (is_f32<T>()) {
        T dbeta = T(0), bmax = T(0);
#pragma unroll
        for (int k = 0; k < P; ++k) {
          const T d = d_abs(bn[k] - beta[k]);
          dbeta = d > dbeta ? d : dbeta;
          bmax = d_abs(bn[k]) > bmax ? d_abs(bn[k]) : bmax;
        }
        converged |= t > 0 && dbeta < T(32) * eps * (T(1) + bmax);
      }
      if (!cont || bad) iters = maxit;
      if (cont) dev_old = dev_new;
#pragma unroll
      for (int k = 0; k < P; ++k) beta[k] = bn[k];
      sh_flag[1] = (cont && !bad && !converged) ? 1 : 0;
    }
    __syncthreads();
    if (!sh_flag[1]) break;
  }

  // post-fit: X'WX at the final (clamped) mu
  T accx[NT];
#pragma unroll
  for (int i = 0; i < NT; ++i) accx[i] = T(0);
  for (int s = tid; s < S; s += kThreads) {
    T xs[P];
    load_row<T, P>(x, s, xs);
    const T m = mur[s];
    acc_outer<T, P>(accx, wscale<UseW>(m / (T(1) + alpha * m), wr, s), xs);
  }
  block_sum<T, NT>(accx, red);
  if (tid == 0) {
    T xtwx[P][P], a[P][P], L[P][P], ainv[P][P];
    unpack_sym<T, P>(accx, xtwx);
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
      for (int j = 0; j < P; ++j) a[i][j] = xtwx[i][j];
      a[i][i] += ridge[i];
    }
    cholesky<T, P>(a, L);
    chol_inverse<T, P>(L, ainv);
#pragma unroll
    for (int k = 0; k < P; ++k) {
      T s = T(0);
#pragma unroll
      for (int m = 0; m < P; ++m) {
        T r = T(0);
#pragma unroll
        for (int n = 0; n < P; ++n) r += xtwx[m][n] * ainv[n][k];
        s += ainv[k][m] * r;
      }
      bvar_out[(size_t)g * P + k] = s;
      beta_out[(size_t)g * P + k] = beta[k];
    }
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
      for (int j = 0; j < P; ++j) sh_ainv[i * P + j] = ainv[i][j];
    }
    dev_out[g] = dev;
    iter_out[g] = iters;
  }
  __syncthreads();
  for (int s = tid; s < S; s += kThreads) {
    T xs[P];
    load_row<T, P>(x, s, xs);
    const T m = mur[s];
    T q = T(0);
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
      for (int j = 0; j < P; ++j) q += sh_ainv[i * P + j] * (xs[i] * xs[j]);
    }
    hat_g[s] = wscale<UseW>(m / (T(1) + alpha * m), wr, s) * q;
    if (use_smem) mu_g[s] = m;
  }
}

// w == nullptr selects the unweighted instantiations
template <typename T>
int launch(const T* y, const T* nf, long long nf_gstride, const T* w,
           const T* alpha, const T* beta0, const T* ridge, const T* x, int G,
           int S, int p, T tol, int maxit, T min_mu, T* beta, T* bvar, T* dev,
           int* iters, T* mu, T* hat, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w != nullptr) {
    const size_t smem = row_smem_bytes<T>(S, 3);
    DK_DISPATCH_P(p, irls_kernel<T, P, true><<<G, kThreads, smem, st>>>(
                          y, nf, nf_gstride, alpha, beta0, ridge, x, S, tol,
                          maxit, min_mu, smem > 0, beta, bvar, dev, iters,
                          mu, hat, w))
  } else {
    const size_t smem = row_smem_bytes<T>(S, 2);
    DK_DISPATCH_P(p, irls_kernel<T, P, false><<<G, kThreads, smem, st>>>(
                          y, nf, nf_gstride, alpha, beta0, ridge, x, S, tol,
                          maxit, min_mu, smem > 0, beta, bvar, dev, iters,
                          mu, hat, w))
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int irls_launch_f32(const float* y, const float* nf, long long nf_gstride,
                    const float* w, const float* alpha, const float* beta0,
                    const float* ridge, const float* x, int G, int S, int p,
                    float tol, int maxit, float min_mu, float* beta,
                    float* bvar, float* dev, int* iters, float* mu,
                    float* hat, void* stream) {
  return launch<float>(y, nf, nf_gstride, w, alpha, beta0, ridge, x, G, S, p,
                       tol, maxit, min_mu, beta, bvar, dev, iters, mu, hat,
                       stream);
}

int irls_launch_f64(const double* y, const double* nf, long long nf_gstride,
                    const double* w, const double* alpha, const double* beta0,
                    const double* ridge, const double* x, int G, int S, int p,
                    double tol, int maxit, double min_mu, double* beta,
                    double* bvar, double* dev, int* iters, double* mu,
                    double* hat, void* stream) {
  return launch<double>(y, nf, nf_gstride, w, alpha, beta0, ridge, x, G, S,
                        p, tol, maxit, min_mu, beta, bvar, dev, iters, mu,
                        hat, stream);
}

}  // extern "C"
