// K1: ridge NB IRLS, one warp per gene (fitBeta contract).
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
// What bounds it on the H100: the bytes it must move (y in, mu and the hat
// diagonal out, 12 bytes per sample in float32) against ~3.4 sweeps of an
// exp, two logs and two divisions per sample.  The design:
// - one warp per gene, persistent warps taking the next gene from a
//   per-launch counter; the sums reduced by a warp butterfly that leaves
//   them on every lane, and every lane runs the same ridge solve and
//   control, so the sweep loop has no barrier and no broadcast;
// - one pass over the row per sweep: the pass that computes mu and the
//   deviance at the new beta also sums X'WX and X'Wz at that mu, which are
//   the next sweep's normal equations and, after the last sweep, the
//   post-fit X'WX.  A sweep whose beta diverges keeps the old mu, whose
//   sums the warp still holds.  Passes per gene: sweeps + 2 (the first
//   adds the deviance constant, the last writes mu and the hat diagonal),
//   where the block layout made 2 sweeps + 3;
// - mu is recomputed from beta in each pass, so no mu scratch: only y
//   (and the weights, or a (G,S) factor row) is read, through L1/L2 (staged
//   per warp in shared memory they measured slower, PERF.md section 6);
// - what does not change is hoisted: lgamma(size) and size log(size) once
//   per gene; the design x, an (S,) factor row and its logs staged once
//   per block in shared memory (when they fit in kBlockStageBytes); a
//   (G,S) factor row's log is taken per sample, as the plain version does.
//   The working response keeps the plain version's log(mu) - log(nf): the
//   x'beta it equals off the min_mu clamp saves a log per sample, but its
//   other rounding moved float32 fits of ill-conditioned p = 5 and 8 genes
//   to other points of their flat valleys (PERF.md section 6).
//
// Weighted mode (UseW; pallas_irls.py:106-124, 156-169, 221-258 use_w): the
// gene's observation weights multiply W in the normal equations, every
// deviance term (the mu-independent part included, which is summed per
// sample in both modes, so nothing a weight would have to scale is
// hoisted out of the sum), the sandwich's X'WX and the hat diagonal.
//
// Designs wider than 8 columns (8 < p <= 16, irls_wide_kernel, p a launch
// argument): the same contract, one warp per gene from the same counter,
// but no lane holds the normal equations or a p x p matrix (at P = 16 the
// templated kernel used 255 registers and spilled 88,744 bytes, PERF.md
// section 6).  Each pass walks the samples in tiles of 32 (common.cuh's
// wide section): a lane computes its sample's mu, w, z and deviance terms
// and writes x_s and w x_s into the warp's tile buffers; the lanes then add
// the tile to X'WX in 4 x 4 blocks of its upper triangle they own, and to
// X'Wz at the diagonal blocks' rows; the ridge system is factored and
// solved in the warp's shared memory.
// The post-fit inverse, the sandwich and the hat diagonal follow the
// templated kernel's order of operations on the same shared matrices.
#include "common.cuh"

namespace {

using namespace dk;

// mu = max(nf exp(x'beta), min_mu)
template <typename T, int P>
__device__ __forceinline__ T mu_at(const T (&beta)[P], const T (&xs)[P],
                                   T nfs, T min_mu) {
  T xb = T(0);
#pragma unroll
  for (int k = 0; k < P; ++k) xb += beta[k] * xs[k];
  const T m = nfs * d_exp(xb);
  return m > min_mu ? m : min_mu;
}

// Add sample s's terms of X'WX (packed) and X'Wz at mu m to acc[0..NT+P);
// lm = log(mu), lnf = log(nf).
template <typename T, int P, bool UseW>
__device__ __forceinline__ void acc_normal(T* acc, T m, T lm, T lnf, T yv,
                                           T alpha, const T (&xs)[P],
                                           const T* wr, int s) {
  constexpr int NT = P * (P + 1) / 2;
  const T w = wscale<UseW>(m / (T(1) + alpha * m), wr, s);
  const T z = lm - lnf + (yv - m) / m;
  acc_outer<T, P>(acc, w, xs);
  const T wz = w * z;
#pragma unroll
  for (int i = 0; i < P; ++i) acc[NT + i] += wz * xs[i];
}

template <typename T, int P, bool UseW>
__global__ void __launch_bounds__(kWarpBlock)
    irls_kernel(const T* __restrict__ y, const T* __restrict__ nf,
                long long nf_gstride, const T* __restrict__ wts,
                const T* __restrict__ alpha_in, const T* __restrict__ beta0,
                const T* __restrict__ ridge, const T* __restrict__ x, int G,
                int S, T tol, int maxit, T min_mu, int stage_block,
                T* __restrict__ beta_out,
                T* __restrict__ bvar_out, T* __restrict__ dev_out,
                int* __restrict__ iter_out, T* __restrict__ mu_out,
                T* __restrict__ hat_out, int* __restrict__ counter) {
  constexpr int NT = P * (P + 1) / 2;
  constexpr int NA = NT + P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the block's staged design and, for an (S,) factor row, the factors
  // and their logs
  const bool shared_nf = nf_gstride == 0;
  const T* xr = x;
  const T* nf_shared = nf;
  const T* lnf_shared = nullptr;
  if (stage_block) {
    T* sx = reinterpret_cast<T*>(smem_raw);
    block_stage(sx, x, S * P);
    xr = sx;
    if (shared_nf) {
      T* snf = sx + (size_t)S * P;
      for (int i = threadIdx.x; i < S; i += blockDim.x) {
        const T v = __ldg(nf + i);
        snf[i] = v;
        snf[S + i] = d_log(v);
      }
      nf_shared = snf;
      lnf_shared = snf + S;
    }
    __syncthreads();
  }
  T rdg[P];
#pragma unroll
  for (int k = 0; k < P; ++k) rdg[k] = __ldg(ridge + k);
  const T eps = Eps<T>::value;
  const T tol_eff = tol > T(30) * eps ? tol : T(30) * eps;

  for (;;) {
    const int g = next_gene(counter);
    if (g >= G) break;
    const T* yr = y + (size_t)g * S;
    const T* nfr = shared_nf ? nf_shared : nf + (size_t)g * nf_gstride;
    const T* wr = UseW ? wts + (size_t)g * S : nullptr;
    const T alpha = alpha_in[g];
    const T size = T(1) / alpha;
    const T lgs = d_lgamma(size);
    const T sls = size * d_log(size);

    // beta: mu's coefficients; bret: the returned ones (they differ only
    // after a diverged sweep, which keeps the old mu)
    T beta[P], bret[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      beta[k] = beta0[(size_t)g * P + k];
      bret[k] = beta[k];
    }

    // first pass: the mu-independent deviance constant (acc[NA]) and the
    // normal equations at the initial mu
    T acc[NA + 1];
#pragma unroll
    for (int i = 0; i <= NA; ++i) acc[i] = T(0);
    for (int s = lane_id(); s < S; s += 32) {
      T xs[P];
      x_row<T, P>(xr, s, xs);
      const T nfs = nfr[s];
      const T m = mu_at<T, P>(beta, xs, nfs, min_mu);
      const T yv = yr[s];
      acc[NA] += wscale<UseW>(
          d_lgamma(yv + size) - lgs - d_lgamma(yv + T(1)) + sls, wr, s);
      acc_normal<T, P, UseW>(acc, m, d_log(m),
                             lnf_shared ? lnf_shared[s] : d_log(nfs), yv,
                             alpha, xs, wr, s);
    }
    warp_allsum<T, NA + 1>(acc);
    const T dev_const = T(-2) * acc[NA];

    // control state: the same values on every lane
    T dev_old = T(0), dev = T(0);
    int iters = 0;
    for (int t = 0; t < maxit; ++t) {
      ++iters;
      T a[P][P], L[P][P], rhs[P], bn[P];
      unpack_sym<T, P>(acc, a);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        a[k][k] += rdg[k];
        rhs[k] = acc[NT + k];
      }
      cholesky<T, P>(a, L);
      chol_solve<T, P>(L, rhs, bn);
      bool diverged = false;
#pragma unroll
      for (int k = 0; k < P; ++k) diverged |= d_abs(bn[k]) > T(30);
      if (diverged) {
        // mu (and so acc) stays at the old beta
#pragma unroll
        for (int k = 0; k < P; ++k) bret[k] = bn[k];
        iters = maxit;
        break;
      }

      // one pass at the new beta: mu, the deviance (acc[NA]) and the
      // normal equations at that mu
#pragma unroll
      for (int i = 0; i <= NA; ++i) acc[i] = T(0);
      for (int s = lane_id(); s < S; s += 32) {
        T xs[P];
        x_row<T, P>(xr, s, xs);
        const T nfs = nfr[s];
        const T m = mu_at<T, P>(bn, xs, nfs, min_mu);
        const T yv = yr[s];
        const T lm = d_log(m);
        const T lsm = d_log(size + m);
        const T tt = yv > T(0) ? yv * (lm - lsm) : T(0);
        acc[NA] += wscale<UseW>(-size * lsm + tt, wr, s);
        acc_normal<T, P, UseW>(acc, m, lm,
                               lnf_shared ? lnf_shared[s] : d_log(nfs), yv,
                               alpha, xs, wr, s);
      }
      warp_allsum<T, NA + 1>(acc);
      const T dev_new = dev_const + T(-2) * acc[NA];
      dev = dev_new;
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
      if (bad) iters = maxit;
      dev_old = dev_new;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        beta[k] = bn[k];
        bret[k] = bn[k];
      }
      if (bad || converged) break;
    }

    // post-fit: the sandwich from X'WX at the final mu (acc[0..NT))
    T xtwx[P][P], a[P][P], L[P][P], ainv[P][P];
    unpack_sym<T, P>(acc, xtwx);
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
      for (int j = 0; j < P; ++j) a[i][j] = xtwx[i][j];
      a[i][i] += rdg[i];
    }
    cholesky<T, P>(a, L);
    chol_inverse<T, P>(L, ainv);
    if (lane_id() == 0) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        T sv = T(0);
#pragma unroll
        for (int m = 0; m < P; ++m) {
          T r = T(0);
#pragma unroll
          for (int n = 0; n < P; ++n) r += xtwx[m][n] * ainv[n][k];
          sv += ainv[k][m] * r;
        }
        bvar_out[(size_t)g * P + k] = sv;
        beta_out[(size_t)g * P + k] = bret[k];
      }
      dev_out[g] = dev;
      iter_out[g] = iters;
    }
    // last pass: the final mu and the hat diagonal
    T* mu_g = mu_out + (size_t)g * S;
    T* hat_g = hat_out + (size_t)g * S;
    for (int s = lane_id(); s < S; s += 32) {
      T xs[P];
      x_row<T, P>(xr, s, xs);
      const T m = mu_at<T, P>(beta, xs, nfr[s], min_mu);
      T q = T(0);
#pragma unroll
      for (int i = 0; i < P; ++i) {
#pragma unroll
        for (int j = 0; j < P; ++j) q += ainv[i][j] * (xs[i] * xs[j]);
      }
      hat_g[s] = wscale<UseW>(m / (T(1) + alpha * m), wr, s) * q;
      mu_g[s] = m;
    }
  }
}

template <typename T, int P, bool UseW>
int launch_p(const T* y, const T* nf, long long nf_gstride, const T* w,
             const T* alpha, const T* beta0, const T* ridge, const T* x, int G,
             int S, T tol, int maxit, T min_mu, T* beta, T* bvar, T* dev,
             int* iters, T* mu, T* hat, int* counter, cudaStream_t st) {
  const size_t smem = block_stage_bytes<T>(S, P + (nf_gstride == 0 ? 2 : 0));
  auto kernel = irls_kernel<T, P, UseW>;
  int err = 0;
  const int blocks = persistent_blocks(kernel, smem, G, &err);
  if (err) return err;
  kernel<<<blocks, kWarpBlock, smem, st>>>(
      y, nf, nf_gstride, w, alpha, beta0, ridge, x, G, S, tol, maxit, min_mu,
      smem > 0, beta, bvar, dev, iters, mu, hat, counter);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 8 < p <= kPWide
// ---------------------------------------------------------------------------

// shared values per warp: the tile buffers of x and w x, the tile's w z,
// and the coefficients mu is computed at.  Between passes the ridge
// system's matrix takes the x buffer's room; after the last sweep the
// post-fit matrices take both buffers'.
constexpr int kWideWarpVals = 2 * kTileVals + kTileStride + kPWide;

// One pass over a gene's samples (x the design transposed, p x S) at the
// coefficients sb: X'WX (gb, the lane's block) and X'Wz (rz, a diagonal
// block's rows) at that mu, reduced into group 0's lanes (gram_map), and
// the warp's total of the deviance terms on every lane: with First the
// mu-independent part (the deviance constant), else the part that depends
// on mu.
template <typename T, bool UseW, bool First>
__device__ __forceinline__ T wide_pass(const GramMap& gm, const T* yr,
                                       const T* nfr, const T* lnf_shared,
                                       const T* wr, const T* x, int S, int p,
                                       T alpha, T size, T lgs, T sls,
                                       T min_mu, const T* sb, T* xb, T* ub,
                                       T* zb, GramBlock<T>& gb, T (&rz)[4]) {
  const int lane = lane_id();
  GramBlock<T> unused;
  gram_zero(gb);
#pragma unroll
  for (int j = 0; j < 4; ++j) rz[j] = T(0);
  T dev[1] = {T(0)};
  __syncwarp();
  for (int base = 0; base < S; base += kTile) {
    const int s = base + lane;
    const int n = S - base < kTile ? S - base : kTile;
    if (s < S) {
      T eta = T(0);
      for (int k = 0; k < p; ++k) {
        const T v = __ldg(x + (size_t)k * S + s);
        xb[k * kTileStride + lane] = v;
        eta += sb[k] * v;
      }
      const T nfs = nfr[s];
      const T mm = nfs * d_exp(eta);
      const T m = mm > min_mu ? mm : min_mu;
      const T yv = yr[s];
      const T lm = d_log(m);
      if constexpr (First) {
        dev[0] += wscale<UseW>(
            d_lgamma(yv + size) - lgs - d_lgamma(yv + T(1)) + sls, wr, s);
      } else {
        const T lsm = d_log(size + m);
        const T tt = yv > T(0) ? yv * (lm - lsm) : T(0);
        dev[0] += wscale<UseW>(-size * lsm + tt, wr, s);
      }
      const T w = wscale<UseW>(m / (T(1) + alpha * m), wr, s);
      const T z = lm - (lnf_shared ? lnf_shared[s] : d_log(nfs)) +
                  (yv - m) / m;
      for (int k = 0; k < p; ++k)
        ub[k * kTileStride + lane] = w * xb[k * kTileStride + lane];
      zb[lane] = w * z;
    }
    __syncwarp();
    gram_add<T, false, true>(gm, gb, unused, rz, ub, xb, zb, n);
    __syncwarp();
  }
  warp_allsum<T, 1>(dev);
  // the tile buffers are the reductions' scratch
  gram_reduce(gm, gb, xb);
  gram_reduce<T, 4>(gm, rz, ub);
  return dev[0];
}

// X'Wz (group 0's diagonal blocks' rz) onto lane k < p, through the
// warp's shared vector `vec`.
template <typename T>
__device__ __forceinline__ T wide_rhs(const GramMap& gm, const T (&rz)[4],
                                      T* vec, int p) {
  if (gm.grp == 0 && gm.diag) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (gm.r0 + j < p) vec[gm.r0 + j] = rz[j];
    }
  }
  __syncwarp();
  const T r = lane_id() < p ? vec[lane_id()] : T(0);
  __syncwarp();
  return r;
}

// x: the design transposed (p x S, common.cuh's wide section)
template <typename T, bool UseW>
__global__ void __launch_bounds__(kWarpBlock)
    irls_wide_kernel(const T* __restrict__ y, const T* __restrict__ nf,
                     long long nf_gstride, const T* __restrict__ wts,
                     const T* __restrict__ alpha_in,
                     const T* __restrict__ beta0, const T* __restrict__ ridge,
                     const T* __restrict__ x, int G, int S, int p, T tol,
                     int maxit, T min_mu, int stage_nf,
                     T* __restrict__ beta_out, T* __restrict__ bvar_out,
                     T* __restrict__ dev_out, int* __restrict__ iter_out,
                     T* __restrict__ mu_out, T* __restrict__ hat_out,
                     int* __restrict__ counter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  // an (S,) factor row and its logs, staged for the block
  const bool shared_nf = nf_gstride == 0;
  const T* nf_shared = nf;
  const T* lnf_shared = nullptr;
  if (stage_nf) {
    for (int i = threadIdx.x; i < S; i += blockDim.x) {
      const T v = __ldg(nf + i);
      sm[i] = v;
      sm[S + i] = d_log(v);
    }
    nf_shared = sm;
    lnf_shared = sm + S;
    __syncthreads();
  }
  T* wv = sm + (stage_nf ? 2 * (size_t)S : 0) +
          (size_t)(threadIdx.x >> 5) * kWideWarpVals;
  T* xb = wv;
  T* ub = wv + kTileVals;
  T* zb = wv + 2 * kTileVals;
  T* sb = zb + kTileStride;
  T* amat = wv;               // the ridge system, then its inverse
  T* gmat = wv + kMat;        // the post-fit X'WX
  T* li = wv + kTileVals;     // the post-fit factor's inverse
  const int lane = lane_id();
  const GramMap gm = gram_map(p);
  const T eps = Eps<T>::value;
  const T tol_eff = tol > T(30) * eps ? tol : T(30) * eps;

  for (;;) {
    const int g = next_gene(counter);
    if (g >= G) break;
    const T* yr = y + (size_t)g * S;
    const T* nfr = shared_nf ? nf_shared : nf + (size_t)g * nf_gstride;
    const T* lnfr = shared_nf ? lnf_shared : nullptr;
    const T* wr = UseW ? wts + (size_t)g * S : nullptr;
    const T alpha = alpha_in[g];
    const T size = T(1) / alpha;
    const T lgs = d_lgamma(size);
    const T sls = size * d_log(size);

    // lane k < p holds coefficient k of mu's beta (bk) and of the returned
    // one (bret; they differ only after a diverged sweep, which keeps the
    // old mu); sb holds mu's for the passes
    T bk = lane < p ? beta0[(size_t)g * p + lane] : T(0);
    T bret = bk;
    __syncwarp();
    if (lane < p) sb[lane] = bk;
    __syncwarp();

    GramBlock<T> gb;
    T rz[4];
    const T dev_const =
        T(-2) * wide_pass<T, UseW, true>(gm, yr, nfr, lnfr, wr, x, S, p,
                                         alpha, size, lgs, sls, min_mu, sb,
                                         xb, ub, zb, gb, rz);

    // control state: the same values on every lane
    T dev_old = T(0), dev = T(0);
    int iters = 0;
    for (int t = 0; t < maxit; ++t) {
      ++iters;
      gram_store(gm, gb, amat, p, ~0u, false, ridge);
      const T r = wide_rhs(gm, rz, zb, p);
      warp_cholesky<T, false>(amat, p);
      const T bn = warp_chol_solve(amat, p, r);
      if (__any_sync(kFullMask, lane < p && d_abs(bn) > T(30))) {
        // mu (and so gb, rz) stays at the old beta
        bret = bn;
        iters = maxit;
        break;
      }
      T dbeta = T(0), bmax = T(0);
      if (is_f32<T>()) {
        dbeta = warp_max(lane < p ? d_abs(bn - bk) : T(0));
        bmax = warp_max(lane < p ? d_abs(bn) : T(0));
      }
      __syncwarp();
      if (lane < p) sb[lane] = bn;
      __syncwarp();
      const T dev_new =
          dev_const + T(-2) * wide_pass<T, UseW, false>(
                                  gm, yr, nfr, lnfr, wr, x, S, p, alpha,
                                  size, lgs, sls, min_mu, sb, xb, ub, zb, gb,
                                  rz);
      dev = dev_new;
      const T conv_test = d_abs(dev_new - dev_old) / (d_abs(dev_new) + T(0.1));
      const bool bad = isnan(conv_test);
      bool converged = t > 0 && conv_test < tol_eff;
      if (is_f32<T>()) converged |= t > 0 && dbeta < T(32) * eps * (T(1) + bmax);
      if (bad) iters = maxit;
      dev_old = dev_new;
      bk = bn;
      bret = bn;
      if (bad || converged) break;
    }

    // post-fit: the sandwich from X'WX at the final mu
    __syncwarp();
    gram_store(gm, gb, gmat, p, ~0u, false, static_cast<const T*>(nullptr));
    gram_store(gm, gb, amat, p, ~0u, false, ridge);
    warp_cholesky<T, false>(amat, p);
    warp_chol_inverse(amat, li, amat, p);
    if (lane < p) {
      // ainv is symmetric: column `lane` read as its row
      T sv = T(0);
      for (int m = 0; m < p; ++m) {
        T r = T(0);
        for (int n = 0; n < p; ++n)
          r += gmat[m * kPWide + n] * amat[n * kPWide + lane];
        sv += amat[m * kPWide + lane] * r;
      }
      bvar_out[(size_t)g * p + lane] = sv;
      beta_out[(size_t)g * p + lane] = bret;
    }
    if (lane == 0) {
      dev_out[g] = dev;
      iter_out[g] = iters;
    }
    // last pass: the final mu and the hat diagonal
    T* mu_g = mu_out + (size_t)g * S;
    T* hat_g = hat_out + (size_t)g * S;
    for (int s = lane; s < S; s += 32) {
      T xv[kPWide];
      T eta = T(0);
#pragma unroll
      for (int k = 0; k < kPWide; ++k) {
        xv[k] = k < p ? __ldg(x + (size_t)k * S + s) : T(0);
        if (k < p) eta += sb[k] * xv[k];
      }
      const T mm = nfr[s] * d_exp(eta);
      const T m = mm > min_mu ? mm : min_mu;
      T q = T(0);
#pragma unroll
      for (int i = 0; i < kPWide; ++i) {
        if (i < p) {
#pragma unroll
          for (int j = 0; j < kPWide; ++j) {
            if (j < p) q += amat[i * kPWide + j] * (xv[i] * xv[j]);
          }
        }
      }
      hat_g[s] = wscale<UseW>(m / (T(1) + alpha * m), wr, s) * q;
      mu_g[s] = m;
    }
  }
}

// dynamic shared memory of a wide launch: the staged factor row and its
// logs (when they fit in kBlockStageBytes) and the warps' values
template <typename T>
inline size_t wide_smem(int S, bool shared_nf, bool* stage_nf) {
  const size_t nfb = shared_nf ? block_stage_bytes<T>(S, 2) : 0;
  *stage_nf = nfb > 0;
  return nfb + (size_t)kBlockWarps * kWideWarpVals * sizeof(T);
}

template <typename T, bool UseW>
int launch_wide(const T* y, const T* nf, long long nf_gstride, const T* w,
                const T* alpha, const T* beta0, const T* ridge, const T* x,
                int G, int S, int p, T tol, int maxit, T min_mu, T* beta,
                T* bvar, T* dev, int* iters, T* mu, T* hat, int* counter,
                cudaStream_t st) {
  bool stage_nf = false;
  const size_t smem = wide_smem<T>(S, nf_gstride == 0, &stage_nf);
  auto kernel = irls_wide_kernel<T, UseW>;
  int err = allow_smem(kernel, smem);
  if (err) return err;
  const int blocks = persistent_blocks(kernel, smem, G, &err);
  if (err) return err;
  kernel<<<blocks, kWarpBlock, smem, st>>>(
      y, nf, nf_gstride, w, alpha, beta0, ridge, x, G, S, p, tol, maxit,
      min_mu, stage_nf, beta, bvar, dev, iters, mu, hat, counter);
  return (int)cudaGetLastError();
}

template <typename T, bool UseW>
int occupancy_wide(int S, int shared_nf) {
  bool stage_nf = false;
  const size_t smem = wide_smem<T>(S, shared_nf != 0, &stage_nf);
  auto kernel = irls_wide_kernel<T, UseW>;
  int err = allow_smem(kernel, smem);
  const int n = err ? 0 : blocks_per_sm(kernel, smem, &err);
  return err ? -1 : n;
}

// w == nullptr selects the unweighted instantiations, 8 < p <= 16 the wide
// kernel; `counter` is one zeroed int of device memory (the warps' gene
// counter)
template <typename T>
int launch(const T* y, const T* nf, long long nf_gstride, const T* w,
           const T* alpha, const T* beta0, const T* ridge, const T* x, int G,
           int S, int p, T tol, int maxit, T min_mu, T* beta, T* bvar, T* dev,
           int* iters, T* mu, T* hat, int* counter, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p > kPNarrow && p <= kPWide) {
    return w != nullptr
               ? launch_wide<T, true>(y, nf, nf_gstride, w, alpha, beta0,
                                      ridge, x, G, S, p, tol, maxit, min_mu,
                                      beta, bvar, dev, iters, mu, hat,
                                      counter, st)
               : launch_wide<T, false>(y, nf, nf_gstride, w, alpha, beta0,
                                       ridge, x, G, S, p, tol, maxit, min_mu,
                                       beta, bvar, dev, iters, mu, hat,
                                       counter, st);
  }
  if (w != nullptr) {
    DK_DISPATCH_P(p, return launch_p<T, P, true>(
                         y, nf, nf_gstride, w, alpha, beta0, ridge, x, G, S,
                         tol, maxit, min_mu, beta, bvar, dev, iters, mu, hat,
                         counter, st))
  } else {
    DK_DISPATCH_P(p, return launch_p<T, P, false>(
                         y, nf, nf_gstride, w, alpha, beta0, ridge, x, G, S,
                         tol, maxit, min_mu, beta, bvar, dev, iters, mu, hat,
                         counter, st))
  }
  return (int)cudaErrorInvalidValue;
}

// resident blocks per SM of the kernel a launch would take (-1 on a
// refusal or an unsupported p)
template <typename T, bool UseW>
int occupancy(int p, int S, int shared_nf) {
  if (p > kPNarrow && p <= kPWide) return occupancy_wide<T, UseW>(S, shared_nf);
  int err = 0;
  DK_DISPATCH_P(p, {
    const int n = blocks_per_sm(
        irls_kernel<T, P, UseW>,
        block_stage_bytes<T>(S, P + (shared_nf ? 2 : 0)), &err);
    return err ? -1 : n;
  })
  return -1;
}

}  // namespace

extern "C" {

int irls_blocks_per_sm(int f64, int weighted, int p, int S, int shared_nf) {
  if (f64) {
    return weighted ? occupancy<double, true>(p, S, shared_nf)
                    : occupancy<double, false>(p, S, shared_nf);
  }
  return weighted ? occupancy<float, true>(p, S, shared_nf)
                  : occupancy<float, false>(p, S, shared_nf);
}

int irls_launch_f32(const float* y, const float* nf, long long nf_gstride,
                    const float* w, const float* alpha, const float* beta0,
                    const float* ridge, const float* x, int G, int S, int p,
                    float tol, int maxit, float min_mu, float* beta,
                    float* bvar, float* dev, int* iters, float* mu,
                    float* hat, int* counter, void* stream) {
  return launch<float>(y, nf, nf_gstride, w, alpha, beta0, ridge, x, G, S, p,
                       tol, maxit, min_mu, beta, bvar, dev, iters, mu, hat,
                       counter, stream);
}

int irls_launch_f64(const double* y, const double* nf, long long nf_gstride,
                    const double* w, const double* alpha, const double* beta0,
                    const double* ridge, const double* x, int G, int S, int p,
                    double tol, int maxit, double min_mu, double* beta,
                    double* bvar, double* dev, int* iters, double* mu,
                    double* hat, int* counter, void* stream) {
  return launch<double>(y, nf, nf_gstride, w, alpha, beta0, ridge, x, G, S,
                        p, tol, maxit, min_mu, beta, bvar, dev, iters, mu, hat,
                        counter, stream);
}

}  // extern "C"
