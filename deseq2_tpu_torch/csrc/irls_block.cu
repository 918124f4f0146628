// K1 for designs of kPWide < p <= kPBlock columns (16 < p <= 64): ridge
// NB IRLS with a thread block per gene (fitBeta contract, irls.cu's).
//
// Replaces the TPU kernel deseq2_tpu/ops/pallas_irls.py:fit_beta_pallas
// (_irls_kernel) past 16 columns, where the JAX package runs its XLA core
// (pallas_irls.py:266-284, the `p > 8` gate).  The contract, the clamps,
// the stopping rules (the float32-only exit on a beta that stops moving
// included), the |beta| > 30 guard, the weighted mode, minmu and the (S,)
// or (G,S) factors are irls_wide_kernel's (irls.cu), and so is the order
// of every step: one pass over the gene's samples per sweep sums the
// deviance and the next sweep's X'WX and X'Wz at the new mu, the post-fit
// inverse, the sandwich and the hat diagonal follow.
//
// What bounds it on the H100: past 16 columns, the gram.  A pass costs
// p (p + 1) / 2 multiply-adds a sample (2,080 at p = 64) against the
// per-sample exp, logs and divisions (~60 operations); bytes are y in and
// mu and the hat diagonal out, as at any p.  The design (common.cuh's
// block section): persistent blocks of 256 threads, each taking its next
// gene from the launch's counter (one atomic per gene); a pass walks the
// samples in tiles of up to 256 (one sample a thread), writing x_s and
// w x_s into the block's tile buffers, and the threads own the gram's
// 4 x 4 upper blocks (at p = 64 one a thread for 136 of the 256, at fewer
// columns in groups over the tile's samples), reduced in group order; the
// ridge system is factored, solved and inverted in the block's shared
// memory.  Every entry is summed in one fixed order: two launches give the
// same bits, and a gene's result does not depend on its neighbours.  In
// float32 the gram's multiply-adds are plain FMA instructions.  In float64
// (irls_block_mma) they run on the FP64 tensor cores (common.cuh's float64
// gram section): X'WX and X'Wz (the gram's column p, z being the design
// tile's row p) in the warps' mma.sync runs, and the hat diagonal as Y =
// U' X per 8 samples (U: the inverse's upper triangle, its fragments held
// in registers) dotted with X; the design tiles come in by cp.async.
#include "common.cuh"

namespace {

using namespace dk;

// the block kernel's p x p matrices: the ridge system (then its factor and
// inverse) and the post-fit factor's inverse (then the post-fit X'WX)
constexpr int kBlockMats = 2;

// One pass over a gene's samples at the coefficients sb (wide_pass over
// the block): X'WX (gb) and X'Wz (rz) at that mu reduced into group 0's
// threads, and the deviance terms' total on every thread.
template <typename T, bool UseW, bool First>
__device__ __forceinline__ T block_pass(const GramMap& gm, const T* yr,
                                        const T* nfr, const T* wr,
                                        const T* x, int S,
                                        const BlockLayout& lay, T alpha,
                                        T size, T lgs, T sls, T min_mu,
                                        const T* sb, T* tile, T* red,
                                        GramBlock<T>& gb, T (&rz)[4]) {
  const int t = threadIdx.x;
  const int p = lay.p, tw = lay.tw, ts = lay.ts;
  T* xb = tile;
  T* ub = tile + (size_t)lay.pr * ts;
  T* zb = ub + (size_t)lay.pr * ts;
  GramBlock<T> unused;
  gram_zero(gb);
#pragma unroll
  for (int j = 0; j < 4; ++j) rz[j] = T(0);
  T dev[1] = {T(0)};
  for (int base = 0; base < S; base += tw) {
    const int s = base + t;
    const int n = S - base < tw ? S - base : tw;
    __syncthreads();
    if (t < tw && s < S) {
      T eta = T(0);
      for (int k = 0; k < p; ++k) {
        const T v = __ldg(x + (size_t)k * S + s);
        xb[k * ts + t] = v;
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
      const T z = lm - d_log(nfs) + (yv - m) / m;
      for (int k = 0; k < p; ++k) ub[k * ts + t] = w * xb[k * ts + t];
      zb[t] = w * z;
    }
    __syncthreads();
    block_gram_add<T, false, true>(gm, gb, unused, rz, ub, xb, zb, ts, n);
  }
  block_allsum<T, 1>(dev, red);
  // the tile buffers are the reductions' scratch
  block_gram_reduce(gm, gb, tile);
  block_gram_reduce<T, 4>(gm, rz, tile);
  return dev[0];
}

// X'Wz (group 0's diagonal blocks' rz) into the shared vector vec (p
// values).  Ends with a __syncthreads.
template <typename T>
__device__ __forceinline__ void block_rhs(const GramMap& gm, const T (&rz)[4],
                                          T* vec, int p) {
  if (gm.grp == 0 && gm.diag) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (gm.r0 + j < p) vec[gm.r0 + j] = rz[j];
    }
  }
  __syncthreads();
}

// --- float64: the tensor-core path (common.cuh's float64 gram section) ---

// the float64 layout: one p x p matrix (the ridge system, its factor, its
// inverse); the tile buffer holds the design's rows with z's column (p + 1
// columns: X'Wz is the gram's column p), then kBlockWarpsN rows (the
// weights in the sweeps, the warps' partial hat sums in the last pass),
// and after the fit the second matrix (the factor's inverse, then X'WX)
// until the last pass
__host__ __device__ inline BlockLayout irls_mma_layout(int p, int tw) {
  return block_mma_layout(p, tw, 1, (p + 8) >> 3, kBlockWarpsN, p * p);
}

// block_pass in float64: first every sample's terms, each thread some
// samples (x'beta from the design in global memory), the deviance terms
// summed and each sample's weight and working response written to wg and
// zg (the gene's rows of the hat-diagonal and mu outputs, its scratch
// until the last pass); then the tiles (gram_mma_pass): X'WX and X'Wz
// into the warp's run (acc).  So no gram accumulator is live while the
// special functions run.  Returns the deviance terms' total on every
// thread.
template <bool UseW, bool First>
__device__ __forceinline__ double block_pass_mma(
    const MmaRun<kMmaRunK1>& run, const double* yr, const double* nfr,
    const double* wr, const double* x, int S, const BlockLayout& lay,
    double alpha, double size, double lgs, double sls, double min_mu,
    const double* sb, double* tile, double* red, double* wg, double* zg,
    double (&acc)[kMmaRunK1][2]) {
  using T = double;
  const int p = lay.p;
  T dev[1] = {T(0)};
  for (int s = threadIdx.x; s < S; s += kBlockThreads) {
    T eta = T(0);
    for (int k = 0; k < p; ++k) eta += sb[k] * __ldg(x + (size_t)k * S + s);
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
    wg[s] = wscale<UseW>(m / (T(1) + alpha * m), wr, s);
    zg[s] = lm - d_log(nfs) + (yv - m) / m;
  }
  block_allsum<T, 1>(dev, red);
  gram_mma_pass<kMmaRunK1, false>(run, acc, tile, lay, x, S, wg, zg);
  return dev[0];
}

// The hat diagonal in float64: h_s = w_s x_s' A^-1 x_s = 2 w_s x_s' U x_s,
// U = A^-1's upper triangle with its diagonal halved.  Its units are
// (column tile jt of U, k-step kt of U's rows: kt <= 2 jt + 1, 4 kt < p),
// jt-major, cut into kBlockWarpsN runs; a warp keeps its units' U
// fragments in registers for the gene.  kHatRun: 72 units at p = 64.
constexpr int kHatRun = 9;

struct HatRun {
  int jt0, kt0, n;
  double u[kHatRun];
};

__device__ __forceinline__ int hat_kmax(int jt, int nk) {
  return 2 * jt + 1 < nk - 1 ? 2 * jt + 1 : nk - 1;
}

__device__ __forceinline__ HatRun hat_run(int p) {
  HatRun h;
  const int nt = (p + 7) >> 3, nk = (p + 3) >> 2;
  int total = 0;
  for (int jt = 0; jt < nt; ++jt) total += hat_kmax(jt, nk) + 1;
  const int w = threadIdx.x >> 5;
  const int per = total / kBlockWarpsN, more = total % kBlockWarpsN;
  const int start = w * per + (w < more ? w : more);
  h.n = per + (w < more ? 1 : 0);
  int jt = 0, kt = 0;
  for (int k = 0; k < start; ++k) {
    if (++kt > hat_kmax(jt, nk)) {
      ++jt;
      kt = 0;
    }
  }
  h.jt0 = jt;
  h.kt0 = kt;
  return h;
}

// The run's U fragments from A^-1 (row stride p): lane l holds U[4 kt +
// l % 4][8 jt + l / 4] (as the A operand of Y = U' X).
__device__ __forceinline__ void hat_load(HatRun& h, const double* ainv,
                                         int p) {
  const int lane = lane_id(), nk = (p + 3) >> 2;
  int jt = h.jt0, kt = h.kt0;
#pragma unroll
  for (int q = 0; q < kHatRun; ++q) {
    const int i = 4 * kt + (lane & 3), j = 8 * jt + (lane >> 2);
    double v = 0.0;
    if (q < h.n && i <= j && j < p)
      v = i < j ? ainv[i * p + j] : 0.5 * ainv[i * p + i];
    h.u[q] = v;
    if (++kt > hat_kmax(jt, nk)) {
      ++jt;
      kt = 0;
    }
  }
}

// x_s' U x_s over the warp's units for the tile's first n samples (xb: the
// design rows, zero past p and past n up to tw): per 8 samples, Y = U' X
// on the tensor cores, each column tile's Y dotted with x's rows into the
// lane's sums, which the 8 lanes of a sample pair add by butterfly; the
// warp writes them to its row of qb (stride ts).
__device__ __forceinline__ void hat_mma(const HatRun& h, const double* xb,
                                        double* qb, int p, int ts, int n) {
  const int lane = lane_id(), r = lane >> 2, c = lane & 3;
  const int nk = (p + 3) >> 2;
  double* qw = qb + (threadIdx.x >> 5) * ts;
  // two blocks of 8 samples at a time: two independent products a unit
  for (int s0 = 0; s0 < n; s0 += 16) {
    double y[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
    double part[2][2] = {{0.0, 0.0}, {0.0, 0.0}};
    int jt = h.jt0, kt = h.kt0;
#pragma unroll
    for (int q = 0; q < kHatRun; ++q) {
      if (q < h.n) {
        const double* xr = xb + (4 * kt + c) * ts + s0 + r;
        mma_f64(y[0], h.u[q], xr[0]);
        mma_f64(y[1], h.u[q], xr[8]);
        const bool last = kt == hat_kmax(jt, nk);
        if (last || q == h.n - 1) {
          const double* xd = xb + (8 * jt + r) * ts + s0 + 2 * c;
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            part[b][0] += y[b][0] * xd[8 * b];
            part[b][1] += y[b][1] * xd[8 * b + 1];
            y[b][0] = y[b][1] = 0.0;
          }
        }
        if (last) {
          ++jt;
          kt = 0;
        } else {
          ++kt;
        }
      }
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        part[b][0] += __shfl_xor_sync(kFullMask, part[b][0], o);
        part[b][1] += __shfl_xor_sync(kFullMask, part[b][1], o);
      }
    }
    if (r == 0) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        qw[s0 + 8 * b + 2 * c] = part[b][0];
        qw[s0 + 8 * b + 2 * c + 1] = part[b][1];
      }
    }
  }
}

// irls_block_kernel in float64: X'WX, X'Wz and the hat diagonal on the
// tensor cores; the factor by block_cholesky_rows (block_cholesky's bits)
// and the solve by block_chol_solve_rows; the sweeps' control, the inverse
// and the sandwich are irls_block_kernel's (without its float32-only
// exit)
template <bool UseW>
__device__ __forceinline__ void irls_block_mma(
    double* sm, const double* y, const double* nf, long long nf_gstride,
    const double* wts, const double* alpha_in, const double* beta0,
    const double* ridge, const double* x, int G, int S, int p, int tw,
    double tol, int maxit, double min_mu, double* beta_out,
    double* bvar_out, double* dev_out, int* iter_out, double* mu_out,
    double* hat_out, int* counter) {
  using T = double;
  const BlockLayout lay = irls_mma_layout(p, tw);
  const int ts = lay.ts;
  T* amat = sm;                 // the ridge system, its factor, its inverse
  T* vec = sm + lay.mat;
  T* sb = vec;                  // mu's coefficients
  T* rhs = vec + kPBlock;       // X'Wz, then the new coefficients
  T* red = vec + kBlockRed;     // block sums' scratch
  int* slot = reinterpret_cast<int*>(vec + kBlockSlots);
  T* tile = vec + lay.vec;
  T* m2 = tile;                 // after the fit: the factor's inverse, X'WX
  T* qb = tile + (size_t)lay.pr * ts;
  const int t = threadIdx.x;
  const T tol_eff = tol > T(30) * Eps<T>::value ? tol : T(30) * Eps<T>::value;
  const bool shared_nf = nf_gstride == 0;

  for (;;) {
    const int g = block_next_gene(counter, slot);
    if (g >= G) break;
    const T* yr = y + (size_t)g * S;
    const T* nfr = shared_nf ? nf : nf + (size_t)g * nf_gstride;
    const T* wr = UseW ? wts + (size_t)g * S : nullptr;
    const T alpha = alpha_in[g];
    const T size = T(1) / alpha;
    const T lgs = d_lgamma(size);
    const T sls = size * d_log(size);

    T bk = t < p ? beta0[(size_t)g * p + t] : T(0);
    T bret = bk;
    if (t < p) sb[t] = bk;
    __syncthreads();

    // the warp's gram run and, after the fit, its hat units (set per gene
    // so that neither holds registers through the other's phase)
    const MmaRun<kMmaRunK1> run =
        mma_run<kMmaRunK1>((p + 7) >> 3, lay.pr >> 3, ts);
    T acc[kMmaRunK1][2];
    // the gene's mu and hat-diagonal rows: the passes' scratch (z, w)
    T* mu_g = mu_out + (size_t)g * S;
    T* hat_g = hat_out + (size_t)g * S;
    const T dev_const =
        T(-2) * block_pass_mma<UseW, true>(run, yr, nfr, wr, x, S, lay, alpha,
                                           size, lgs, sls, min_mu, sb, tile,
                                           red, hat_g, mu_g, acc);
    T dev_old = T(0), dev = T(0);
    int iters = 0;
    for (int it = 0; it < maxit; ++it) {
      ++iters;
      gram_mma_store(run, acc, false, amat, p, ~0ull, false,
                                      ridge, rhs);
      block_cholesky_rows(amat, p, tile);
      block_chol_solve_rows(amat, p, rhs);
      const T bn = t < p ? rhs[t] : T(0);
      const bool diverged = __syncthreads_or(t < p && d_abs(bn) > T(30));
      if (diverged) {
        bret = bn;
        iters = maxit;
        break;
      }
      if (t < p) sb[t] = bn;
      __syncthreads();
      const T dev_new =
          dev_const + T(-2) * block_pass_mma<UseW, false>(
                                  run, yr, nfr, wr, x, S, lay, alpha, size,
                                  lgs, sls, min_mu, sb, tile, red, hat_g,
                                  mu_g, acc);
      dev = dev_new;
      const T conv_test = d_abs(dev_new - dev_old) / (d_abs(dev_new) + T(0.1));
      const bool bad = isnan(conv_test);
      const bool converged = it > 0 && conv_test < tol_eff;
      if (bad) iters = maxit;
      dev_old = dev_new;
      bk = bn;
      bret = bn;
      if (bad || converged) break;
    }

    // post-fit: the sandwich from X'WX at the final mu
    gram_mma_store(run, acc, false, amat, p, ~0ull, false,
                                    ridge, nullptr);
    block_cholesky_rows(amat, p, tile);
    block_chol_inverse(amat, m2, amat, p);
    gram_mma_store(run, acc, false, m2, p, ~0ull, false,
                                    nullptr, nullptr);
    HatRun hat = hat_run(p);
    hat_load(hat, amat, p);
    if (t < p) {
      T sv = T(0);
      for (int m = 0; m < p; ++m) {
        T r = T(0);
        for (int n = 0; n < p; ++n) r += m2[m * p + n] * amat[n * p + t];
        sv += amat[m * p + t] * r;
      }
      bvar_out[(size_t)g * p + t] = sv;
      beta_out[(size_t)g * p + t] = bret;
    }
    if (t == 0) {
      dev_out[g] = dev;
      iter_out[g] = iters;
    }
    // last pass: the final mu and each sample's weight (kept in hat_g),
    // then the hat diagonal a tile at a time
    for (int s = t; s < S; s += kBlockThreads) {
      T eta = T(0);
      for (int k = 0; k < p; ++k)
        eta += sb[k] * __ldg(x + (size_t)k * S + s);
      const T mm = nfr[s] * d_exp(eta);
      const T m = mm > min_mu ? mm : min_mu;
      hat_g[s] = wscale<UseW>(m / (T(1) + alpha * m), wr, s);
      mu_g[s] = m;
    }
    T* xb = tile;
    for (int base = 0; base < S; base += tw) {
      const int s = base + t;
      const int n = S - base < tw ? S - base : tw;
      __syncthreads();
      mma_stage(xb, x, S, base, n, p, lay.pr, ts, tw, -1);
      cp_async_wait_all();
      __syncthreads();
      hat_mma(hat, xb, qb, p, ts, n);
      __syncthreads();
      if (t < n) {
        T q = T(0);
        for (int k = 0; k < kBlockWarpsN; ++k) q += qb[k * ts + t];
        hat_g[s] = hat_g[s] * (T(2) * q);
      }
    }
  }
}

// irls_wide_kernel with a thread block per gene (common.cuh's block
// section); x: the design transposed (p x S)
template <typename T, bool UseW>
__global__ void __launch_bounds__(kBlockThreads)
    irls_block_kernel(const T* __restrict__ y, const T* __restrict__ nf,
                      long long nf_gstride, const T* __restrict__ wts,
                      const T* __restrict__ alpha_in,
                      const T* __restrict__ beta0, const T* __restrict__ ridge,
                      const T* __restrict__ x, int G, int S, int p, int tw,
                      T tol, int maxit, T min_mu, T* __restrict__ beta_out,
                      T* __restrict__ bvar_out, T* __restrict__ dev_out,
                      int* __restrict__ iter_out, T* __restrict__ mu_out,
                      T* __restrict__ hat_out, int* __restrict__ counter) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const BlockLayout lay = block_layout(p, tw, kBlockMats, true);
  const int ts = lay.ts;
  T* amat = sm;                 // the ridge system, its factor, its inverse
  T* m2 = sm + lay.mat;         // the factor's inverse, then X'WX
  T* vec = m2 + lay.mat;
  T* sb = vec;                  // mu's coefficients
  T* rhs = vec + kPBlock;       // X'Wz, then the new coefficients
  T* red = vec + kBlockRed;     // block sums' scratch
  int* slot = reinterpret_cast<int*>(vec + kBlockSlots);
  T* tile = vec + lay.vec;
  const int t = threadIdx.x;
  const GramMap gm = block_gram_map(p);
  const T eps = Eps<T>::value;
  const T tol_eff = tol > T(30) * eps ? tol : T(30) * eps;
  const bool shared_nf = nf_gstride == 0;

  for (;;) {
    const int g = block_next_gene(counter, slot);
    if (g >= G) break;
    const T* yr = y + (size_t)g * S;
    const T* nfr = shared_nf ? nf : nf + (size_t)g * nf_gstride;
    const T* wr = UseW ? wts + (size_t)g * S : nullptr;
    const T alpha = alpha_in[g];
    const T size = T(1) / alpha;
    const T lgs = d_lgamma(size);
    const T sls = size * d_log(size);

    // thread k < p holds coefficient k of mu's beta (bk) and of the
    // returned one (bret); sb holds mu's for the passes
    T bk = t < p ? beta0[(size_t)g * p + t] : T(0);
    T bret = bk;
    if (t < p) sb[t] = bk;
    __syncthreads();

    GramBlock<T> gb;
    T rz[4];
    const T dev_const =
        T(-2) * block_pass<T, UseW, true>(gm, yr, nfr, wr, x, S, lay, alpha,
                                          size, lgs, sls, min_mu, sb, tile,
                                          red, gb, rz);

    // control state: the same values on every thread
    T dev_old = T(0), dev = T(0);
    int iters = 0;
    for (int it = 0; it < maxit; ++it) {
      ++iters;
      block_gram_store(gm, gb, amat, p, ~0ull, false, ridge);
      block_rhs(gm, rz, rhs, p);
      block_cholesky<T, false>(amat, p);
      block_chol_solve(amat, p, rhs);
      const T bn = t < p ? rhs[t] : T(0);
      const bool diverged = __syncthreads_or(t < p && d_abs(bn) > T(30));
      if (diverged) {
        // mu (and so gb, rz) stays at the old beta
        bret = bn;
        iters = maxit;
        break;
      }
      T dbeta = T(0), bmax = T(0);
      if (is_f32<T>()) {
        dbeta = block_max(t < p ? d_abs(bn - bk) : T(0), red);
        bmax = block_max(t < p ? d_abs(bn) : T(0), red);
      }
      if (t < p) sb[t] = bn;
      __syncthreads();
      const T dev_new =
          dev_const + T(-2) * block_pass<T, UseW, false>(
                                  gm, yr, nfr, wr, x, S, lay, alpha, size,
                                  lgs, sls, min_mu, sb, tile, red, gb, rz);
      dev = dev_new;
      const T conv_test = d_abs(dev_new - dev_old) / (d_abs(dev_new) + T(0.1));
      const bool bad = isnan(conv_test);
      bool converged = it > 0 && conv_test < tol_eff;
      if (is_f32<T>())
        converged |= it > 0 && dbeta < T(32) * eps * (T(1) + bmax);
      if (bad) iters = maxit;
      dev_old = dev_new;
      bk = bn;
      bret = bn;
      if (bad || converged) break;
    }

    // post-fit: the sandwich from X'WX at the final mu
    block_gram_store(gm, gb, amat, p, ~0ull, false, ridge);
    block_cholesky<T, false>(amat, p);
    block_chol_inverse(amat, m2, amat, p);
    block_gram_store(gm, gb, m2, p, ~0ull, false,
                     static_cast<const T*>(nullptr));
    if (t < p) {
      // ainv is symmetric: column t read as its row
      T sv = T(0);
      for (int m = 0; m < p; ++m) {
        T r = T(0);
        for (int n = 0; n < p; ++n) r += m2[m * p + n] * amat[n * p + t];
        sv += amat[m * p + t] * r;
      }
      bvar_out[(size_t)g * p + t] = sv;
      beta_out[(size_t)g * p + t] = bret;
    }
    if (t == 0) {
      dev_out[g] = dev;
      iter_out[g] = iters;
    }
    // last pass: the final mu and the hat diagonal, a tile of the design
    // at a time in the x tile buffer
    T* mu_g = mu_out + (size_t)g * S;
    T* hat_g = hat_out + (size_t)g * S;
    T* xb = tile;
    for (int base = 0; base < S; base += tw) {
      const int s = base + t;
      __syncthreads();
      if (t < tw && s < S) {
        T eta = T(0);
        for (int k = 0; k < p; ++k) {
          const T v = __ldg(x + (size_t)k * S + s);
          xb[k * ts + t] = v;
          eta += sb[k] * v;
        }
        const T mm = nfr[s] * d_exp(eta);
        const T m = mm > min_mu ? mm : min_mu;
        T q = T(0);
        for (int i = 0; i < p; ++i) {
          const T xi = xb[i * ts + t];
          for (int j = 0; j < p; ++j)
            q += amat[i * p + j] * (xi * xb[j * ts + t]);
        }
        hat_g[s] = wscale<UseW>(m / (T(1) + alpha * m), wr, s) * q;
        mu_g[s] = m;
      }
    }
  }
}

// The float64 instantiations take the tensor-core path (irls_block_mma).
#define DK_IRLS_BLOCK_F64(W)                                                  \
  template <>                                                                 \
  __global__ void __launch_bounds__(kBlockThreads)                            \
      irls_block_kernel<double, W>(                                           \
      const double* __restrict__ y, const double* __restrict__ nf,            \
      long long nf_gstride, const double* __restrict__ wts,                   \
      const double* __restrict__ alpha_in, const double* __restrict__ beta0,  \
      const double* __restrict__ ridge, const double* __restrict__ x, int G,  \
      int S, int p, int tw, double tol, int maxit, double min_mu,             \
      double* __restrict__ beta_out, double* __restrict__ bvar_out,           \
      double* __restrict__ dev_out, int* __restrict__ iter_out,               \
      double* __restrict__ mu_out, double* __restrict__ hat_out,              \
      int* __restrict__ counter) {                                            \
    extern __shared__ __align__(16) unsigned char smem_raw[];                 \
    irls_block_mma<W>(reinterpret_cast<double*>(smem_raw), y, nf, nf_gstride, \
                      wts, alpha_in, beta0, ridge, x, G, S, p, tw, tol,       \
                      maxit, min_mu, beta_out, bvar_out, dev_out, iter_out,   \
                      mu_out, hat_out, counter);                              \
  }
DK_IRLS_BLOCK_F64(false)
DK_IRLS_BLOCK_F64(true)
#undef DK_IRLS_BLOCK_F64

// dynamic shared memory and tile width of a block launch
template <typename T>
inline size_t block_smem(int p, int* tw) {
  if constexpr (!is_f32<T>()) {
    *tw = block_mma_tile(p, 1, (p + 8) >> 3, kBlockWarpsN, p * p);
    return irls_mma_layout(p, *tw).vals * sizeof(T);
  }
  *tw = block_tile<T>(p, kBlockMats, true);
  return block_layout(p, *tw, kBlockMats, true).vals * sizeof(T);
}

template <typename T, bool UseW>
int launch_block(const T* y, const T* nf, long long nf_gstride, const T* w,
                 const T* alpha, const T* beta0, const T* ridge, const T* x,
                 int G, int S, int p, T tol, int maxit, T min_mu, T* beta,
                 T* bvar, T* dev, int* iters, T* mu, T* hat, int* counter,
                 cudaStream_t st) {
  int tw = 0;
  const size_t smem = block_smem<T>(p, &tw);
  auto kernel = irls_block_kernel<T, UseW>;
  int err = allow_smem(kernel, smem);
  if (err) return err;
  const int blocks = persistent_gene_blocks(kernel, smem, G, &err);
  if (err) return err;
  kernel<<<blocks, kBlockThreads, smem, st>>>(
      y, nf, nf_gstride, w, alpha, beta0, ridge, x, G, S, p, tw, tol, maxit,
      min_mu, beta, bvar, dev, iters, mu, hat, counter);
  return (int)cudaGetLastError();
}

template <typename T, bool UseW>
int occupancy_block(int p) {
  int tw = 0;
  const size_t smem = block_smem<T>(p, &tw);
  auto kernel = irls_block_kernel<T, UseW>;
  int err = allow_smem(kernel, smem);
  const int n = err ? 0 : blocks_per_sm(kernel, smem, &err, kBlockThreads);
  return err ? -1 : n;
}

// w == nullptr selects the unweighted instantiation; `counter` is one
// zeroed int of device memory (the blocks' gene counter)
template <typename T>
int launch(const T* y, const T* nf, long long nf_gstride, const T* w,
           const T* alpha, const T* beta0, const T* ridge, const T* x, int G,
           int S, int p, T tol, int maxit, T min_mu, T* beta, T* bvar, T* dev,
           int* iters, T* mu, T* hat, int* counter, void* stream) {
  if (p <= kBlockMinP || p > kPBlock) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w != nullptr
             ? launch_block<T, true>(y, nf, nf_gstride, w, alpha, beta0, ridge,
                                     x, G, S, p, tol, maxit, min_mu, beta,
                                     bvar, dev, iters, mu, hat, counter, st)
             : launch_block<T, false>(y, nf, nf_gstride, w, alpha, beta0,
                                      ridge, x, G, S, p, tol, maxit, min_mu,
                                      beta, bvar, dev, iters, mu, hat,
                                      counter, st);
}

}  // namespace

extern "C" {

// resident blocks per SM of the kernel a launch would take (-1 on a
// refusal or an unsupported p)
int irls_block_blocks_per_sm(int f64, int weighted, int p) {
  if (p <= kBlockMinP || p > kPBlock) return -1;
  if (f64) {
    return weighted ? occupancy_block<double, true>(p)
                    : occupancy_block<double, false>(p);
  }
  return weighted ? occupancy_block<float, true>(p)
                  : occupancy_block<float, false>(p);
}

int irls_block_launch_f32(const float* y, const float* nf,
                          long long nf_gstride, const float* w,
                          const float* alpha, const float* beta0,
                          const float* ridge, const float* x, int G, int S,
                          int p, float tol, int maxit, float min_mu,
                          float* beta, float* bvar, float* dev, int* iters,
                          float* mu, float* hat, int* counter, void* stream) {
  return launch<float>(y, nf, nf_gstride, w, alpha, beta0, ridge, x, G, S, p,
                       tol, maxit, min_mu, beta, bvar, dev, iters, mu, hat,
                       counter, stream);
}

int irls_block_launch_f64(const double* y, const double* nf,
                          long long nf_gstride, const double* w,
                          const double* alpha, const double* beta0,
                          const double* ridge, const double* x, int G, int S,
                          int p, double tol, int maxit, double min_mu,
                          double* beta, double* bvar, double* dev, int* iters,
                          double* mu, double* hat, int* counter,
                          void* stream) {
  return launch<double>(y, nf, nf_gstride, w, alpha, beta0, ridge, x, G, S,
                        p, tol, maxit, min_mu, beta, bvar, dev, iters, mu, hat,
                        counter, stream);
}

}  // extern "C"
