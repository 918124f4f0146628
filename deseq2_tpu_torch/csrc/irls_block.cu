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
// gene from the launch's counter (one atomic per gene); a pass first
// computes every sample's terms, then walks the samples in tiles, and the
// threads own the gram's 4 x 4 upper blocks (at p = 64 one a thread for
// 136 of the 256, at fewer columns in groups over the tile's samples),
// reduced in group order.  Every entry is summed in one fixed order: two
// launches give the same bits, and a gene's result does not depend on its
// neighbours.  In float64 (irls_block_mma) the grams run on the FP64
// tensor cores (common.cuh's float64 gram section): X'WX and X'Wz (the
// gram's column p, z being the design tile's row p) in the warps' mma.sync
// runs, and the hat diagonal as Y = U' X per 8 samples (U: the inverse's
// upper triangle, its fragments held in registers) dotted with X; the
// design tiles come in by cp.async.  In float32 (irls_block_rows) a gene
// was latency-bound on a column-major design at two or three blocks an
// SM: its per-sweep Cholesky (three block barriers a column) took 0.31 of
// it at p = 25, the hat diagonal (one p^2 chain a sample) 0.18 (`studies
// phases k1`, PERF.md section 6).  So the tiles are sample-major and the gram
// threads read a sample's four rows in one 128-bit load (common.cuh's
// float32 K1 section), the groups' partial blocks are summed by all 256
// threads straight into the ridge system (rows_reduce), warp 0 factors
// and solves (one block barrier a sweep), the hat diagonal is |L^-1 x|^2
// over k threads a sample and the sandwich over k threads a coefficient,
// and the kernel runs four blocks an SM (64 registers a thread; its tile
// width follows from a quarter of the SM's shared memory, 256 samples at
// p = 25, 64 at p = 64; where a tile holds the block's 256 samples, the
// terms are taken as the tile is staged).
#include "common.cuh"

namespace {

using namespace dk;

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

// --- float32: terms first, sample-major tiles, four blocks an SM ---

// the float32 kernel's resident blocks an SM (its launch bounds: 64
// registers a thread) and the shared memory each may take for them (the
// SM's 228 KB less the 1 KB a block the card keeps)
constexpr int kRowsBlocks = 4;
constexpr size_t kRowsSmemTarget = 233472 / kRowsBlocks - 1024;

// the float32 layout: the ridge system (its factor, then A^-1), X'WX and
// after the fit L^-1 (p rows of lt = rows_ld(pr) values), the vectors
// (the block's, then X'Wz),
// then the tile: tw sample-major design rows (ts = rows_ld(pr) values
// each), then the tile's w and w z; the same region holds the groups'
// partial blocks at a pass's end and X'WX after the fit.  Every part
// starts on 16 bytes.
__host__ __device__ inline BlockLayout irls_rows_layout(int p, int tw) {
  BlockLayout l;
  l.p = p;
  l.pr = (p + 3) & ~3;
  l.tw = tw;
  l.ts = rows_ld(l.pr);
  l.mat = ((size_t)p * p + 3) & ~(size_t)3;
  l.vec = kBlockVecVals + kPBlock;
  const size_t buf = (size_t)tw * (l.ts + 2);
  const size_t scratch =
      (size_t)block_gram_groups(p) * block_gram_blocks(p) * 20;
  l.tile = buf > scratch ? buf : scratch;
  if (l.tile < (size_t)p * p) l.tile = (size_t)p * p;
  l.vals = l.mat + (size_t)p * l.ts + l.vec + l.tile;
  return l;
}

inline int irls_rows_tile(int p) {
  int tw = kBlockThreads;
  while (tw > 32 &&
         irls_rows_layout(p, tw).vals * sizeof(float) > kRowsSmemTarget)
    tw -= 32;
  return tw;
}

// Sample s's terms at x'beta = eta: its deviance term (returned; with
// First the mu-independent part), w and w z.
template <bool UseW, bool First>
__device__ __forceinline__ float rows_terms(const float* yr,
                                            const float* nfr,
                                            const float* wr, int s,
                                            float eta, float alpha,
                                            float size, float lgs, float sls,
                                            float min_mu, float& w,
                                            float& wz) {
  using T = float;
  const T nfs = nfr[s];
  const T mm = nfs * d_exp(eta);
  const T m = mm > min_mu ? mm : min_mu;
  const T yv = yr[s];
  const T lm = d_log(m);
  T dev;
  if constexpr (First) {
    dev = wscale<UseW>(
        d_lgamma(yv + size) - lgs - d_lgamma(yv + T(1)) + sls, wr, s);
  } else {
    const T lsm = d_log(size + m);
    const T tt = yv > T(0) ? yv * (lm - lsm) : T(0);
    dev = wscale<UseW>(-size * lsm + tt, wr, s);
  }
  w = wscale<UseW>(m / (T(1) + alpha * m), wr, s);
  wz = w * (lm - d_log(nfs) + (yv - m) / m);
  return dev;
}

// A pass's sums into the ridge system: every active thread's partial
// block (gb, and rz: X'Wz at a diagonal block's rows) to part (the tile's
// room: 20 values a thread), then each entry summed over the groups in
// group order (block_gram_reduce's order, so its bits) by the block's
// threads and written to G (X'WX, both triangles, row stride p), amat (G
// with the ridge on its diagonal, block_gram_store's values) and xz
// (X'Wz).  Every thread of the block calls it; it ends with a
// __syncthreads.
__device__ __forceinline__ void rows_reduce(const GramMap& gm,
                                            const GramBlock<float>& gb,
                                            const float (&rz)[4], float* part,
                                            float* G, float* amat,
                                            const float* ridge, float* xz,
                                            int p) {
  const int t = threadIdx.x, nb = gm.nb, nbr = (p + 3) >> 2;
  __syncthreads();
  if (gm.active) {
    float4* pt = reinterpret_cast<float4*>(part + (size_t)t * 20);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pt[i] = make_float4(gb.a[i][0], gb.a[i][1], gb.a[i][2], gb.a[i][3]);
    pt[4] = make_float4(rz[0], rz[1], rz[2], rz[3]);
  }
  __syncthreads();
  for (int q = t; q < nb * 20; q += kBlockThreads) {
    const int b = q / 20, e = q - 20 * b;
    int rb = 0, cb = b;
    while (cb >= nbr - rb) {
      cb -= nbr - rb;
      ++rb;
    }
    const int r0 = 4 * rb, c0 = 4 * (rb + cb);
    float v = part[q];
    for (int g = 1; g < gm.ng; ++g) v += part[(size_t)g * nb * 20 + q];
    if (e < 16) {
      const int r = r0 + (e >> 2), c = c0 + (e & 3);
      if (r <= c && c < p) {
        G[r * p + c] = v;
        G[c * p + r] = v;
        const float a = r == c ? v + ridge[r] : v;
        amat[r * p + c] = a;
        amat[c * p + r] = a;
      }
    } else if (cb == 0 && r0 + e - 16 < p) {
      xz[r0 + e - 16] = v;
    }
  }
  __syncthreads();
}

// One pass over a gene's samples at the coefficients sb: first every
// sample's terms, thread t its samples t, t + 256, ... (x'beta from the
// design in global memory), the deviance terms summed and each sample's
// w and w z written to wg and zg (the gene's rows of the hat-diagonal and
// mu outputs, its scratch until the last pass); then the tiles, the block
// staging them (k1_stage, w, w z) and adding each to its blocks of X'WX
// and X'Wz (k1_gram_add), summed into G, amat and xz (rows_reduce).  So
// no gram accumulator is live while the special functions run or past the
// pass, and all 256 threads run the terms whatever the tile width.  Where
// a tile holds 256 samples (up to ~37 columns) the terms are taken as
// each thread stages its tile's sample, which reads x once.  Returns the
// deviance terms' total on every thread.
template <bool UseW, bool First>
__device__ __forceinline__ float rows_pass(
    const GramMap& gm, const float* yr, const float* nfr, const float* wr,
    const float* x, int S, const BlockLayout& lay, float alpha, float size,
    float lgs, float sls, float min_mu, const float* sb, float* tile,
    float* red, float* wg, float* zg, float* G, float* amat,
    const float* ridge, float* xz) {
  using T = float;
  const int t = threadIdx.x;
  const int p = lay.p, tw = lay.tw, ld = lay.ts;
  T dev[1] = {T(0)};
  T* xb = tile;
  T* wb = tile + (size_t)tw * ld;
  T* zb = wb + tw;
  GramBlock<T> gb;
  T rz[4];
  gram_zero(gb);
#pragma unroll
  for (int j = 0; j < 4; ++j) rz[j] = T(0);
  if (tw == kBlockThreads) {
    // a tile is the block's samples: thread t stages its samples t, t +
    // 256, ... (k1_row, their x'sb on the way) and their terms at once, the
    // same values in the same order as the terms-first loop below
    for (int base = 0; base < S; base += tw) {
      const int s = base + t;
      const int n = S - base < tw ? S - base : tw;
      __syncthreads();
      if (t < n) {
        const T eta = k1_row(xb, x, S, s, p, lay.pr, ld, t, sb);
        T w, wz;
        dev[0] += rows_terms<UseW, First>(yr, nfr, wr, s, eta, alpha, size,
                                          lgs, sls, min_mu, w, wz);
        wb[t] = w;
        zb[t] = wz;
      }
      __syncthreads();
      k1_gram_add(gm, gb, rz, xb, wb, zb, ld, n);
    }
    block_allsum<T, 1>(dev, red);
  } else {
    for (int s = t; s < S; s += kBlockThreads) {
      T eta = T(0);
      for (int k = 0; k < p; ++k)
        eta += sb[k] * __ldg(x + (size_t)k * S + s);
      T w, wz;
      dev[0] += rows_terms<UseW, First>(yr, nfr, wr, s, eta, alpha, size,
                                        lgs, sls, min_mu, w, wz);
      wg[s] = w;
      zg[s] = wz;
    }
    block_allsum<T, 1>(dev, red);
    for (int base = 0; base < S; base += tw) {
      const int n = S - base < tw ? S - base : tw;
      __syncthreads();
      k1_stage(xb, x, S, base, n, p, lay.pr, ld);
      if (t < n) {
        wb[t] = wg[base + t];
        zb[t] = zg[base + t];
      }
      __syncthreads();
      k1_gram_add(gm, gb, rz, xb, wb, zb, ld, n);
    }
  }
  // the tile is the reduction's scratch
  rows_reduce(gm, gb, rz, tile, G, amat, ridge, xz, p);
  return dev[0];
}

// The sweep's solve on warp 0, after warp_cholesky_ll's factor of the
// ridge system in a (both triangles): block_chol_solve_rows' steps with r
// = X'Wz (xz) in lane l's registers (entry l and, Rows = 2, l + 32;
// Rows = 1 takes p <= 32); then whether a coefficient passed |beta| > 30
// and, in float32's stop, the largest move from sb and the largest
// |beta|, into flag[0..2].  The new coefficients go to rhs (the returned
// beta) and, unless the sweep diverged, to sb (mu's).
template <int Rows>
__device__ __forceinline__ void rows_solve(const float* L, int p,
                                           const float* xz, float* rhs,
                                           float* sb, float* flag) {
  using T = float;
  const int lane = lane_id();
  const bool in0 = lane < p, in1 = Rows == 2 && lane + 32 < p;
  T r0 = in0 ? xz[lane] : T(0), r1 = in1 ? xz[lane + 32] : T(0);
  const T d0 = in0 ? T(1) / L[lane * (p + 1)] : T(0);
  const T d1 = in1 ? T(1) / L[(lane + 32) * (p + 1)] : T(0);
  for (int i = 0; i < p; ++i) {
    const T wi =
        __shfl_sync(kFullMask, Rows == 1 || i < 32 ? r0 * d0 : r1 * d1, i & 31);
    const T* li = L + i * p;
    if (lane == i) r0 = wi;
    if (lane + 32 == i) r1 = wi;
    if (lane > i && in0) r0 -= li[lane] * wi;
    if (lane + 32 > i && in1) r1 -= li[lane + 32] * wi;
  }
  for (int i = p - 1; i >= 0; --i) {
    const T xi =
        __shfl_sync(kFullMask, Rows == 1 || i < 32 ? r0 * d0 : r1 * d1, i & 31);
    const T* li = L + i * p;
    if (lane == i) r0 = xi;
    if (lane + 32 == i) r1 = xi;
    if (lane < i) r0 -= li[lane] * xi;
    if (lane + 32 < i) r1 -= li[lane + 32] * xi;
  }
  const bool diverged = __any_sync(
      kFullMask, (in0 && d_abs(r0) > T(30)) || (in1 && d_abs(r1) > T(30)));
  T mv = T(0), mb = T(0);
  if (in0) {
    mv = d_abs(r0 - sb[lane]);
    mb = d_abs(r0);
  }
  if (in1) {
    mv = d_abs(r1 - sb[lane + 32]) > mv ? d_abs(r1 - sb[lane + 32]) : mv;
    mb = d_abs(r1) > mb ? d_abs(r1) : mb;
  }
  mv = warp_max(mv);
  mb = warp_max(mb);
  if (in0) rhs[lane] = r0;
  if (in1) rhs[lane + 32] = r1;
  if (!diverged) {
    if (in0) sb[lane] = r0;
    if (in1) sb[lane + 32] = r1;
  }
  if (lane == 0) {
    flag[0] = diverged ? T(1) : T(0);
    flag[1] = mv;
    flag[2] = mb;
  }
}

// irls_block_kernel in float32: every pass's terms on all 256 threads,
// then sample-major tiles (rows_pass); the sweep's factor and solve on
// warp 0 (warp_cholesky_ll, block_cholesky's bits, one row a lane up to 32
// columns; rows_solve) with one block barrier; after the fit L^-1 and A^-1 (k1_inverse), the sandwich
// over k threads a coefficient and the hat diagonal as |L^-1 x|^2 over k
// threads a sample (k = 256 / (the samples a round) a power of 2).  The
// sweeps' control is irls_block_mma's, with float32's stop on a beta that
// stops moving.
template <bool UseW>
__device__ __forceinline__ void irls_block_rows(
    float* sm, const float* y, const float* nf, long long nf_gstride,
    const float* wts, const float* alpha_in, const float* beta0,
    const float* ridge, const float* x, int G, int S, int p, int tw,
    float tol, int maxit, float min_mu, float* beta_out, float* bvar_out,
    float* dev_out, int* iter_out, float* mu_out, float* hat_out,
    int* counter) {
  using T = float;
  const BlockLayout lay = irls_rows_layout(p, tw);
  const int ld = lay.ts;
  T* amat = sm;                 // the ridge system, its factor, A^-1
  T* li = sm + lay.mat;         // X'WX (row stride p), after the fit L^-1
  T* vec = li + (size_t)p * ld;
  T* sb = vec;                  // mu's coefficients
  T* rhs = vec + kPBlock;       // the returned coefficients
  T* red = vec + kBlockRed;     // block sums' scratch
  int* slot = reinterpret_cast<int*>(vec + kBlockSlots);
  T* flag = vec + kBlockSlots + 1;  // the sweep's verdict (rows_solve)
  T* xz = vec + kBlockVecVals;  // X'Wz
  T* tile = vec + lay.vec;
  const int t = threadIdx.x;
  const GramMap gm = block_gram_map(p);
  const T eps = Eps<T>::value;
  const T tol_eff = tol > T(30) * eps ? tol : T(30) * eps;
  const bool shared_nf = nf_gstride == 0;
  // the hat's and the sandwich's threads: kh a sample, ks a coefficient
  int kh = 1;
  while (kBlockThreads / kh > tw) kh <<= 1;
  int ks = 1;
  while (2 * ks * p <= kBlockThreads) ks <<= 1;

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
    if (t < p) sb[t] = rhs[t] = beta0[(size_t)g * p + t];
    __syncthreads();

    // the gene's mu and hat-diagonal rows: the passes' scratch (w z, w)
    T* mu_g = mu_out + (size_t)g * S;
    T* hat_g = hat_out + (size_t)g * S;
    const T dev_const =
        T(-2) * rows_pass<UseW, true>(gm, yr, nfr, wr, x, S, lay, alpha,
                                      size, lgs, sls, min_mu, sb, tile, red,
                                      hat_g, mu_g, li, amat, ridge, xz);
    // control state: the same values on every thread
    T dev_old = T(0), dev = T(0);
    int iters = 0;
    for (int it = 0; it < maxit; ++it) {
      ++iters;
      // the ridge system and X'Wz from the last pass (rows_reduce)
      if (t < 32) {
        // one row a lane up to 32 columns, two past them
        if (p <= 32) {
          warp_cholesky_ll<T, 1, false>(amat, p);
          rows_solve<1>(amat, p, xz, rhs, sb, flag);
        } else {
          warp_cholesky_ll<T, 2, false>(amat, p);
          rows_solve<2>(amat, p, xz, rhs, sb, flag);
        }
      }
      __syncthreads();
      if (flag[0] != T(0)) {
        // mu stays at the old beta: its sums once more (the same pass, so
        // the same bits), so that no gram is live through the factor
        rows_pass<UseW, false>(gm, yr, nfr, wr, x, S, lay, alpha, size, lgs,
                               sls, min_mu, sb, tile, red, hat_g, mu_g, li,
                               amat, ridge, xz);
        iters = maxit;
        break;
      }
      const T dbeta = flag[1], bmax = flag[2];
      const T dev_new =
          dev_const + T(-2) * rows_pass<UseW, false>(
                                  gm, yr, nfr, wr, x, S, lay, alpha, size,
                                  lgs, sls, min_mu, sb, tile, red, hat_g,
                                  mu_g, li, amat, ridge, xz);
      dev = dev_new;
      const T conv_test = d_abs(dev_new - dev_old) / (d_abs(dev_new) + T(0.1));
      const bool bad = isnan(conv_test);
      const bool converged =
          it > 0 && (conv_test < tol_eff || dbeta < T(32) * eps * (T(1) + bmax));
      if (bad) iters = maxit;
      dev_old = dev_new;
      if (bad || converged) break;
    }

    // post-fit: the sandwich from X'WX at the final mu, the last pass's
    // system (rhs, the returned coefficients until they are written, then
    // the inverse's scratch; X'WX to the tile's room, then L^-1 in its)
    if (t < p) beta_out[(size_t)g * p + t] = rhs[t];
    T* xw = tile;
    for (int e = t; e < p * p; e += kBlockThreads) xw[e] = li[e];
    if (t < 32) {
      if (p <= 32)
        warp_cholesky_ll<T, 1, false>(amat, p);
      else
        warp_cholesky_ll<T, 2, false>(amat, p);
    }
    __syncthreads();
    k1_inverse<kBlockWarpsN>(amat, p, li, ld, amat, p, lay.pr, rhs);
    {
      const int col = t / ks;
      const T v = lanes_sum(
          col < p ? k1_sandwich_part(amat, xw, p, p, col, t % ks, ks) : T(0),
          ks);
      if (col < p && t % ks == 0) bvar_out[(size_t)g * p + col] = v;
    }
    if (t == 0) {
      dev_out[g] = dev;
      iter_out[g] = iters;
    }
    // last pass: the final mu and the hat diagonal.  With a thread a
    // sample (kh = 1) each thread stages its own samples' rows, x read
    // once and no barrier; else each sample's weight first (kept in
    // hat_g), then the hat diagonal, kBlockThreads / kh samples a round.
    if (kh == 1) {
      __syncthreads();
      for (int s = t; s < S; s += kBlockThreads) {
        const T eta = k1_row(tile, x, S, s, p, lay.pr, ld, t, sb);
        const T mm = nfr[s] * d_exp(eta);
        const T m = mm > min_mu ? mm : min_mu;
        mu_g[s] = m;
        hat_g[s] = wscale<UseW>(m / (T(1) + alpha * m), wr, s) *
                   k1_hat_part(li, ld, tile + t * ld, p, 0, 1);
      }
      continue;
    }
    for (int s = t; s < S; s += kBlockThreads) {
      T eta = T(0);
      for (int k = 0; k < p; ++k)
        eta += sb[k] * __ldg(x + (size_t)k * S + s);
      const T mm = nfr[s] * d_exp(eta);
      const T m = mm > min_mu ? mm : min_mu;
      hat_g[s] = wscale<UseW>(m / (T(1) + alpha * m), wr, s);
      mu_g[s] = m;
    }
    const int hn = kBlockThreads / kh;
    for (int base = 0; base < S; base += hn) {
      const int n = S - base < hn ? S - base : hn;
      __syncthreads();
      k1_stage(tile, x, S, base, n, p, lay.pr, ld);
      __syncthreads();
      const int r = t / kh;
      const T q = lanes_sum(
          r < n ? k1_hat_part(li, ld, tile + r * ld, p, t % kh, kh) : T(0),
          kh);
      if (r < n && t % kh == 0) hat_g[base + r] *= q;
    }
  }
}

// irls_wide_kernel with a thread block per gene (common.cuh's block
// section); x: the design transposed (p x S).  float64 takes the
// tensor-core path (irls_block_mma), float32 the sample-major one
// (irls_block_rows) at kRowsBlocks blocks an SM.
template <typename T, bool UseW>
__global__ void irls_block_kernel(
    const T* __restrict__ y, const T* __restrict__ nf, long long nf_gstride,
    const T* __restrict__ wts, const T* __restrict__ alpha_in,
    const T* __restrict__ beta0, const T* __restrict__ ridge,
    const T* __restrict__ x, int G, int S, int p, int tw, T tol, int maxit,
    T min_mu, T* __restrict__ beta_out, T* __restrict__ bvar_out,
    T* __restrict__ dev_out, int* __restrict__ iter_out,
    T* __restrict__ mu_out, T* __restrict__ hat_out,
    int* __restrict__ counter);

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

#define DK_IRLS_BLOCK_F32(W)                                                  \
  template <>                                                                 \
  __global__ void __launch_bounds__(kBlockThreads, kRowsBlocks)               \
      irls_block_kernel<float, W>(                                            \
      const float* __restrict__ y, const float* __restrict__ nf,              \
      long long nf_gstride, const float* __restrict__ wts,                    \
      const float* __restrict__ alpha_in, const float* __restrict__ beta0,    \
      const float* __restrict__ ridge, const float* __restrict__ x, int G,    \
      int S, int p, int tw, float tol, int maxit, float min_mu,               \
      float* __restrict__ beta_out, float* __restrict__ bvar_out,             \
      float* __restrict__ dev_out, int* __restrict__ iter_out,                \
      float* __restrict__ mu_out, float* __restrict__ hat_out,                \
      int* __restrict__ counter) {                                            \
    extern __shared__ __align__(16) unsigned char smem_raw[];                 \
    irls_block_rows<W>(reinterpret_cast<float*>(smem_raw), y, nf, nf_gstride, \
                       wts, alpha_in, beta0, ridge, x, G, S, p, tw, tol,      \
                       maxit, min_mu, beta_out, bvar_out, dev_out, iter_out,  \
                       mu_out, hat_out, counter);                             \
  }
DK_IRLS_BLOCK_F32(false)
DK_IRLS_BLOCK_F32(true)
#undef DK_IRLS_BLOCK_F32

// dynamic shared memory and tile width of a block launch
template <typename T>
inline size_t block_smem(int p, int* tw) {
  if constexpr (!is_f32<T>()) {
    *tw = block_mma_tile(p, 1, (p + 8) >> 3, kBlockWarpsN, p * p);
    return irls_mma_layout(p, *tw).vals * sizeof(T);
  }
  *tw = irls_rows_tile(p);
  return irls_rows_layout(p, *tw).vals * sizeof(T);
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
