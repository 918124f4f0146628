"""Single-cell scale pipeline: sample-axis streaming (the JAX package's
deseq2_tpu/parallel/sc.py, BASELINE #5).

At 30k genes x 50k cells one (G,S) float32 intermediate is 6 GB, so the
bulk pipeline's materialize-mu design would keep several such buffers
live.  This variant keeps the counts as the only (G,S) array (int32 on
the device, plus the (G,S) normalization factors of a covariate design
that has them) and recomputes every per-sample quantity inside passes
over sample chunks.  The group design's fitted mean factorizes as
mu[g,s] = q[g, cell(s)] * sf[s], so its persistent state is (G,C) group
means plus (G,p) betas; a covariate design (any small-p model matrix)
keeps (G,p) betas and recomputes mu = sf * exp(x beta) in every chunk.

The math, clamps and convergence rules are the bulk pipeline's (reference
src/DESeq2.cpp:163-465, R/core.R:657-1508) with the single-cell defaults
minmu = 1e-6 and no outlier replacement (R/core.R:297-303).  The JAX
package's `lax.scan` over chunks is a Python loop over chunks here, its
`lax.while_loop` a Python loop whose condition is read back from the
device once per iteration, and its `lax.cond` a Python branch on a
count read back once.  The lockstep semantics, maxit, the float32-only
stall exits, the cascade of straggler caps and the grid fallback's
2 x cap limit are the JAX package's.

Straggler blocks.  Once a search's live genes fit a cap, they are
compacted (compact_live_indices), their count rows (and factor rows)
gathered once into a block by one index_select each, and they iterate on
that block alone; so do the grid fallback's genes and the histogram
path's overflow genes.  Each cap is at most half the level above it, so
a block holds at most half the rows of the (G,S) arrays.  The TPU
workarounds of the JAX module do not carry over: no byte ledger of the
blocks (it kept the 2025 libtpu from charging them against HBM at
compile time), no per-chunk gather of the rows in their place (on the
H100 that was no faster at 2,048-sample chunks and 1.4x / 2.1x slower at
4,096 / 8,192, PERF.md), and a ragged last chunk is just a narrower
chunk.

Search precision.  The dispersion estimation (stage 1, the trend and
prior, the QL shrinkage or the MAP search) runs in SEARCH_DTYPE, float64,
whatever the call's dtype; the GLM, the test and the tail run in the
call's.  The JAX package's float32 searches stop a gene once an accepted
step gains < 50 eps |lp| (0.03 at 4,096 samples), a log posterior summed
from float32 terms resolves no finer, and their estimates land up to a
few percent from float64's, which flips confident calls of bench.py's
single-cell gate (PERF.md, `studies sc`).

Histogram path.  For integer counts the per-sample lgamma/digamma sums of
the dispersion log posterior collapse into per-gene sums over HIST_K
count-tail bins; genes with a count >= HIST_K are redone on the exact
per-sample path.  It is on in float32 and off in float64 by default (the
JAX package's rule), and `use_hist=True` turns it on in float64 too (the
gate's float64 side, so that both sides sum in the same order).

Entry points: `fused_sc_pipeline` (the parametric Wald pipeline, device
tensors) and `fused_sc_results` (the staged single-cell DESeq story:
fit_type "glmGamPoi" with the quasi-likelihood F-test, or "parametric"
with the Wald test or the chi-square LRT, and the independent-filtering
tail; host numpy columns).

Gene mesh (parallel/sharding.py, the JAX package's shard_map stages): the
counts' row blocks stream on their shards' devices, each block running
stage 1 (its straggler cascade and caps, its histogram overflow redo),
the MAP search and the IRLS on its own; the trend, the prior, the QL
shrinkage, the test and the filtering tail run once on the gathered
vectors on the mesh's first device.  A count that rounding decides may
move with a block's G, through its caps, as it moves with the chunk
width.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import profiling
from ..ops.nb import digamma_diff, lgamma_diff_centered, trigamma
from ..ops.padding import compact_live_indices
from .filterdev import bh_adjust, filtered_bh_dev, theta_grid_dev
from .fused import LN2, LOG2E, _masked_median, gamma_trend_fit
from .sharding import GeneMesh, as_mesh

__all__ = ["fused_sc_pipeline", "fused_sc_results", "DEFAULT_CHUNK",
           "HIST_K", "SEARCH_DTYPE"]

# sample chunk of the streamed passes (`python -m
# deseq2_tpu_torch.ops.studies sc` times the widths on the card)
DEFAULT_CHUNK = 2048
HIST_K = 64   # count-tail histogram width for the low-count fast path
# dtype of the dispersion estimation in every call (module docstring)
SEARCH_DTYPE = torch.float64


# ---------------------------------------------------------------------------
# setup and streamed chunks
# ---------------------------------------------------------------------------

def _bounds(S, chunk):
    return [(s, min(s + chunk, S)) for s in range(0, S, chunk)]


def _setup(counts, x, size_factors, chunk, dtype, cells=None,
           norm_factors=None):
    """The streamed passes' environment: the (G,S) counts (and factors),
    the chunk bounds, and the per-sample rows they read (size factors, the
    design x, its packed outer products xx, and the group codes of a group
    design).  No padding: a ragged last chunk is narrower."""
    S = counts.shape[1]
    p = x.shape[1]
    return dict(
        counts=counts, nf=norm_factors, sf=size_factors, x=x,
        xx=(x[:, :, None] * x[:, None, :]).reshape(S, p * p), cells=cells,
        S=S, p=p, dtype=dtype, bounds=_bounds(S, chunk),
        ridge=torch.diag(torch.full((p,), 1e-6 / LN2 ** 2, dtype=dtype,
                                    device=counts.device)))


def _group_design(cells, n_groups, dtype):
    """Intercept + treatment indicators of the group factor: (S, p)."""
    lv = torch.arange(1, n_groups, device=cells.device)
    return torch.cat([torch.ones(cells.shape[0], 1, dtype=dtype,
                                 device=cells.device),
                      (cells[:, None] == lv[None, :]).to(dtype)], dim=1)


def _rows(env, idx):
    """The environment of the gene block `idx`: its count rows (and its
    normalization-factor rows) gathered once, one index_select each."""
    sub = dict(env, counts=env["counts"].index_select(0, idx))
    if env["nf"] is not None:
        sub["nf"] = env["nf"].index_select(0, idx)
    return sub


def _y_chunk(env, s0, s1):
    return env["counts"][:, s0:s1].to(env["dtype"])


def _mu_factor(env, s0, s1):
    """Per-chunk normalization for mu: the (g, chunk) block of the gene x
    sample normalization factors when present (tximport/avgTxLength
    datasets, R/methods.R:286-361, streamed like the counts), else the
    shared size-factor row."""
    nf = env["nf"]
    return env["sf"][None, s0:s1] if nf is None else nf[:, s0:s1]


def _count_tails(env, K=HIST_K):
    """Per-gene count-tail histogram: tails[g, k] = #{s: y[g,s] > k} for
    k < K, and each gene's largest count.

    For integer counts lgamma(y+c) - lgamma(c) = sum_{k<y} log(c+k) and
    digamma(y+c) - digamma(c) = sum_{k<y} 1/(c+k), so the log posterior's
    per-sample sums collapse into per-gene sums over the K bins.  Exact
    for genes whose counts all lie below K."""
    counts = env["counts"]
    G = counts.shape[0]
    dev = counts.device
    hist = torch.zeros(G * (K + 1), dtype=torch.int64, device=dev)
    mx = torch.zeros(G, dtype=counts.dtype, device=dev)
    base = torch.arange(G, device=dev)[:, None] * (K + 1)
    for s0, s1 in env["bounds"]:
        y = counts[:, s0:s1]
        hist += torch.bincount((base + torch.clamp(y, max=K)).reshape(-1),
                               minlength=G * (K + 1))
        mx = torch.maximum(mx, y.max(dim=1).values)
    hist = hist.reshape(G, K + 1)[:, 1:]
    tails = torch.flip(torch.cumsum(torch.flip(hist, (1,)), 1), (1,))
    return tails.to(env["dtype"]), mx


# ---------------------------------------------------------------------------
# streamed log posterior
# ---------------------------------------------------------------------------

def _lp_dlp_factory(group):
    """make_lp(env, mu_state, min_mu, tails=None) for the
    group design (mu_state: the (g, C) clamped group means) or a covariate
    design (mu_state: the (g, p) betas of mu)."""

    def make_lp(env, mu_state, min_mu, tails=None):
        """Streamed dispersion log posterior + derivative over log alpha
        for the genes of `env` (all of them, or a block: _rows).  `tails`: the block's count-tail histogram (_count_tails),
        whose bin sums replace the per-sample lgamma/digamma sums."""
        p, dtype = env["p"], env["dtype"]

        def lp_dlp(la, use_prior, pm, pv):
            g = la.shape[0]
            alpha = torch.exp(la)
            inv_a = 1.0 / alpha
            ll = la.new_zeros(g)
            s1 = la.new_zeros(g)
            b = la.new_zeros(g, p * p)
            db = la.new_zeros(g, p * p)
            ac, ic = alpha[:, None], inv_a[:, None]
            for c0, c1 in env["bounds"]:
                y = _y_chunk(env, c0, c1)
                if group:
                    mu = mu_state[:, env["cells"][c0:c1]] \
                        * env["sf"][None, c0:c1]
                else:
                    mu = _mu_factor(env, c0, c1) * torch.exp(
                        mu_state @ env["x"][c0:c1].T)
                mu = torch.clamp(mu, min=min_mu)
                mua = mu * ac
                # one reciprocal serves every ratio: w = mu*r,
                # mua/(1+mua) = mua*r, y/(mu + 1/alpha) = y*alpha*r
                r = 1.0 / (1.0 + mua)
                l1p = torch.log1p(mua)
                if tails is None:
                    ll += (lgamma_diff_centered(y, ic)
                           - (y + ic) * l1p).sum(dim=1)
                    s1 += (l1p - mua * r + y * (ac * r)
                           - digamma_diff(y, ic)).sum(dim=1)
                else:
                    ll += (-(y + ic) * l1p).sum(dim=1)
                    s1 += (l1p - mua * r + y * (ac * r)).sum(dim=1)
                w = mu * r
                xx = env["xx"][c0:c1]
                b += w @ xx
                db += (-w * w) @ xx
            if tails is not None:
                ks = torch.arange(tails.shape[1], dtype=dtype,
                                  device=la.device)[None, :]
                # sum_{k<y} log(1 + k/c) per gene is sum_k tail_k *
                # log1p(k*alpha); sum_{k<y} 1/(c+k) is sum_k tail_k/(c+k)
                ll = ll + (tails * torch.log1p(ks * ac)).sum(dim=1)
                s1 = s1 - (tails / (ic + ks)).sum(dim=1)
            bm = b.reshape(g, p, p)
            logdet = torch.linalg.slogdet(bm).logabsdet
            binv = torch.linalg.inv_ex(bm).inverse
            tr = torch.einsum("gij,gji->g", binv, db.reshape(g, p, p))
            lp = ll - 0.5 * logdet
            dlp = (s1 / (alpha * alpha) - 0.5 * tr) * alpha
            if use_prior:
                lp = lp - 0.5 * (la - pm) ** 2 / pv
                dlp = dlp - (la - pm) / pv
            return lp, dlp

        return lp_dlp

    return make_lp


_make_lp_dlp = _lp_dlp_factory(group=True)
_make_lp_dlp_x = _lp_dlp_factory(group=False)


# ---------------------------------------------------------------------------
# per-gene streamed solvers
# ---------------------------------------------------------------------------

def _caps(G, fracs, floor):
    """The cascade of straggler caps: powers of two, each at most half the
    previous level."""
    caps, prev = [], G
    for frac in fracs:
        c = min(1 << (max(G // frac, floor) - 1).bit_length(), G)
        if c * 2 <= prev:
            caps.append(c)
            prev = c
    return caps


def _take(v, idx):
    return v[idx] if torch.is_tensor(v) and v.dim() else v


def _line_search(env, mu_state, la0, use_prior, pm, pv, maxit, min_disp,
                 min_mu, make_lp=_make_lp_dlp, tails=None):
    """Armijo backtracking ascent (cpp:163-277), streamed, with cascading
    straggler compaction: once the live set fits a cap, those genes are
    gathered and finish on their own block, so tail iterations cost cap/G
    of a full sweep.  Returns log_alpha, last_lp, initial_lp, iter."""
    dtype = env["dtype"]
    G = la0.shape[0]
    lp0, dlp0 = make_lp(env, mu_state, min_mu, tails=tails)(
        la0, use_prior, pm, pv)
    eps = torch.finfo(dtype).eps
    tol = torch.clamp(lp0.abs() * 50.0 * eps, min=1e-6)
    min_la = torch.log(torch.tensor(min_disp / 10.0, dtype=dtype))
    zi = torch.zeros(G, dtype=torch.int32, device=la0.device)
    # a, kappa, lp, dlp, iters, iacc, done, tol
    state = [la0, torch.ones_like(la0), lp0, dlp0, zi, zi.clone(),
             torch.zeros(G, dtype=torch.bool, device=la0.device), tol]
    f32 = eps > 1e-10

    def step(s, lp_dlp, pm_):
        a, kappa, lp, dlp, iters, iacc, done, tol_ = s
        live = ~done
        iters = iters + live.to(torch.int32)
        a_pr = a + kappa * dlp
        kappa = torch.where(a_pr < -30.0, (-30.0 - a) / dlp, kappa)
        kappa = torch.where(a_pr > 10.0, (10.0 - a) / dlp, kappa)
        a_new = a + kappa * dlp
        lp_new, dlp_next = lp_dlp(a_new, use_prior, pm_, pv)
        accept = -lp_new <= -lp - kappa * 1e-4 * dlp * dlp
        upd = live & accept
        iacc = iacc + upd.to(torch.int32)
        conv = (lp_new - lp) < tol_
        under = a_new < min_la
        a = torch.where(upd, a_new, a)
        lp = torch.where(upd & (conv | ~under), lp_new, lp)
        newly = upd & (conv | under)
        if f32:
            newly = newly | (live & ~accept & (kappa * dlp * dlp < tol_))
        cont = upd & ~conv & ~under
        dlp = torch.where(cont, dlp_next, dlp)
        kap = torch.clamp(kappa * 1.1, max=1.0)
        kap = torch.where(iacc % 5 == 0, kap / 2.0, kap)
        kappa = torch.where(cont, kap,
                            torch.where(live & ~accept, kappa / 2.0, kappa))
        return [a, kappa, lp, dlp, iters, iacc, done | newly, tol_]

    t = 0

    def run_phase(s, lp_dlp, pm_, stop_at):
        nonlocal t
        while t < maxit and int((~s[6]).sum()) > (stop_at or 0):
            s = step(s, lp_dlp, pm_)
            t += 1
        return s

    caps = _caps(G, (2, 8, 32), 512)
    s = run_phase(state, make_lp(env, mu_state, min_mu, tails=tails), pm,
                  caps[0] if caps else None)
    outer, abs_idx = [], None
    for ci, cap in enumerate(caps):
        loc = compact_live_indices(~s[6], cap)
        outer.append((s, loc))
        s = [v[loc] for v in s]
        abs_idx = loc if abs_idx is None else abs_idx[loc]
        t_sub = None if tails is None else tails[abs_idx]
        lp_sub = make_lp(_rows(env, abs_idx), mu_state[abs_idx], min_mu,
                         tails=t_sub)
        s = run_phase(s, lp_sub, _take(pm, abs_idx),
                      caps[ci + 1] if ci + 1 < len(caps) else None)
    for ostate, loc in reversed(outer):
        full = [v.clone() for v in ostate]
        for f, part in zip(full, s):
            f[loc] = part
        s = full
    return dict(log_alpha=s[0], last_lp=s[2], initial_lp=lp0, iter=s[4])


def _grid_fallback(env, mu_state, grid, disp_cur, need, pm, pv, use_prior,
                   min_mu, make_lp=_make_lp_dlp, tails=None):
    """Two-stage grid search (cpp:468-513) on the `need` genes only
    (compacted); past twice the cap the remaining genes keep their
    line-search value."""
    dtype = env["dtype"]
    G = disp_cur.shape[0]
    cap = min(1 << (max(G // 16, 256) - 1).bit_length(), G)
    gridv = grid.to(dtype)
    n_pts = gridv.shape[0]
    delta = gridv[1] - gridv[0]
    frac = torch.linspace(0.0, 1.0, n_pts, dtype=dtype, device=grid.device)

    def search(idx):
        lp_dlp = make_lp(_rows(env, idx), mu_state[idx], min_mu,
                         tails=None if tails is None else tails[idx])
        g = idx.shape[0]
        pm_c = _take(pm, idx)

        def argmax_over(points):
            best_lp = torch.full((g,), -math.inf, dtype=dtype,
                                 device=idx.device)
            best_a = torch.zeros(g, dtype=dtype, device=idx.device)
            for j in range(points.shape[0]):
                lp, _ = lp_dlp(points[j], use_prior, pm_c, pv)
                better = lp > best_lp
                best_lp = torch.where(better, lp, best_lp)
                best_a = torch.where(better, points[j], best_a)
            return best_a

        a_hat = argmax_over(gridv[:, None].expand(n_pts, g))
        return argmax_over(a_hat[None, :] - delta
                           + 2.0 * delta * frac[:, None])

    def run(cur, sel):
        idx = compact_live_indices(sel, cap)
        la = search(idx)
        out = cur.clone()
        out[idx] = torch.where(sel[idx], torch.exp(la), cur[idx])
        return out

    n = int(need.sum())
    if n == 0:
        return disp_cur
    d1 = run(disp_cur, need)
    if n <= cap:
        return d1
    return run(d1, need & (d1 == disp_cur))


def _gene_est_search(env, mu_state, alpha_init, grid, maxit, min_disp,
                     min_mu, max_disp, make_lp, tails=None):
    """Gene-wise dispersion MLE: line search + no-increase rule + grid
    fallback (R/core.R:765-847)."""
    la0 = torch.log(alpha_init)
    mle = _line_search(env, mu_state, la0, False, la0, 1.0, maxit, min_disp,
                       min_mu, make_lp=make_lp, tails=tails)
    alpha_mle = torch.clamp(torch.exp(mle["log_alpha"]), max=max_disp)
    no_inc = mle["last_lp"] < mle["initial_lp"] \
        + mle["initial_lp"].abs() / 1e6
    dge = torch.where(no_inc, alpha_init, alpha_mle)
    conv = (mle["iter"] < maxit) & (mle["iter"] != 1)
    need_grid = ~conv & (dge > min_disp * 10)
    dge = _grid_fallback(env, mu_state, grid, dge, need_grid,
                         torch.zeros_like(dge), 1.0, False, min_mu,
                         make_lp=make_lp, tails=tails)
    return torch.clamp(dge, min_disp, max_disp), mle["iter"]


def _redo_overflow(env, ovf, ovf_cap, search, outs):
    """Re-run `search` (a function of (block env, idx)) on the genes with a
    count >= HIST_K, exactly, on their rows gathered into a block, and
    write its outputs into `outs` at those genes."""
    idx = compact_live_indices(ovf, ovf_cap)
    redo = search(_rows(env, idx), idx)
    sel = ovf[idx]
    for o, r in zip(outs, redo):
        o[idx] = torch.where(sel, r, o[idx])
    return outs


def _gene_est(env, mu_state, alpha_init, grid, maxit, min_disp, min_mu,
              max_disp, base_make, use_hist, ovf_cap):
    """Gene-wise estimate, on the histogram path (with the exact redo of
    the overflow genes) or the per-sample path."""
    if not use_hist:
        return _gene_est_search(env, mu_state, alpha_init, grid, maxit,
                                min_disp, min_mu, max_disp, base_make)
    tails, max_y = _count_tails(env)
    dge, it = _gene_est_search(env, mu_state, alpha_init, grid, maxit,
                               min_disp, min_mu, max_disp, base_make,
                               tails=tails)
    if ovf_cap > 0:
        dge, it = _redo_overflow(
            env, max_y >= HIST_K, ovf_cap,
            lambda e, idx: _gene_est_search(
                e, mu_state[idx], alpha_init[idx], grid, maxit, min_disp,
                min_mu, max_disp, base_make), [dge, it])
    return dge, it


def _map_search(env, mu_state, disp_init, pm, pv, grid, maxit, min_disp,
                min_mu, max_disp, make_lp, tails=None):
    """MAP shrinkage line search + grid fallback (R/core.R:1016-1063)."""
    res = _line_search(env, mu_state, torch.log(disp_init), True, pm, pv,
                       maxit, min_disp, min_mu, make_lp=make_lp, tails=tails)
    disp_map = torch.exp(res["log_alpha"])
    disp_map = _grid_fallback(env, mu_state, grid, disp_map,
                              res["iter"] >= maxit, pm, pv, True, min_mu,
                              make_lp=make_lp, tails=tails)
    return torch.clamp(disp_map, min_disp, max_disp)


def _map(env, mu_state, disp_init, pm, pv, grid, maxit, min_disp, min_mu,
         max_disp, base_make, use_hist, ovf_cap):
    """MAP search, on the histogram path (+ the exact overflow redo) or
    the per-sample path."""
    if not use_hist:
        return _map_search(env, mu_state, disp_init, pm, pv, grid, maxit,
                           min_disp, min_mu, max_disp, base_make)
    tails, max_y = _count_tails(env)
    dm = _map_search(env, mu_state, disp_init, pm, pv, grid, maxit, min_disp,
                     min_mu, max_disp, base_make, tails=tails)
    if ovf_cap > 0:
        (dm,) = _redo_overflow(
            env, max_y >= HIST_K, ovf_cap,
            lambda e, idx: (_map_search(
                e, mu_state[idx], disp_init[idx], pm[idx], pv, grid, maxit,
                min_disp, min_mu, max_disp, base_make),), [dm])
    return dm


# ---------------------------------------------------------------------------
# streamed IRLS
# ---------------------------------------------------------------------------

def _solve(a, b):
    """Batched solve of a x = b (b: (g, p)); a singular or NaN system
    gives NaN/inf rows instead of an exception for the whole batch."""
    return torch.linalg.solve_ex(a, b[..., None])[0][..., 0]


def _glm_fit(env, beta0, all_zero, alpha, base_mean, llaf, llar, maxit,
             min_mu, with_reduced=False, with_loglik=False):
    """Streamed ridge IRLS + sandwich variances (cpp:282-465, R/core.R:
    1400-1508), shared by the group and covariate designs; optionally the
    log-likelihoods at the unclamped mu for the LRT/QL test, with the
    intercept-only reduced model in closed form and the one-pass
    elementwise difference ll_diff.

    One streamed sweep per iteration: the sweep at beta_k yields both the
    deviance of beta_k (the reference's convergence test on successive
    iterates, shifted by one sweep) and the normal equations for
    beta_{k+1}; sweep 0 also accumulates the beta-independent deviance
    constant."""
    p, dtype = env["p"], env["dtype"]
    G = beta0.shape[0]
    dev = beta0.device
    ridge = env["ridge"]
    y_alpha = torch.where(all_zero, torch.ones_like(alpha), alpha)
    size = 1.0 / y_alpha
    eps = torch.finfo(dtype).eps
    beta_tol = max(1e-8, 30.0 * eps)

    def irls_pass(env_l, d_size, d_alpha, beta, with_const=False):
        g = beta.shape[0]
        A = beta.new_zeros(g, p * p)
        r = beta.new_zeros(g, p)
        dv = beta.new_zeros(g)
        dc = beta.new_zeros(g)
        sz = d_size[:, None]
        for c0, c1 in env_l["bounds"]:
            y = _y_chunk(env_l, c0, c1)
            nfc = _mu_factor(env_l, c0, c1)
            x_c = env_l["x"][c0:c1]
            mu = torch.clamp(nfc * torch.exp(beta @ x_c.T), min=min_mu)
            lm = torch.log(mu)
            mua = d_alpha[:, None] * mu
            # one reciprocal: w = mu*rr, and w*z folds to
            # rr*(mu*log(mu/nf) + y - mu) with no divides
            rr = 1.0 / (1.0 + mua)
            A += (mu * rr) @ env_l["xx"][c0:c1]
            r += (rr * (mu * (lm - torch.log(nfc)) + y - mu)) @ x_c
            # stable difference form of the NB deviance (identical value
            # to cpp:365-382's; the direct lgamma(y+size) form cancels in
            # float32 at size = 1/alpha >> y)
            t = torch.where(y > 0.0, y * lm, torch.zeros_like(y))
            dv += -2.0 * (t - (y + sz) * torch.log1p(mua)).sum(dim=1)
            if with_const:
                dc += (lgamma_diff_centered(y, sz)
                       - torch.lgamma(y + 1.0)).sum(dim=1)
        return A.reshape(g, p, p), r, dv, dc

    def step(k, s, env_l, data):
        beta_prev, beta, dev_prev, iters, dev_out, A_out, active = s
        d_size, d_alpha, d_devc = data
        A, r, dv, _ = irls_pass(env_l, d_size, d_alpha, beta)
        dev_cur = d_devc + dv
        dev_out = torch.where(active, dev_cur, dev_out)
        A_out = torch.where(active[:, None, None], A, A_out)
        ct = (dev_cur - dev_prev).abs() / (dev_cur.abs() + 0.1)
        bad = torch.isnan(ct)
        convd = (ct < beta_tol) & (k > 1)
        if eps > 1e-10:   # float32-only beta-stall exit (ops/irls.py)
            dbeta = (beta - beta_prev).abs().amax(dim=1)
            bmax = beta.abs().amax(dim=1)
            convd = convd | ((dbeta < 32.0 * eps * (1.0 + bmax)) & (k > 1))
        iters = torch.where(active & bad, maxit, iters)
        solve_now = active & ~convd & ~bad & (k < maxit)
        beta_new = _solve(A + ridge, r)
        diverged = beta_new.abs().amax(dim=1) > 30.0
        beta_out = torch.where(solve_now[:, None], beta_new, beta)
        iters = iters + solve_now.to(torch.int32)
        iters = torch.where(solve_now & diverged, maxit, iters)
        dev_prev = torch.where(active, dev_cur, dev_prev)
        return [beta, beta_out, dev_prev, iters, dev_out, A_out,
                solve_now & ~diverged]

    # ---- sweep 0, fused with the deviance constant ----
    A0, r0, dv0, dc = irls_pass(env, size, y_alpha, beta0, with_const=True)
    # in the stable regrouping the n*size*log(size) and n*lgamma(size)
    # terms cancel into the per-sample differences
    dev_const = -2.0 * dc
    dev0 = dev_const + dv0
    # the k = 0 bookkeeping: no convergence test, a NaN deviance stamps
    # maxit and keeps beta0, else solve and count it; divergence stamps
    # maxit
    bad0 = torch.isnan(dev0)
    beta1 = _solve(A0 + ridge, r0)
    div0 = beta1.abs().amax(dim=1) > 30.0
    solve0 = ~bad0
    iters0 = solve0.to(torch.int32)
    iters0 = torch.where(bad0 | (solve0 & div0),
                         torch.full_like(iters0, maxit), iters0)
    state = [beta0, torch.where(solve0[:, None], beta1, beta0), dev0,
             iters0, dev0, A0, solve0 & ~div0]
    data_full = (size, y_alpha, dev_const)

    k = 1

    def run_phase(s, env_l, data, stop_at):
        nonlocal k
        while k <= maxit and int(s[6].sum()) > (stop_at or 0):
            s = step(k, s, env_l, data)
            k += 1
        return s

    caps = _caps(G, (4, 16, 64), 512)
    state = run_phase(state, env, data_full, caps[0] if caps else None)
    outer, abs_idx = [], None
    for ci, cap in enumerate(caps):
        loc = compact_live_indices(state[6], cap)
        outer.append((state, loc))
        state = [v[loc] for v in state]
        abs_idx = loc if abs_idx is None else abs_idx[loc]
        data_sub = tuple(v[abs_idx] for v in data_full)
        nxt = caps[ci + 1] if ci + 1 < len(caps) else None
        state = run_phase(state, _rows(env, abs_idx), data_sub, nxt)
    for ostate, loc in reversed(outer):
        full = [v.clone() for v in ostate]
        for f, part in zip(full, state):
            f[loc] = part
        state = full
    _, beta, _, beta_iter, deviance, A, _ = state

    # sandwich diagonal (cpp:429-455) from the A of the last swept beta
    # (the final beta for converged and maxit rows; the pre-divergence
    # beta for diverged rows, the kernel's kept-mu rule)
    ainv = torch.linalg.inv_ex(A + ridge).inverse
    beta_var = torch.diagonal(ainv @ A @ ainv, dim1=1, dim2=2)
    out = dict(beta=beta, beta_var=beta_var, beta_iter=beta_iter,
               deviance=deviance)

    if with_loglik or with_reduced:
        # log-likelihoods at the UNclamped mu (nbinomLogLike, R/core.R:
        # 2208-2230); mu_reduced = baseMean*sf is the intercept closed
        # form (R/fitNbinomGLMs.R:99-137)
        one = torch.ones_like(llaf)
        af = torch.where(all_zero, one, llaf)
        ar = torch.where(all_zero, one, llar)
        szf, szr = (1.0 / af)[:, None], (1.0 / ar)[:, None]
        ll_f = beta.new_zeros(G)
        ll_r = beta.new_zeros(G)
        ll_d = beta.new_zeros(G)
        for c0, c1 in env["bounds"]:
            y = _y_chunk(env, c0, c1)
            const = -torch.lgamma(y + 1.0)

            def row_terms(mu, inv_a, alp):
                # stable difference form: the final dispersion can sit at
                # min_disp, where 1/alpha = 1e8 and the direct form
                # destroys the QL F statistic in float32
                t = torch.where(y > 0.0, y * torch.log(mu),
                                torch.zeros_like(y))
                return (lgamma_diff_centered(y, inv_a) + const + t
                        - (y + inv_a) * torch.log1p(mu * alp[:, None]))

            nfc = _mu_factor(env, c0, c1)
            tf = row_terms(nfc * torch.exp(beta @ env["x"][c0:c1].T), szf,
                           af)
            ll_f += tf.sum(dim=1)
            if with_reduced:
                mu_r = torch.where(all_zero[:, None], 1.0,
                                   base_mean[:, None] * nfc)
                tr = row_terms(mu_r, szr, ar)
                ll_r += tr.sum(dim=1)
                # accumulated elementwise, the difference is O(1) per
                # sample: its float32 sum keeps ~1e-4 absolute accuracy
                # where (big sum) - (big sum) cancels to ~0.1
                ll_d += (tf - tr).sum(dim=1)
        out["ll_full"] = ll_f
        if with_reduced:
            out["ll_reduced"] = ll_r
            out["ll_diff"] = ll_d
    return out


# ---------------------------------------------------------------------------
# stages
# ---------------------------------------------------------------------------

def _init_dispersion(rough_sum, base_mean, base_var, all_zero, xim, S, p,
                     min_disp, max_disp):
    """rough/moments dispersion start (R/core.R:709-728)."""
    rough = torch.clamp(rough_sum / (S - p), min=0.0)
    moments = (base_var - xim * base_mean) / base_mean ** 2
    a0 = torch.minimum(rough, torch.where(all_zero, rough, moments))
    a0 = torch.where(torch.isnan(a0), torch.full_like(a0, min_disp), a0)
    return torch.clamp(a0, min_disp, max_disp)


def _sc_stage1(env, grid, n_groups, maxit, min_disp, min_mu,
               use_hist=False, ovf_cap=0):
    """Base stats + group means + gene-wise dispersion MLE
    (R/core.R:657-860); (G,) and (G,C) outputs only."""
    counts, dtype = env["counts"], env["dtype"]
    G, S = counts.shape
    C = p = n_groups
    max_disp = float(max(10.0, S))
    sf, cells = env["sf"], env["cells"]
    xim = (1.0 / sf).sum() / S
    z = counts.new_zeros(G, dtype=dtype)
    s_yn, s_yn2, tot = z.clone(), z.clone(), z.clone()
    q_num = counts.new_zeros(G, C, dtype=dtype)
    s_lq = q_num.clone()
    oh_all = torch.nn.functional.one_hot(cells, C).to(dtype)
    n_c = oh_all.sum(dim=0)
    # ---- base stats + group means q (G,C): one streamed pass ----
    for c0, c1 in env["bounds"]:
        y = _y_chunk(env, c0, c1)
        yn = y / sf[None, c0:c1]
        oh = oh_all[c0:c1]
        s_yn += yn.sum(dim=1)
        s_yn2 += (yn * yn).sum(dim=1)
        q_num += yn @ oh
        tot += y.sum(dim=1)
        s_lq += torch.log(yn + 0.1) @ oh
    base_mean = s_yn / S
    base_var = (s_yn2 - S * base_mean ** 2) / (S - 1.0)
    all_zero = tot == 0
    q = q_num / n_c[None, :]
    logq = s_lq / n_c[None, :]

    # ---- dispersion start ----
    q_ls = torch.clamp(q, min=1.0)
    rough_sum = z.clone()
    for c0, c1 in env["bounds"]:
        yn = _y_chunk(env, c0, c1) / sf[None, c0:c1]
        mu_ls = q_ls[:, cells[c0:c1]]
        rough_sum += (((yn - mu_ls) ** 2 - mu_ls) / mu_ls ** 2).sum(dim=1)
    alpha_init = _init_dispersion(rough_sum, base_mean, base_var, all_zero,
                                  xim, S, p, min_disp, max_disp)

    # mu for the dispersion fit: the group mean times sf, clamped (the
    # linearMu fast path, exact for the group design; R/core.R:754-764)
    q_mu = torch.where(all_zero[:, None], 1.0, q)
    dge, dgi = _gene_est(env, q_mu, alpha_init, grid, maxit, min_disp,
                         min_mu, max_disp, _make_lp_dlp, use_hist, ovf_cap)
    return dict(base_mean=base_mean, base_var=base_var, all_zero=all_zero,
                disp_gene_est=dge, disp_gene_iter=dgi, q=q, logq=logq)


def _sc_stage_map(env, grid, q, all_zero, disp_gene_est, disp_fit,
                  disp_prior_var, maxit, min_disp, min_mu,
                  use_hist=False, ovf_cap=0, make_lp=_make_lp_dlp):
    """DESeq2-type MAP shrinkage line search with the log-normal prior
    (R/core.R:1016-1063).  `q`: the group means (group design) or the
    stage-1 betas of mu (make_lp=_make_lp_dlp_x)."""
    max_disp = float(max(10.0, env["S"]))
    mu_state = torch.where(all_zero[:, None], 1.0, q) \
        if make_lp is _make_lp_dlp else q
    disp_init = torch.where(disp_gene_est > 0.1 * disp_fit, disp_gene_est,
                            disp_fit)
    return _map(env, mu_state, disp_init, torch.log(disp_fit),
                disp_prior_var, grid, maxit, min_disp, min_mu, max_disp,
                make_lp, use_hist, ovf_cap)


def _sc_stage_glm(env, beta0, all_zero, dispersion, base_mean, maxit,
                  min_mu, ll_alpha_full=None, ll_alpha_red=None,
                  with_reduced=False, with_loglik=False):
    """Streamed ridge IRLS + sandwich SEs; optionally the intercept-only
    reduced model's closed form and the log-likelihoods for LRT/QL.
    `dispersion` weights the IRLS; the full model's logLike uses
    `ll_alpha_full` (reference quirk: nbinomLogLike runs at
    dispersions(object) even when the betas were fit at the trend,
    R/fitNbinomGLMs.R:180-182) and the reduced closed form
    `ll_alpha_red` (= alpha_hat, R/fitNbinomGLMs.R:103-114)."""
    return _glm_fit(env, beta0, all_zero, dispersion, base_mean,
                    dispersion if ll_alpha_full is None else ll_alpha_full,
                    dispersion if ll_alpha_red is None else ll_alpha_red,
                    maxit, min_mu, with_reduced, with_loglik)


def _group_beta0(logq):
    """IRLS start of the group design: the group means of log(yn + 0.1)
    as intercept + treatment effects."""
    return torch.cat([logq[:, :1], logq[:, 1:] - logq[:, :1]], dim=1)


def _xim_x(env):
    """momentsDispEstimate's xim: mean of 1/sf, or with gene x sample
    factors the mean over samples of 1/colMeans(nf) (R/core.R:2440-2444)."""
    if env["nf"] is None:
        return (1.0 / env["sf"]).sum() / env["S"]
    return (1.0 / env["nf"].mean(dim=0, dtype=env["dtype"])).mean()


def _sc_stage1_x(env, grid, maxit, min_disp, min_mu, use_hist=False,
                 ovf_cap=0, xim=None):
    """Covariate gene-wise stage: base stats + rough/moments start + a
    streamed GLM fit at the starting dispersions for mu + the dispersion
    MLE (R/core.R:657-860 with linearMu=False).  Persistent state per
    gene: the (G,p) betas of mu, never a (G,S).  `xim`: momentsDisp's
    xim over every gene (a block's own is _xim_x of its rows)."""
    counts, dtype, x = env["counts"], env["dtype"], env["x"]
    G, S = counts.shape
    p = env["p"]
    max_disp = float(max(10.0, S))
    xim = _xim_x(env) if xim is None else xim
    # the host starts the mu GLM by QR on log(normCounts + 0.1)
    # (fitNbinomGLMs.R:139-155)
    q_m, r_m = torch.linalg.qr(x)
    xtx = x.T @ x
    z = counts.new_zeros(G, dtype=dtype)
    s_yn, s_yn2, tot = z.clone(), z.clone(), z.clone()
    xty = counts.new_zeros(G, p, dtype=dtype)
    qty = xty.clone()
    # ---- pass 1: base stats + X-projections of the normalized counts ----
    for c0, c1 in env["bounds"]:
        y = _y_chunk(env, c0, c1)
        yn = y / _mu_factor(env, c0, c1)
        s_yn += yn.sum(dim=1)
        s_yn2 += (yn * yn).sum(dim=1)
        tot += y.sum(dim=1)
        xty += yn @ x[c0:c1]
        qty += torch.log(yn + 0.1) @ q_m[c0:c1]
    base_mean = s_yn / S
    base_var = (s_yn2 - S * base_mean ** 2) / (S - 1.0)
    all_zero = tot == 0
    beta_ls = torch.linalg.solve(xtx, xty.T).T           # (G,p) LS fit
    b0 = torch.linalg.solve_triangular(r_m, qty.T, upper=True).T

    # ---- pass 2: rough dispersion residual sum (R/core.R:2422) ----
    rough_sum = z.clone()
    for c0, c1 in env["bounds"]:
        yn = _y_chunk(env, c0, c1) / _mu_factor(env, c0, c1)
        mu_ls = torch.clamp(beta_ls @ x[c0:c1].T, min=1.0)
        rough_sum += (((yn - mu_ls) ** 2 - mu_ls) / mu_ls ** 2).sum(dim=1)
    alpha_init = _init_dispersion(rough_sum, base_mean, base_var, all_zero,
                                  xim, S, p, min_disp, max_disp)

    # ---- mu for the dispersion search: a streamed GLM fit at the
    # starting dispersions (R/core.R:753-764, linearMu=False) ----
    beta_mu = _glm_fit(env, b0, all_zero, alpha_init, base_mean, alpha_init,
                       alpha_init, maxit, min_mu)["beta"]
    dge, dgi = _gene_est(env, beta_mu, alpha_init, grid, maxit, min_disp,
                         min_mu, max_disp, _make_lp_dlp_x, use_hist, ovf_cap)
    return dict(base_mean=base_mean, base_var=base_var, all_zero=all_zero,
                disp_gene_est=dge, disp_gene_iter=dgi, beta_mu=beta_mu,
                beta0=b0)


def _sc_qr_init_x(env):
    """Streamed QR beta start on log(normCounts + 0.1) for a model matrix
    (fitNbinomGLMs.R:139-155): one pass over the counts, (G,p) output."""
    q_m, r_m = torch.linalg.qr(env["x"])
    qty = env["counts"].new_zeros(env["counts"].shape[0], env["p"],
                                  dtype=env["dtype"])
    for c0, c1 in env["bounds"]:
        yn = _y_chunk(env, c0, c1) / _mu_factor(env, c0, c1)
        qty += torch.log(yn + 0.1) @ q_m[c0:c1]
    return torch.linalg.solve_triangular(r_m, qty.T, upper=True).T


# ---------------------------------------------------------------------------
# trend and prior
# ---------------------------------------------------------------------------

def _sc_trend_and_prior(base_mean, disp_gene_est, all_zero, S, p, min_disp,
                        fit_type):
    """Cross-gene trend + dispersion prior.  parametric: the gamma GLM on
    the device (R/core.R:2166-2189).  glmGamPoi: loc_median_fit with the
    closest-index prediction on the host (R/core.R:906-925), G scalars.
    Returns (disp_fit (G,) on the device, coefs or None, var_log_disp,
    disp_prior_var, host columns or None)."""
    dtype, dev = base_mean.dtype, base_mean.device
    if fit_type == "parametric":
        use = (disp_gene_est > 100 * min_disp) & ~all_zero
        coefs, _ = gamma_trend_fit(base_mean, disp_gene_est, use)
        disp_fit = coefs[0] + coefs[1] / torch.where(all_zero, 1.0,
                                                     base_mean)
    elif fit_type == "glmGamPoi":
        from scipy.special import polygamma

        from ..gampoi import loc_median_fit_dev, make_closest_index_disp_fn
        bm = base_mean.double().cpu().numpy()
        dge = disp_gene_est.double().cpu().numpy()
        az = all_zero.cpu().numpy()
        use = (dge > 100 * min_disp) & ~az
        medians = loc_median_fit_dev(bm[use], dge[use], dev, dtype)
        fn = make_closest_index_disp_fn(bm[use], medians)
        fit = np.ones_like(bm)
        fit[~az] = fn(bm[~az])
        # the MAD on the host (the device _masked_median's semantics)
        with np.errstate(divide="ignore", invalid="ignore"):
            resid_h = np.where(az, np.nan, np.log(dge) - np.log(fit))
        med_h = np.nanmedian(resid_h)
        vld = (1.4826 * np.nanmedian(np.abs(resid_h - med_h))) ** 2
        dpv = max(vld - float(polygamma(1, (S - p) / 2.0)), 0.25)

        def t(v):
            return torch.as_tensor(v, dtype=torch.float64).to(
                device=dev, dtype=dtype)

        return (t(fit), None, t(vld), t(dpv),
                dict(bm=bm, dge=dge, az=az, fit=fit))
    else:
        raise ValueError("fused_sc_results supports fit_type='parametric' "
                         "or 'glmGamPoi'")
    resid = torch.log(disp_gene_est) - torch.log(disp_fit)
    med = _masked_median(resid, ~all_zero)
    var_log_disp = (1.4826 * _masked_median((resid - med).abs(),
                                            ~all_zero)) ** 2
    exp_var = trigamma(torch.tensor((S - p) / 2.0, dtype=torch.float64))
    disp_prior_var = torch.clamp(var_log_disp - exp_var.to(dtype=dtype,
                                                           device=dev),
                                 min=0.25)
    return disp_fit, coefs, var_log_disp, disp_prior_var, None


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _counts_on(counts, dev):
    """The counts on `dev` as int32 (6 GB at 30,000 x 50,000), after
    checking that the largest fits."""
    if not torch.is_tensor(counts):
        counts = torch.as_tensor(np.asarray(counts))
    if counts.dtype.is_floating_point or counts.dtype == torch.bool:
        raise ValueError("fused_sc_results takes integer counts, not "
                         f"{counts.dtype}")
    counts = counts.to(dev)
    if counts.dtype != torch.int32:
        if counts.numel() and int(counts.max()) > np.iinfo(np.int32).max:
            raise ValueError("counts past 2^31 - 1 do not fit int32")
        counts = counts.to(torch.int32)
    return counts


def _hist_plan(counts, use_hist, dtype):
    """(use_hist, ovf_cap): the histogram path is on in float32 and off in
    float64 unless use_hist=True asks for it (False turns it off); it is
    declined when more than a quarter of the genes hold a count >= HIST_K,
    and otherwise the overflow genes get a power-of-two redo buffer."""
    G = counts.shape[0]
    on = (dtype == torch.float32) if use_hist is None else bool(use_hist)
    if not on:
        return False, 0, 0
    n_ovf = _n_overflow(counts)
    if n_ovf > G // 4:
        return False, 0, n_ovf
    return True, _ovf_cap(n_ovf, G), n_ovf


def _n_overflow(counts):
    return int((counts.amax(dim=1) >= HIST_K).sum())


def _ovf_cap(n_ovf, G):
    """The overflow redo's power-of-two buffer for n_ovf of G genes."""
    return min(1 << (max(n_ovf, 64) - 1).bit_length(), G) if n_ovf else 0


def fused_sc_results(counts, cells=None, size_factors=None, n_groups=None,
                     grid=None, maxit=100, min_disp_pow=-8, min_mu=1e-6,
                     chunk=DEFAULT_CHUNK, test="Wald",
                     fit_type="parametric", alpha=0.1,
                     independent_filtering=True, mesh=None, quiet=True,
                     design=None, reduced_design=None, norm_factors=None,
                     device=None, dtype=torch.float64, use_hist=None,
                     info=None):
    """Full single-cell-scale DESeq results: the staged streamed pipeline.

    - fit_type="glmGamPoi": the loc_median_fit dispersion trend
      (R/core.R:906-925) + quasi-likelihood dispersion shrinkage
      (R/core.R:1064-1096); with test="LRT" the quasi-likelihood F-test
      (R/core.R:1898-1947) against the intercept-only reduced model (or
      `reduced_design`), with the betas fit at the trend dispersions.
    - fit_type="parametric": the bulk pipeline's gamma trend + MAP line
      search; test="Wald" (z) or "LRT" (chi-square).
    - the tail: no Cook's (the reference disables outlier replacement
      for single cell, R/core.R:297-303), independent filtering + BH
      (R/results.R:638-718).

    A group design takes `cells` (codes) + `n_groups`; any small-p model
    matrix takes `design` (and `reduced_design`, and (G,S)
    `norm_factors`).  Runs on `device` (the card unless "cpu") in `dtype`.
    `use_hist`: None (the histogram path in float32 only), True (also in
    float64) or False; the dispersion estimation runs in SEARCH_DTYPE
    (module docstring).  `info`: a dict that receives the chunk and the
    histogram plan.
    Returns a dict of host numpy columns (the results table +
    diagnostics)."""
    from ..engine import resolve_device
    from ..gampoi import ql_f_test
    from ..results import choose_filter_theta

    dev = resolve_device(device, mesh)
    mesh = as_mesh(mesh) or GeneMesh([dev])
    G, S = counts.shape
    use_x = design is not None
    if norm_factors is not None and not use_x:
        raise ValueError("norm_factors at single-cell scale require the "
                         "design= (model matrix) mode — the group "
                         "factorization assumes shared per-sample "
                         "factors")
    if use_x:
        design = np.asarray(design, np.float64)
        if design.shape[0] != S:
            raise ValueError("design must be (samples, p)")
        p = design.shape[1]
        if reduced_design is not None:
            reduced_design = np.asarray(reduced_design, np.float64)
            rp = reduced_design.shape[1]
            if rp == 1 and np.all(reduced_design == 1.0):
                reduced_design = None    # ~1: intercept closed form
            elif rp >= p:
                raise ValueError("reduced_design must have fewer columns "
                                 "than design")
    else:
        if cells is None or n_groups is None:
            raise ValueError("provide cells+n_groups (group design) or "
                             "design= (arbitrary model matrix)")
        p = n_groups
    if size_factors is None:
        raise ValueError("size_factors are required (estimate on host "
                         "or pass ones)")
    min_disp = 10.0 ** min_disp_pow
    max_disp = max(10.0, S)
    if grid is None:
        grid = np.linspace(np.log(min_disp), np.log(max_disp), 20)
    if test not in ("Wald", "LRT"):
        raise ValueError("test must be 'Wald' or 'LRT'")
    if fit_type == "glmGamPoi" and test == "Wald" and not quiet:
        import warnings
        warnings.warn("glmGamPoi fitType is designed for the LRT "
                      "quasi-likelihood F-test (reference R/core.R:"
                      "347-350); Wald p-values use the QL-mapped "
                      "dispersions")

    def on_dev(v, dt=dtype, d=dev):
        if not torch.is_tensor(v):
            v = torch.as_tensor(np.asarray(v, np.float64))
        return v.to(device=d, dtype=dt)

    counts = _counts_on(counts, dev)
    nf = None if norm_factors is None else on_dev(norm_factors)
    if not use_x:
        cells_d = torch.as_tensor(np.asarray(cells)).to(
            device=dev, dtype=torch.int64) if not torch.is_tensor(cells) \
            else cells.to(device=dev, dtype=torch.int64)
    blocks = mesh.shards(G)
    if not blocks:
        raise ValueError(f"no genes of {G} fall to this process's shards "
                         f"of {mesh}")
    counts_b, nf_b = mesh.split(counts), mesh.split(nf, G)

    def gat(parts):
        return mesh.gather(parts, G)

    def make_env(dt, c, nf_, d):
        """The streamed passes' environment of the counts block `c` (and
        factors `nf_`) on `d` in `dt`, its per-sample rows made from the
        caller's values (the (G,S) counts and factors are shared: a chunk
        is promoted as it is read)."""
        sf_t = on_dev(size_factors, dt, d)
        if use_x:
            return _setup(c, on_dev(design, dt, d), sf_t, chunk, dt,
                          norm_factors=nf_)
        cd = cells_d.to(d)
        return _setup(c, _group_design(cd, n_groups, dt), sf_t, chunk, dt,
                      cells=cd)

    envs = [make_env(dtype, c, nf_, d) for c, nf_, (_, _, d)
            in zip(counts_b, nf_b, blocks)]
    hist_on, ovf_cap, n_ovf = _hist_plan(counts, use_hist, dtype)
    caps = [_ovf_cap(_n_overflow(c), c.shape[0]) if hist_on else 0
            for c in counts_b]
    kw = dict(maxit=maxit, min_disp=min_disp, min_mu=min_mu)
    # the dispersion estimation (stage 1, trend, prior, QL or MAP) runs in
    # SEARCH_DTYPE; the GLM, the test and the tail in the call's dtype
    sdt = SEARCH_DTYPE
    envs_s = envs if sdt == dtype else [
        make_env(sdt, c, nf_, d) for c, nf_, (_, _, d)
        in zip(counts_b, nf_b, blocks)]
    grids_s = [on_dev(grid, sdt, d) for _, _, d in blocks]

    with profiling.stage("sc.stage1", genes=G):
        if use_x:
            # momentsDisp's xim over every gene's factors
            xim = _xim_x(dict(envs_s[0], nf=nf, S=S))
            st1s = [_sc_stage1_x(e, g, **kw, use_hist=hist_on, ovf_cap=cp,
                                 xim=xim.to(e["x"].device))
                    for e, g, cp in zip(envs_s, grids_s, caps)]
        else:
            st1s = [_sc_stage1(e, g, n_groups, **kw, use_hist=hist_on,
                               ovf_cap=cp)
                    for e, g, cp in zip(envs_s, grids_s, caps)]
    all_zero, dge, base_mean_s = (gat([st[k] for st in st1s]) for k in (
        "all_zero", "disp_gene_est", "base_mean"))

    with profiling.stage("sc.trendPrior", genes=G):
        disp_fit, coefs, var_log_disp, disp_prior_var, host = \
            _sc_trend_and_prior(base_mean_s, dge, all_zero, S, p,
                                min_disp, fit_type)
        disp_outlier = torch.log(dge) > torch.log(disp_fit) \
            + 2.0 * torch.sqrt(var_log_disp)
        out = dict(trendCoefs=coefs, dispPriorVar=disp_prior_var,
                   varLogDispEsts=var_log_disp)
        if fit_type == "glmGamPoi":
            # QL shrinkage on the host (G-vector ops; R/core.R:1064-1096)
            from ..gampoi import overdispersion_shrinkage, ql_to_nb_alpha
            bm, az, fitv = host["bm"], host["az"], host["fit"]
            nzm = ~az
            shrink = overdispersion_shrinkage(
                host["dge"][nzm], bm[nzm], S - p, fitv[nzm], device=dev,
                dtype=sdt)
            dm = np.ones(G)
            dm[nzm] = ql_to_nb_alpha(shrink["ql_disp_shrunken"], bm[nzm],
                                     fitv[nzm], min_disp, max_disp)
            disp_map = on_dev(dm, sdt)
            for k_src, k_dst in (("ql_disp_estimate", "qlDispMLE"),
                                 ("ql_disp_trend", "qlDispFit"),
                                 ("ql_disp_shrunken", "qlDispMAP")):
                full = np.full(G, np.nan)
                full[nzm] = shrink[k_src]
                out[k_dst] = full
            out["ql_df0"] = shrink["ql_df0"]
    if fit_type != "glmGamPoi":
        with profiling.stage("sc.MAP", genes=G):
            disp_map = gat([_sc_stage_map(
                e, g, st["beta_mu"] if use_x else st["q"], st["all_zero"],
                st["disp_gene_est"], dfit, disp_prior_var.to(dfit.device),
                **kw, use_hist=hist_on, ovf_cap=cp,
                make_lp=_make_lp_dlp_x if use_x else _make_lp_dlp)
                for e, g, st, dfit, cp in zip(envs_s, grids_s, st1s,
                                              mesh.split(disp_fit), caps)])
    dispersion = torch.where(disp_outlier, dge, disp_map)
    # into the call's dtype
    st1s = [{k: v.to(dtype) if v.is_floating_point() else v
             for k, v in st.items()} for st in st1s]
    dge, disp_fit, disp_map, dispersion = (
        v.to(dtype) for v in (dge, disp_fit, disp_map, dispersion))
    base_mean, base_var, dgi = (gat([st[k] for st in st1s]) for k in (
        "base_mean", "base_var", "disp_gene_iter"))

    # ---- GLM fits ----
    lrt = test == "LRT"
    ql_mode = lrt and fit_type == "glmGamPoi"
    # QL betas are fit at the trend dispersions (alpha_hat = dispFit, as
    # glm_gp); otherwise at the final dispersions
    fit_alpha = disp_fit if ql_mode else dispersion
    # intercept-only reduced model: closed form inside the full fit; a
    # reduced model matrix runs a second streamed fit
    red_closed = lrt and (not use_x or reduced_design is None)
    gkw = dict(maxit=maxit, min_mu=min_mu)
    with profiling.stage("sc.GLM", genes=G):
        glms = []
        for e, st, fa, dsp in zip(envs, st1s, mesh.split(fit_alpha),
                                  mesh.split(dispersion)):
            beta0 = st["beta0"] if use_x else _group_beta0(st["logq"])
            glm = _sc_stage_glm(e, beta0, st["all_zero"], fa,
                                st["base_mean"], ll_alpha_full=dsp,
                                ll_alpha_red=fa, with_reduced=red_closed,
                                with_loglik=lrt, **gkw)
            if lrt and not red_closed:
                d = e["x"].device
                env_r = dict(_setup(e["counts"], on_dev(reduced_design, d=d),
                                    e["sf"], chunk, dtype), nf=e["nf"])
                glm_r = _sc_stage_glm(env_r, _sc_qr_init_x(env_r),
                                      st["all_zero"], fa, st["base_mean"],
                                      ll_alpha_full=dsp, with_loglik=True,
                                      **gkw)
                glm = dict(glm, ll_reduced=glm_r["ll_full"])
            glms.append(glm)
        glm = {k: gat([g[k] for g in glms]) for k in glms[0]}

    with profiling.stage("sc.testTail", genes=G):
        beta, beta_var = glm["beta"], glm["beta_var"]
        beta_log2 = LOG2E * beta
        se_log2 = LOG2E * torch.sqrt(torch.clamp(beta_var, min=0.0))
        nan = torch.tensor(float("nan"), dtype=dtype, device=dev)
        azc = all_zero[:, None]
        pval_full = None
        if lrt:
            df_test = p - (reduced_design.shape[1]
                           if use_x and reduced_design is not None else 1)
            if ql_mode:
                # the quasi-likelihood F-test on the host (G scalars)
                nzm = ~host["az"]
                llf = glm["ll_full"].double().cpu().numpy()
                llr = (llf - glm["ll_diff"].double().cpu().numpy()
                       if "ll_diff" in glm
                       else glm["ll_reduced"].double().cpu().numpy())
                f_stat = np.full(G, np.nan)
                pval = np.full(G, np.nan)
                f_stat[nzm], pval[nzm] = ql_f_test(
                    llf[nzm], llr[nzm], df_test, out["qlDispMAP"][nzm],
                    out["ql_df0"], S - p)
                stat_last, p_last = on_dev(f_stat), on_dev(pval)
            else:
                lrt_stat = 2.0 * (glm["ll_diff"] if "ll_diff" in glm
                                  else glm["ll_full"] - glm["ll_reduced"])
                # pchisq semantics: stat <= 0 gives p = 1
                p_last = torch.special.gammaincc(
                    torch.tensor(df_test / 2.0, dtype=dtype, device=dev),
                    torch.clamp(lrt_stat, min=0.0) / 2.0)
                stat_last = torch.where(all_zero, nan, lrt_stat)
            out["LRTStatistic"] = torch.where(all_zero, nan, stat_last)
            out["LRTPvalue"] = torch.where(all_zero, nan, p_last)
        else:
            stat_full = beta_log2 / se_log2
            pval_full = torch.erfc(stat_full.abs() / math.sqrt(2.0))
            stat_last = torch.where(all_zero, nan, stat_full[:, -1])
            p_last = pval_full[:, -1]
        p_last = torch.where(all_zero, nan, p_last)

        # ---- independent filtering + BH tail (R/results.R:638-718) ----
        if independent_filtering:
            theta = theta_grid_dev(base_mean)
            filter_padj, num_rej, cutoffs = filtered_bh_dev(
                p_last, base_mean, theta, alpha)
            num_rej_h = num_rej.cpu().numpy()
            theta_h = theta.cpu().numpy()
            j, _, _ = choose_filter_theta(theta_h, num_rej_h)
            padj = filter_padj[j]
            out["filterThreshold"] = float(cutoffs[j])
            out["filterTheta"] = float(theta_h[j])
            out["filterNumRej"] = num_rej_h
        else:
            padj = bh_adjust(p_last, ~torch.isnan(p_last))

        def nanmask(v):
            return torch.where(all_zero, nan, v)

        out.update(
            baseMean=base_mean, baseVar=base_var, allZero=all_zero,
            dispGeneEst=nanmask(dge), dispFit=nanmask(disp_fit),
            dispersion=nanmask(dispersion), dispMAP=nanmask(disp_map),
            dispOutlier=disp_outlier & ~all_zero,
            beta=torch.where(azc, nan, beta_log2),
            betaSE=torch.where(azc, nan, se_log2),
            log2FoldChange=nanmask(beta_log2[:, -1]),
            lfcSE=nanmask(se_log2[:, -1]), stat=stat_last, pvalue=p_last,
            padj=padj, betaIter=glm["beta_iter"],
            betaConv=glm["beta_iter"] < maxit,
            dispGeneIter=nanmask(dgi.to(dtype)),
            deviance=nanmask(glm["deviance"]))
        if lrt:
            out["llFull"] = nanmask(glm["ll_full"])
        else:
            out["statMatrix"] = torch.where(azc, nan, stat_full)
            out["pvalueMatrix"] = torch.where(azc, nan, pval_full)
        res = {k: v.cpu().numpy() if torch.is_tensor(v) else v
               for k, v in out.items()}
    if info is not None:
        info.update(chunk=chunk, n_chunks=len(envs[0]["bounds"]),
                    use_hist=hist_on, hist_overflow_genes=n_ovf,
                    ovf_cap=ovf_cap)
    return res


def fused_sc_pipeline(counts, cells, size_factors, grid, n_groups, maxit=100,
                      min_disp_pow=-8, min_mu=1e-6, chunk=DEFAULT_CHUNK,
                      device=None, dtype=torch.float64, mesh=None):
    """The parametric Wald single-cell pipeline (device tensors keyed like
    the bulk fused pipeline): stage 1, the gamma trend and MAD prior, the
    MAP search (these in SEARCH_DTYPE, as in fused_sc_results), the IRLS
    and the Wald test with plain BH (in `dtype`).  `mesh`: a GeneMesh, as
    in fused_sc_results."""
    from ..engine import resolve_device

    dev = resolve_device(device, mesh)
    mesh = as_mesh(mesh) or GeneMesh([dev])
    G, S = counts.shape
    p = n_groups
    min_disp = 10.0 ** min_disp_pow
    counts = _counts_on(counts, dev)
    cells = torch.as_tensor(np.asarray(cells)).to(device=dev,
                                                  dtype=torch.int64)
    sf_h = np.asarray(size_factors, np.float64)
    blocks = list(zip(mesh.split(counts), mesh.shards(G)))

    def gat(parts):
        return mesh.gather(parts, G)

    def make_env(dt, c, d):
        cd = cells.to(d)
        return _setup(c, _group_design(cd, n_groups, dt),
                      torch.as_tensor(sf_h).to(device=d, dtype=dt), chunk,
                      dt, cells=cd)

    sdt = SEARCH_DTYPE
    envs = [make_env(dtype, c, d) for c, (_, _, d) in blocks]
    envs_s = envs if sdt == dtype else [make_env(sdt, c, d)
                                        for c, (_, _, d) in blocks]
    grids_s = [torch.as_tensor(np.asarray(grid, np.float64)).to(
        device=d, dtype=sdt) for _, (_, _, d) in blocks]
    kw = dict(maxit=maxit, min_disp=min_disp, min_mu=min_mu)
    st1s = [_sc_stage1(e, g, n_groups, **kw) for e, g in zip(envs_s, grids_s)]
    all_zero, dge, bm_s = (gat([st[k] for st in st1s]) for k in (
        "all_zero", "disp_gene_est", "base_mean"))
    disp_fit, coefs, var_log_disp, disp_prior_var, _ = _sc_trend_and_prior(
        bm_s, dge, all_zero, S, p, min_disp, "parametric")
    disp_map = gat([_sc_stage_map(e, g, st["q"], st["all_zero"],
                                  st["disp_gene_est"], dfit,
                                  disp_prior_var.to(dfit.device), **kw)
                    for e, g, st, dfit in zip(envs_s, grids_s, st1s,
                                              mesh.split(disp_fit))])
    disp_outlier = torch.log(dge) > torch.log(disp_fit) \
        + 2.0 * torch.sqrt(var_log_disp)
    dispersion = torch.where(disp_outlier, dge, disp_map)
    base_mean, base_var = (gat([st[k] for st in st1s]).to(dtype)
                           for k in ("base_mean", "base_var"))
    dge, disp_fit, disp_map, dispersion = (
        v.to(dtype) for v in (dge, disp_fit, disp_map, dispersion))
    glms = [_sc_stage_glm(e, _group_beta0(st["logq"].to(dtype)),
                          st["all_zero"], dsp, st["base_mean"].to(dtype),
                          maxit, min_mu)
            for e, st, dsp in zip(envs, st1s, mesh.split(dispersion))]
    glm = {k: gat([g[k] for g in glms]) for k in glms[0]}
    beta_log2 = LOG2E * glm["beta"]
    se_log2 = LOG2E * torch.sqrt(torch.clamp(glm["beta_var"], min=0.0))
    stat = beta_log2 / se_log2
    pval = torch.erfc(stat.abs() / math.sqrt(2.0))
    nan = torch.tensor(float("nan"), dtype=dtype, device=dev)
    azc = all_zero[:, None]
    padj = bh_adjust(torch.where(all_zero, nan, pval[:, -1]), ~all_zero)

    def nanmask(v):
        return torch.where(all_zero, nan, v)

    return dict(
        baseMean=base_mean, baseVar=base_var, allZero=all_zero,
        dispGeneEst=nanmask(dge), dispFit=nanmask(disp_fit),
        dispersion=nanmask(dispersion), dispMAP=nanmask(disp_map),
        dispOutlier=disp_outlier & ~all_zero, trendCoefs=coefs,
        dispPriorVar=disp_prior_var, varLogDispEsts=var_log_disp,
        beta=torch.where(azc, nan, beta_log2),
        betaSE=torch.where(azc, nan, se_log2),
        stat=torch.where(azc, nan, stat), pvalue=torch.where(azc, nan, pval),
        betaIter=glm["beta_iter"], betaConv=glm["beta_iter"] < maxit,
        deviance=nanmask(glm["deviance"]), padjLast=padj)
