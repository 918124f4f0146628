"""glmGamPoi-style quasi-likelihood machinery, implemented natively.

The reference dispatches fitType="glmGamPoi" to the external glmGamPoi
package (Ahlmann-Eltze & Huber 2020) at three points:

1. gene-wise dispersion MLE (R/core.R:789-816) — same Cox-Reid-adjusted
   NB profile MLE objective our batched line-search kernel already
   optimizes, so the gene-est stage reuses it (the 13x speed claim of
   glmGamPoi on CPU is moot on TPU where all genes fit in one batched
   program);
2. dispersion trend via loc_median_fit (R/core.R:906-925) — a sliding-
   window median over mean-sorted genes with nearest-mean prediction;
3. quasi-likelihood shrinkage (R/core.R:1064-1096) via
   overdispersion_shrinkage: QL dispersions relative to the trend,
   empirical-Bayes squeezed with an estimated prior df (the
   limma/edgeR-QL squeezeVar family: Lund et al. 2012, Smyth 2004),
   plus the QL F-test in nbinomLRT (R/core.R:1898-1947).

This module implements (2), (3) and the F-test natively; dispersions.py
and lrt.py wire them into the pipeline under fit_type="glmGamPoi".

A copy of the JAX package's numpy/scipy module (deseq2_tpu/gampoi.py):
these are (G,)-vector operations, fitted on the host in both packages.
Beside it, loc_median_fit_dev: the sliding median's window selection on
a device (the JAX package keeps it in parallel/sc.py), which the trend
and the QL shrinkage of both engines use.
DESeq2 maps QL dispersions back to NB alphas via
alpha = (ql*(m + m^2 d) - m)/m^2  (R/core.R:1075,1094), i.e.
ql = (1 + m*alpha)/(1 + m*d) — the per-gene NB variance ratio vs the
trend — which fixes the forward map used here.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import digamma, polygamma
from scipy.stats import f as f_dist


# ---------------------------------------------------------------------------
# loc_median_fit
# ---------------------------------------------------------------------------

def loc_median_fit(x, y, fraction=0.1, npoints=None, weighted=True):
    """Sliding-window (weighted) median of y over x-sorted order
    (glmGamPoi::loc_median_fit behavior).

    Returns fitted values aligned with the input order.  Large inputs
    take a vectorized path (strided windows + chunked row sort, torch's
    multithreaded stable sort when available) with selection semantics
    identical to the scalar loop — at 30k genes the loop costs ~9 s,
    a third of the whole streamed single-cell QL pipeline.
    """
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n = len(x)
    if npoints is None:
        npoints = max(int(np.round(fraction * n)), 2)
    npoints = min(npoints, n)
    order = np.argsort(x, kind="stable")
    ys = y[order]
    half = npoints // 2
    if n >= 4096:
        med = _sliding_median_vec(ys, n, npoints, half, weighted)
    else:
        med = np.empty(n)
        for i in range(n):
            lo = max(0, i - half)
            hi = min(n, lo + npoints)
            lo = max(0, hi - npoints)
            window = ys[lo:hi]
            if weighted:
                # tricube weights on window position
                rel = (np.arange(lo, hi) - i) / max(half, 1)
                w = (1 - np.minimum(np.abs(rel), 1.0) ** 3) ** 3
                med[i] = _weighted_median(window, w)
            else:
                med[i] = np.median(window)
    out = np.empty(n)
    out[order] = med
    return out


def _row_stable_sort(W):
    """Row-wise argsort.  Stability does not affect the output here:
    tied window values return the same median value whichever tie wins
    (the cum-weight crossing lands inside the tied run), so the fast
    unstable quicksort is safe."""
    return np.argsort(W, axis=1)


def _sliding_median_vec(ys, n, npoints, half, weighted, chunk_rows=2048):
    """Vectorized sliding (weighted) median over x-sorted values.

    Windows are the same [lo, lo+npoints) slices as the scalar loop
    (lo = clip(i - half, 0, n - npoints)); the weighted-median pick is
    the same first-index-where-cumw>=half rule as _weighted_median."""
    k = npoints
    lo_all = np.clip(np.arange(n) - half, 0, n - k)
    Wview = np.lib.stride_tricks.sliding_window_view(ys, k)  # (n-k+1, k)
    med = np.empty(n)
    ar_k = np.arange(k, dtype=np.float64)
    for s in range(0, n, chunk_rows):
        e = min(s + chunk_rows, n)
        lo = lo_all[s:e]
        Wc = Wview[lo]                                # (rows, k) copy-free
        if not weighted:
            med[s:e] = np.median(Wc, axis=1)
            continue
        off = (np.arange(s, e) - lo).astype(np.float64)
        rel = (ar_k[None, :] - off[:, None]) / max(half, 1)
        wts = (1.0 - np.minimum(np.abs(rel), 1.0) ** 3) ** 3
        idx = _row_stable_sort(Wc)
        vs = np.take_along_axis(Wc, idx, axis=1)
        ws = np.take_along_axis(wts, idx, axis=1)
        cw = np.cumsum(ws, axis=1)
        tot = cw[:, -1]
        # np.searchsorted(cw, 0.5*tot, side='left') == first cw >= t
        pick = (cw >= 0.5 * tot[:, None]).argmax(axis=1)
        pick = np.minimum(pick, k - 1)
        row_med = vs[np.arange(e - s), pick]
        bad = tot <= 0
        if bad.any():
            row_med[bad] = np.median(Wc[bad], axis=1)
        med[s:e] = row_med
    return med


def _weighted_median(v, w):
    o = np.argsort(v, kind="stable")
    v, w = v[o], w[o]
    cw = np.cumsum(w)
    if cw[-1] <= 0:
        return np.median(v)
    idx = np.searchsorted(cw, 0.5 * cw[-1])
    return v[min(idx, len(v) - 1)]


def _loc_median_window_dev(ys, npoints):
    """Sliding tricube-weighted median over x-sorted values, on the device.

    The windows and the first-crossing pick of loc_median_fit's
    scalar loop (glmGamPoi::loc_median_fit contract).  The pick is an
    exact binary search in bit space: for positive floats the integer bit
    pattern orders as the values do, so 32/64 halving steps bring hi to
    the smallest window value v* with W(<= v*) >= half, the first-crossing
    element of the sorted-cumsum formulation, ties included."""
    n = ys.shape[0]
    dev, dtype = ys.device, ys.dtype
    half_w = npoints // 2
    ar_n = torch.arange(n, device=dev)
    lo_i = torch.clamp(ar_n - half_w, 0, n - npoints)
    Wc = ys[lo_i[:, None] + torch.arange(npoints, device=dev)[None, :]]
    off = (ar_n - lo_i).to(dtype)
    rel = (torch.arange(npoints, dtype=dtype, device=dev)[None, :]
           - off[:, None]) / max(half_w, 1)
    wts = (1.0 - torch.clamp(rel.abs(), max=1.0) ** 3) ** 3
    half = 0.5 * wts.sum(dim=1)
    f64 = dtype == torch.float64
    Wb = Wc.view(torch.int64 if f64 else torch.int32)  # ys > 0: ordered
    lo = Wb.amin(dim=1) - 1                             # predicate false
    hi = Wb.amax(dim=1)                                 # predicate true
    zero = torch.zeros((), dtype=dtype, device=dev)
    for _ in range(64 if f64 else 32):
        mid = lo + (hi - lo) // 2
        ok = torch.where(Wb <= mid[:, None], wts, zero).sum(dim=1) >= half
        lo, hi = torch.where(ok, lo, mid), torch.where(ok, mid, hi)
    return hi.view(dtype)


def loc_median_fit_dev(x, y, device="cpu", dtype=torch.float64,
                       fraction=0.1):
    """loc_median_fit with the window stage on `device` for inputs of
    4,096 points or more (the same windows, weights and pick; the values
    selected in `dtype`; in float64 equal to loc_median_fit).  Every
    glmGamPoi trend and QL shrinkage of the port uses it: the host's
    sort-based windows took 28 s of each at 60,000 genes (numpy over
    60,000 x 6,000 windows)."""
    n = len(x)
    if n < 4096:
        return loc_median_fit(x, y)
    npoints = min(max(int(np.round(fraction * n)), 2), n)
    order = np.argsort(x, kind="stable")
    ys = torch.as_tensor(np.asarray(y, np.float64)[order]).to(
        device=device, dtype=dtype)
    out = np.empty(n)
    out[order] = _loc_median_window_dev(ys, npoints).double().cpu().numpy()
    return out


def make_closest_index_disp_fn(base_means, medians):
    """Nearest-base-mean prediction used by the reference's glmGamPoi
    dispersion function (R/core.R:913-925)."""
    order = np.argsort(base_means, kind="stable")
    sorted_bm = np.asarray(base_means)[order]
    ordered_medians = np.asarray(medians)[order]

    def fn(means):
        means = np.atleast_1d(np.asarray(means, dtype=np.float64))
        iv = np.searchsorted(sorted_bm, means, side="right")
        left = np.clip(iv - 1, 0, len(sorted_bm) - 1)
        right = np.clip(iv, 0, len(sorted_bm) - 1)
        dist_left = np.abs(means - sorted_bm[left])
        dist_right = np.abs(sorted_bm[right] - means)
        idx = np.where(dist_left <= dist_right, left, right)
        return ordered_medians[idx]

    return fn


# ---------------------------------------------------------------------------
# empirical-Bayes variance squeezing (limma fitFDist / squeezeVar family)
# ---------------------------------------------------------------------------

def trigamma_inverse(x):
    """Solve trigamma(y) = x by Newton iteration (limma's algorithm)."""
    x = np.asarray(x, dtype=np.float64)
    y = 0.5 + 1.0 / x
    for _ in range(50):
        tri = polygamma(1, y)
        dif = tri * (1.0 - tri / x) / polygamma(2, y)
        y = y + dif
        if np.all(np.abs(dif) / np.maximum(y, 1e-12) < 1e-8):
            break
    return y


def fit_f_dist(s2, df1, s20_trend=None):
    """Moment-match log(s2) ~ log(s20 * F(df1, df0)): estimate the prior
    df0 and scale s20.  With a trend, s20_trend supplies the per-gene
    scale and only df0 is estimated.  Returns (s20 array, df0 scalar)."""
    s2 = np.asarray(s2, dtype=np.float64)
    ok = np.isfinite(s2) & (s2 > 0)
    z = np.log(s2[ok])
    if s20_trend is not None:
        z = z - np.log(np.asarray(s20_trend, dtype=np.float64)[ok])
    e = z - digamma(df1 / 2.0) + np.log(df1 / 2.0)
    emean = e.mean()
    n = len(e)
    evar = np.sum((e - emean) ** 2) / max(n - 1, 1) - polygamma(1, df1 / 2.0)
    if evar > 0:
        df0 = 2.0 * float(trigamma_inverse(evar))
        s20_scalar = np.exp(emean + digamma(df0 / 2.0) - np.log(df0 / 2.0))
    else:
        df0 = np.inf
        s20_scalar = np.exp(emean)
    if s20_trend is not None:
        s20 = s20_scalar * np.asarray(s20_trend, dtype=np.float64)
    else:
        s20 = np.full(len(s2), s20_scalar)
    return s20, df0


def squeeze_var(s2, df1, s20, df0):
    """Posterior (squeezed) variances (limma squeezeVar)."""
    s2 = np.asarray(s2, dtype=np.float64)
    if np.isinf(df0):
        return np.asarray(s20, dtype=np.float64) * np.ones_like(s2)
    return (df0 * np.asarray(s20) + df1 * s2) / (df0 + df1)


def overdispersion_shrinkage(disp_est, gene_means, df, disp_trend,
                             device="cpu", dtype=torch.float64):
    """Quasi-likelihood dispersion shrinkage
    (glmGamPoi::overdispersion_shrinkage contract as consumed by the
    reference at R/core.R:1064-1096).  The QL trend's windows run through
    loc_median_fit_dev on `device` in `dtype`.

    Returns dict(ql_disp_estimate, ql_disp_trend, ql_disp_shrunken,
    ql_df0)."""
    disp_est = np.asarray(disp_est, dtype=np.float64)
    gene_means = np.asarray(gene_means, dtype=np.float64)
    disp_trend = np.asarray(disp_trend, dtype=np.float64)
    m = gene_means
    # per-gene NB variance ratio vs the trend (see module docstring)
    ql_disp_estimate = (1.0 + m * disp_est) / (1.0 + m * disp_trend)
    # QL trend over mean-sorted genes
    ql_disp_trend = loc_median_fit_dev(m, ql_disp_estimate, device, dtype)
    ql_disp_trend = np.maximum(ql_disp_trend, 1e-8)
    # empirical-Bayes squeeze of the ratio toward the trend
    s20, df0 = fit_f_dist(ql_disp_estimate, df1=max(df, 1),
                          s20_trend=ql_disp_trend)
    ql_disp_shrunken = squeeze_var(ql_disp_estimate, max(df, 1), s20, df0)
    return dict(ql_disp_estimate=ql_disp_estimate,
                ql_disp_trend=ql_disp_trend,
                ql_disp_shrunken=ql_disp_shrunken,
                ql_df0=df0)


def ql_to_nb_alpha(ql_disp, gene_means, disp_trend, min_disp, max_disp):
    """alpha giving the same NB variance as a QL dispersion relative to
    the trend (R/core.R:1075,1094)."""
    m = np.asarray(gene_means, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = (ql_disp * (m + m ** 2 * disp_trend) - m) / m ** 2
    return np.clip(alpha, min_disp, max_disp)


# ---------------------------------------------------------------------------
# quasi-likelihood F-test
# ---------------------------------------------------------------------------

def ql_f_test(ll_full, ll_reduced, df_test, ql_disp_shrunken, ql_df0,
              df_resid):
    """QL F-test (glmGamPoi::test_de contract, consumed at
    R/core.R:1930-1933): F = (deviance drop / df_test) / ql_disp,
    p = upper tail of F(df_test, ql_df0 + df_resid)."""
    dev_drop = 2.0 * (np.asarray(ll_full) - np.asarray(ll_reduced))
    with np.errstate(divide="ignore", invalid="ignore"):
        f_stat = (dev_drop / df_test) / np.asarray(ql_disp_shrunken)
    f_stat = np.maximum(f_stat, 0.0)
    df2 = (ql_df0 + df_resid) if np.isfinite(ql_df0) else np.inf
    if np.isinf(df2):
        from scipy.stats import chi2
        pval = chi2.sf(f_stat * df_test, df_test)
    else:
        pval = f_dist.sf(f_stat, df_test, df2)
    return f_stat, pval
