"""On-device independent filtering: theta-grid filtered BH.

The heavy part of pvalueAdjustment (reference R/results.R:638-718 and the
vendored genefilter filtered_p, R/results.R:721-740): a 50-point theta grid
of baseMean quantile cutoffs, BH within each filtered subset, and the
rejection count per cutoff.  The p-values are sorted once; each cutoff then
needs a cumsum (subset ranks) and a reverse cummin over the shared order.
The final cutoff choice (lowess over 50 scalars) stays on the host
(results.choose_filter_theta).
"""

from __future__ import annotations

import torch


def quantile_type7(sorted_v, q):
    """R type-7 quantile of a pre-sorted vector at probabilities q."""
    n = sorted_v.shape[0]
    h = (n - 1) * q
    lo = torch.clamp(torch.floor(h).to(torch.int64), 0, n - 1)
    hi = torch.clamp(lo + 1, 0, n - 1)
    frac = h - lo.to(h.dtype)
    return sorted_v[lo] + frac * (sorted_v[hi] - sorted_v[lo])


def theta_grid_dev(filter_stat, n_theta=50):
    """Default theta grid (reference R/results.R:645-649): R's
    seq(lower, upper, length.out=n), lower + i * by with the last point
    set to upper, in float64 (so bit-equal to the host flow's np.linspace),
    then in filter_stat's dtype."""
    G = filter_stat.shape[0]
    lower = (filter_stat == 0).to(torch.float64).sum() / G
    upper = torch.where(lower < 0.95, torch.full_like(lower, 0.95),
                        torch.ones_like(lower))
    by = (upper - lower) / (n_theta - 1)
    t = lower + torch.arange(n_theta, dtype=torch.float64,
                             device=filter_stat.device) * by
    t[-1] = upper
    return t.to(filter_stat.dtype)


def _rev_cummin(v):
    return torch.flip(torch.cummin(torch.flip(v, dims=(-1,)), dim=-1).values,
                      dims=(-1,))


def filtered_bh_dev(pvalue, filter_stat, theta, alpha):
    """(filter_padj (T,G), num_rej (T,), cutoffs (T,)) on device.

    For each theta: cutoff = type-7 quantile of filter_stat; BH over the
    genes with filter_stat >= cutoff and a finite p (NaN p stays NaN, as R's
    p.adjust keeps NA)."""
    G = pvalue.shape[0]
    dtype = pvalue.dtype
    cutoffs = quantile_type7(torch.sort(filter_stat).values, theta)
    finite = ~torch.isnan(pvalue)
    pv = torch.where(finite, pvalue, torch.full_like(pvalue, float("inf")))
    order = torch.sort(pv, stable=True).indices
    p_sorted = pv[order]
    f_sorted = filter_stat[order]
    fin_sorted = finite[order]

    valid = fin_sorted[None, :] & (f_sorted[None, :] >= cutoffs[:, None])
    n = valid.to(dtype).sum(dim=1, keepdim=True)
    rank = torch.cumsum(valid.to(dtype), dim=1)
    scaled = torch.where(valid, p_sorted[None, :] * n / rank,
                         torch.full_like(rank, float("inf")))
    adj = torch.clamp(_rev_cummin(scaled), max=1.0)
    padj_sorted = torch.where(valid, adj, torch.full_like(adj, float("nan")))
    filter_padj = torch.empty_like(padj_sorted)
    filter_padj[:, order] = padj_sorted
    num_rej = torch.where(valid, (adj < alpha).to(dtype),
                          torch.zeros_like(adj)).sum(dim=1)
    return filter_padj, num_rej, cutoffs


def bh_adjust(p, valid):
    """BH over the valid entries; NaN elsewhere."""
    G = p.shape[0]
    n = valid.sum()
    pv = torch.where(valid, p, torch.full_like(p, float("inf")))
    order = torch.sort(pv, stable=True).indices
    ranked = pv[order]
    i = torch.arange(1, G + 1, dtype=p.dtype, device=p.device)
    inf = torch.full_like(ranked, float("inf"))
    scaled = torch.where(torch.isfinite(ranked), ranked * n / i, inf)
    adj = torch.clamp(_rev_cummin(scaled), max=1.0)
    out = torch.empty_like(adj)
    out[order] = adj
    return torch.where(valid, out, torch.full_like(out, float("nan")))
