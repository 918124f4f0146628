"""The beta prior variance on the device for the fused betaPrior route.

Port of the JAX package's parallel/priordev.py: estimateBetaPriorVar's
weighted-quantile matching (reference R/core.R:1601-1689 with the vendored
Hmisc wtd.quantile, R/core.R:2762-2914; the host estimator is wald.py).

Hmisc collapses duplicate values (wtd.table) before its right-continuous
step lookup.  With ties, the first sorted index whose cumulative weight
reaches the target carries the same value the collapsed table would, so a
plain sort, cumsum and left-sided search is exact
(torch.searchsorted(..., right=False)).

The quantile is taken in float64 whatever the pipeline's dtype: a float32
cumsum over tens of thousands of weights rounds the running total, and a
target that falls on a step can then pick the neighbouring index (the
float32 and float64 picks are compared on the card by chip_smoke.py's
betaPrior phase).
"""

from __future__ import annotations

import math

import torch


def wtd_quantile_dev(x, w, prob):
    """Hmisc wtd.quantile(type='quantile', normwt=TRUE) of x under weights
    w at one probability, in x's dtype; entries with w == 0 are excluded
    (callers encode the |beta| < 10 mask as w = 0)."""
    incl = w > 0
    n = incl.sum().to(x.dtype)
    xs_key = torch.where(incl, x, torch.full_like(x, math.inf))
    order = torch.argsort(xs_key, stable=True)
    xs = xs_key[order]
    ws = w[order]
    ws = ws * n / ws.sum()                       # normwt
    cumw = torch.cumsum(ws, dim=0)
    o = 1.0 + (n - 1.0) * prob
    low = torch.clamp(torch.floor(o), min=1.0)
    high = torch.minimum(low + 1.0, n)
    frac = torch.remainder(o, 1.0)
    last = x.shape[0] - 1
    idx_low = torch.clamp(torch.searchsorted(cumw, low.reshape(1),
                                             right=False), 0, last)
    idx_high = torch.clamp(torch.searchsorted(cumw, high.reshape(1),
                                              right=False), 0, last)
    return ((1.0 - frac) * xs[idx_low] + frac * xs[idx_high])[0]


def match_weighted_upper_quantile_var_dev(beta_col, weights,
                                          upper_quantile=0.05):
    """matchWeightedUpperQuantileForVariance (R/core.R:2416-2419) on the
    device, in float64: sd = wtd.quantile(|beta|, 1 - q) / qnorm(1 - q/2),
    var = sd^2.  Entries with |beta| >= 10 or not finite are excluded
    (w = 0), estimateBetaPriorVar's useFinite mask (R/core.R:1648-1666).
    Returns a float64 scalar tensor."""
    from scipy.stats import norm
    z = float(norm.ppf(1.0 - upper_quantile / 2.0))
    b = beta_col.double()
    finite = torch.isfinite(b) & (b.abs() < 10.0)
    w = torch.where(finite, weights.double(), torch.zeros_like(b))
    q = wtd_quantile_dev(torch.where(finite, b, torch.zeros_like(b)).abs(),
                         w, 1.0 - upper_quantile)
    return (q / z) ** 2
