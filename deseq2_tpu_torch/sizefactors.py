"""Size-factor estimation: median-of-ratios and variants (the JAX
package's sizefactors.py).

Reference: estimateSizeFactorsForMatrix (R/core.R:535-578), the
estimateSizeFactors method (R/methods.R:363-498), estimateNormFactors
(R/core.R:2159-2163), estimateSizeFactorsIterate (R/core.R:2589-2622).

With the default location function (the median) the log ratios and the
per-sample medians are taken on the counts' device; a user `locfunc`
runs the JAX package's numpy loop on the host.  The iterate type
alternates ~ 1 mean-trend dispersion fits (dispersions.py, on the device)
with L-BFGS-B over the log size factors on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import resolve_device
from .hostdev import as_t, to_np


def _median_dev(v, mask):
    """Per-column median over the masked entries (np.median's average of
    the two middle values for an even count)."""
    from .parallel.fused import nanmedian
    return nanmedian(torch.where(mask, v, torch.full_like(v, float("nan"))))


def size_factors_for_matrix(counts, locfunc=None, geo_means=None,
                            control_genes=None, type="ratio", device=None):
    """Median-of-ratios size factors (reference R/core.R:535-578).

    sf_j = exp(locfunc_i(log K_ij - loggeomeans_i)) over genes with finite
    log-geo-mean and positive count.  `counts`: (G,S) numpy or tensor;
    `device`: where the default (median) path runs (counts' own device
    for a tensor, else the card unless the caller names another)."""
    if type not in ("ratio", "poscounts"):
        raise ValueError("type must be 'ratio' or 'poscounts'")
    if locfunc is not None:
        return _size_factors_host(to_np(counts), locfunc, geo_means,
                                  control_genes, type)
    dev = counts.device if torch.is_tensor(counts) else \
        resolve_device(device)
    c = as_t(counts, dev)
    incoming_geo_means = geo_means is not None
    logc = torch.log(c)
    if not incoming_geo_means:
        if type == "ratio":
            loggeomeans = logc.mean(dim=1)
        else:  # poscounts: zeros contribute log(1)=0; all-zero rows -> -inf
            lc = torch.where(torch.isfinite(logc), logc,
                             torch.zeros_like(logc))
            loggeomeans = lc.mean(dim=1)
            loggeomeans = torch.where(c.sum(dim=1) == 0,
                                      torch.full_like(loggeomeans,
                                                      -float("inf")),
                                      loggeomeans)
    else:
        geo_means = np.asarray(geo_means, dtype=np.float64)
        if len(geo_means) != c.shape[0]:
            raise ValueError(
                "geoMeans should be as long as the number of rows of counts")
        with np.errstate(divide="ignore"):
            loggeomeans = as_t(np.log(geo_means), dev)
    if bool(torch.isinf(loggeomeans).all()):
        raise ValueError(
            "every gene contains at least one zero, cannot compute log "
            "geometric means")
    if control_genes is not None:
        idx = np.asarray(control_genes)
        if idx.dtype == bool:
            idx = np.where(idx)[0]
        idx = torch.as_tensor(idx, device=dev)
        loggeomeans, c, logc = loggeomeans[idx], c[idx], logc[idx]
    sel = torch.isfinite(loggeomeans)[:, None] & (c > 0)
    sf = torch.exp(_median_dev(logc - loggeomeans[:, None], sel))
    sf = to_np(sf)
    if incoming_geo_means:
        # stabilize to geometric mean 1 (R/core.R:573-576)
        sf = sf / np.exp(np.mean(np.log(sf)))
    return sf


def _size_factors_host(counts, locfunc, geo_means, control_genes, type):
    """The JAX package's numpy loop, for a user location function."""
    counts = np.asarray(counts, dtype=np.float64)
    incoming_geo_means = geo_means is not None
    with np.errstate(divide="ignore"):
        if not incoming_geo_means:
            if type == "ratio":
                loggeomeans = np.mean(np.log(counts), axis=1)
            else:
                lc = np.log(counts)
                lc[~np.isfinite(lc)] = 0.0
                loggeomeans = np.mean(lc, axis=1)
                loggeomeans[counts.sum(axis=1) == 0] = -np.inf
        else:
            geo_means = np.asarray(geo_means, dtype=np.float64)
            if len(geo_means) != counts.shape[0]:
                raise ValueError("geoMeans should be as long as the number "
                                 "of rows of counts")
            loggeomeans = np.log(geo_means)
    if np.all(np.isinf(loggeomeans)):
        raise ValueError(
            "every gene contains at least one zero, cannot compute log "
            "geometric means")
    if control_genes is not None:
        idx = np.asarray(control_genes)
        if idx.dtype == bool:
            idx = np.where(idx)[0]
        loggeomeans, counts = loggeomeans[idx], counts[idx]
    S = counts.shape[1]
    sf = np.empty(S)
    with np.errstate(divide="ignore"):
        logc = np.log(counts)
    for j in range(S):
        sel = np.isfinite(loggeomeans) & (counts[:, j] > 0)
        sf[j] = np.exp(locfunc(logc[sel, j] - loggeomeans[sel]))
    if incoming_geo_means:
        sf = sf / np.exp(np.mean(np.log(sf)))
    return sf


def estimate_norm_factors(counts, norm_matrix, locfunc=None, geo_means=None,
                          control_genes=None, device=None):
    """Gene x sample normalization factors (reference R/core.R:2159-2163)."""
    norm_matrix = np.asarray(norm_matrix, np.float64)
    sf = size_factors_for_matrix(np.asarray(counts, float) / norm_matrix,
                                 locfunc=locfunc, geo_means=geo_means,
                                 control_genes=control_genes, device=device)
    nf = norm_matrix * sf[None, :]
    return nf / np.exp(np.mean(np.log(nf), axis=1))[:, None]


def estimate_size_factors(dds, type="ratio", locfunc=None, geo_means=None,
                          control_genes=None, norm_matrix=None, quiet=True,
                          device=None):
    """The estimateSizeFactors method (reference R/methods.R:363-498).

    - avgTxLength assay (tximport ingestion) takes precedence and produces
      gene x sample normalization factors (R/methods.R:383-391)
    - normMatrix option multiplies in a user normalization matrix
    - type='iterate' runs the alternating likelihood maximization

    `device`: where the counts' log ratios and medians are taken (and, for
    type='iterate', the dispersion fits run); the card by default."""
    from .hostdev import counts_t
    dev = resolve_device(device)
    dds = dds.copy()
    if type == "iterate":
        dds.size_factors = size_factors_iterate(dds, device=dev)
        return dds
    if "avgTxLength" in dds.assays:
        dds.normalization_factors = estimate_norm_factors(
            dds.counts, dds.assays["avgTxLength"], locfunc=locfunc,
            geo_means=geo_means, control_genes=control_genes, device=dev)
        return dds
    if norm_matrix is not None:
        dds.normalization_factors = estimate_norm_factors(
            dds.counts, norm_matrix, locfunc=locfunc, geo_means=geo_means,
            control_genes=control_genes, device=dev)
        return dds
    counts = counts_t(dds, dev) if locfunc is None else dds.counts
    dds.size_factors = size_factors_for_matrix(
        counts, locfunc=locfunc, geo_means=geo_means,
        control_genes=control_genes, type=type)
    return dds


def size_factors_iterate(dds, niter=10, quantile_q=0.05, device=None):
    """Iterative size factors by alternating ~1 dispersion fits with
    L-BFGS-B maximization of a trimmed NB likelihood over log sf
    (reference R/core.R:2589-2622)."""
    import scipy.optimize

    from .dispersions import estimate_dispersions
    from .formula import parse_formula
    from .glm import nb_logpmf_np

    dev = resolve_device(device)
    obj = dds.copy()
    obj.design = parse_formula("~ 1")
    S = obj.n_samples
    sf = np.ones(S)
    idx = obj.counts.sum(axis=1) > 0
    cts = obj.counts[idx].astype(np.float64)
    for i in range(niter):
        obj.size_factors = sf
        obj = estimate_dispersions(obj, fit_type="mean", quiet=True,
                                   device=dev)
        q = (np.asarray(obj.assays["mu"]) / sf[None, :])[idx]
        disps = obj.row_data["dispersion"][idx]

        sf_old = sf

        def neg_fn(p):
            sfv = np.exp(p - np.mean(p))
            mu_new = q * sfv[None, :]
            gene_ll = nb_logpmf_np(cts, mu_new, disps[:, None]).sum(axis=1)
            cut = np.quantile(gene_ll, quantile_q)
            return -np.sum(gene_ll[gene_ll > cut])

        res = scipy.optimize.minimize(neg_fn, np.log(sf_old),
                                      method="L-BFGS-B")
        if not res.success:
            raise RuntimeError(
                "iterative size factor normalization did not converge "
                "within an iteration")
        sf = np.exp(res.x - np.mean(res.x))
        if i > 0 and np.sum((np.log(sf_old) - np.log(sf)) ** 2) < 1e-4:
            break
        if i == niter - 1:
            raise RuntimeError(
                "iterative size factor normalization did not converge")
    return sf
