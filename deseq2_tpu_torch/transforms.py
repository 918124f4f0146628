"""Variance-stabilizing transforms: VST, rlog, normTransform (the JAX
package's transforms.py).

Reference: varianceStabilizingTransformation/getVarianceStabilizedData/vst
(R/vst.R:112-267), rlog/rlogData (R/rlog.R:108-287), normTransform
(R/helper.R:421-435).

Everything runs on one torch device: the card unless the caller passes
device="cpu".  The dispersion step of a blind (or not yet fitted)
transform is what the reference fits (R/vst.R:253-254, R/rlog.R:141-142):
size factors, the gene-wise estimate (kernel K2, then K3 for the genes
that do not converge) and the trend, the host-exact engine's stages in
float64; no MAP, GLM fit, Cook's distances or filtering.  The (G,S)
payload is computed on the device in DESeqConfig.dtype (float64 by
default, float32 for the fast path; rlog fits in float64 and casts, see
rlog_data) and stays there: DESeqTransform.matrix downloads it on first
access.  The local trend's integral and spline are
1-D fits on the host; only their evaluation over the counts runs on the
device.  A device failure propagates to the caller.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import profiling
from .dispersions import (estimate_dispersions_fit,
                          estimate_dispersions_gene_est,
                          get_base_means_and_variances)
from .engine import LOG2E, device_counts, resolve_device, resolve_dtype
from .hostdev import F64, as_t, factors_t, idx_t, rows, to_np
from .quantiles import r_quantile_type7
from .sizefactors import estimate_size_factors

__all__ = ["DESeqTransform", "variance_stabilizing_transformation", "vst",
           "norm_transform", "rlog", "rlog_data",
           "get_variance_stabilized_data", "rlog_arrow_irls"]


class DESeqTransform:
    """Transformed data container (reference DESeqTransform,
    R/AllClasses.R:460-489).

    The (G,S) payload is a tensor on the device the transform ran on;
    `.matrix` downloads it to host float64 numpy on first access, and
    `.matrix_device` returns it as stored, for consumers that only need
    reductions of it (plot_pca_data's top-variance genes)."""

    def __init__(self, matrix, col_data, row_names, col_names, attrs=None):
        self._matrix = matrix
        self.col_data = col_data
        self.row_names = row_names
        self.col_names = col_names
        self.attrs = attrs or {}

    @property
    def matrix(self):
        m = self._matrix
        if not isinstance(m, np.ndarray):
            m = np.asarray(to_np(m), np.float64)
            self._matrix = m
        return m

    @matrix.setter
    def matrix(self, value):
        self._matrix = value

    @property
    def matrix_device(self):
        """The payload as stored: a tensor after a transform, until
        `.matrix` replaces it with its host copy."""
        return self._matrix

    @property
    def shape(self):
        return tuple(self._matrix.shape)


def _normalized(dds, dev, dtype):
    """Normalized counts (G,S) on `dev` in `dtype`; the counts uploaded
    once and carried by the dataset (engine.device_counts)."""
    c = device_counts(dds, dev)
    dds._counts_dev = c
    return c.to(dtype) / factors_t(dds, dev).to(dtype)


def _dispersion_step(dds, fit_type, dev):
    """Gene-wise dispersion estimates and the trend, as the reference
    fits them for a transform: the host-exact engine's stages (K2, K3 for
    the genes the line search leaves) under the dataset's configuration,
    in float64."""
    with profiling.stage("dispersions.geneEst", genes=dds.n_genes):
        dds = estimate_dispersions_gene_est(dds, quiet=True,
                                            config=dds.config, device=dev)
    with profiling.stage("dispersions.fit", genes=dds.n_genes):
        return estimate_dispersions_fit(dds, fit_type=fit_type, quiet=True,
                                        device=dev)


def _blind(dds):
    from .formula import parse_formula
    dds.design = parse_formula("~ 1")


def _with_size_factors(dds, dev):
    if dds.size_factors is None and dds.normalization_factors is None:
        with profiling.stage("estimateSizeFactors", genes=dds.n_genes):
            dds = estimate_size_factors(dds, device=dev)
    return dds


def variance_stabilizing_transformation(dds, blind=True,
                                        fit_type="parametric", device=None):
    """(reference varianceStabilizingTransformation, R/vst.R:112-142)"""
    dev = resolve_device(device)
    dds = _with_size_factors(dds.copy(share_counts=True), dev)
    if blind:
        _blind(dds)
    if blind or dds.dispersion_function is None:
        dds = _dispersion_step(dds, fit_type, dev)
    vsd = _get_vsd_raw(dds, dev)
    return DESeqTransform(vsd, dds.col_data, dds.row_names, dds.col_names)


def get_variance_stabilized_data(dds, device=None):
    """Closed-form / numeric-integral / asinh VST as host float64 numpy
    (reference getVarianceStabilizedData, R/vst.R:146-193)."""
    return np.asarray(to_np(_get_vsd_raw(dds, resolve_device(device))),
                      np.float64)


def _spline_eval(spline, v):
    """A scipy CubicSpline evaluated at the tensor `v` (any shape) on its
    device: the piece of each point found by binary search over the
    breakpoints, the end pieces extended beyond them (PPoly's
    extrapolation)."""
    x = torch.as_tensor(spline.x, dtype=v.dtype, device=v.device)
    c = torch.as_tensor(spline.c, dtype=v.dtype, device=v.device)
    i = torch.clamp(torch.searchsorted(x, v.contiguous(), right=True) - 1,
                    0, x.numel() - 2)
    s = v - x[i]
    return ((c[0][i] * s + c[1][i]) * s + c[2][i]) * s + c[3][i]


def _get_vsd_raw(dds, dev):
    """The VST payload (G,S) on `dev` in DESeqConfig.dtype."""
    disp_fn = dds.dispersion_function
    if disp_fn is None or disp_fn.fit_type is None:
        raise ValueError("call estimate_dispersions before "
                         "get_variance_stabilized_data")
    if disp_fn.fit_type not in ("parametric", "local", "mean"):
        raise ValueError("fitType is not parametric, local or mean")
    dtype = resolve_dtype(dds.config)
    with profiling.stage("transform.payload", genes=dds.n_genes):
        q = _normalized(dds, dev, dtype)
        if disp_fn.fit_type == "parametric":
            a, ep = (float(v) for v in disp_fn.coefficients)
            aq = a * q
            return torch.log((1.0 + ep + 2.0 * aq
                              + 2.0 * torch.sqrt(aq * (1.0 + ep + aq)))
                             / (4.0 * a)) / np.log(2.0)
        if disp_fn.fit_type == "mean":
            al = float(disp_fn.mean)
            return (2.0 * torch.asinh(torch.sqrt(al * q)) - np.log(al)
                    - np.log(4.0)) / np.log(2.0)
        return _vst_local(dds, disp_fn, q)


def _vst_local(dds, disp_fn, q):
    """Numeric trapezoid integration of 1/sqrt(var(x)) on an asinh grid,
    cubic-spline interpolation, affine calibration to log2 at the
    .95/.999 quantiles of the row means (R/vst.R:157-183).  The grid, the
    integral and the spline are host numpy over 1,000 points; the spline
    is evaluated over the normalized counts on their device."""
    from scipy.interpolate import CubicSpline
    if dds.size_factors is not None:
        sf = np.asarray(dds.size_factors, np.float64)
    else:
        nf = factors_t(dds, q.device)
        sf = to_np(torch.exp(torch.log(nf).mean(dim=0)))
    qmax = float(q.max())
    row_means = to_np(q.mean(dim=1).double())
    xg = np.sinh(np.linspace(np.arcsinh(0), np.arcsinh(qmax), 1000))[1:]
    xim = np.mean(1.0 / sf)
    base_vars_at_grid = disp_fn(xg) * xg ** 2 + xim * xg
    integrand = 1.0 / np.sqrt(base_vars_at_grid)
    mid = np.arcsinh((xg[1:] + xg[:-1]) / 2)
    csum = np.cumsum((xg[1:] - xg[:-1])
                     * (integrand[1:] + integrand[:-1]) / 2)
    splf = CubicSpline(mid, csum)
    h1 = r_quantile_type7(row_means, 0.95)
    h2 = r_quantile_type7(row_means, 0.999)
    eta = (np.log2(h2) - np.log2(h1)) / \
        (splf(np.arcsinh(h2)) - splf(np.arcsinh(h1)))
    xi = np.log2(h1) - eta * splf(np.arcsinh(h1))
    return float(eta) * _spline_eval(splf, torch.asinh(q)) + float(xi)


def vst(dds, blind=True, nsub=1000, fit_type="parametric", device=None):
    """Fast VST: estimate the trend on a 1000-gene subset spanning the mean
    range (reference vst, R/vst.R:219-267)."""
    if dds.n_genes < nsub:
        raise ValueError("less than 'nsub' rows, use "
                         "variance_stabilizing_transformation directly")
    dev = resolve_device(device)
    dds = dds.copy(share_counts=True)
    if blind:
        _blind(dds)
    dds = _with_size_factors(dds, dev)
    base_mean = to_np(_normalized(dds, dev, F64).mean(dim=1))
    if np.sum(base_mean > 5) < nsub:
        raise ValueError("less than 'nsub' rows with mean normalized "
                         "count > 5, use variance_stabilizing_transformation")
    sub_idx = np.where(base_mean > 5)[0]
    o = np.argsort(base_mean[sub_idx], kind="stable")
    # R: o[round(seq(from=1, to=length(o), length=nsub))]
    pick = np.round(np.linspace(1, len(o), nsub)).astype(int) - 1
    object_sub = _dispersion_step(dds.subset_genes(sub_idx[o[pick]]),
                                  fit_type, dev)
    dds = get_base_means_and_variances(dds, dev)
    # the subset's trend is applied to the full object; varLogDispEsts is
    # not recomputed over the full set (matches the reference assignment)
    dds.dispersion_function = object_sub.dispersion_function
    nzmask = ~dds.row_data["allZero"]
    disp_fit = np.full(dds.n_genes, np.nan)
    disp_fit[nzmask] = object_sub.dispersion_function(
        dds.row_data["baseMean"][nzmask])
    dds.set_row_data("dispFit", disp_fit, "intermediate",
                     "fitted values of dispersion")
    vsd = _get_vsd_raw(dds, dev)
    return DESeqTransform(vsd, dds.col_data, dds.row_names, dds.col_names)


def norm_transform(dds, f=torch.log2, pc=1, device=None):
    """f(normalized counts + pc) (reference normTransform,
    R/helper.R:421-435); `f` maps a tensor to a tensor."""
    dev = resolve_device(device)
    dds = _with_size_factors(dds.copy(share_counts=True), dev)
    nt = f(_normalized(dds, dev, resolve_dtype(dds.config)) + pc)
    return DESeqTransform(nt, dds.col_data, dds.row_names, dds.col_names)


# ---------------------------------------------------------------------------
# rlog
# ---------------------------------------------------------------------------

def rlog(dds, blind=True, intercept=None, beta_prior_var=None,
         fit_type="parametric", device=None):
    """Regularized log transform (reference rlog, R/rlog.R:108-164)."""
    dev = resolve_device(device)
    dds = _with_size_factors(dds.copy(share_counts=True), dev)
    if blind:
        _blind(dds)
    if intercept is None:
        _sparse_test(_normalized(dds, dev, F64), 0.9, 100, 0.1)
    if blind or "dispFit" not in dds.row_data:
        dds = _dispersion_step(dds, fit_type, dev)
    rld, bpv, fitted_intercept = rlog_data(dds, intercept, beta_prior_var,
                                           device=dev)
    t = DESeqTransform(rld, dds.col_data, dds.row_names, dds.col_names,
                       attrs={"betaPriorVar": bpv})
    if fitted_intercept is not None:
        t.attrs["rlogIntercept"] = fitted_intercept
    return t


def rlog_arrow_irls(y, nf, alpha, lam0_nat, lam1_nat, has_intercept,
                    tol=1e-4, maxit=100, min_mu=0.5):
    """Ridge IRLS specialized to the rlog design (SURVEY hard part 6), on
    the tensors' device in their dtype.

    The rlog model matrix is [1 | I_S] (intercept + one indicator per
    sample; R/rlog.R:190-196), so X'WX + diag(ridge) is an ARROW matrix
    [[a00, w'], [w, diag(w)+lam1]] and each IRLS sweep solves it in
    O(S) per gene by block elimination (Schur complement of the
    diagonal block) instead of the O(S^3) dense solve the generic
    (S+1)-column path would cost.  With a frozen intercept the design
    is I_S and the system is fully diagonal.

    Same update/convergence rules as ops/irls.py (src/DESeq2.cpp:282-465,
    deviance-relative tol; |beta|>30 divergence guard); the deviance's
    mu-free part is computed once.  A sweep runs on the genes still
    active only: most genes converge in under 15 sweeps while a few run
    to maxit, so the working set shrinks as genes leave it (their betas
    written out as they leave).  `y` (G,S); `nf` (S,) shared size factors
    or a (G,S) matrix; `alpha` (G,).  Natural-log scale throughout;
    returns tensors (xbeta (G,S), intercept (G,), iters)."""
    dtype = y.dtype
    G = y.shape[0]
    alpha = alpha.to(dtype)[:, None]
    size = 1.0 / alpha
    norm_c = y / nf

    if has_intercept:
        # rank-deficient design: init = intercept-only (glm.py rule)
        m = torch.clamp(norm_c.mean(dim=1), min=1e-30)
        b0 = torch.where(norm_c.sum(dim=1) > 0, torch.log(m),
                         torch.zeros_like(m))
        bs = torch.zeros_like(y)
    else:
        b0 = torch.zeros(G, dtype=dtype, device=y.device)
        bs = torch.log(norm_c + 0.1)
    del norm_c
    b0_out, bs_out = b0.clone(), bs.clone()
    iters = torch.zeros(G, dtype=torch.int64, device=y.device)

    # the working set: the active genes' rows of every per-gene tensor
    ws = dict(rows=torch.arange(G, device=y.device), y=y, alpha=alpha,
              size=size, ypos=y > 0, b0=b0, bs=bs,
              dev_const=-2.0 * (torch.lgamma(y + size) - torch.lgamma(size)
                                - torch.lgamma(y + 1.0)).sum(dim=1),
              dev_old=torch.zeros(G, dtype=dtype, device=y.device))
    if nf.dim() == 2:
        ws["nf"] = nf

    def mu_of(nfw, b0v, bsv):
        return torch.clamp(nfw * torch.exp(b0v[:, None] + bsv), min=min_mu)

    def deviance(w, mu):
        t = torch.where(w["ypos"], w["y"] * (torch.log(mu)
                                             - torch.log(w["size"] + mu)),
                        torch.zeros_like(mu))
        return w["dev_const"] - 2.0 * (
            w["size"] * torch.log(w["size"] / (w["size"] + mu))
            + t).sum(dim=1)

    mu = mu_of(nf, b0, bs)
    for t_it in range(maxit):
        if ws["rows"].numel() == 0:
            break
        iters[ws["rows"]] += 1
        nfw = ws.get("nf", nf)
        yw = ws["y"]
        w = mu / (1.0 + ws["alpha"] * mu)
        rs = w * (torch.log(mu / nfw) + (yw - mu) / mu)
        if has_intercept:
            d = w + lam1_nat
            swd = (w * w / d).sum(dim=1)
            schur = w.sum(dim=1) + lam0_nat - swd
            ws["b0"] = (rs.sum(dim=1) - (w * rs / d).sum(dim=1)) / schur
            ws["bs"] = (rs - w * ws["b0"][:, None]) / d
        else:
            ws["bs"] = rs / (w + lam1_nat)
        del w, rs
        absmax = torch.maximum(ws["b0"].abs(), ws["bs"].abs().amax(dim=1))
        mu = mu_of(nfw, ws["b0"], ws["bs"])
        dev_new = deviance(ws, mu)
        conv_test = (dev_new - ws["dev_old"]).abs() / (dev_new.abs() + 0.1)
        keep = ~(absmax > 30.0) & ~torch.isnan(conv_test)
        if t_it > 0:
            keep &= ~(conv_test < tol)
        ws["dev_old"] = dev_new
        if not bool(keep.all()):
            out = ws["rows"][~keep]
            b0_out[out] = ws["b0"][~keep]
            bs_out[out] = ws["bs"][~keep]
            ws = {k: v[keep] for k, v in ws.items()}
            mu = mu[keep]
    b0_out[ws["rows"]] = ws["b0"]
    bs_out[ws["rows"]] = ws["bs"]
    xbeta = b0_out[:, None] + bs_out if has_intercept else bs_out
    return xbeta, b0_out, iters


def _rlog_prior_var(q, bm, dfit):
    """The rlog prior variance: the weighted upper quantile of the
    observed log fold changes (reference R/rlog.R:233-240,
    matchWeightedUpperQuantileForVariance with Hmisc wtd.quantile
    semantics) over all G x S entries, on their device: one sort, the
    cumulative weights in float64, one scalar back.  wtd.table's collapse
    of duplicate values is not needed: ties share a value, so the
    right-continuous step lookup returns the same quantile either way.
    Zero weights (a gene with base mean 0) drop out, as wtd.quantile
    drops them."""
    from scipy.stats import norm
    lfc = torch.log2(q + 0.5) - torch.log2(bm + 0.5)[:, None]
    w = (1.0 / (1.0 / bm + dfit))[:, None].expand_as(lfc)
    xs, order = torch.sort(lfc.abs().reshape(-1), stable=True)
    ws = w.reshape(-1)[order].double()
    n_el = float((ws != 0).sum())
    cumw = torch.cumsum(ws * (n_el / ws.sum()), dim=0)     # normwt
    n = float(cumw[-1])
    ordv = 1.0 + (n - 1.0) * 0.95
    low = max(np.floor(ordv), 1.0)
    high = min(low + 1.0, n)
    frac = ordv % 1.0
    at = torch.searchsorted(cumw, torch.tensor(
        [low, high], dtype=torch.float64, device=cumw.device))
    lh = to_np(xs[torch.clamp(at, 0, xs.numel() - 1)].double())
    q95 = (1.0 - frac) * lh[0] + frac * lh[1]
    return float((q95 / norm.ppf(1 - 0.05 / 2)) ** 2)


def rlog_data(dds, intercept=None, beta_prior_var=None, device=None):
    """Shrunken per-sample log2 fits (reference rlogData,
    R/rlog.R:172-272): intercept + one indicator per sample, ridge on all
    but the intercept, fitted by rlog_arrow_irls on the device.  Returns
    (the (G,S) payload tensor in DESeqConfig.dtype, betaPriorVar, the
    fitted log2 intercept or None).

    The prior variance and the fit run in float64 whatever the dtype:
    a gene stops when its deviance changes by less than 1e-4 relative,
    and float32 sweeps move that test enough that a low-count gene can
    stop a sweep apart from float64 and land past a float32 payload's
    0.01 limit (`python -m deseq2_tpu_torch.ops.studies rlog`: 1-4 genes
    per seed of bench.py's 2,048 x 1,024 gate slice on the CPU, up to 0.09
    log2 units); float64 sweeps of the shrinking working set cost little.
    Only the payload is cast."""
    dev = resolve_device(device)
    dtype = resolve_dtype(dds.config)
    if "dispFit" not in dds.row_data:
        raise ValueError("first estimate dispersion")
    if "allZero" not in dds.row_data or "baseMean" not in dds.row_data:
        dds = get_base_means_and_variances(dds.copy(share_counts=True),
                                           dev)
    G, S = dds.n_genes, dds.n_samples
    nf = factors_t(dds, dev)
    if intercept is None:
        has_intercept = True
        all_zero = np.asarray(dds.row_data["allZero"], bool)
    else:
        # frozen intercept: the design is I_S and the intercept enters the
        # normalization factors (R/rlog.R:200-213)
        has_intercept = False
        intercept = np.asarray(intercept, dtype=np.float64)
        if len(intercept) != G:
            raise ValueError("intercept should be as long as the number of "
                             "rows of object")
        all_zero = ~np.isfinite(intercept)
        intercept = np.where(all_zero, -10.0, intercept)
        nf = nf * as_t(2.0 ** intercept, dev)[:, None]

    nz = ~all_zero
    dfit_nz = np.asarray(dds.row_data["dispFit"], np.float64)[nz]
    if np.any(np.isnan(dfit_nz)):
        raise ValueError("NA dispFit")
    nz_i = idx_t(nz, dev)
    y = device_counts(dds, dev)[nz_i].to(F64)
    nf_nz = rows(nf, nz_i)

    if beta_prior_var is None:
        with profiling.stage("rlog.priorVar", genes=G):
            beta_prior_var = _rlog_prior_var(
                y / nf_nz,
                as_t(np.asarray(dds.row_data["baseMean"])[nz], dev),
                as_t(dfit_nz, dev))
    # log2-scale ridge -> natural scale, as fitNbinomGLMs does
    # (R/fitNbinomGLMs.R:157-162)
    lam1_nat = (1.0 / beta_prior_var) / (np.log(2.0) ** 2)
    lam0_nat = 1e-6 / (np.log(2.0) ** 2)
    with profiling.stage("rlog.irls", genes=G):
        xbeta_nat, b0_nat, _ = rlog_arrow_irls(
            y, nf_nz, as_t(dfit_nz, dev), lam0_nat, lam1_nat,
            has_intercept, tol=1e-4)
    normalized_data = torch.zeros((G, S), dtype=F64, device=dev)
    normalized_data[nz_i] = LOG2E * xbeta_nat
    fitted_intercept = None
    if intercept is not None:
        off = np.where(all_zero, 0.0, intercept)
        normalized_data += as_t(off, dev)[:, None]
    else:
        fitted_intercept = np.full(G, -np.inf)
        fitted_intercept[nz] = LOG2E * to_np(b0_nat)
    return normalized_data.to(dtype), beta_prior_var, fitted_intercept


def _sparse_test(x, p, t1, t2):
    """Warn when single samples dominate row sums (reference sparseTest,
    R/rlog.R:274-287); `x` the (G,S) normalized counts on their device,
    reduced there to their row sums and maxima."""
    rs = to_np(x.sum(dim=1)).astype(np.float64)
    if np.all(rs <= t1):
        return
    with np.errstate(invalid="ignore"):     # all-zero rows: 0 / 0
        prop = (to_np(x.amax(dim=1)).astype(np.float64) / rs)[rs > t1]
    total = np.mean(prop > p)
    if total > t2:
        warnings.warn(
            "the rlog assumes that data is close to a negative binomial "
            f"distribution; for {round(total*100,1)}% of genes with sum of "
            f"normalized counts above {t1}, a single sample's count made up "
            f"more than {p*100}% of the row sum. Consider vst() instead.")
