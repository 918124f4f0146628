"""Dispersion estimation pipeline: gene-wise MLE -> trend -> MAP shrinkage
(the JAX package's dispersions.py, the host-exact engine's stages).

Reference: estimateDispersionsGeneEst (R/core.R:657-860),
estimateDispersionsFit (R/core.R:864-939), estimateDispersionsPriorVar
(R/core.R:1135-1208), estimateDispersionsMAP (R/core.R:943-1131), plus
helpers roughDispEstimate/momentsDispEstimate/linearModelMu
(R/core.R:2422-2471) and parametric/local trend fits (R/core.R:2166-2203).

The gene-wise and MAP searches run kernels K2 (ops/cuda_ls.py) and K3
(ops/cuda_grid.py) in float64 on the device of the (G,S) state, with the
configuration's useCR and weightThreshold; mu comes from K1 (glm.py) or
the least-squares rewrite.  The trend fit and the prior variance are the
cross-gene reductions over (G,) scalars and run on the host in numpy, as
in the JAX package (their code is copied from it).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import profiling
from .cooks import model_matrix_groups, n_or_more_in_cell
from .engine import resolve_device
from .glm import fit_glm_tensors, get_and_check_weights
from .hostdev import (F64, as_t, counts_t, dev_array, factors_t, idx_t,
                      na_pad, na_pad_t, rows, to_np)

__all__ = [
    "estimate_dispersions", "estimate_dispersions_gene_est",
    "estimate_dispersions_fit", "estimate_dispersions_map",
    "estimate_dispersions_prior_var", "get_base_means_and_variances",
    "model_matrix_groups", "n_or_more_in_cell",
]



# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def get_base_means_and_variances(dds, device=None):
    """baseMean/baseVar of (weighted) normalized counts + allZero flag
    (reference getBaseMeansAndVariances, R/core.R:2138-2157)."""
    dev = resolve_device(device)
    y = counts_t(dds, dev)
    cts_norm = y / factors_t(dds, dev)
    if "weights" in dds.assays:
        cts_norm = as_t(dds.assays["weights"], dev) * cts_norm
    dds.set_row_data("baseMean", to_np(cts_norm.mean(dim=1)),
                     "intermediate",
                     "mean of normalized counts for all samples")
    dds.set_row_data("baseVar", to_np(cts_norm.var(dim=1, correction=1)),
                     "intermediate",
                     "variance of normalized counts for all samples")
    dds.set_row_data("allZero", to_np(y.sum(dim=1) == 0), "intermediate",
                     "all counts for a gene are zero")
    return dds


def linear_model_mu(y, x):
    """Least-squares fitted values, the 'Huber rewrite'
    (reference linearModelMu, R/core.R:2454-2463); y a (G,S) tensor."""
    q, r = np.linalg.qr(x)
    h = x @ np.linalg.inv(r)
    return (y @ torch.as_tensor(q, dtype=F64, device=y.device)) @ \
        torch.as_tensor(h, dtype=F64, device=y.device).T


def rough_disp_estimate(y, x):
    """Residual-based rough dispersion (reference R/core.R:2422-2437)."""
    mu = torch.clamp(linear_model_mu(y, x), min=1.0)
    m, p = x.shape
    est = (((y - mu) ** 2 - mu) / mu ** 2).sum(dim=1) / (m - p)
    return torch.clamp(est, min=0.0)


def moments_disp_estimate(dds, nz=None, nf=None):
    """Method-of-moments dispersion (reference R/core.R:2439-2448) over
    the rows `nz` (all by default).  Uses baseMean/baseVar which must be
    present; `nf`: those rows' factors as a tensor, when at hand."""
    if nz is None:
        nz = np.ones(dds.n_genes, bool)
    if nf is None:
        nf = rows(factors_t(dds, "cpu"), idx_t(nz, "cpu"))
    if nf.dim() == 2:
        xim = float((1.0 / nf.mean(dim=0)).mean())
    else:
        xim = np.mean(1.0 / dds.size_factors)
    bv = dds.row_data["baseVar"][nz]
    bm = dds.row_data["baseMean"][nz]
    with np.errstate(divide="ignore", invalid="ignore"):
        return (bv - xim * bm) / bm ** 2


# ---------------------------------------------------------------------------
# gene-wise estimates
# ---------------------------------------------------------------------------

def estimate_dispersions_gene_est(dds, min_disp=None, kappa_0=None,
                                  disp_tol=None, maxit=None, use_cr=None,
                                  weight_threshold=None, quiet=True,
                                  model_matrix=None, niter=None,
                                  linear_mu=None, min_mu=None,
                                  alpha_init=None, config=None, device=None):
    """Gene-wise dispersion MLE (reference R/core.R:657-860)."""
    from .config import cfg
    from .ops.cuda_grid import fit_disp_grid
    from .ops.cuda_ls import fit_disp_line_search
    min_disp = cfg(min_disp, "min_disp", config)
    kappa_0 = cfg(kappa_0, "kappa_0", config)
    disp_tol = cfg(disp_tol, "disp_tol", config)
    maxit = cfg(maxit, "maxit_disp", config)
    use_cr = cfg(use_cr, "use_cr", config)
    weight_threshold = cfg(weight_threshold, "weight_threshold", config)
    niter = cfg(niter, "niter_disp", config)
    min_mu = cfg(min_mu, "min_mu", config)
    dev = resolve_device(device)
    dds = dds.copy()
    if "dispGeneEst" in dds.row_data:
        dds.remove_row_data(["dispGeneEst", "dispGeneIter"])
    if np.log(min_disp / 10) <= -30:
        raise ValueError("for computational stability, log(minDisp/10) "
                         "should be above -30")
    if model_matrix is None:
        model_matrix, _ = dds.model_matrix()
    model_matrix = np.asarray(model_matrix, dtype=np.float64)
    if model_matrix.shape[0] == model_matrix.shape[1]:
        raise ValueError(
            "the number of samples and the number of model coefficients are "
            "equal, i.e., there are no replicates to estimate the dispersion. "
            "use an alternate design formula")

    dds = get_base_means_and_variances(dds, dev)
    dds.attrs.pop("weightsOK", None)
    dds, weights, use_weights = get_and_check_weights(
        dds, model_matrix, weight_threshold=weight_threshold, device=dev)
    w_fit = weights
    if weights is not None:
        weights = torch.clamp(weights, min=1e-6)

    nz = ~dds.row_data["allZero"]
    nz_i = idx_t(nz, dev)
    y_nz = counts_t(dds, dev)[nz_i]
    nf_nz = rows(factors_t(dds, dev), nz_i)
    w_nz = weights[nz_i] if weights is not None else None
    wfit_nz = w_fit[nz_i] if w_fit is not None else None
    Gnz = int(nz.sum())
    x_t = torch.as_tensor(model_matrix, dtype=F64, device=dev)

    if alpha_init is None:
        rough = to_np(rough_disp_estimate(y_nz / nf_nz, model_matrix))
        moments = moments_disp_estimate(dds, nz, nf_nz)
        alpha_hat = np.minimum(rough, moments)
    else:
        alpha_hat = (np.full(Gnz, alpha_init) if np.isscalar(alpha_init)
                     else np.asarray(alpha_init, dtype=np.float64))
    max_disp = max(10.0, dds.n_samples)
    alpha_hat = np.clip(alpha_hat, min_disp, max_disp)
    alpha_init_saved = alpha_hat.copy()
    alpha_hat_new = alpha_hat.copy()

    if linear_mu is None:
        _, ngroups = model_matrix_groups(model_matrix)
        linear_mu = ngroups == model_matrix.shape[1]
        if use_weights:
            linear_mu = False

    fitidx = np.ones(Gnz, dtype=bool)
    mu = torch.zeros((Gnz, dds.n_samples), dtype=F64, device=dev)
    disp_iter = np.zeros(Gnz, dtype=np.int64)
    last_lp = np.zeros(Gnz)
    initial_lp = np.zeros(Gnz)
    names = [f"x{i+1}" for i in range(model_matrix.shape[1])]
    just_intercept = (model_matrix.shape[1] == 1
                      and np.all(model_matrix == 1.0))
    for it in range(niter):
        fi = idx_t(fitidx, dev)
        y_sub = y_nz[fi]
        nf_sub = rows(nf_nz, fi)
        if not linear_mu:
            fit = fit_glm_tensors(
                y_sub, nf_sub, model_matrix, names, alpha_hat[fitidx],
                np.full(model_matrix.shape[1], 1e-6),
                weights=None if wfit_nz is None else wfit_nz[fi],
                just_intercept=just_intercept, min_mu=min_mu)
            fit_mu = fit["mu"]
        else:
            fit_mu = linear_model_mu(y_sub / nf_sub, model_matrix) * nf_sub
        fit_mu = torch.clamp(fit_mu, min=min_mu)
        mu[fi] = fit_mu

        la = torch.as_tensor(np.log(alpha_hat[fitidx]), dtype=F64,
                             device=dev)
        res = fit_disp_line_search(
            y_sub, x_t, fit_mu, la, la, 1.0, float(np.log(min_disp / 10)),
            kappa_0=kappa_0, tol=disp_tol, maxit=maxit, use_prior=False,
            weights=None if w_nz is None else w_nz[fi], use_cr=use_cr,
            weight_threshold=weight_threshold)
        disp_iter[fitidx] = to_np(res["iter"])
        alpha_hat_new[fitidx] = np.minimum(
            np.exp(to_np(res["log_alpha"])), max_disp)
        last_lp[fitidx] = to_np(res["last_lp"])
        initial_lp[fitidx] = to_np(res["initial_lp"])
        with np.errstate(invalid="ignore"):
            fitidx = np.abs(np.log(alpha_hat_new) - np.log(alpha_hat)) > 0.05
        fitidx[np.isnan(fitidx)] = False
        alpha_hat = alpha_hat_new.copy()
        if fitidx.sum() == 0:
            break

    disp_gene_est = alpha_hat.copy()
    if niter == 1:
        # don't accept moves that didn't raise the posterior materially
        # (reference R/core.R:827-830)
        no_increase = last_lp < initial_lp + np.abs(initial_lp) / 1e6
        disp_gene_est[no_increase] = alpha_init_saved[no_increase]
    conv = (disp_iter < maxit) & (disp_iter != 1)

    refit = ~conv & (disp_gene_est > min_disp * 10)
    if refit.sum() > 0:
        ri = idx_t(refit, dev)
        grid = torch.as_tensor(
            np.linspace(np.log(min_disp), np.log(max_disp), 20), dtype=F64,
            device=dev)
        la = fit_disp_grid(
            y_nz[ri], x_t, mu[ri], grid,
            torch.zeros(int(refit.sum()), dtype=F64, device=dev), 1.0,
            use_prior=False, weights=None if w_nz is None else w_nz[ri],
            use_cr=use_cr, weight_threshold=weight_threshold)
        disp_gene_est[refit] = np.exp(to_np(la))
    disp_gene_est = np.clip(disp_gene_est, min_disp, max_disp)

    dds.set_row_data("dispGeneEst", na_pad(disp_gene_est, nz),
                     "intermediate", "gene-wise estimates of dispersion")
    dds.set_row_data("dispGeneIter", na_pad(disp_iter.astype(float), nz),
                     "intermediate", "number of iterations for gene-wise")
    dds.assays["mu"] = dev_array(na_pad_t(mu, nz))
    return dds


# ---------------------------------------------------------------------------
# trend fit (numpy over (G,) scalars, copied from the JAX package)
# ---------------------------------------------------------------------------

def parametric_dispersion_fit(means, disps):
    """Gamma-GLM fit of disp = asymptDisp + extraPois/mean with iterative
    outlier masking (reference parametricDispersionFit, R/core.R:2166-2189).

    The inner gamma GLM with identity link is IRLS with weights 1/mu^2 and
    working response y (R's glm.fit semantics, eps=1e-8, maxit=25)."""
    coefs = np.array([0.1, 1.0])
    it = 0
    while True:
        residuals = disps / (coefs[0] + coefs[1] / means)
        good = (residuals > 1e-4) & (residuals < 15)
        if good.sum() == 0:
            raise FloatingPointError("parametric dispersion fit failed")
        x = np.column_stack([np.ones(good.sum()), 1.0 / means[good]])
        y = disps[good]
        fit_coefs, converged = _gamma_glm_identity(x, y, start=coefs)
        oldcoefs = coefs
        coefs = fit_coefs
        if not np.all(coefs > 0):
            raise FloatingPointError("parametric dispersion fit failed")
        if np.sum(np.log(coefs / oldcoefs) ** 2) < 1e-6 and converged:
            break
        it += 1
        if it > 10:
            raise FloatingPointError("dispersion fit did not converge")
    coefs = np.asarray(coefs)

    def fn(q):
        return coefs[0] + coefs[1] / np.asarray(q, dtype=np.float64)

    return fn, coefs


def _gamma_glm_identity(x, y, start, maxit=25, eps=1e-8):
    """Gamma GLM, identity link, via IRLS (R glm.fit semantics: weights
    1/mu^2, working response y, deviance-relative convergence)."""
    beta = np.asarray(start, dtype=np.float64)
    mu = x @ beta
    if np.any(mu <= 0):
        raise FloatingPointError("cannot find valid starting values")
    dev_old = _gamma_deviance(y, mu)
    converged = False
    for _ in range(maxit):
        w = 1.0 / mu ** 2
        xtw = x.T * w
        beta = np.linalg.solve(xtw @ x, xtw @ y)
        mu = x @ beta
        if np.any(mu <= 0):
            raise FloatingPointError("gamma glm diverged to non-positive mu")
        dev = _gamma_deviance(y, mu)
        if abs(dev - dev_old) / (abs(dev) + 0.1) < eps:
            converged = True
            break
        dev_old = dev
    return beta, converged


def _gamma_deviance(y, mu):
    return 2.0 * np.sum((y - mu) / mu - np.log(y / mu))


def local_dispersion_fit(means, disps, min_disp, device="cpu"):
    """Local regression of log disp on log mean, weighted by mean
    (reference localDispersionFit, R/core.R:2194-2203, which uses locfit):
    tricube-weighted local quadratic regression (span 0.7) times the
    reference's prior weights = means, as in the JAX package, whose
    point-by-point numpy loop costs O(genes x fit points) on the host.
    Here the fit points stay on `device` in float64 and every evaluation
    runs the fused engine's estimator there (parallel/fused.py:
    local_trend_eval, the same k nearest points and weights)."""
    if np.all(disps < min_disp * 10):
        return lambda m: np.full(np.shape(m), min_disp), None
    from .parallel.fused import local_trend_eval, local_trend_state
    ts = local_trend_state(as_t(means, device), as_t(disps, device),
                           as_t(disps >= min_disp * 10, device, torch.bool))

    def fn(m):
        m = np.asarray(m, dtype=np.float64)
        x0 = torch.log(as_t(m.reshape(-1), ts["lxs"].device))
        return to_np(local_trend_eval(ts, x0)).reshape(m.shape)

    return fn, None


def estimate_dispersions_fit(dds, fit_type="parametric", min_disp=1e-8,
                             quiet=True, device=None):
    """Fit the mean-dispersion trend and store the dispersion function
    (reference estimateDispersionsFit, R/core.R:864-939, and the
    dispersionFunction<- setter, R/methods.R:142-194)."""
    from .dataset import DispersionFunction

    dev = resolve_device(device)
    dds = dds.copy()
    if "allZero" not in dds.row_data:
        dds = get_base_means_and_variances(dds, dev)
    nz = ~dds.row_data["allZero"]
    gene_ests = dds.row_data["dispGeneEst"][nz]
    base_means = dds.row_data["baseMean"][nz]
    use_for_fit = gene_ests > 100 * min_disp
    if use_for_fit.sum() == 0:
        raise ValueError(
            "all gene-wise dispersion estimates are within 2 orders of "
            "magnitude from the minimum value; standard curve fitting "
            "techniques will not work. One can instead use the gene-wise "
            "estimates as final estimates.")

    if fit_type == "parametric":
        try:
            fn, coefs = parametric_dispersion_fit(base_means[use_for_fit],
                                                  gene_ests[use_for_fit])
            disp_fn = DispersionFunction(fn, "parametric",
                                         coefficients=coefs)
        except (FloatingPointError, np.linalg.LinAlgError):
            if not quiet:
                warnings.warn(
                    "the dispersion trend was not well captured by the "
                    "parametric function y = a/x + b; a local regression "
                    "fit was substituted")
            fit_type = "local"
    if fit_type == "local":
        fn, _ = local_dispersion_fit(base_means[use_for_fit],
                                     gene_ests[use_for_fit], min_disp, dev)
        disp_fn = DispersionFunction(fn, "local")
    elif fit_type == "mean":
        use_for_mean = gene_ests > 10 * min_disp
        mean_disp = _trimmed_mean(gene_ests[use_for_mean], trim=0.001)
        disp_fn = DispersionFunction(lambda m: np.full(np.shape(m), mean_disp)
                                     if np.ndim(m) else mean_disp,
                                     "mean", mean=mean_disp)
    elif fit_type == "glmGamPoi":
        # local median trend with nearest-base-mean prediction
        # (reference R/core.R:906-925); the windows on the stage's device
        from .gampoi import loc_median_fit_dev, make_closest_index_disp_fn
        bm_fit = base_means[use_for_fit]
        medians = loc_median_fit_dev(bm_fit, gene_ests[use_for_fit], dev,
                                     F64)
        fn = make_closest_index_disp_fn(bm_fit, medians)
        disp_fn = DispersionFunction(fn, "glmGamPoi")
    elif fit_type not in ("parametric", "local", "mean"):
        raise ValueError("unknown fitType")

    set_dispersion_function(dds, disp_fn)
    return dds


def set_dispersion_function(dds, disp_fn, estimate_var=True):
    """The dispersionFunction<- setter: computes dispFit on baseMean and
    varLogDispEsts = mad(log geneEst - log fit)^2 over non-zero genes
    (reference R/methods.R:142-194)."""
    dds.dispersion_function = disp_fn
    nz = ~dds.row_data["allZero"]
    base_means = dds.row_data["baseMean"]
    disp_fit = np.full(dds.n_genes, np.nan)
    disp_fit[nz] = np.asarray(disp_fn(base_means[nz]), dtype=np.float64)
    dds.set_row_data("dispFit", disp_fit, "intermediate",
                     "fitted values of dispersion")
    if estimate_var:
        gene_ests = dds.row_data["dispGeneEst"][nz]
        with np.errstate(divide="ignore", invalid="ignore"):
            resid = np.log(gene_ests) - np.log(disp_fit[nz])
        resid = resid[np.isfinite(resid)]
        disp_fn.var_log_disp_ests = _mad(resid) ** 2
    return dds


def _mad(x):
    """R's mad(): median absolute deviation * 1.4826."""
    med = np.median(x)
    return 1.4826 * np.median(np.abs(x - med))


def _trimmed_mean(x, trim):
    x = np.sort(np.asarray(x, dtype=np.float64))
    n = len(x)
    k = int(np.floor(n * trim))
    if k > 0:
        x = x[k:n - k]
    return x.mean()


# ---------------------------------------------------------------------------
# prior variance and MAP shrinkage
# ---------------------------------------------------------------------------

def estimate_dispersions_prior_var(dds, min_disp=1e-8, model_matrix=None,
                                   rng_seed=2):
    """Variance of the log-normal dispersion prior
    (reference estimateDispersionsPriorVar, R/core.R:1135-1208)."""
    from scipy.special import polygamma

    nz = ~dds.row_data["allZero"]
    gene_ests = dds.row_data["dispGeneEst"][nz]
    above = gene_ests >= min_disp * 100
    if model_matrix is None:
        model_matrix, _ = dds.model_matrix()
    with np.errstate(divide="ignore", invalid="ignore"):
        disp_residuals = np.log(gene_ests) - \
            np.log(dds.row_data["dispFit"][nz])
    if above.sum() == 0:
        raise ValueError("no data found which is greater than minDisp")
    var_log_disp_ests = dds.dispersion_function.var_log_disp_ests

    m, p = model_matrix.shape
    if (m - p) <= 3 and m > p:
        # Monte-Carlo KL matching of the residual histogram against
        # log chi^2_(m-p) + N(0, s) over a variance grid
        # (reference R/core.R:1157-1191), with R's exact set.seed(2)
        # streams (rng_r.py) consumed in R's evaluation order and R
        # hist()'s right-closed bins; the smoothing is the JAX package's
        # direct local-quadratic loess.
        obs_dist = disp_residuals[above]
        brks = np.arange(-20, 21) / 2.0
        obs_dist = obs_dist[(obs_dist > brks[0]) & (obs_dist < brks[-1])]
        obs_var_grid = np.linspace(0, 8, 200)
        obs_hist = _hist_density_right(obs_dist, brks)
        chis, norms = _mc_kl_streams(rng_seed, m - p, len(obs_var_grid))
        kl_divs = np.empty(len(obs_var_grid))
        for i, v in enumerate(obs_var_grid):
            rand = (np.log(chis[i]) + np.sqrt(v) * norms[i]
                    - np.log(m - p))
            rand = rand[(rand > brks[0]) & (rand < brks[-1])]
            rand_hist = _hist_density_right(rand, brks)
            z = np.concatenate([obs_hist, rand_hist])
            small = z[z > 0].min()
            kl_divs[i] = np.sum(obs_hist * (np.log(obs_hist + small)
                                            - np.log(rand_hist + small)))
        fitted = _loess_quadratic(obs_var_grid, kl_divs, span=0.2)
        fine = np.linspace(0, 8, 1000)
        fitted_fine = np.interp(fine, obs_var_grid, fitted)
        argmin_kl = fine[np.argmin(fitted_fine)]
        return max(argmin_kl, 0.25)

    if m > p:
        exp_var_log_disp = polygamma(1, (m - p) / 2.0)
        return max(var_log_disp_ests - float(exp_var_log_disp), 0.25)
    return var_log_disp_ests


_MC_KL_CACHE = {}


def _mc_kl_streams(rng_seed, df, n_grid, n=10000):
    """R-exact set.seed(seed) deviate streams for the MC-KL branch, cached
    per (seed, df): they depend only on the seed and df (the rnorm sd
    scales the standard stream without changing the uniforms consumed)."""
    key = (int(rng_seed), int(df), int(n_grid), int(n))
    hit = _MC_KL_CACHE.get(key)
    if hit is not None:
        return hit
    from .rng_r import RRandomState
    rng = RRandomState(rng_seed)
    chis = np.empty((n_grid, n))
    norms = np.empty((n_grid, n))
    for i in range(n_grid):
        chis[i] = rng.rchisq(n, df)
        norms[i] = rng.rnorm(n, 0.0, 1.0)
    if len(_MC_KL_CACHE) >= 4:   # ~32 MB per entry: keep a few
        _MC_KL_CACHE.pop(next(iter(_MC_KL_CACHE)))
    _MC_KL_CACHE[key] = (chis, norms)
    return chis, norms


def _hist_density_right(x, brks):
    """R hist() bin densities: right-closed intervals (a, b], lowest
    bin closed on both ends (include.lowest=TRUE)."""
    idx = np.searchsorted(brks, x, side="left") - 1
    idx = np.where((x == brks[0]), 0, idx)
    nb = len(brks) - 1
    counts = np.bincount(idx[(idx >= 0) & (idx < nb)], minlength=nb)
    widths = np.diff(brks)
    n = len(x)
    return counts / (max(n, 1) * widths)


def _loess_quadratic(x, y, span=0.2):
    """Simple loess (degree 2, tricube) used to smooth the KL curve."""
    n = len(x)
    k = max(int(np.ceil(span * n)), 4)
    out = np.empty(n)
    for i in range(n):
        d = np.abs(x - x[i])
        idx = np.argpartition(d, k - 1)[:k]
        h = d[idx].max()
        w = (1 - np.minimum(d[idx] / h, 1) ** 3) ** 3
        X = np.column_stack([np.ones(k), x[idx] - x[i],
                             (x[idx] - x[i]) ** 2])
        XtW = X.T * w
        try:
            beta = np.linalg.solve(XtW @ X, XtW @ y[idx])
            out[i] = beta[0]
        except np.linalg.LinAlgError:
            out[i] = np.average(y[idx], weights=w)
    return out


def estimate_dispersions_map(dds, outlier_sd=None, disp_prior_var=None,
                             min_disp=None, kappa_0=None, disp_tol=None,
                             maxit=None, use_cr=None, weight_threshold=None,
                             model_matrix=None, quiet=True, type="DESeq2",
                             config=None, device=None):
    """MAP dispersion shrinkage toward the trend
    (reference estimateDispersionsMAP, R/core.R:943-1131)."""
    from .config import cfg
    from .ops.cuda_grid import fit_disp_grid
    from .ops.cuda_ls import fit_disp_line_search
    outlier_sd = cfg(outlier_sd, "outlier_sd", config)
    min_disp = cfg(min_disp, "min_disp", config)
    kappa_0 = cfg(kappa_0, "kappa_0", config)
    disp_tol = cfg(disp_tol, "disp_tol", config)
    maxit = cfg(maxit, "maxit_disp", config)
    use_cr = cfg(use_cr, "use_cr", config)
    weight_threshold = cfg(weight_threshold, "weight_threshold", config)
    dev = resolve_device(device)
    dds = dds.copy()
    if "allZero" not in dds.row_data:
        dds = get_base_means_and_variances(dds, dev)
    if "dispersion" in dds.row_data:
        dds.remove_row_data(["dispersion", "dispOutlier", "dispMAP",
                             "dispIter", "dispConv"])
    if model_matrix is None:
        model_matrix, _ = dds.model_matrix()
    model_matrix = np.asarray(model_matrix, dtype=np.float64)

    nz = ~dds.row_data["allZero"]
    if disp_prior_var is None:
        if np.nansum(dds.row_data["dispGeneEst"] >= min_disp * 100) == 0:
            warnings.warn(
                f"all genes have dispersion estimates < {min_disp*10}, "
                f"returning disp = {min_disp*10}")
            disp = np.full(dds.n_genes, np.nan)
            disp[nz] = min_disp * 10
            dds.set_row_data("dispersion", disp, "intermediate",
                             "final estimates of dispersion")
            dds.dispersion_function.disp_prior_var = 0.25
            return dds
        disp_prior_var = estimate_dispersions_prior_var(
            dds, min_disp=min_disp, model_matrix=model_matrix)
    dds.dispersion_function.disp_prior_var = disp_prior_var

    dds, weights, use_weights = get_and_check_weights(
        dds, model_matrix, weight_threshold=weight_threshold, device=dev)
    nz = ~dds.row_data["allZero"]
    nz_i = idx_t(nz, dev)
    w_nz = weights[nz_i] if weights is not None else None
    var_log_disp_ests = dds.dispersion_function.var_log_disp_ests
    if type == "glmGamPoi":
        return _map_gampoi(dds, nz, model_matrix, use_weights, min_disp,
                           outlier_sd, var_log_disp_ests, dev)

    y_nz = counts_t(dds, dev)[nz_i]
    mu = as_t(dds.assays["mu"], dev)[nz_i]
    gene_est = dds.row_data["dispGeneEst"][nz]
    disp_fit = dds.row_data["dispFit"][nz]
    x_t = torch.as_tensor(model_matrix, dtype=F64, device=dev)

    # init at gene estimate unless an order of magnitude below the trend
    disp_init = np.where(gene_est > 0.1 * disp_fit, gene_est, disp_fit)
    disp_init = np.where(np.isnan(disp_init), disp_fit, disp_init)

    log_fit = torch.as_tensor(np.log(disp_fit), dtype=F64, device=dev)
    res = fit_disp_line_search(
        y_nz, x_t, mu, torch.as_tensor(np.log(disp_init), dtype=F64,
                                       device=dev),
        log_fit, float(disp_prior_var), float(np.log(min_disp / 10)),
        kappa_0=kappa_0, tol=disp_tol, maxit=maxit, use_prior=True,
        weights=w_nz, use_cr=use_cr, weight_threshold=weight_threshold)
    disp_map = np.exp(to_np(res["log_alpha"]))
    disp_iter = to_np(res["iter"]).astype(np.int64)

    disp_conv = disp_iter < maxit
    refit = ~disp_conv
    if refit.sum() > 0:
        ri = idx_t(refit, dev)
        max_disp = max(10.0, dds.n_samples)
        grid = torch.as_tensor(
            np.linspace(np.log(min_disp), np.log(max_disp), 20), dtype=F64,
            device=dev)
        # the JAX package's MAP fallback always keeps the Cox-Reid term
        # (dispersions.py:699-708)
        la = fit_disp_grid(
            y_nz[ri], x_t, mu[ri], grid, log_fit[ri], float(disp_prior_var),
            use_prior=True, weights=None if w_nz is None else w_nz[ri],
            use_cr=True, weight_threshold=weight_threshold)
        disp_map[refit] = np.exp(to_np(la))

    max_disp = max(10.0, dds.n_samples)
    disp_map = np.clip(disp_map, min_disp, max_disp)
    dispersion_final = disp_map.copy()

    # outlier exemption: gene-wise estimates far above the trend keep their
    # own value (reference R/core.R:1105-1115)
    with np.errstate(divide="ignore", invalid="ignore"):
        disp_outlier = (np.log(gene_est) > np.log(disp_fit)
                        + outlier_sd * np.sqrt(var_log_disp_ests))
    disp_outlier = np.where(np.isnan(disp_outlier), False,
                            disp_outlier).astype(bool)
    dispersion_final[disp_outlier] = gene_est[disp_outlier]

    dds.set_row_data("dispersion", na_pad(dispersion_final, nz),
                     "intermediate", "final estimate of dispersion")
    dds.set_row_data("dispIter", na_pad(disp_iter.astype(float), nz),
                     "intermediate", "number of iterations")
    disp_outlier_full = np.zeros(dds.n_genes, dtype=bool)
    disp_outlier_full[nz] = disp_outlier
    dds.set_row_data("dispOutlier", disp_outlier_full, "intermediate",
                     "dispersion flagged as outlier")
    dds.set_row_data("dispMAP", na_pad(disp_map, nz), "intermediate",
                     "maximum a posteriori estimate")
    return dds


def _map_gampoi(dds, nz, model_matrix, use_weights, min_disp, outlier_sd,
                var_log_disp_ests, dev):
    """The glmGamPoi branch of estimateDispersionsMAP: quasi-likelihood
    shrinkage instead of the log-normal-prior MAP (reference
    R/core.R:1064-1096; deseq2_tpu/dispersions.py:631-660), on the host
    over (G,) columns but for the QL trend's windows (on `dev`)."""
    from .gampoi import overdispersion_shrinkage, ql_to_nb_alpha
    if use_weights:
        raise ValueError("type='glmGamPoi' cannot handle weights")
    gene_est = dds.row_data["dispGeneEst"][nz]
    disp_fit = dds.row_data["dispFit"][nz]
    gene_means = dds.row_data["baseMean"][nz]
    df = dds.n_samples - model_matrix.shape[1]
    shrink = overdispersion_shrinkage(gene_est, gene_means, df, disp_fit,
                                      device=dev)
    max_disp = max(10.0, dds.n_samples)
    disp_fit_corrected = ql_to_nb_alpha(
        shrink["ql_disp_trend"], gene_means, disp_fit, min_disp, max_disp)
    for name, vals, desc in (
            ("qlDispMLE", shrink["ql_disp_estimate"],
             "quasi likelihood dispersion MLE"),
            ("qlDispFit", shrink["ql_disp_trend"],
             "quasi likelihood dispersion Trend"),
            ("qlDispMAP", shrink["ql_disp_shrunken"],
             "quasi likelihood dispersion MAP"),
            ("dispFitQLCorrected", disp_fit_corrected,
             "dispersion trend corrected by quasi likelihood")):
        dds.set_row_data(name, na_pad(vals, nz), "intermediate", desc)
    dds.attrs["quasiLikelihood_df0"] = shrink["ql_df0"]
    disp_map = ql_to_nb_alpha(shrink["ql_disp_shrunken"], gene_means,
                              disp_fit, min_disp, max_disp)
    dispersion_final = disp_map.copy()
    with np.errstate(divide="ignore", invalid="ignore"):
        disp_outlier = (np.log(gene_est) > np.log(disp_fit)
                        + outlier_sd * np.sqrt(var_log_disp_ests))
    disp_outlier = np.where(np.isnan(disp_outlier), False,
                            disp_outlier).astype(bool)
    dispersion_final[disp_outlier] = gene_est[disp_outlier]
    dds.set_row_data("dispersion", na_pad(dispersion_final, nz),
                     "intermediate", "final estimate of dispersion")
    dds.set_row_data("dispIter", na_pad(np.zeros(int(nz.sum())), nz),
                     "intermediate", "number of iterations")
    disp_outlier_full = np.zeros(dds.n_genes, dtype=bool)
    disp_outlier_full[nz] = disp_outlier
    dds.set_row_data("dispOutlier", disp_outlier_full, "intermediate",
                     "dispersion flagged as outlier")
    dds.set_row_data("dispMAP", na_pad(disp_map, nz), "intermediate",
                     "maximum a posteriori estimate")
    return dds


def estimate_dispersions(dds, fit_type="parametric", min_disp=None,
                         quiet=True, model_matrix=None, min_mu=None,
                         config=None, device=None, **kw):
    """Three-step estimateDispersions method
    (reference R/methods.R:500-568).  `device`: where the (G,S) state and
    the searches live (the card by default)."""
    from .config import cfg
    min_disp = cfg(min_disp, "min_disp", config)
    min_mu = cfg(min_mu, "min_mu", config)
    if dds.size_factors is None and dds.normalization_factors is None:
        raise ValueError("first call estimate_size_factors")
    if "dispersion" in dds.row_data:
        if not quiet:
            warnings.warn("found already estimated dispersions, replacing")
        dds = dds.copy()
        dds.remove_row_data(["dispersion", "dispOutlier", "dispMAP",
                             "dispIter", "dispGeneEst", "dispGeneIter",
                             "dispFit"])
    # replicate check (reference checkForExperimentalReplicates)
    mm = model_matrix if model_matrix is not None else dds.model_matrix()[0]
    if np.asarray(mm).shape[0] == np.asarray(mm).shape[1]:
        raise ValueError(
            "the design matrix has the same number of samples and "
            "coefficients to fit, estimation of dispersion is not possible")
    # constant-row guard (reference R/methods.R:522-529)
    rng_rows = dds.counts.max(axis=1) - dds.counts.min(axis=1)
    if np.all(rng_rows == 0):
        raise ValueError("all genes have equal values for all samples; "
                         "will not be able to perform differential analysis")
    G = dds.n_genes
    with profiling.stage("dispersions.geneEst", genes=G):
        dds = estimate_dispersions_gene_est(
            dds, min_disp=min_disp, quiet=quiet, model_matrix=model_matrix,
            min_mu=min_mu, config=config, device=device, **kw)
    with profiling.stage("dispersions.fit", genes=G):
        dds = estimate_dispersions_fit(dds, fit_type=fit_type,
                                       min_disp=min_disp, quiet=quiet,
                                       device=device)
    with profiling.stage("dispersions.MAP", genes=G):
        dds = estimate_dispersions_map(
            dds, min_disp=min_disp, quiet=quiet, model_matrix=model_matrix,
            type=("glmGamPoi" if fit_type == "glmGamPoi" else "DESeq2"),
            config=config, device=device)
    return dds
