"""Wald testing and LFC prior machinery (the JAX package's wald.py), the
host-exact engine's test stage.

Reference: nbinomWaldTest (R/core.R:1332-1565), estimateBetaPriorVar
(R/core.R:1601-1689), estimateMLEForBetaPriorVar (R/core.R:1693-1734),
fitGLMsWithPrior (R/fitNbinomGLMs.R:242-337).

The GLM fits run K1 in float64 on the device of the (G,S) state
(glm.py); mu, the hat diagonals and Cook's distances stay there as
DeviceArray assays, and the per-gene columns come to the host as numpy.
The beta prior variance is the JAX package's numpy estimator over the
(G,p) MLE columns.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
from scipy.stats import norm, t as t_dist

from . import profiling
from .cooks import calculate_cooks_distance, record_max_cooks
from .engine import resolve_device
from .expanded import (add_all_contrasts, average_priors_over_levels,
                       make_expanded_model_matrix)
from .glm import fit_nbinom_glms, get_and_check_weights
from .hostdev import as_t, dev_array, idx_t, na_pad, na_pad_t, to_np
from .quantiles import (match_upper_quantile_for_variance,
                        match_weighted_upper_quantile_for_variance)


def _na_pad_bool(values, nz_mask):
    """Booleans NA-padded as floats (NaN on the all-zero rows)."""
    out = np.full(len(nz_mask), np.nan)
    out[nz_mask] = values.astype(float)
    return out


def nbinom_wald_test(dds, beta_prior=False, beta_prior_var=None,
                     model_matrix=None, model_matrix_type=None,
                     beta_tol=None, maxit=None, use_optim=None, quiet=True,
                     use_t=False, df=None, use_qr=None, min_mu=None,
                     config=None, device=None):
    """Wald test of GLM coefficients (reference nbinomWaldTest,
    R/core.R:1332-1565).  `device`: where the fits and the (G,S) state
    live (the card by default)."""
    from .config import cfg
    from .dispersions import get_base_means_and_variances
    beta_tol = cfg(beta_tol, "beta_tol", config)
    maxit = cfg(maxit, "maxit_beta", config)
    use_optim = cfg(use_optim, "use_optim", config)
    use_qr = cfg(use_qr, "use_qr", config)
    min_mu = cfg(min_mu, "min_mu", config)
    dev = resolve_device(device)
    dds = dds.copy()
    if dds.dispersions is None:
        raise ValueError("testing requires dispersion estimates, first call "
                         "estimate_dispersions()")
    if any(t == "results" for t, _ in dds.row_meta.values()):
        dds.remove_results()
    if "allZero" not in dds.row_data:
        dds = get_base_means_and_variances(dds, dev)

    nz = ~dds.row_data["allZero"]
    obj_nz = dds.subset_genes(nz)

    model_as_formula = model_matrix is None
    if model_as_formula:
        blind = not dds.design.variables
        if blind:
            beta_prior = False
        if model_matrix_type is None:
            model_matrix_type = "expanded" if beta_prior else "standard"
        if model_matrix_type == "expanded" and not beta_prior:
            raise ValueError("expanded model matrices require a beta prior")
        dds.attrs["modelMatrixType"] = model_matrix_type
        rename_cols = dds.design_has_intercept()
        if beta_prior and not dds.design_has_intercept():
            raise ValueError("betaPrior=TRUE can only be used if the design "
                             "has an intercept")
        if beta_prior and any(o > 1 for o in dds.design.term_orders):
            raise ValueError(
                "betaPrior=FALSE should be used for designs with "
                "interactions")
    else:
        if beta_prior and beta_prior_var is None:
            raise ValueError("user-supplied model matrix with betaPrior=TRUE "
                             "requires supplying betaPriorVar")
        dds.attrs["modelMatrixType"] = "user-supplied"
        model_matrix_type = "user-supplied"
        rename_cols = False

    if not beta_prior:
        with profiling.stage("wald.fitGLM", genes=obj_nz.n_genes):
            fit = fit_nbinom_glms(obj_nz, beta_tol=beta_tol, maxit=maxit,
                                  use_optim=use_optim, use_qr=use_qr,
                                  rename_cols=rename_cols,
                                  model_matrix=model_matrix, min_mu=min_mu,
                                  device=dev)
        H = fit["hat_diagonals"]
        mu = fit["mu"]
        model_matrix = fit["model_matrix"]
        model_matrix_names = fit["model_matrix_names"]
        beta_prior_var = np.full(model_matrix.shape[1], 1e6)
        mle_beta_matrix = None
        mle_names = None
    else:
        with profiling.stage("wald.fitGLMsWithPrior", genes=obj_nz.n_genes):
            (fit, H, mu, beta_prior_var, model_matrix, model_matrix_names,
             mle_beta_matrix, mle_names) = fit_glms_with_prior(
                dds, obj_nz, beta_tol=beta_tol, maxit=maxit,
                use_optim=use_optim, use_qr=use_qr,
                beta_prior_var=beta_prior_var, model_matrix=model_matrix,
                min_mu=min_mu, device=dev)
        # remove pre-existing MLE_ columns
        dds.remove_row_data([n for n in list(dds.row_data)
                             if n.startswith("MLE_")])

    dds.assays["mu"] = dev_array(na_pad_t(as_t(mu, dev), nz))
    dds.assays["H"] = dev_array(na_pad_t(as_t(H, dev), nz))
    dds.attrs["betaPrior"] = beta_prior
    dds.attrs["betaPriorVar"] = beta_prior_var
    dds.attrs["modelMatrix"] = model_matrix
    dds.attrs["modelMatrixNames"] = model_matrix_names
    dds.attrs["test"] = "Wald"

    # Cook's distance over the *dispersion* model matrix
    if model_as_formula:
        disp_model_matrix, _ = dds.model_matrix()
    else:
        disp_model_matrix = model_matrix
    dds.attrs["dispModelMatrix"] = disp_model_matrix
    # the reference refreshes objectNZ's mu with the Wald-fit mu BEFORE
    # Cook's (R/core.R:1436 precedes :1457); nbinomLRT does not — there
    # Cook's sees the gene-est mu (R/core.R:1888 precedes :1959)
    obj_nz.assays["mu"] = dev_array(as_t(mu, dev))
    with profiling.stage("wald.cooks", genes=obj_nz.n_genes):
        cooks = calculate_cooks_distance(obj_nz, H, disp_model_matrix, dev)
        max_cooks = record_max_cooks(disp_model_matrix, cooks,
                                     obj_nz.n_genes)
    dds.assays["cooks"] = dev_array(na_pad_t(cooks, nz))

    beta_matrix = fit["beta_matrix"]
    beta_se = fit["beta_se"]
    with np.errstate(divide="ignore", invalid="ignore"):
        wald_stat = beta_matrix / beta_se

    if use_t:
        if df is not None:
            df = np.asarray(df, dtype=np.float64)
            if df.size == 1:
                df = np.full(obj_nz.n_genes, float(df))
            else:
                df = df[nz]
        else:
            if "weights" in dds.assays:
                _, w, _ = get_and_check_weights(obj_nz, disp_model_matrix,
                                                device=dev)
                num_samps = to_np(w.sum(dim=1))
            else:
                num_samps = np.full(obj_nz.n_genes, dds.n_samples)
            df = num_samps - disp_model_matrix.shape[1]
        df = np.where(df > 0, df, np.nan)
        wald_pvalue = 2.0 * t_dist.sf(np.abs(wald_stat), df[:, None])
    else:
        wald_pvalue = 2.0 * norm.sf(np.abs(wald_stat))

    beta_conv = fit["beta_conv"]
    if np.any(~beta_conv) and not quiet:
        warnings.warn(f"{np.sum(~beta_conv)} rows did not converge in beta; "
                      "labelled in row_data['betaConv']. Use larger maxit")

    names_spaces = [n.replace("_", " ") for n in model_matrix_names]
    lfc_type = "MAP" if beta_prior else "MLE"
    for j, (n, ns) in enumerate(zip(model_matrix_names, names_spaces)):
        dds.set_row_data(n, na_pad(beta_matrix[:, j], nz), "results",
                         f"log2 fold change ({lfc_type}): {ns}")
        dds.set_row_data(f"SE_{n}", na_pad(beta_se[:, j], nz), "results",
                         f"standard error: {ns}")
    if beta_prior and mle_beta_matrix is not None:
        # description deliberately does NOT contain "log2 fold change":
        # resultsNames greps on that phrase and must exclude MLE_ columns
        # (reference R/core.R:1544-1547, R/results.R:619-621)
        for j, n in enumerate(mle_names):
            dds.set_row_data(f"MLE_{n}", na_pad(mle_beta_matrix[:, j], nz),
                             "results", "MLE " + n.replace("_", " "))
    for j, (n, ns) in enumerate(zip(model_matrix_names, names_spaces)):
        dds.set_row_data(f"WaldStatistic_{n}", na_pad(wald_stat[:, j], nz),
                         "results", f"Wald statistic: {ns}")
    for j, (n, ns) in enumerate(zip(model_matrix_names, names_spaces)):
        dds.set_row_data(f"WaldPvalue_{n}", na_pad(wald_pvalue[:, j], nz),
                         "results", f"Wald test p-value: {ns}")
    dds.set_row_data("betaConv", _na_pad_bool(beta_conv, nz), "results",
                     "convergence of betas")
    dds.set_row_data("betaIter", na_pad(fit["beta_iter"].astype(float), nz),
                     "results", "iterations for betas")
    dds.set_row_data("deviance", na_pad(-2.0 * fit["log_like"], nz),
                     "results", "deviance for the fitted model")
    dds.set_row_data("maxCooks", na_pad(max_cooks, nz), "results",
                     "maximum Cook's distance for row")
    if use_t:
        dds.set_row_data("tDegreesFreedom", na_pad(df, nz), "results",
                         "t degrees of freedom for Wald test")
    return dds


def fit_glms_with_prior(dds, obj_nz, beta_tol, maxit, use_optim, use_qr,
                        beta_prior_var=None, model_matrix=None, min_mu=0.5,
                        device=None):
    """Two-pass fit: MLE -> prior variance -> ridge refit
    (reference fitGLMsWithPrior, R/fitNbinomGLMs.R:242-337)."""
    dev = resolve_device(device)
    model_matrix_type = dds.attrs["modelMatrixType"]
    # obj_nz may have been subset before the attr was stamped on dds;
    # estimate_beta_prior_var dispatches the expanded-matrix handling
    # (addAllContrasts/averagePriorsOverLevels) on it
    obj_nz.attrs["modelMatrixType"] = model_matrix_type
    provided_mm = model_matrix

    if beta_prior_var is None or not all(
            k in dds.assays for k in ("mu", "H")):
        if provided_mm is not None:
            raise ValueError("cannot estimate beta prior variance with a "
                             "user-supplied model matrix")
        fit_mle = fit_nbinom_glms(obj_nz, beta_tol=beta_tol, maxit=maxit,
                                  use_optim=use_optim, use_qr=use_qr,
                                  rename_cols=(model_matrix_type ==
                                               "standard"),
                                  min_mu=min_mu, device=dev)
        H = fit_mle["hat_diagonals"]
        mu = fit_mle["mu"]
        mle_beta_matrix = fit_mle["beta_matrix"]
        # the MLE columns always carry 'condition_b_vs_a' style names so
        # results(addMLE=TRUE) can find them, even in expanded mode
        # (reference R/fitNbinomGLMs.R:272-278)
        from .formula import rename_model_matrix_columns
        conv = rename_model_matrix_columns(dds.col_data, dds.design)
        mle_names = [conv.get(n, n) for n in fit_mle["model_matrix_names"]]
        # store MLE_ columns on the nz object for estimate_beta_prior_var
        for j, n in enumerate(mle_names):
            obj_nz.set_row_data(f"MLE_{n}", mle_beta_matrix[:, j], "results",
                                "MLE " + n.replace("_", " "))
    else:
        nzmask = ~dds.row_data["allZero"]
        nz_i = idx_t(nzmask, dev)
        H = as_t(dds.assays["H"], dev)[nz_i]
        mu = as_t(dds.assays["mu"], dev)[nz_i]
        mle_names = [n[len("MLE_"):] for n in obj_nz.row_data
                     if n.startswith("MLE_")]
        mle_beta_matrix = np.column_stack(
            [obj_nz.row_data[f"MLE_{n}"] for n in mle_names]) \
            if mle_names else None

    if beta_prior_var is None:
        beta_prior_var, prior_names = estimate_beta_prior_var(obj_nz)
    else:
        beta_prior_var = np.asarray(beta_prior_var, dtype=np.float64)
        if model_matrix_type == "expanded":
            mm, prior_names = make_expanded_model_matrix(dds)
            if len(beta_prior_var) != mm.shape[1]:
                raise ValueError(
                    f"betaPriorVar should have length {mm.shape[1]}")
        else:
            prior_names = None

    if np.any(beta_prior_var == 0):
        raise ValueError("beta prior variances are equal to zero for some "
                         "variables")
    lam = 1.0 / beta_prior_var

    if model_matrix_type == "standard":
        fit = fit_nbinom_glms(obj_nz, lam=lam, beta_tol=beta_tol,
                              maxit=maxit, use_optim=use_optim,
                              use_qr=use_qr, min_mu=min_mu, device=dev)
        model_matrix = fit["model_matrix"]
        names = fit["model_matrix_names"]
    elif model_matrix_type == "expanded":
        model_matrix, names = make_expanded_model_matrix(dds)
        fit = fit_nbinom_glms(obj_nz, lam=lam, beta_tol=beta_tol,
                              maxit=maxit, use_optim=use_optim,
                              use_qr=use_qr, model_matrix=model_matrix,
                              model_matrix_names=names, rename_cols=False,
                              min_mu=min_mu, device=dev)
    else:  # user-supplied
        fit = fit_nbinom_glms(obj_nz, lam=lam, beta_tol=beta_tol,
                              maxit=maxit, use_optim=use_optim,
                              use_qr=use_qr, model_matrix=provided_mm,
                              rename_cols=False, min_mu=min_mu, device=dev)
        model_matrix = fit["model_matrix"]
        names = fit["model_matrix_names"]

    return (fit, H, mu, beta_prior_var, model_matrix, names,
            mle_beta_matrix, mle_names)


def estimate_beta_prior_var(obj_nz, beta_prior_method="weighted",
                            upper_quantile=0.05, model_matrix=None):
    """Beta prior variance from the distribution of MLE coefficients
    (reference estimateBetaPriorVar, R/core.R:1601-1689).

    obj_nz: dataset subset to non-zero rows carrying MLE_ columns.
    Returns (variances, names) where names follow the expanded naming when
    modelMatrixType == 'expanded'."""
    from .formula import rename_model_matrix_columns

    mle_cols = [n for n in obj_nz.row_data if n.startswith("MLE_")]
    beta_matrix = np.column_stack([obj_nz.row_data[n] for n in mle_cols])
    names = [n[len("MLE_"):] for n in mle_cols]
    # reverse the condition_B_vs_A renaming to model.matrix style
    if not isinstance(obj_nz.design, np.ndarray):
        conv = rename_model_matrix_columns(obj_nz.col_data, obj_nz.design)
        rev = {v: k for k, v in conv.items()}
        names = [rev.get(n, n) for n in names]

    model_matrix_type = obj_nz.attrs.get("modelMatrixType")
    if model_matrix_type == "expanded":
        beta_matrix, names = add_all_contrasts(obj_nz, beta_matrix, names)

    # weights = 1 / (1/baseMean + trended dispersion)  (R/core.R:1637-1646)
    disp_fit = obj_nz.row_data.get("dispFit")
    if disp_fit is None:
        disp_fit = np.mean(obj_nz.row_data["dispersion"])
    varlogk = 1.0 / obj_nz.row_data["baseMean"] + disp_fit
    weights = 1.0 / varlogk

    if beta_matrix.shape[0] > 1:
        prior_var = np.empty(beta_matrix.shape[1])
        for j in range(beta_matrix.shape[1]):
            col = beta_matrix[:, j]
            use_finite = np.abs(col) < 10
            if use_finite.sum() == 0:
                prior_var[j] = 1e6
            elif beta_prior_method == "quantile":
                prior_var[j] = match_upper_quantile_for_variance(
                    col[use_finite], upper_quantile)
            else:
                prior_var[j] = match_weighted_upper_quantile_for_variance(
                    col[use_finite], weights[use_finite], upper_quantile)
    else:
        prior_var = beta_matrix[0] ** 2

    # intercept gets a wide prior
    prior_var = np.asarray(prior_var, dtype=np.float64)
    for j, n in enumerate(names):
        if n in ("Intercept", "(Intercept)"):
            prior_var[j] = 1e6

    if model_matrix_type == "expanded":
        prior_var, names = average_priors_over_levels(obj_nz, prior_var, names)
    return prior_var, names


def estimate_mle_for_beta_prior_var(dds, maxit=100, use_optim=True,
                                    use_qr=True, model_matrix_type=None,
                                    device=None):
    """Standalone MLE pass storing MLE_ columns + H assay
    (reference estimateMLEForBetaPriorVar, R/core.R:1693-1734)."""
    dev = resolve_device(device)
    dds = dds.copy()
    nz = ~dds.row_data["allZero"]
    obj_nz = dds.subset_genes(nz)
    if model_matrix_type is None:
        blind = not dds.design.variables
        model_matrix_type = "standard" if blind else "expanded"
    dds.attrs["modelMatrixType"] = model_matrix_type
    fit = fit_nbinom_glms(obj_nz, maxit=maxit, use_optim=use_optim,
                          use_qr=use_qr,
                          rename_cols=(model_matrix_type == "standard"),
                          device=dev)
    names = fit["model_matrix_names"]
    if not isinstance(dds.design, np.ndarray):
        from .formula import rename_model_matrix_columns
        conv = rename_model_matrix_columns(dds.col_data, dds.design)
        names = [conv.get(n, n) for n in names]
    dds.remove_row_data([n for n in list(dds.row_data)
                         if n.startswith("MLE_")])
    for j, n in enumerate(names):
        dds.set_row_data(f"MLE_{n}", na_pad(fit["beta_matrix"][:, j], nz),
                         "results", "MLE " + n.replace("_", " "))
    dds.assays["H"] = dev_array(na_pad_t(fit["hat_diagonals"], nz))
    return dds
