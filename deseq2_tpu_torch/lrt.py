"""Likelihood ratio test (reference nbinomLRT, R/core.R:1787-2012): the
JAX package's lrt.py, with both fits through K1 in float64 on the device
of the (G,S) state (glm.py), and the quasi-likelihood F-test of the
glmGamPoi path (R/core.R:1898-1947), whose fits run K1 at minmu = 1e-6
with the dispersions held at the trend."""

from __future__ import annotations

import warnings

import numpy as np
import torch
from scipy.stats import chi2

from .cooks import calculate_cooks_distance, record_max_cooks
from .dispersions import get_base_means_and_variances
from .engine import resolve_device
from .formula import parse_formula
from .glm import fit_nbinom_glms
from .hostdev import dev_array, na_pad, na_pad_t


def check_lrt(full, reduced):
    """(reference checkLRT, R/core.R:2475-2481)"""
    full_vars = set(parse_formula(full).variables)
    red_vars = parse_formula(reduced).variables
    missing = [v for v in red_vars if v not in full_vars]
    if missing:
        raise ValueError(
            "the following variables in the reduced formula not in the full "
            "formula: " + ", ".join(missing))


def nbinom_lrt(dds, full=None, reduced=None, beta_tol=None, maxit=None,
               use_optim=None, quiet=True, use_qr=None, min_mu=None,
               type="DESeq2", config=None, device=None):
    """Full-vs-reduced likelihood ratio chi-squared test
    (reference nbinomLRT, R/core.R:1787-2012); type='glmGamPoi' runs the
    quasi-likelihood F-test instead (R/core.R:1898-1947).  `device`: where
    the fits and the (G,S) state live (the card by default)."""
    from .config import cfg
    dev = resolve_device(device)
    beta_tol = cfg(beta_tol, "beta_tol", config)
    maxit = cfg(maxit, "maxit_beta", config)
    use_optim = cfg(use_optim, "use_optim", config)
    use_qr = cfg(use_qr, "use_qr", config)
    min_mu = cfg(min_mu, "min_mu", config)
    dds = dds.copy()
    if dds.dispersions is None:
        raise ValueError("testing requires dispersion estimates, first call "
                         "estimate_dispersions()")
    if reduced is None:
        raise ValueError("provide a reduced formula or matrix for the LRT")
    if full is None:
        full = dds.design

    model_as_formula = not (isinstance(full, np.ndarray)
                            and isinstance(reduced, np.ndarray))
    if model_as_formula:
        full = full if isinstance(full, np.ndarray) else parse_formula(full)
        check_lrt(full, reduced)
        full_mm, full_names = dds.model_matrix(full)
        reduced_mm, _ = dds.model_matrix(reduced)
        df = full_mm.shape[1] - reduced_mm.shape[1]
    else:
        df = full.shape[1] - reduced.shape[1]
        full_mm, reduced_mm = full, reduced
    if df < 1:
        raise ValueError("less than one degree of freedom, perhaps full and "
                         "reduced models are not in the correct order")

    if any(t == "results" for t, _ in dds.row_meta.values()):
        dds.remove_results()
    if "allZero" not in dds.row_data:
        dds = get_base_means_and_variances(dds, dev)

    model_matrix_type = "standard" if model_as_formula else "user-supplied"
    dds.attrs["modelMatrixType"] = model_matrix_type
    rename_cols = model_as_formula and dds.design_has_intercept()

    nz = ~dds.row_data["allZero"]
    obj_nz = dds.subset_genes(nz)

    if type == "glmGamPoi":
        return _nbinom_lrt_gampoi(dds, obj_nz, nz, full, reduced, full_mm,
                                  reduced_mm, df, model_as_formula,
                                  rename_cols, beta_tol, maxit, use_qr, dev)

    if model_as_formula:
        full_model = fit_nbinom_glms(obj_nz, model_formula=full,
                                     rename_cols=rename_cols,
                                     beta_tol=beta_tol, maxit=maxit,
                                     use_optim=use_optim, use_qr=use_qr,
                                     warn_nonpos_var=False, min_mu=min_mu,
                                     device=dev)
        model_matrix = full_model["model_matrix"]
        reduced_model = fit_nbinom_glms(obj_nz, model_formula=reduced,
                                        beta_tol=beta_tol, maxit=maxit,
                                        use_optim=use_optim, use_qr=use_qr,
                                        warn_nonpos_var=False, min_mu=min_mu,
                                     device=dev)
    else:
        full_model = fit_nbinom_glms(obj_nz, model_matrix=full,
                                     rename_cols=False, beta_tol=beta_tol,
                                     maxit=maxit, use_optim=use_optim,
                                     use_qr=use_qr, warn_nonpos_var=False,
                                     min_mu=min_mu, device=dev)
        model_matrix = full
        reduced_model = fit_nbinom_glms(obj_nz, model_matrix=reduced,
                                        rename_cols=False, beta_tol=beta_tol,
                                        maxit=maxit, use_optim=use_optim,
                                        use_qr=use_qr, warn_nonpos_var=False,
                                        min_mu=min_mu, device=dev)

    lrt_stat = 2.0 * (full_model["log_like"] - reduced_model["log_like"])
    lrt_pvalue = chi2.sf(lrt_stat, df)
    deviance = -2.0 * full_model["log_like"]

    H = full_model["hat_diagonals"]
    disp_model_matrix = model_matrix
    dds.attrs["dispModelMatrix"] = disp_model_matrix
    # obj_nz still carries the gene-est mu here: the reference stores
    # fullModel$mu only after Cook's in nbinomLRT (R/core.R:1888 vs 1959),
    # unlike nbinomWaldTest — keep that quirk for parity
    cooks = calculate_cooks_distance(obj_nz, H, disp_model_matrix, dev)
    max_cooks = record_max_cooks(disp_model_matrix, cooks, obj_nz.n_genes)
    dds.assays["H"] = dev_array(na_pad_t(H, nz))
    dds.assays["cooks"] = dev_array(na_pad_t(cooks, nz))

    dds.attrs["betaPrior"] = False
    dds.attrs["betaPriorVar"] = np.full(model_matrix.shape[1], 1e6)
    dds.attrs["modelMatrix"] = model_matrix
    dds.attrs["modelMatrixNames"] = full_model["model_matrix_names"]
    dds.attrs["reducedModelMatrix"] = reduced_mm
    dds.attrs["test"] = "LRT"
    dds.assays["mu"] = dev_array(na_pad_t(full_model["mu"], nz))

    if np.any(~full_model["beta_conv"]) and not quiet:
        warnings.warn(f"{np.sum(~full_model['beta_conv'])} rows did not "
                      "converge in beta; use larger maxit")

    if model_as_formula:
        comparison = f"'{full}' vs '{parse_formula(reduced)}'"
    else:
        comparison = "full vs reduced"

    names = full_model["model_matrix_names"]
    names_spaces = [n.replace("_", " ") for n in names]
    beta_matrix, beta_se = full_model["beta_matrix"], full_model["beta_se"]
    for j, (n, ns) in enumerate(zip(names, names_spaces)):
        dds.set_row_data(n, na_pad(beta_matrix[:, j], nz), "results",
                         f"log2 fold change (MLE): {ns}")
        dds.set_row_data(f"SE_{n}", na_pad(beta_se[:, j], nz), "results",
                         f"standard error: {ns}")
    dds.set_row_data("LRTStatistic", na_pad(lrt_stat, nz), "results",
                     f"LRT statistic: {comparison}")
    dds.set_row_data("LRTPvalue", na_pad(lrt_pvalue, nz), "results",
                     f"LRT p-value: {comparison}")
    dds.set_row_data("fullBetaConv",
                     na_pad(full_model["beta_conv"].astype(float), nz),
                     "results", "convergence of betas for full model")
    dds.set_row_data("reducedBetaConv",
                     na_pad(reduced_model["beta_conv"].astype(float), nz),
                     "results", "convergence of betas for reduced model")
    dds.set_row_data("betaIter",
                     na_pad(full_model["beta_iter"].astype(float), nz),
                     "results", "iterations for betas for full model")
    dds.set_row_data("deviance", na_pad(deviance, nz), "results",
                     "deviance of the full model")
    dds.set_row_data("maxCooks", na_pad(max_cooks, nz), "results",
                     "maximum Cook's distance for row")
    return dds


def _nbinom_lrt_gampoi(dds, obj_nz, nz, full, reduced, full_mm, reduced_mm,
                       df, model_as_formula, rename_cols, beta_tol, maxit,
                       use_qr, dev):
    """Quasi-likelihood F-test path (reference R/core.R:1898-1947;
    deseq2_tpu/lrt.py:166-247): betas fit with the *trend* dispersions
    held fixed, at minmu = 1e-6 (K1), test statistic F = (deviance drop /
    df) / qlDispMAP with denominator df ql_df0 + residual df."""
    from .gampoi import ql_f_test

    for needed in ("qlDispMAP", "dispFit"):
        if needed not in dds.row_data:
            raise ValueError(
                "nbinomLRT of type 'glmGamPoi' requires first calling "
                "estimate_dispersions(dds, fit_type='glmGamPoi')")
    if "quasiLikelihood_df0" not in dds.attrs:
        raise ValueError("missing quasiLikelihood_df0; run "
                         "estimate_dispersions(fit_type='glmGamPoi')")

    disp_trend = obj_nz.row_data["dispFit"]
    kwargs = dict(rename_cols=False, beta_tol=beta_tol, maxit=maxit,
                  use_optim=False, use_qr=use_qr, warn_nonpos_var=False,
                  min_mu=1e-6, alpha_hat=disp_trend, device=dev)
    if model_as_formula:
        full_model = fit_nbinom_glms(obj_nz, model_formula=full,
                                     **{**kwargs,
                                        "rename_cols": rename_cols})
        reduced_model = fit_nbinom_glms(obj_nz, model_formula=reduced,
                                        **kwargs)
        model_matrix = full_model["model_matrix"]
    else:
        full_model = fit_nbinom_glms(obj_nz, model_matrix=full_mm, **kwargs)
        reduced_model = fit_nbinom_glms(obj_nz, model_matrix=reduced_mm,
                                        **kwargs)
        model_matrix = full_mm

    ql_df0 = dds.attrs["quasiLikelihood_df0"]
    df_resid = dds.n_samples - model_matrix.shape[1]
    f_stat, pval = ql_f_test(full_model["log_like"],
                             reduced_model["log_like"], df,
                             obj_nz.row_data["qlDispMAP"], ql_df0, df_resid)
    deviance = -2.0 * full_model["log_like"]

    dds.attrs["betaPrior"] = False
    dds.attrs["betaPriorVar"] = np.full(model_matrix.shape[1], 1e6)
    dds.attrs["modelMatrix"] = model_matrix
    dds.attrs["modelMatrixNames"] = full_model["model_matrix_names"]
    dds.attrs["reducedModelMatrix"] = reduced_mm
    dds.attrs["dispModelMatrix"] = model_matrix
    dds.attrs["test"] = "LRT"
    dds.assays["mu"] = dev_array(na_pad_t(full_model["mu"], nz))

    if model_as_formula:
        comparison = f"'{full}' vs '{parse_formula(reduced)}'"
    else:
        comparison = "full vs reduced"
    names = full_model["model_matrix_names"]
    names_spaces = [n.replace("_", " ") for n in names]
    beta_matrix = full_model["beta_matrix"]
    na = np.full(obj_nz.n_genes, np.nan)
    ones = np.ones(obj_nz.n_genes)
    for j, (n, ns) in enumerate(zip(names, names_spaces)):
        dds.set_row_data(n, na_pad(beta_matrix[:, j], nz), "results",
                         f"log2 fold change (MLE): {ns}")
        dds.set_row_data(f"SE_{n}", na_pad(na, nz), "results",
                         f"standard error: {ns}")
    dds.set_row_data("LRTStatistic", na_pad(f_stat, nz), "results",
                     f"LRT statistic: {comparison}")
    dds.set_row_data("LRTPvalue", na_pad(pval, nz), "results",
                     f"LRT p-value: {comparison}")
    dds.set_row_data("fullBetaConv", na_pad(ones, nz), "results",
                     "convergence of betas for full model")
    dds.set_row_data("reducedBetaConv", na_pad(ones, nz), "results",
                     "convergence of betas for reduced model")
    dds.set_row_data("betaIter", na_pad(na, nz), "results",
                     "iterations for betas for full model")
    dds.set_row_data("deviance", na_pad(deviance, nz), "results",
                     "deviance of the full model")
    dds.set_row_data("maxCooks", na_pad(na, nz), "results",
                     "maximum Cook's distance for row")
    return dds
