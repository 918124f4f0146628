"""The beta prior variance of the Wald test's LFC prior: a copy of the
JAX package's numpy estimator (reference estimateBetaPriorVar,
R/core.R:1601-1689), the part of wald.py that betaPrior and type="normal"
shrinkage use.  The rest of the host Wald test is ROADMAP.md queue 1,
item 7.
"""

from __future__ import annotations

import numpy as np

from .expanded import add_all_contrasts, average_priors_over_levels
from .quantiles import (match_upper_quantile_for_variance,
                        match_weighted_upper_quantile_for_variance)


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
