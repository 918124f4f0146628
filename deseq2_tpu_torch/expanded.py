"""Expanded model matrices: one indicator per factor level.

Reference: makeExpandedModelMatrix / averagePriorsOverLevels /
addAllContrasts (R/expanded.R:1-98).  Expanded matrices make shrunken LFCs
independent of the reference-level choice; the '_null_level_' trick adds a
phantom reference level so model.matrix emits a column per real level.
"""

from __future__ import annotations

import numpy as np

from .formula import Factor, build_model_matrix, make_names


def get_design_factors(dds):
    """(reference getDesignFactors, R/core.R:2400-2405)"""
    if isinstance(dds.design, np.ndarray):
        return []
    return [v for v in dds.design.variables
            if isinstance(dds.col_data.get(v), Factor)]


def make_expanded_model_matrix(dds):
    """(reference makeExpandedModelMatrix, R/expanded.R:1-18)

    Build the design matrix over colData where every design factor has been
    releveled to a phantom '_null_level_' reference (with one phantom row
    that is dropped), so each real level gets its own indicator column.
    """
    design_factors = get_design_factors(dds)
    S = dds.n_samples
    col_data = {}
    for k, v in dds.col_data.items():
        if k in design_factors:
            f = v
            new_levels = ["_null_level_"] + list(f.levels)
            codes = np.concatenate([f.codes + 1, [0]])
            nf = Factor.__new__(Factor)
            nf.codes = codes
            nf.levels = new_levels
            nf.ordered = False
            col_data[k] = nf
        elif isinstance(v, Factor):
            codes = np.concatenate([v.codes, [v.codes[-1]]])
            nf = Factor.__new__(Factor)
            nf.codes = codes
            nf.levels = list(v.levels)
            nf.ordered = v.ordered
            col_data[k] = nf
        else:
            col_data[k] = np.concatenate([v, [v[-1]]])
    mm, names, _ = build_model_matrix(dds.design, col_data, n_rows=S + 1)
    keep = [i for i, n in enumerate(names) if "_null_level_" not in n]
    mm = mm[:-1, keep]
    names = [names[i] for i in keep]
    names = ["Intercept" if n == "(Intercept)" else n for n in names]
    names = make_names(names)
    return mm, names


def add_all_contrasts(dds, beta_matrix, beta_names):
    """Append columns for all pairwise level contrasts of each design factor
    (reference addAllContrasts, R/expanded.R:76-98).

    Returns (matrix, names) where the added columns are named
    '<factor>Cntrst' (all sharing the name, as in the reference)."""
    beta_matrix = np.asarray(beta_matrix)
    names = list(beta_names)
    for f in get_design_factors(dds):
        lvls = dds.col_data[f].levels
        mm_colnames = set(make_names([f"{f}{l}" for l in lvls]))
        cols = [i for i, n in enumerate(names) if n in mm_colnames]
        M = beta_matrix[:, cols]
        n = M.shape[1]
        if n > 1:
            contrast_cols = []
            for j in range(n - 1):
                for i in range(j + 1, n):
                    contrast_cols.append(M[:, i] - M[:, j])
            cname = make_names([f"{f}Cntrst"])[0]
            beta_matrix = np.column_stack([beta_matrix] + contrast_cols)
            names = names + [cname] * len(contrast_cols)
    return beta_matrix, names


def average_priors_over_levels(dds, beta_prior_var, prior_names):
    """Average the prior variance over all levels + contrasts of each factor
    (reference averagePriorsOverLevels, R/expanded.R:20-73).

    beta_prior_var/prior_names: values and names from estimate_beta_prior_var
    over the MLE fit (+Cntrst columns).  Returns vector aligned with the
    expanded model matrix columns."""
    _, expanded_names = make_expanded_model_matrix(dds)
    name_to_val = {}
    for n, v in zip(prior_names, beta_prior_var):
        name_to_val.setdefault(n, []).append(v)
    out = np.zeros(len(expanded_names))
    for i, n in enumerate(expanded_names):
        if n in name_to_val:
            out[i] = name_to_val[n][0]
    for f in get_design_factors(dds):
        lvls = dds.col_data[f].levels
        mm_colnames = set(make_names([f"{f}{l}" for l in lvls]
                                     + [f"{f}Cntrst"]))
        vals = [v for n, vs in name_to_val.items() if n in mm_colnames
                for v in vs]
        if vals:
            mean_var = float(np.mean(vals))
            for i, n in enumerate(expanded_names):
                if n in mm_colnames:
                    out[i] = mean_var
    if np.any(np.isnan(out)):
        raise ValueError("beta prior is NA for some columns")
    if not np.all(out > 0):
        bad = [expanded_names[i] for i in np.where(out <= 0)[0]]
        raise ValueError(f"beta prior for {bad} is not greater than 0")
    return out, expanded_names
