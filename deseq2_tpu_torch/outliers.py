"""Count-outlier replacement and refit (the JAX package's outliers.py).

Reference: replaceOutliers (R/core.R:2069-2115), refitWithoutOutliers
(R/core.R:2484-2563).  The Cook's mask, the trimmed means and the
replaced counts are computed on the device of the (G,S) state; the host
counts take only the replaced entries.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.stats import f as f_dist

from . import profiling
from .cooks import r_trimmed_mean, record_max_cooks
from .dispersions import (estimate_dispersions_gene_est,
                          estimate_dispersions_map,
                          get_base_means_and_variances, n_or_more_in_cell)
from .engine import resolve_device
from .hostdev import (as_t, counts_t, dev_array, factors_t, full_factors,
                      idx_t, to_np)


def replace_outliers(dds, trim=0.2, cooks_cutoff=None, min_replicates=7,
                     which_samples=None, device=None):
    """Replace counts with Cook's > cutoff by trimmed mean * size factor
    (reference replaceOutliers, R/core.R:2069-2115)."""
    from .engine import device_counts
    if "modelMatrix" not in dds.attrs or "cooks" not in dds.assays:
        raise ValueError("first run deseq(), nbinom_wald_test, or nbinom_lrt "
                         "to identify outliers")
    if min_replicates < 3:
        raise ValueError("at least 3 replicates are necessary to identify "
                         "a sample as a count outlier")
    dev = resolve_device(device)
    dds = dds.copy()
    p = dds.attrs["modelMatrix"].shape[1]
    m = dds.n_samples
    if m <= p:
        dds.assays["originalCounts"] = dds.counts.copy()
        return dds
    if cooks_cutoff is None:
        cooks_cutoff = f_dist.ppf(0.99, p, m - p)
    cooks = as_t(dds.assays["cooks"], dev)
    outlier_mask = cooks > cooks_cutoff       # NaN compares False
    dds.set_row_data("replace", to_np(outlier_mask.any(dim=1)),
                     "intermediate", "had counts replaced")
    nf = full_factors(factors_t(dds, dev), dds.n_genes)
    trim_base_mean = r_trimmed_mean(counts_t(dds, dev) / nf, trim)
    replacement = (trim_base_mean[:, None] * nf).to(torch.int64)

    if which_samples is None:
        which_samples = n_or_more_in_cell(dds.attrs["modelMatrix"],
                                          min_replicates)
    which_samples = np.asarray(which_samples, dtype=bool)
    dds.col_data["replaceable"] = which_samples
    dds.assays["originalCounts"] = dds.counts
    if which_samples.sum() == 0:
        return dds
    c_dev = device_counts(dds, dev)
    take = outlier_mask & torch.as_tensor(which_samples, device=dev)[None, :]
    dds._counts_dev = torch.where(take, replacement.to(c_dev.dtype), c_dev)
    r, c = (to_np(v) for v in torch.nonzero(take, as_tuple=True))
    new_counts = dds.counts.copy()
    new_counts[r, c] = to_np(replacement[take]).astype(new_counts.dtype)
    dds.counts = new_counts
    return dds


def _splice_rows(a, idx, sub, dev):
    """A copy of the (G,S) assay `a` with rows `idx` taken from `sub`."""
    out = as_t(a, dev).clone()
    out[idx_t(idx, dev)] = as_t(sub, dev)
    return dev_array(out)


def refit_without_outliers(dds, test, beta_prior, full, reduced, quiet,
                           min_replicates_for_replace, model_matrix,
                           model_matrix_type, device=None):
    """Replace outliers then refit dispersions + GLM on replaced rows only,
    splicing results back (reference refitWithoutOutliers,
    R/core.R:2484-2563)."""
    from .engine import device_counts
    from .lrt import nbinom_lrt
    from .wald import nbinom_wald_test

    dev = resolve_device(device)
    cooks = dds.assays["cooks"]
    counts_orig_dev = device_counts(dds, dev)
    with profiling.stage("outliers.replace", genes=dds.n_genes):
        dds = replace_outliers(dds,
                               min_replicates=min_replicates_for_replace,
                               device=dev)

    replace = dds.row_data.get("replace")
    nrefit = int(np.nansum(replace)) if replace is not None else 0
    if nrefit > 0:
        dds = get_base_means_and_variances(dds, dev)
        new_all_zero = np.where(replace & dds.row_data["allZero"])[0]
    if nrefit > 0 and nrefit > len(new_all_zero):
        refit_idx = np.where(replace & ~dds.row_data["allZero"])[0]
        object_sub = dds.subset_genes(refit_idx)
        # strip intermediate/results columns
        drop = [n for n, (t, _) in object_sub.row_meta.items()
                if t in ("intermediate", "results")]
        object_sub.remove_row_data(drop)

        object_sub = estimate_dispersions_gene_est(
            object_sub, quiet=quiet, model_matrix=model_matrix, device=dev)
        # redo fitted dispersion on the new base means
        disp_fn = dds.dispersion_function
        object_sub.dispersion_function = disp_fn
        disp_fit = np.full(object_sub.n_genes, np.nan)
        nzs = ~object_sub.row_data["allZero"]
        disp_fit[nzs] = disp_fn(object_sub.row_data["baseMean"][nzs])
        object_sub.set_row_data("dispFit", disp_fit, "intermediate",
                                "fitted values of dispersion")
        disp_prior_var = disp_fn.disp_prior_var
        object_sub = estimate_dispersions_map(
            object_sub, quiet=quiet, disp_prior_var=disp_prior_var,
            model_matrix=model_matrix, device=dev)
        if test == "Wald":
            beta_prior_var = dds.attrs.get("betaPriorVar")
            object_sub = nbinom_wald_test(
                object_sub, beta_prior=beta_prior,
                beta_prior_var=beta_prior_var, quiet=quiet,
                model_matrix=model_matrix,
                model_matrix_type=model_matrix_type, device=dev)
        else:
            object_sub = nbinom_lrt(object_sub, full=full, reduced=reduced,
                                    quiet=quiet, device=dev)

        # splice back per-gene results
        for name in object_sub.row_data:
            if name in dds.row_data:
                dds.row_data[name][refit_idx] = object_sub.row_data[name]
        for name in ("mu", "H", "cooks"):
            if name in object_sub.assays and name in dds.assays:
                dds.assays[name] = _splice_rows(
                    dds.assays[name], refit_idx, object_sub.assays[name],
                    dev)
        # newly all-zero rows: results go NA
        res_cols = [n for n, (t, _) in dds.row_meta.items()
                    if t == "results"]
        for n in res_cols:
            if dds.row_data[n].dtype.kind == "f":
                dds.row_data[n][new_all_zero] = np.nan

        if np.all(dds.col_data["replaceable"]):
            dds.row_data["maxCooks"] = np.full(dds.n_genes, np.nan)
        else:
            replace_cooks = as_t(dds.assays["cooks"], dev).clone()
            replace_cooks[:, torch.as_tensor(
                np.where(dds.col_data["replaceable"])[0], device=dev)] = 0.0
            dds.row_data["maxCooks"] = record_max_cooks(
                dds.attrs["dispModelMatrix"], replace_cooks, dds.n_genes)

    if nrefit > 0:
        dds.assays["replaceCounts"] = dev_array(device_counts(dds, dev))
        dds.assays["replaceCooks"] = dds.assays["cooks"]
        dds.counts = dds.assays["originalCounts"]
        dds._counts_dev = counts_orig_dev
        dds.assays["cooks"] = cooks
        del dds.assays["originalCounts"]
    return dds
