"""Utility functions: collapseReplicates, fpm/fpkm, unmix (the JAX
package's helper.py).

Reference: R/helper.R:70-391.

These are host numpy over a dataset's counts and (G,) columns, as in the
JAX package; where they need size factors they estimate them on `device`
(the card unless the caller passes device="cpu").  covariance_matrix
reads a fit's columns whichever engine wrote them (host numpy, or the
fused engine's columns still on the device, fetched on first touch).
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.optimize

from .formula import Factor
from .sizefactors import estimate_size_factors, size_factors_for_matrix

__all__ = ["collapse_replicates", "fpm", "fpkm", "unmix",
           "covariance_matrix", "normalize_gene_length",
           "integrate_with_single_cell", "make_counts_from_abundance"]


def collapse_replicates(dds, groupby, run=None, rename_cols=True):
    """Sum technical-replicate columns by a grouping factor
    (reference collapseReplicates, R/helper.R:187-216)."""
    if not isinstance(groupby, Factor):
        groupby = Factor(np.asarray(groupby).astype(str))
    groupby = groupby.droplevels()
    if len(groupby) != dds.n_samples:
        raise ValueError("groupby must be as long as the columns of object")
    if len(dds.assays) > 0:
        warnings.warn("collapse_replicates only sums the counts; other "
                      "assays are dropped and must be combined manually")
    groups = [np.where(groupby.codes == i)[0]
              for i in range(groupby.nlevels)]
    countdata = np.column_stack(
        [dds.counts[:, idx].sum(axis=1) for idx in groups]).astype(np.int64)
    cols_to_keep = [int(idx[0]) for idx in groups]
    collapsed = dds.copy()
    collapsed.counts = countdata
    # the source's device copy of its counts has the other shape
    collapsed._counts_dev = None
    collapsed.assays = {}
    collapsed.col_data = {
        k: (v[cols_to_keep] if isinstance(v, Factor)
            else np.asarray(v)[cols_to_keep])
        for k, v in dds.col_data.items()}
    collapsed.col_names = ([groupby.levels[i]
                            for i in range(groupby.nlevels)]
                           if rename_cols
                           else [dds.col_names[i] for i in cols_to_keep])
    if run is not None:
        run = np.asarray(run)
        if len(run) != len(groupby):
            raise ValueError("run must be as long as groupby")
        collapsed.col_data["runsCollapsed"] = np.array(
            [",".join(run[idx]) for idx in groups], dtype=object)
    if dds.counts.sum() != collapsed.counts.sum():
        raise RuntimeError("collapsed counts do not sum to the original")
    return collapsed


def fpm(dds, robust=True, device=None):
    """Fragments per million (reference fpm, R/helper.R:378-391)."""
    no_avg_tx_len = "avgTxLength" not in dds.assays
    if robust and dds.size_factors is None and no_avg_tx_len:
        dds = estimate_size_factors(dds, device=device)
    k = dds.counts.astype(np.float64)
    if robust and no_avg_tx_len:
        library_sizes = dds.size_factors * np.exp(
            np.mean(np.log(k.sum(axis=0))))
    else:
        library_sizes = k.sum(axis=0)
    return 1e6 * k / library_sizes[None, :]


def fpkm(dds, robust=True, device=None):
    """Fragments per kilobase per million (reference fpkm,
    R/helper.R:291-323).

    Feature length comes from (1) the avgTxLength assay, else
    (2) row_data['basepairs']."""
    f = fpm(dds, robust=robust, device=device)
    if "avgTxLength" in dds.assays:
        exprs = 1e3 * f / np.asarray(dds.assays["avgTxLength"], np.float64)
        if robust:
            sf = size_factors_for_matrix(exprs, device=device)
            return exprs / sf[None, :]
        return exprs
    basepairs = dds.row_data.get("basepairs")
    if basepairs is None:
        raise ValueError(
            "supply row_data['basepairs'] (no genomic ranges support); "
            "it will be used to produce FPKM values")
    if np.all(basepairs == 0):
        raise ValueError("all basepairs are zero")
    return 1e3 * f / np.asarray(basepairs, dtype=np.float64)[:, None]


def unmix(x, pure, alpha=None, shift=None, power=1, return_details=False,
          quiet=True):
    """Deconvolve bulk mixtures against pure-component profiles
    (reference unmix, R/helper.R:70-132).

    Per-sample L-BFGS-B minimizing sum |VST(x) - VST(pure @ p)|^power;
    rows of the returned mixture matrix are normalized to sum 1."""
    x = np.asarray(x, dtype=np.float64)
    pure = np.asarray(pure, dtype=np.float64)
    if (alpha is None) == (shift is None):
        raise ValueError("provide exactly one of alpha or shift")
    if power not in (1, 2):
        raise ValueError("power must be 1 or 2")
    if x.shape[0] != pure.shape[0]:
        raise ValueError("x and pure must have the same number of rows")
    if pure.shape[1] <= 1:
        raise ValueError("pure must have more than one column")

    if shift is None:
        if alpha <= 0:
            raise ValueError("alpha must be positive")

        def vst(q):
            return (2.0 * np.arcsinh(np.sqrt(alpha * q)) - np.log(alpha)
                    - np.log(4.0)) / np.log(2.0)
        lower = 1e-6
    else:
        if shift <= 0:
            raise ValueError("shift must be positive")

        def vst(q):
            return np.log(q + shift)
        lower = 0.0

    pure_v = vst(pure)
    cc = np.corrcoef(pure_v, rowvar=False)
    np.fill_diagonal(cc, 0.0)
    if np.any(cc > 0.99):
        warnings.warn("some columns of 'pure' are highly correlated (>.99 "
                      "after VST), may result in instability of unmix()")

    n_comp = pure.shape[1]
    mix = np.empty((x.shape[1], n_comp))
    for i in range(x.shape[1]):
        target = vst(x[:, i])

        def loss(p):
            return np.sum(np.abs(target - vst(pure @ p)) ** power)

        res = scipy.optimize.minimize(
            loss, np.ones(n_comp), method="L-BFGS-B",
            bounds=[(lower, 100.0)] * n_comp)
        mix[i] = res.x
    mix = mix / mix.sum(axis=1, keepdims=True)
    if return_details:
        fitted = pure @ mix.T
        cors = np.array([np.corrcoef(vst(x[:, i]), vst(fitted[:, i]))[0, 1]
                         for i in range(x.shape[1])])
        return dict(mix=mix, cor=cors, fitted=fitted)
    return mix


def covariance_matrix(dds, row_number):
    """Covariance matrix of the GLM coefficients of a single gene, log2
    scale (reference covarianceMatrix diagnostic, R/core.R:2373-2398).

    Rebuilds the sandwich sigma = A^-1 (X'WX) A^-1 with
    A = X'WX + ridge(1/betaPriorVar) from the stored log2 coefficients.
    Only for standard model matrices."""
    if dds.attrs.get("modelMatrixType") != "standard":
        raise ValueError("only for standard model matrices")
    ln2 = np.log(2.0)
    coef_cols = dds.results_names()
    beta = ln2 * np.array([float(dds.row_data[c][row_number])
                           for c in coef_cols])
    x, _ = dds.model_matrix()
    sf = dds.size_factors
    alpha = float(dds.row_data["dispersion"][row_number])
    mu_hat = np.maximum(sf * np.exp(x @ beta), 0.5)
    # W = diag(1 / (1/mu^2 * (mu + alpha mu^2))) = mu / (1 + alpha mu)
    w = mu_hat / (1.0 + alpha * mu_hat)
    beta_prior_var = np.asarray(dds.attrs["betaPriorVar"], dtype=np.float64)
    ridge = np.diag(1.0 / (ln2 ** 2 * beta_prior_var))
    xtwx = (x * w[:, None]).T @ x
    a_inv = np.linalg.inv(xtwx + ridge)
    sigma = a_inv @ xtwx @ a_inv.T
    return np.log2(np.e) ** 2 * sigma


def normalize_gene_length(*args, **kwargs):
    """Deprecated in the reference (R/helper.R:393-398): normalization for
    gene length was moved upstream of DESeq2 (tximport pipeline)."""
    raise NotImplementedError(
        "normalizeGeneLength is deprecated in the reference; use the "
        "tximport ingestion path (dataset_from_tximport) where average "
        "transcript lengths become normalization factors")


def integrate_with_single_cell(res, dds, csv_table=None):
    """Menu-driven integration of bulk DE results with pre-processed
    scRNA-seq datasets (reference integrateWithSingleCell,
    R/helper.R:476-580).

    The reference reads a packaged CSV of Bioconductor dataset accessors
    and interactively prompts the user; those packages don't exist
    outside Bioconductor, so this port resolves the organism the same
    way (tximeta metadata, else ENSG/ENSMUSG gene-id prefixes) and
    returns the organism plus the organism-filtered dataset menu (the
    vendored catalog from the reference's singleCellTab.csv — see
    singlecell_tab.py) for the caller to act on.  Pass `csv_table` (list
    of dicts with keys org/pkg/func/data/pub/n_cells/desc) to supply a
    custom menu."""
    if csv_table is None:
        from .singlecell_tab import SINGLE_CELL_TAB
        csv_table = SINGLE_CELL_TAB
    org_meta = dds.metadata.get("txomeInfo", {}) if hasattr(
        dds, "metadata") and isinstance(getattr(dds, "metadata", None),
                                        dict) else {}
    tximeta_org = org_meta.get("organism")
    if tximeta_org is not None:
        if tximeta_org == "Homo sapiens":
            org = "human"
        elif tximeta_org == "Mus musculus":
            org = "mouse"
        else:
            raise ValueError("Only human and mouse are currently supported")
    else:
        test_gene = (res.row_names[0] if getattr(res, "row_names", None)
                     is not None else "")
        if str(test_gene).startswith("ENSG"):
            org = "human"
        elif str(test_gene).startswith("ENSMUSG"):
            org = "mouse"
        else:
            raise ValueError("Only human and mouse are currently supported")
    tab = [row for row in (csv_table or []) if row.get("org") == org]
    return dict(org=org, datasets=tab, res=res, dds=dds)


def make_counts_from_abundance(counts, abundance, length,
                               counts_from_abundance="lengthScaledTPM"):
    """tximport::makeCountsFromAbundance equivalent (vendored for the
    tximport ingestion contract exercised by the reference's
    tests/testthat/test_txi.R:22-28).

    'scaledTPM': abundance columns rescaled so each sample's total
    matches its original count total.  'lengthScaledTPM': abundance is
    first multiplied by the gene's mean transcript length across
    samples, then rescaled the same way.
    """
    counts = np.asarray(counts, dtype=np.float64)
    abundance = np.asarray(abundance, dtype=np.float64)
    if counts_from_abundance == "lengthScaledTPM":
        length = np.asarray(length, dtype=np.float64)
        new_cts = abundance * length.mean(axis=1, keepdims=True)
    elif counts_from_abundance == "scaledTPM":
        new_cts = abundance.copy()
    else:
        raise ValueError("countsFromAbundance must be 'scaledTPM' or "
                         "'lengthScaledTPM'")
    scale = counts.sum(axis=0) / new_cts.sum(axis=0)
    return new_cts * scale[None, :]
