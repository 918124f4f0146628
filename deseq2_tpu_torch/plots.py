"""Visualization layer: plotDispEsts, plotMA, plotPCA, plotCounts,
plotSparsity (reference R/plots.R:1-451; the JAX package's plots.py).

Each plot function is split into a pure data-preparation function
(`*_data`, returns plain arrays/dicts — unit-testable, no display
dependency) and a thin matplotlib rendering wrapper.  matplotlib is
imported lazily so headless/compute-only installs never pay for it.
"""

from __future__ import annotations

import numpy as np
import torch

from .formula import Factor


def _require_mpl():
    try:
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
        return plt
    except ImportError as e:  # pragma: no cover
        raise ImportError("matplotlib is required for plotting") from e


# ---------------------------------------------------------------------------
# plotDispEsts (reference R/plots.R:1-85)
# ---------------------------------------------------------------------------

def plot_disp_ests_data(dds):
    """Gene-wise / fitted / final dispersion estimates over baseMean."""
    for col in ("baseMean", "dispGeneEst", "dispersion"):
        if col not in dds.row_data:
            raise ValueError("first run estimate_dispersions()")
    px = dds.row_data["baseMean"]
    sel = px > 0
    return dict(
        base_mean=px[sel],
        gene_est=dds.row_data["dispGeneEst"][sel],
        fitted=(dds.row_data["dispFit"][sel]
                if "dispFit" in dds.row_data else None),
        final=dds.row_data["dispersion"][sel],
        outlier=(dds.row_data["dispOutlier"][sel].astype(bool)
                 if "dispOutlier" in dds.row_data else
                 np.zeros(int(sel.sum()), dtype=bool)),
    )


def plot_disp_ests(dds, ymin=None, gene_color="black", fit_color="red",
                   final_color="dodgerblue", legend=True, ax=None):
    plt = _require_mpl()
    d = plot_disp_ests_data(dds)
    if ax is None:
        _, ax = plt.subplots()
    if ymin is None:
        with np.errstate(invalid="ignore"):
            pos = d["gene_est"][d["gene_est"] > 0]
        ymin = 10 ** (np.floor(np.log10(np.nanmin(pos)) + 0.1)) \
            if pos.size else 1e-8
    ax.scatter(d["base_mean"], np.maximum(d["gene_est"], ymin), s=2,
               c=gene_color, label="gene-est", alpha=0.5)
    ax.scatter(d["base_mean"], d["final"], s=2, c=final_color,
               label="final", alpha=0.5)
    out = d["outlier"]
    if out.any():
        ax.scatter(d["base_mean"][out], d["final"][out], s=16,
                   facecolors="none", edgecolors=final_color,
                   label="outlier")
    if d["fitted"] is not None:
        o = np.argsort(d["base_mean"])
        ax.plot(d["base_mean"][o], d["fitted"][o], c=fit_color,
                label="fitted")
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel("mean of normalized counts")
    ax.set_ylabel("dispersion")
    if legend:
        ax.legend(loc="lower left", fontsize="small")
    return ax


# ---------------------------------------------------------------------------
# plotMA (reference R/plots.R:89-237)
# ---------------------------------------------------------------------------

def plot_ma_data(res, alpha=None):
    """MA-plot triples (mean, lfc, significant) from a results table."""
    if alpha is None:
        alpha = res.metadata.get("alpha", 0.1)
    padj = res.padj if res.padj is not None else \
        np.full_like(res.base_mean, np.nan)
    with np.errstate(invalid="ignore"):
        is_de = np.where(np.isnan(padj), False, padj < alpha)
    return dict(mean=res.base_mean, lfc=res.log2_fold_change,
                is_de=is_de, alpha=alpha)


def plot_ma(res, alpha=None, main="", xlab="mean of normalized counts",
            ylim=None, colNonSig="gray60", colSig="blue", ax=None):
    plt = _require_mpl()
    d = plot_ma_data(res, alpha=alpha)
    if ax is None:
        _, ax = plt.subplots()
    sel = d["mean"] > 0
    mean, lfc, sig = d["mean"][sel], d["lfc"][sel], d["is_de"][sel]
    if ylim is not None:
        lfc = np.clip(lfc, ylim[0], ylim[1])
    ax.scatter(mean[~sig], lfc[~sig], s=2, c="gray", alpha=0.5)
    ax.scatter(mean[sig], lfc[sig], s=2, c="tab:blue", alpha=0.7)
    ax.axhline(0.0, c="red", lw=0.8)
    ax.set_xscale("log")
    ax.set_xlabel(xlab)
    ax.set_ylabel("log fold change")
    if ylim is not None:
        ax.set_ylim(*ylim)
    if main:
        ax.set_title(main)
    return ax


# ---------------------------------------------------------------------------
# plotPCA (reference R/plots.R:239-337)
# ---------------------------------------------------------------------------

def plot_pca_data(transform, intgroup=("condition",), ntop=500, pc_x=1,
                  pc_y=2):
    """PCA on the top-`ntop` variance genes of a DESeqTransform.

    Returns dict(x, y, percent_var, group, sample_names) matching the
    reference's returnData=TRUE data.frame."""
    if isinstance(intgroup, str):
        intgroup = (intgroup,)
    raw = getattr(transform, "matrix_device", None)
    if torch.is_tensor(raw):
        # payload on the device (vst/rlog): the row variances and the
        # top-ntop gather run there, and only (ntop, S) is downloaded
        rv = raw.var(dim=1, correction=1)
        sel = torch.argsort(rv, descending=True)[:min(ntop, raw.shape[0])]
        x = raw[sel].double().cpu().numpy().T  # samples x genes
        n_samples = raw.shape[1]
    else:
        mat = np.asarray(transform.matrix, dtype=np.float64)
        rv = mat.var(axis=1, ddof=1)
        select = np.argsort(rv)[::-1][:min(ntop, mat.shape[0])]
        n_samples = mat.shape[1]
        x = mat[select].T  # samples x genes
    xc = x - x.mean(axis=0, keepdims=True)
    u, s, _ = np.linalg.svd(xc, full_matrices=False)
    var_explained = s ** 2 / np.sum(s ** 2)
    pcs = u * s[None, :]
    missing = [g for g in intgroup if g not in transform.col_data]
    if missing:
        raise ValueError(f"the argument 'intgroup' should specify columns "
                         f"of col_data; missing: {missing}")
    groups = []
    for j in range(n_samples):
        vals = []
        for g in intgroup:
            v = transform.col_data[g]
            vals.append(v.as_strings()[j] if isinstance(v, Factor)
                        else str(np.asarray(v)[j]))
        groups.append(":".join(vals))
    return dict(x=pcs[:, pc_x - 1], y=pcs[:, pc_y - 1],
                percent_var=var_explained, group=np.asarray(groups),
                sample_names=list(transform.col_names or
                                  range(n_samples)))


def plot_pca(transform, intgroup=("condition",), ntop=500, pc_x=1, pc_y=2,
             ax=None):
    plt = _require_mpl()
    d = plot_pca_data(transform, intgroup, ntop, pc_x, pc_y)
    if ax is None:
        _, ax = plt.subplots()
    for g in np.unique(d["group"]):
        m = d["group"] == g
        ax.scatter(d["x"][m], d["y"][m], label=g)
    ax.set_xlabel(f"PC{pc_x}: {d['percent_var'][pc_x-1]*100:.0f}% variance")
    ax.set_ylabel(f"PC{pc_y}: {d['percent_var'][pc_y-1]*100:.0f}% variance")
    ax.legend(fontsize="small")
    return ax


# ---------------------------------------------------------------------------
# plotCounts (reference R/plots.R:365-415)
# ---------------------------------------------------------------------------

def plot_counts_data(dds, gene, intgroup="condition", normalized=True,
                     transform=True, replaced=False, pc=None, device=None):
    """Normalized counts of one gene by group (size factors, when missing,
    estimated on `device`)."""
    if isinstance(gene, (int, np.integer)):
        idx = int(gene)
    else:
        if dds.row_names is None or gene not in dds.row_names:
            raise ValueError(f"gene {gene!r} not found in row names")
        idx = dds.row_names.index(gene)
    if intgroup not in dds.col_data:
        raise ValueError("intgroup should be a column of col_data")
    if normalized and dds.size_factors is None and \
            dds.normalization_factors is None:
        from .sizefactors import estimate_size_factors
        dds = estimate_size_factors(dds, device=device)
    if replaced and "replaceCounts" in dds.assays:
        cnts = np.asarray(dds.assays["replaceCounts"][idx], np.float64)
    else:
        cnts = np.asarray(dds.counts[idx], dtype=np.float64)
    if normalized:
        nf = dds.size_or_norm_factors()
        cnts = cnts / (nf[idx] if nf.ndim == 2 else nf)
    if pc is None:
        pc = 0.5 if transform else 0.0
    group = dds.col_data[intgroup]
    glabels = group.as_strings() if isinstance(group, Factor) else \
        [str(v) for v in np.asarray(group)]
    name = dds.row_names[idx] if dds.row_names else f"gene{idx}"
    return dict(count=cnts + pc, group=np.asarray(glabels), gene=name,
                log_scale=transform)


def plot_counts(dds, gene, intgroup="condition", normalized=True,
                transform=True, ax=None, device=None):
    plt = _require_mpl()
    d = plot_counts_data(dds, gene, intgroup, normalized, transform,
                         device=device)
    if ax is None:
        _, ax = plt.subplots()
    levels = list(dict.fromkeys(d["group"]))
    pos = {g: i for i, g in enumerate(levels)}
    xs = np.array([pos[g] for g in d["group"]], dtype=float)
    xs = xs + np.random.default_rng(0).uniform(-0.05, 0.05, len(xs))
    ax.scatter(xs, d["count"])
    if d["log_scale"]:
        ax.set_yscale("log")
    ax.set_xticks(range(len(levels)), levels)
    ax.set_xlabel("group")
    ax.set_ylabel("normalized count")
    ax.set_title(d["gene"])
    return ax


# ---------------------------------------------------------------------------
# plotSparsity (reference R/plots.R:437-445)
# ---------------------------------------------------------------------------

def plot_sparsity_data(dds, normalized=True, device=None):
    """Row sums and the largest sample's share of them (size factors,
    when missing, estimated on `device`)."""
    if normalized and dds.size_factors is None and \
            dds.normalization_factors is None:
        from .sizefactors import estimate_size_factors
        dds = estimate_size_factors(dds, device=device)
    x = dds.counts_normalized() if normalized else \
        dds.counts.astype(np.float64)
    rs = x.sum(axis=1)
    rmx = x.max(axis=1)
    keep = rs > 0
    return dict(sum=rs[keep], max_prop=(rmx / rs)[keep])


def plot_sparsity(dds, normalized=True, ax=None, device=None):
    plt = _require_mpl()
    d = plot_sparsity_data(dds, normalized, device=device)
    if ax is None:
        _, ax = plt.subplots()
    ax.scatter(d["sum"], d["max_prop"], s=2, alpha=0.5)
    ax.set_xscale("log")
    ax.set_ylim(0, 1.05)
    ax.set_xlabel("sum of counts per gene")
    ax.set_ylabel("max count / sum")
    ax.set_title("Concentration of counts over total sum of counts")
    return ax
