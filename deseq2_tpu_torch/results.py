"""Results tables: alt hypotheses, Cook's masking, independent filtering,
BH adjustment.

Reference: results() (R/results.R:298-615), pvalueAdjustment/filtered_p
(R/results.R:638-740), makeWaldTest (R/results.R:1101-1118), with the LRT
and useT arms.  Contrasts (getContrast/cleanContrast, R/results.R:760-1040)
are not ported yet and raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy.stats import f as f_dist
from scipy.stats import norm
from scipy.stats import t as t_dist

from . import profiling
from .formula import Factor
from .quantiles import r_quantile_type7
from .stats_r import p_adjust, r_lowess

LOG2E = np.log2(np.e)
LN2 = np.log(2.0)


@dataclass
class DESeqResults:
    """Results table (reference DESeqResults, R/AllClasses.R:431-456)."""

    base_mean: np.ndarray
    log2_fold_change: np.ndarray
    lfc_se: np.ndarray
    stat: np.ndarray
    pvalue: np.ndarray
    padj: np.ndarray = None
    svalue: np.ndarray = None
    row_names: list = None
    descriptions: dict = field(default_factory=dict)
    prior_info: dict = field(default_factory=dict)
    metadata: dict = field(default_factory=dict)
    extra_columns: dict = field(default_factory=dict)

    # pandas-free column access
    def __getitem__(self, key):
        mapping = {"baseMean": "base_mean", "log2FoldChange":
                   "log2_fold_change", "lfcSE": "lfc_se", "stat": "stat",
                   "pvalue": "pvalue", "padj": "padj", "svalue": "svalue"}
        if key in mapping:
            return getattr(self, mapping[key])
        return self.extra_columns[key]

    @property
    def column_names(self):
        cols = ["baseMean", "log2FoldChange", "lfcSE", "stat", "pvalue"]
        if self.padj is not None:
            cols.append("padj")
        if self.svalue is not None:
            cols.append("svalue")
        return cols + list(self.extra_columns)

    def to_dict(self):
        return {c: self[c] for c in self.column_names}

    def summary(self, alpha=None, quiet=False):
        """Census of up/down/outlier/low-count genes; prints like the
        reference summary method (R/methods.R:766-824) and returns the
        text (pass quiet=True to suppress printing)."""
        if alpha is None:
            alpha = self.metadata.get("alpha", 0.1)
        pv = self.padj if self.padj is not None else self.pvalue
        notallzero = self.base_mean > 0
        up = np.nansum((pv < alpha) & (self.log2_fold_change > 0))
        down = np.nansum((pv < alpha) & (self.log2_fold_change < 0))
        outlier = int(np.sum(notallzero & np.isnan(self.pvalue)))
        ft = self.metadata.get("filterThreshold")
        if ft is not None:
            lowcounts = int(np.sum(notallzero & ~np.isnan(self.pvalue)
                                   & np.isnan(pv)))
        else:
            lowcounts = 0
        total = int(np.sum(notallzero))
        lines = [
            f"out of {total} with nonzero total read count",
            f"adjusted p-value < {alpha}",
            f"LFC > 0 (up)       : {int(up)}, "
            f"{100 * up / total:.2g}%",
            f"LFC < 0 (down)     : {int(down)}, "
            f"{100 * down / total:.2g}%",
            f"outliers [1]       : {outlier}, "
            f"{100 * outlier / total:.2g}%",
            f"low counts [2]     : {lowcounts}, "
            f"{100 * lowcounts / total:.2g}%",
        ]
        if ft is not None:
            lines.append(f"(mean count < {float(ft):.2g})")
        text = "\n".join(lines)
        if not quiet:
            print(text)
        return text


def results_names(dds):
    return dds.results_names()


def remove_results(dds):
    dds = dds.copy()
    dds.remove_results()
    return dds


# ---------------------------------------------------------------------------
# results()
# ---------------------------------------------------------------------------

def results(dds, contrast=None, name=None, lfc_threshold=0.0,
            alt_hypothesis="greaterAbs", list_values=(1, -1),
            cooks_cutoff=None, independent_filtering=True, alpha=0.1,
            filter=None, theta=None, p_adjust_method="BH", test=None,
            minmu=0.5, add_mle=False, save_cols=None, tidy=False):
    """Extract a results table (reference results(), R/results.R:298-615).

    `save_cols` copies the named `dds.row_data` (mcols) columns into the
    table's extra columns (reference saveCols, R/results.R:604-609);
    `tidy=True` returns a plain dict of columns with the gene ids first
    under 'row' (reference tidy output, R/results.R:601-603)."""
    if alt_hypothesis not in ("greaterAbs", "lessAbs", "greater", "less",
                              "greaterAbs2014"):
        raise ValueError("unknown altHypothesis")
    if lfc_threshold < 0:
        raise ValueError("lfcThreshold must be non-negative")
    if not (0 < alpha < 1):
        raise ValueError("alpha must be in (0,1)")
    if not any(t == "results" for t, _ in dds.row_meta.values()):
        raise ValueError("couldn't find results. you should first run deseq()")
    if test is None:
        test = dds.attrs["test"]
    elif test == "Wald" and dds.attrs["test"] == "LRT":
        dds = make_wald_test(dds)
    elif test == "LRT" and dds.attrs["test"] == "Wald":
        raise ValueError("the LRT requires the user to run nbinom_lrt or "
                         "deseq(dds, test='LRT')")
    if lfc_threshold == 0 and alt_hypothesis == "lessAbs":
        raise ValueError("when testing altHypothesis='lessAbs', set "
                         "lfcThreshold to a positive value")

    res_names = dds.results_names()
    is_expanded = dds.attrs.get("modelMatrixType") == "expanded"
    has_intercept = dds.design_has_intercept() \
        if not isinstance(dds.design, np.ndarray) else False

    # default contrast: last level vs first level of the last design factor
    if not isinstance(dds.design, np.ndarray):
        terms_order = dds.design.term_orders
        if (test == "Wald" and (is_expanded or not has_intercept)
                and contrast is None and name is None
                and all(o < 2 for o in terms_order)):
            design_vars = dds.design.variables
            last_var = design_vars[-1] if design_vars else None
            if last_var is not None and isinstance(
                    dds.col_data.get(last_var), Factor):
                lv = dds.col_data[last_var]
                contrast = (last_var, lv.levels[-1], lv.levels[0])
    if name is None:
        name = res_names[-1]

    use_t = "tDegreesFreedom" in dds.row_data

    if (contrast is not None
            and dds.attrs.get("modelMatrixType") == "user-supplied"
            and isinstance(contrast, (tuple, list))
            and all(isinstance(c, str) for c in contrast)):
        # (reference R/results.R:376-378)
        raise ValueError("only list- and numeric-type contrasts are "
                         "supported for user-supplied model matrices")

    if add_mle:
        # (reference R/results.R:348-355, 454-460)
        if not dds.attrs.get("betaPrior"):
            raise ValueError("addMLE=TRUE is only for when a beta prior "
                             "was used. otherwise, the log2 fold changes "
                             "are already MLE")
        if not (isinstance(contrast, (list, tuple)) and len(contrast) == 3
                and all(isinstance(c, str) for c in contrast)):
            raise ValueError("addMLE=TRUE should be used by providing "
                             "character vector of length 3 to 'contrast'")

    # Fast path after a fused-engine run: the pipeline already computed
    # the default results tail ON DEVICE (Cook's masking incl. the
    # two-group heuristic, zeroed replaced rows, the independent-
    # filtering grid); a default-argument call fetches five (G,)
    # vectors instead of re-masking and re-filtering host-side.
    fast = _fused_tail_results(dds, contrast, name, lfc_threshold,
                               alt_hypothesis, cooks_cutoff,
                               independent_filtering, filter, theta,
                               p_adjust_method, alpha, test, add_mle)
    if fast is not None:
        fast.metadata["lfcThreshold"] = lfc_threshold
        fast.row_names = list(dds.row_names)
        if save_cols:
            for c in ([save_cols] if isinstance(save_cols, str)
                      else save_cols):
                if c not in dds.row_data:
                    raise ValueError(f"saveCols column '{c}' not in mcols")
                fast.extra_columns[c] = np.asarray(dds.row_data[c]).copy()
        if tidy:
            out = {"row": list(fast.row_names)}
            out.update(fast.to_dict())
            return out
        return fast

    if contrast is not None:
        from .parallel.fused import not_ported
        raise not_ported("results() with a contrast")
    with profiling.stage("results.pullColumns"):
        res = _pull_columns(dds, name, test)

    # alternative hypotheses / lfcThreshold (R/results.R:464-518)
    if not (lfc_threshold == 0 and alt_hypothesis == "greaterAbs"):
        if test == "LRT":
            raise ValueError("tests of log fold change above or below a "
                             "threshold must be Wald tests.")
        if alt_hypothesis == "lessAbs" and dds.attrs.get("betaPrior"):
            raise ValueError("testing altHypothesis='lessAbs' requires "
                             "setting the DESeq() argument betaPrior=FALSE")
        LFC = res.log2_fold_change
        SE = res.lfc_se
        T = lfc_threshold
        if use_t:
            df = dds.row_data["tDegreesFreedom"]

            def pfunc(q):
                return t_dist.sf(q, df)
        else:
            pfunc = norm.sf
        with np.errstate(divide="ignore", invalid="ignore"):
            if alt_hypothesis == "greaterAbs":
                # two-tailed sum version (2023, Nikos Ignatiadis)
                if use_t:
                    new_p = (t_dist.sf((np.abs(LFC) - T) / SE, df)
                             + t_dist.sf((np.abs(LFC) + T) / SE, df))
                else:
                    new_p = (norm.cdf(-np.abs(LFC) + T, scale=SE)
                             + norm.cdf(-np.abs(LFC) - T, scale=SE))
                new_stat = LFC / SE
            elif alt_hypothesis == "greaterAbs2014":
                new_stat = np.sign(LFC) * np.maximum((np.abs(LFC) - T) / SE, 0)
                new_p = np.minimum(1.0, 2.0 * pfunc((np.abs(LFC) - T) / SE))
            elif alt_hypothesis == "lessAbs":
                stat_above = np.maximum((T - LFC) / SE, 0)
                p_above = pfunc((T - LFC) / SE)
                stat_below = np.maximum((LFC + T) / SE, 0)
                p_below = pfunc((LFC + T) / SE)
                new_stat = np.minimum(stat_above, stat_below)
                new_p = np.maximum(p_above, p_below)
            elif alt_hypothesis == "greater":
                new_stat = np.maximum((LFC - T) / SE, 0)
                new_p = pfunc((LFC - T) / SE)
            else:  # less
                new_stat = np.minimum((LFC + T) / SE, 0)
                new_p = pfunc((-T - LFC) / SE)
        res.stat = new_stat
        res.pvalue = new_p

    # Cook's cutoff masking (R/results.R:520-565)
    disp_mm = dds.attrs["dispModelMatrix"]
    m, p = disp_mm.shape
    default_cutoff = f_dist.ppf(0.99, p, m - p) if m > p else np.inf
    if cooks_cutoff is None or cooks_cutoff is True:
        cooks_cutoff = default_cutoff
    perform_cutoff = not (cooks_cutoff is False)
    if perform_cutoff:
      with profiling.stage("results.cooksMask"):
        with np.errstate(invalid="ignore"):
            cooks_outlier = dds.row_data.get("maxCooks") > cooks_cutoff
        cooks_outlier = np.where(np.isnan(dds.row_data.get("maxCooks")),
                                 False, cooks_outlier).astype(bool)
        # two-group heuristic: don't filter if >=3 counts exceed the
        # outlier (vectorized: the cooks assay may be device-resident
        # after a fused-engine run — one gather instead of a fetch per
        # flagged row)
        if np.any(cooks_outlier) and not isinstance(dds.design, np.ndarray):
            dvars = dds.design.variables
            if len(dvars) == 1 and isinstance(dds.col_data.get(dvars[0]),
                                              Factor) \
                    and dds.col_data[dvars[0]].nlevels == 2:
                idxs = np.where(cooks_outlier)[0]
                cooks_rows = np.asarray(dds.assays["cooks"][idxs],
                                        dtype=float)
                counts_rows = np.asarray(dds.counts[idxs])
                jmax = np.nanargmax(cooks_rows, axis=1)
                out_count = counts_rows[np.arange(len(idxs)), jmax]
                unmask = (counts_rows > out_count[:, None]).sum(axis=1) >= 3
                cooks_outlier[idxs[unmask]] = False
        res.pvalue = np.where(cooks_outlier, np.nan, res.pvalue)

    # replaced-to-zero rows (R/results.R:567-575)
    replace = dds.row_data.get("replace")
    if replace is not None and np.nansum(replace) > 0:
        now_zero = np.where(replace & (dds.row_data["baseMean"] == 0))[0]
        res.log2_fold_change[now_zero] = 0
        res.lfc_se[now_zero] = 0
        res.stat[now_zero] = 0
        res.pvalue[now_zero] = 1

    if not dds.attrs.get("betaPrior"):
        res.prior_info = dict(type="none", package="deseq2_tpu")
    else:
        res.prior_info = dict(type="normal", package="deseq2_tpu",
                              betaPriorVar=dds.attrs.get("betaPriorVar"))

    with profiling.stage("results.pvalueAdjustment"):
        res = pvalue_adjustment(res, independent_filtering, filter, theta,
                                alpha, p_adjust_method)
    res.metadata["lfcThreshold"] = lfc_threshold
    res.row_names = list(dds.row_names)
    if save_cols:
        for c in ([save_cols] if isinstance(save_cols, str) else save_cols):
            if c not in dds.row_data:
                raise ValueError(f"saveCols column '{c}' not in mcols")
            res.extra_columns[c] = np.asarray(dds.row_data[c]).copy()
    if tidy:
        out = {"row": list(res.row_names)}
        out.update(res.to_dict())
        return out
    return res


def _fused_tail_results(dds, contrast, name, lfc_threshold,
                        alt_hypothesis, cooks_cutoff,
                        independent_filtering, filter, theta,
                        p_adjust_method, alpha, test, add_mle):
    """Serve a default-argument results() call from the fused engine's
    device-computed tail (engine.deseq_fused stashes it as
    dds._fused_tail).  Returns None when any argument deviates from
    what the pipeline computed, in which case the caller runs the
    host flow.  The device tail equals that flow on the same columns
    (tests/test_torch_public.py)."""
    tail = getattr(dds, "_fused_tail", None)
    if tail is None:
        return None
    if (lfc_threshold != 0 or alt_hypothesis != "greaterAbs" or add_mle
            or filter is not None or theta is not None
            or p_adjust_method != "BH"
            or cooks_cutoff not in (None, True)
            or test != tail["test"] or dds.attrs.get("test") != test):
        return None
    if independent_filtering and alpha != tail["alpha"]:
        return None
    if contrast is not None or name != tail["name"]:
        return None

    if independent_filtering:
        j, lx, lo_fit_y = choose_filter_theta(tail["theta"],
                                              tail["numRej"])
        padj_dev = tail["filterPadj"][j]
    else:
        padj_dev = tail["padjPlain"]
    with profiling.stage("results.fusedTail"):
        f = {k: v.cpu().numpy() for k, v in
             dict(lfc=tail["lfc"], se=tail["se"], stat=tail["stat"],
                  p=tail["pvalue"], padj=padj_dev).items()}
    res = DESeqResults(
        base_mean=np.asarray(dds.row_data["baseMean"], float).copy(),
        log2_fold_change=np.asarray(f["lfc"], float),
        lfc_se=np.asarray(f["se"], float),
        stat=np.asarray(f["stat"], float),
        pvalue=np.asarray(f["p"], float),
        padj=np.asarray(f["padj"], float))
    res.descriptions["log2FoldChange"] = dds.row_meta[tail["name"]][1]
    res.prior_info = dict(type="none", package="deseq2_tpu")
    if independent_filtering:
        res.metadata["filterThreshold"] = float(tail["cutoffs"][j])
        res.metadata["filterTheta"] = float(tail["theta"][j])
        res.metadata["filterNumRej"] = dict(theta=tail["theta"],
                                            numRej=tail["numRej"])
        res.metadata["lo.fit"] = dict(x=lx, y=lo_fit_y)
        res.metadata["alpha"] = alpha
    return res


def _pull_columns(dds, name, test):
    lfc = dds.row_data[name].astype(float)
    lfc_se = dds.row_data["SE_" + name].astype(float)
    if test == "Wald":
        stat = dds.row_data["WaldStatistic_" + name].astype(float)
        pval = dds.row_data["WaldPvalue_" + name].astype(float)
    else:
        stat = dds.row_data["LRTStatistic"].astype(float)
        pval = dds.row_data["LRTPvalue"].astype(float)
    return DESeqResults(base_mean=dds.row_data["baseMean"].copy(),
                        log2_fold_change=lfc.copy(), lfc_se=lfc_se.copy(),
                        stat=stat.copy(), pvalue=pval.copy(),
                        descriptions={"log2FoldChange":
                                      dds.row_meta[name][1]})


# ---------------------------------------------------------------------------
# p-value adjustment with independent filtering
# ---------------------------------------------------------------------------

def filtered_p(filter_stat, test_p, theta, method="BH"):
    """BH per filter cutoff (vendored genefilter impl,
    reference R/results.R:721-740)."""
    cutoffs = r_quantile_type7(filter_stat, theta)
    result = np.full((len(filter_stat), len(theta)), np.nan)
    for i, cut in enumerate(np.atleast_1d(cutoffs)):
        use = filter_stat >= cut
        if np.any(use):
            result[use, i] = p_adjust(test_p[use], method)
    return result


def choose_filter_theta(theta, num_rej):
    """Pick the lowest theta whose rejection count reaches the lowess-fit
    maximum minus its RMSE (reference R/results.R:661-692).  Returns
    (index j, lowess x, lowess y) — the 50-point scalar tail of
    independent filtering, shared by the host and fused paths."""
    lx, lo_fit_y = r_lowess(theta, np.asarray(num_rej, dtype=float),
                            f=1.0 / 5)
    num_rej = np.asarray(num_rej)
    if num_rej.max() <= 10:
        return 0, lx, lo_fit_y
    if np.all(num_rej == 0):
        residual = np.zeros(1)
    else:
        residual = num_rej[num_rej > 0] - lo_fit_y[num_rej > 0]
    max_fit = lo_fit_y.max()
    rmse = np.sqrt(np.mean(residual ** 2))
    thresh = max_fit - rmse
    if np.any(num_rej > thresh):
        j = int(np.where(num_rej > thresh)[0][0])
    elif np.any(num_rej > 0.9 * max_fit):
        j = int(np.where(num_rej > 0.9 * max_fit)[0][0])
    elif np.any(num_rej > 0.8 * max_fit):
        j = int(np.where(num_rej > 0.8 * max_fit)[0][0])
    else:
        j = 0
    return j, lx, lo_fit_y


def pvalue_adjustment(res, independent_filtering, filter, theta, alpha,
                      p_adjust_method="BH"):
    """(reference pvalueAdjustment, R/results.R:638-718)"""
    if independent_filtering:
        if filter is None:
            filter = res.base_mean
        if theta is None:
            lower_quantile = np.mean(filter == 0)
            upper_quantile = 0.95 if lower_quantile < 0.95 else 1.0
            theta = np.linspace(lower_quantile, upper_quantile, 50)
        theta = np.atleast_1d(np.asarray(theta, dtype=np.float64))
        if len(theta) <= 1:
            raise ValueError("theta grid must have length > 1")
        filt_padj = filtered_p(filter, res.pvalue, theta, p_adjust_method)
        with np.errstate(invalid="ignore"):
            num_rej = np.nansum(filt_padj < alpha, axis=0)
        j, lx, lo_fit_y = choose_filter_theta(theta, num_rej)
        padj = filt_padj[:, j]
        cutoffs = r_quantile_type7(filter, theta)
        res.metadata["filterThreshold"] = np.atleast_1d(cutoffs)[j]
        res.metadata["filterTheta"] = theta[j]
        res.metadata["filterNumRej"] = dict(theta=theta, numRej=num_rej)
        res.metadata["lo.fit"] = dict(x=lx, y=lo_fit_y)
        res.metadata["alpha"] = alpha
    else:
        padj = p_adjust(res.pvalue, p_adjust_method)
    res.padj = padj
    return res


def make_wald_test(dds):
    """Add Wald statistics to an LRT-fitted object (reference
    makeWaldTest, R/results.R:1101-1118)."""
    dds = dds.copy()
    for n in dds.results_names():
        beta = dds.row_data[n].astype(float)
        se = dds.row_data["SE_" + n].astype(float)
        with np.errstate(divide="ignore", invalid="ignore"):
            stat = beta / se
        pval = 2.0 * norm.sf(np.abs(stat))
        ns = n.replace("_", " ")
        dds.set_row_data(f"WaldStatistic_{n}", stat, "results",
                         f"Wald statistic: {ns}")
        dds.set_row_data(f"WaldPvalue_{n}", pval, "results",
                         f"Wald test p-value: {ns}")
    return dds
