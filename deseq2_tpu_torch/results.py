"""Results tables: contrasts, alt hypotheses, Cook's masking, independent
filtering, BH adjustment.

Reference: results() (R/results.R:298-615), pvalueAdjustment/filtered_p
(R/results.R:638-740), getContrast/cleanContrast (R/results.R:760-1040),
the contrast zero-zero rules (R/results.R:1237-1270), makeWaldTest
(R/results.R:1101-1118), with the LRT, useT and betaPrior arms.
getContrast runs on the device the fit ran on: the counts (or the
replaceCounts assay) stay there, and only (G,) vectors come back.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy.stats import f as f_dist
from scipy.stats import norm
from scipy.stats import t as t_dist

from . import profiling
from .formula import Factor, make_names
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


def mle_contrast(dds, contrast):
    """lfcMLE column for a character contrast from the stored MLE_
    columns (reference mleContrast, R/results.R:1120-1143)."""
    fac, num, den = contrast
    ref = dds.col_data[fac].levels[0]

    def nm(a, b):
        return make_names([f"MLE_{fac}_{a}_vs_{b}"])[0]

    if den == ref:
        v = np.asarray(dds.row_data[nm(num, den)], dtype=float).copy()
    elif num == ref:
        v = -np.asarray(dds.row_data[nm(den, num)], dtype=float)
    else:
        v = (np.asarray(dds.row_data[nm(num, ref)], dtype=float)
             - np.asarray(dds.row_data[nm(den, ref)], dtype=float))
    return v


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
        contrast = check_contrast(contrast, res_names)
        with profiling.stage("results.cleanContrast"):
            res = clean_contrast(dds, contrast, expanded=is_expanded,
                                 list_values=list_values, test=test,
                                 use_t=use_t, minmu=minmu)
    else:
        with profiling.stage("results.pullColumns"):
            res = _pull_columns(dds, name, test)

    if add_mle:
        lfc_mle = mle_contrast(dds, contrast)
        # an all-zero contrast also zeroes the lfcMLE (R/results.R:459-460)
        lfc_mle[(res.log2_fold_change == 0) & (res.stat == 0)] = 0.0
        res.extra_columns["lfcMLE"] = lfc_mle

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
        if add_mle:
            res.extra_columns["lfcMLE"][now_zero] = 0

    if not dds.attrs.get("betaPrior"):
        res.prior_info = dict(type="none", package="deseq2_tpu")
    else:
        res.prior_info = dict(type="normal", package="deseq2_tpu",
                              betaPriorVar=dds.attrs.get("betaPriorVar"))

    with profiling.stage("results.pvalueAdjustment"):
        from .engine import fit_device
        res = pvalue_adjustment(res, independent_filtering, filter, theta,
                                alpha, p_adjust_method,
                                device=fit_device(dds))
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
    if tail["betaPrior"]:
        # the pipeline computed the default expanded-matrix contrast (last
        # level against the first); any other runs the contrast flow
        if contrast is None \
                or tuple(contrast) != tail.get("defaultContrast"):
            return None
    elif contrast is not None or name != tail["name"]:
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
    if tail["betaPrior"]:
        fac, num_l, den_l = tail["defaultContrast"]
        res.descriptions["log2FoldChange"] = \
            f"log2 fold change (MAP): {fac} {num_l} vs {den_l}"
        res.prior_info = dict(type="normal", package="deseq2_tpu",
                              betaPriorVar=dds.attrs.get("betaPriorVar"))
    else:
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


def _device_filtering(res, alpha, device):
    """The independent-filtering theta grid on the card
    (parallel/filterdev.py) for a results() call the fused tail did not
    compute: the host's 50 per-cutoff BH sorts over G genes are the only
    O(G log G x 50) piece of results() (0.39 s at 60,000 genes).  Same
    semantics as filtered_p + choose_filter_theta (the fused pipeline's
    tail runs the same functions, held to the JAX package in
    tests/test_torch_fused.py)."""
    import torch

    from .parallel.filterdev import filtered_bh_dev, theta_grid_dev
    p_d = torch.as_tensor(np.asarray(res.pvalue, np.float64), device=device)
    bm_d = torch.as_tensor(np.asarray(res.base_mean, np.float64),
                           device=device)
    theta_d = theta_grid_dev(bm_d)
    filt_padj, num_rej, cutoffs = filtered_bh_dev(p_d, bm_d, theta_d, alpha)
    theta, num_rej = theta_d.cpu().numpy(), num_rej.cpu().numpy()
    j, lx, lo_fit_y = choose_filter_theta(theta, num_rej)
    res.padj = filt_padj[j].cpu().numpy().astype(float)
    res.metadata["filterThreshold"] = float(cutoffs[j])
    res.metadata["filterTheta"] = float(theta[j])
    res.metadata["filterNumRej"] = dict(theta=theta, numRej=num_rej)
    res.metadata["lo.fit"] = dict(x=lx, y=lo_fit_y)
    res.metadata["alpha"] = alpha
    return res


def pvalue_adjustment(res, independent_filtering, filter, theta, alpha,
                      p_adjust_method="BH", device=None):
    """(reference pvalueAdjustment, R/results.R:638-718).  With the
    default filter statistic and theta grid at 16,384 genes or more, on a
    fit that ran on a CUDA device, the grid runs there
    (_device_filtering)."""
    if independent_filtering:
        if (filter is None and theta is None and p_adjust_method == "BH"
                and len(res.pvalue) >= 16384 and device is not None
                and device.type == "cuda"):
            return _device_filtering(res, alpha, device)
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


# ---------------------------------------------------------------------------
# contrasts
# ---------------------------------------------------------------------------

def check_contrast(contrast, res_names):
    """(reference checkContrast, R/results.R:1146-1201)"""
    if isinstance(contrast, (list, tuple)) and len(contrast) in (1, 2) \
            and all(isinstance(c, (list, tuple)) for c in contrast):
        if len(contrast) == 1:
            contrast = [list(contrast[0]), []]
        num, den = contrast
        if not all(isinstance(s, str) for s in list(num) + list(den)):
            raise ValueError("list contrast should contain character vectors")
        if not all(s in res_names for s in list(num) + list(den)):
            raise ValueError("all elements of the contrast as a list should "
                             "be elements of results_names()")
        if set(num) & set(den):
            raise ValueError("elements in the contrast list should only "
                             "appear in numerator or denominator, not both")
        if len(list(num) + list(den)) == 0:
            raise ValueError("one of the two elements in the list should be "
                             "a character vector of non-zero length")
        return [list(num), list(den)]
    if isinstance(contrast, (tuple, list)) and len(contrast) == 3 \
            and all(isinstance(s, str) for s in contrast):
        if contrast[1] == contrast[2]:
            raise ValueError(f"{contrast[1]} and {contrast[2]} should be "
                             "different level names")
        return tuple(contrast)
    if isinstance(contrast, (tuple, list)) \
            and any(isinstance(s, str) for s in contrast):
        # reference checkContrast: a character contrast must be exactly
        # (factor, numerator level, denominator level)
        raise ValueError("'contrast', as a character vector of length 3, "
                         "should have the form: contrast = ('factorName', "
                         "'numeratorLevel', 'denominatorLevel'), see the "
                         "results() docstring")
    contrast = np.asarray(contrast, dtype=np.float64)
    if contrast.ndim != 1 or len(contrast) != len(res_names):
        raise ValueError("numeric contrast vector should have one element "
                         "for every element of results_names()")
    if np.all(contrast == 0):
        raise ValueError("numeric contrast vector cannot have all elements "
                         "equal to 0")
    return contrast


def get_contrast(dds, contrast, use_t=False, minmu=0.5):
    """Wald statistics of an arbitrary numeric contrast: getContrast's
    re-entry into the IRLS with maxit=0 (reference getContrast,
    R/results.R:760-827; src/DESeq2.cpp:429-455).

    On the device the fit ran on, in float64: mu from the stored betas,
    clamped at minmu; the sandwich (X'WX + ridge)^-1 X'WX (X'WX +
    ridge)^-1 with the stored betaPriorVar's ridge and the row-max
    normalized weights; c'beta and sqrt(c' Sigma c).  With maxit=0 the
    counts do not enter these (the JAX package hands the replaceCounts or
    the counts to its fit_beta, whose maxit=0 num/den do not read them),
    so none are gathered.  Only (G,) vectors come back to the host."""
    import torch

    from .engine import fit_device
    from .parallel.fused import contrast_sandwich

    dev = fit_device(dds)
    model_matrix = dds.attrs["modelMatrix"]
    nz = np.asarray(~dds.row_data["allZero"])
    nz_idx = torch.as_tensor(np.where(nz)[0], device=dev)
    if dds.normalization_factors is not None:
        nf = torch.as_tensor(np.asarray(dds.normalization_factors,
                                        np.float64)[nz], device=dev)
    else:
        nf = torch.as_tensor(np.asarray(dds.size_factors, np.float64),
                             device=dev)[None, :]
    alpha = torch.as_tensor(np.asarray(dds.row_data["dispersion"],
                                       np.float64)[nz], device=dev)
    coef_columns = dds.results_names()
    beta_mat = torch.as_tensor(LN2 * np.column_stack(
        [np.asarray(dds.row_data[c], np.float64)[nz]
         for c in coef_columns]), device=dev)
    lam_nat = torch.as_tensor(
        1.0 / (LN2 ** 2 * np.asarray(dds.attrs["betaPriorVar"], np.float64)),
        device=dev)
    x = torch.as_tensor(np.asarray(model_matrix, np.float64), device=dev)
    weights = None
    if "weights" in dds.assays:
        w = torch.as_tensor(np.asarray(dds.assays["weights"], np.float64),
                            device=dev)[nz_idx]
        weights = w / w.max(dim=1, keepdim=True).values
    mu = torch.clamp(nf * torch.exp(beta_mat @ x.T), min=minmu)
    num, den, _ = contrast_sandwich(beta_mat, mu, alpha, x, lam_nat,
                                    np.asarray(contrast, np.float64), weights)
    est = LOG2E * num.cpu().numpy()
    se = LOG2E * den.cpu().numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        stat = est / se
    if use_t:
        df = np.asarray(dds.row_data["tDegreesFreedom"])[nz]
        pval = 2.0 * t_dist.sf(np.abs(stat), df)
    else:
        pval = 2.0 * norm.sf(np.abs(stat))
    G = dds.n_genes
    full = {}
    for nmk, v in (("log2FoldChange", est), ("lfcSE", se), ("stat", stat),
                   ("pvalue", pval)):
        arr = np.full(G, np.nan)
        arr[nz] = v
        full[nmk] = arr
    return full


def clean_contrast(dds, contrast, expanded=False, list_values=(1, -1),
                   test="Wald", use_t=False, minmu=0.5):
    """(reference cleanContrast, R/results.R:832-1040)"""
    res_names = dds.results_names()
    res_ready = False
    contrast_all_zero = None
    contrast_name = None

    if isinstance(contrast, tuple):  # character contrast (factor, num, den)
        factor_name, num_level, den_level = contrast
        if factor_name not in dds.col_data or not isinstance(
                dds.col_data[factor_name], Factor):
            raise ValueError(f"{factor_name} should be the name of a factor "
                             "in the colData of the dataset")
        fac = dds.col_data[factor_name]
        base_level = fac.levels[0]
        has_intercept = dds.design_has_intercept()
        first_var = not isinstance(dds.design, np.ndarray) \
            and dds.design.variables \
            and factor_name == dds.design.variables[0]
        no_intercept_pull_coef = (not has_intercept) and (not first_var) and \
            (base_level in (num_level, den_level))

        if not expanded and (has_intercept or no_intercept_pull_coef):
            num_col = make_names([f"{factor_name}_{num_level}_vs_"
                                  f"{base_level}"])[0]
            den_col = make_names([f"{factor_name}_{den_level}_vs_"
                                  f"{base_level}"])[0]
            if den_level == base_level:
                clean_name = f"{factor_name} {num_level} vs {den_level}"
                nm = num_col if not no_intercept_pull_coef else \
                    make_names([f"{factor_name}{num_level}"])[0]
                if nm not in res_names:
                    raise ValueError(
                        f"as {den_level} is the reference level, was "
                        f"expecting {nm} to be present in results_names()")
                res = _pull_columns(dds, nm, test)
                lfc_type = "MAP" if dds.attrs.get("betaPrior") else "MLE"
                res.descriptions["log2FoldChange"] = \
                    f"log2 fold change ({lfc_type}): {clean_name}"
                res_ready = True
            elif num_level == base_level:
                clean_name = f"{factor_name} {num_level} vs {den_level}"
                swap = make_names([f"{factor_name}_{den_level}_vs_"
                                   f"{num_level}"])[0] \
                    if not no_intercept_pull_coef else \
                    make_names([f"{factor_name}{den_level}"])[0]
                if swap not in res_names:
                    raise ValueError(
                        f"as {num_level} is the reference level, was "
                        f"expecting {swap} to be present in results_names()")
                res = _pull_columns(dds, swap, test)
                res.log2_fold_change = -1.0 * res.log2_fold_change
                if test == "Wald":
                    res.stat = -1.0 * res.stat
                lfc_type = "MAP" if dds.attrs.get("betaPrior") else "MLE"
                res.descriptions["log2FoldChange"] = \
                    f"log2 fold change ({lfc_type}): {clean_name}"
                res_ready = True
            else:
                if not (num_col in res_names and den_col in res_names):
                    raise ValueError(
                        f"{num_level} and {den_level} should be levels of "
                        f"{factor_name} such that {num_col} and {den_col} "
                        "are contained in results_names()")
        else:
            num_col = make_names([f"{factor_name}{num_level}"])[0]
            den_col = make_names([f"{factor_name}{den_level}"])[0]
            if not (num_col in res_names and den_col in res_names):
                raise ValueError(f"{num_col} and {den_col} are expected to "
                                 "be in results_names()")
        # all-zero across samples in either level (R/results.R:1237-1243)
        sel = np.isin(fac.codes,
                      [fac.levels.index(num_level),
                       fac.levels.index(den_level)])
        contrast_all_zero = _counts_zero_over(dds, sel.astype(float))
        contrast_name = f"{factor_name} {num_level} vs {den_level}"

    if not res_ready:
        if isinstance(contrast, np.ndarray):
            signs = ["" if c <= 0 else "+" for c in np.sign(contrast)]
            contrast_name = ",".join(
                s + _fmt_num(c) for s, c in zip(signs, contrast))
            contrast_numeric = contrast
        elif isinstance(contrast, list):  # list contrast
            num, den = contrast
            contrast_numeric = np.zeros(len(res_names))
            contrast_numeric[[res_names.index(n) for n in num]] = \
                list_values[0]
            contrast_numeric[[res_names.index(n) for n in den]] = \
                list_values[1]
            v1 = "" if list_values[0] == 1 else f"{round(list_values[0],3)} "
            v2abs = abs(round(list_values[1], 3))
            v2 = "" if v2abs == 1 else f"{v2abs} "
            if num and den:
                contrast_name = (f"{v1}{'+'.join(num)} vs {v2}"
                                 f"{'+'.join(den)}")
            elif num:
                contrast_name = f"{v1}{'+'.join(num)} effect"
            else:
                contrast_name = f"{round(list_values[1],3)} " \
                                f"{'+'.join(den)} effect"
        else:  # character triple needing a numeric contrast
            factor_name, num_level, den_level = contrast
            contrast_numeric = np.zeros(len(res_names))
            contrast_numeric[res_names.index(num_col)] = 1.0
            contrast_numeric[res_names.index(den_col)] = -1.0

        if contrast_all_zero is None:
            contrast_all_zero = _contrast_all_zero_numeric(dds,
                                                           contrast_numeric)
        cols = get_contrast(dds, contrast_numeric, use_t=use_t, minmu=minmu)
        lfc_type = "MAP" if dds.attrs.get("betaPrior") else "MLE"
        res = DESeqResults(
            base_mean=dds.row_data["baseMean"].copy(),
            log2_fold_change=cols["log2FoldChange"],
            lfc_se=cols["lfcSE"], stat=cols["stat"], pvalue=cols["pvalue"],
            descriptions={"log2FoldChange":
                          f"log2 fold change ({lfc_type}): {contrast_name}"})

    # zero out contrasts of all-zero groups (R/results.R:1021-1028)
    if contrast_all_zero is not None:
        contrast_all_zero = contrast_all_zero & ~dds.row_data["allZero"]
        if contrast_all_zero.sum() > 0:
            res.log2_fold_change[contrast_all_zero] = 0
            res.stat[contrast_all_zero] = 0
            res.pvalue[contrast_all_zero] = 1

    # LRT: overwrite stat/p with the stored LRT columns (R/results.R:1030-1037)
    if test == "LRT":
        res.stat = dds.row_data["LRTStatistic"].astype(float).copy()
        res.pvalue = dds.row_data["LRTPvalue"].astype(float).copy()
    return res


def _fmt_num(c):
    if c == int(c):
        return str(int(c))
    return str(c)


def _contrast_all_zero_numeric(dds, contrast):
    """(reference contrastAllZeroNumeric, R/results.R:1245-1270)"""
    model_matrix = dds.attrs["modelMatrix"]
    if np.all(contrast >= 0) or np.all(contrast <= 0):
        return np.zeros(dds.n_genes, dtype=bool)
    contrast_binary = (contrast != 0).astype(float)
    which_samples = (model_matrix @ contrast_binary != 0).astype(float)
    return _counts_zero_over(dds, which_samples)


def _counts_zero_over(dds, which_samples):
    """Rows whose counts are all zero over the samples with a nonzero
    `which_samples` entry, on the device the fit ran on (the counts stay
    there; a (G,) mask comes back)."""
    import torch

    from .engine import device_counts, fit_device
    dev = fit_device(dds)
    sel = torch.as_tensor(np.where(np.asarray(which_samples) != 0)[0],
                          device=dev)
    counts = device_counts(dds, dev)
    return (counts[:, sel] == 0).all(dim=1).cpu().numpy()


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
