"""The DESeqDataSet equivalent: a host-side container of arrays.

Reference data model (R/AllClasses.R:3-330, R/methods.R): everything the
pipeline computes lives *in the object* — per-gene scalars in `row_data`
(mcols), gene x sample matrices in `assays`, run-level scalars in `attrs`.
That everything-in-the-object state model gives free checkpoint/resume
(serialize any prefix of the pipeline) which we keep.

Device placement: counts and assays are host numpy; compute stages upload
once per jitted kernel call.  The orchestration layer is host Python, the
kernels are pure jitted JAX functions over the genes axis.
"""

from __future__ import annotations

import copy as _copy

import numpy as np
import torch

import warnings

from .config import DESeqConfig, DEFAULT
from .formula import (Factor, Formula, build_model_matrix, make_names,
                      parse_formula, rename_model_matrix_columns)

__all__ = ["DESeqDataSet", "DESeqMessage", "dataset_from_matrix",
           "dataset_from_htseq_count"]


class DESeqMessage(UserWarning):
    """Constructor diagnostics the reference emits via message()
    (R/AllClasses.R:163-285).  Raised as warnings so callers/tests can
    capture them; they never interrupt construction."""


def _message(text):
    warnings.warn(text, DESeqMessage, stacklevel=3)


class DispersionFunction:
    """Fitted mean-dispersion trend + its attributes.

    Mirrors the reference's dispersionFunction closure with attributes
    fitType, coefficients, dispPriorVar, varLogDispEsts, mean
    (R/methods.R:142-194, R/core.R:2166-2203).
    """

    def __init__(self, fn, fit_type, coefficients=None, mean=None):
        self._fn = fn
        self.fit_type = fit_type
        self.coefficients = coefficients  # (asymptDisp, extraPois) for parametric
        self.mean = mean                  # for fitType="mean"
        self.disp_prior_var = None
        self.var_log_disp_ests = None

    def __call__(self, means):
        return self._fn(np.asarray(means, dtype=np.float64))


class DESeqDataSet:
    """Count matrix + column metadata + design + accumulated results."""

    def __init__(self, counts, col_data, design, row_names=None,
                 col_names=None, config: DESeqConfig = DEFAULT,
                 check_counts=True):
        counts = np.asarray(counts)
        if check_counts:
            if counts.ndim != 2:
                raise ValueError("counts must be a 2-D matrix (genes x samples)")
            if np.any(np.isnan(counts.astype(np.float64))):
                raise ValueError("NA values are not allowed in the count matrix")
            if counts.dtype.kind not in "iuf":
                raise ValueError("counts matrix should be numeric, currently "
                                 f"it has dtype: {counts.dtype}")
            if counts.dtype.kind == "f":
                if not np.allclose(counts, np.round(counts)):
                    raise ValueError("some values in assay are not integers")
                counts = np.round(counts)
                _message("converting counts to integer mode")
            if np.any(counts < 0):
                raise ValueError("some values in assay are negative")
            if counts.size and np.all(counts == 0):
                raise ValueError("all samples have 0 counts for all genes. "
                                 "check the counting script.")
            if counts.size and bool(
                    np.all(counts == counts[:, :1])):
                warnings.warn("all genes have equal values for all samples. "
                              "will not be able to perform differential "
                              "analysis")
        # R integers are 32-bit and the reference requires counts to fit
        # them (AllClasses.R validity); int32 also halves the HBM upload
        # on the fused engine.  Values past 2^31 keep int64 (a lenient
        # extension — the reference errors there).
        if counts.size and counts.max() > np.iinfo(np.int32).max:
            self.counts = counts.astype(np.int64)
        else:
            self.counts = counts.astype(np.int32)
        n_genes, n_samples = self.counts.shape

        # column data: coerce object/str arrays to Factors (reference
        # AllClasses.R:205-214 warns only for *design* characters; the
        # warning is issued below once design vars are known)
        self.col_data = {}
        coerced_from_char = set()
        self._cols_with_na = set()
        for k, v in dict(col_data).items():
            if isinstance(v, Factor):
                self.col_data[k] = v
            else:
                arr = np.asarray(v)
                if arr.dtype.kind in "OUS" or arr.dtype == bool:
                    if arr.dtype.kind == "O" and any(
                            e is None or (isinstance(e, float) and np.isnan(e))
                            for e in arr.tolist()):
                        self._cols_with_na.add(k)
                    elif arr.dtype.kind in "US" and any(
                            str(e) in ("nan", "<NA>")
                            for e in arr.tolist()):
                        # np.array(['A', np.nan]) coerces NaN to the
                        # *string* 'nan' (and pandas NA stringifies to
                        # '<NA>') before we ever see it; the reference
                        # raises on NA design variables
                        # (R/AllClasses.R:198-201), so flag these two
                        # sentinels.  Deliberately NOT 'None'/'NA'/'NaN':
                        # those are legitimate factor level names (e.g. a
                        # dose column) and only np.nan / pd.NA actually
                        # stringify through numpy coercion.  Limitation:
                        # a *level literally named* 'nan' is still
                        # flagged — rename it.
                        self._cols_with_na.add(k)
                    self.col_data[k] = Factor(arr.astype(str))
                    if arr.dtype.kind in "OUS":
                        coerced_from_char.add(k)
                else:
                    self.col_data[k] = arr
            if len(self.col_data[k]) != n_samples:
                raise ValueError(f"colData column '{k}' length != number of samples")

        self.design = design if isinstance(design, np.ndarray) else parse_formula(design)
        self._design_diagnostics(coerced_from_char)
        self._validate_design()

        self.row_names = list(row_names) if row_names is not None else \
            [f"gene{i+1}" for i in range(n_genes)]
        # duplicate rownames renamed by suffixing .1, .2, ...
        # (reference AllClasses.R:182-191)
        seen = {}
        n_dups = 0
        for i, rn in enumerate(self.row_names):
            if rn in seen:
                seen[rn] += 1
                self.row_names[i] = f"{rn}.{seen[rn]}"
                n_dups += 1
            else:
                seen[rn] = 0
        if n_dups:
            warnings.warn(f"{n_dups} duplicate rownames were renamed by "
                          "adding numbers")
        self.col_names = list(col_names) if col_names is not None else \
            [f"sample{i+1}" for i in range(n_samples)]

        self.row_data = {}    # mcols: name -> (G,) array
        self.row_meta = {}    # name -> (type, description)
        self.assays = {}      # name -> (G,S) array (mu, H, cooks, weights, ...)
        self.attrs = {}       # betaPrior, betaPriorVar, modelMatrix, test, ...
        self.metadata = {}
        self.dispersion_function = None
        self.config = config

    # -- construction-time design diagnostics ------------------------------
    def _design_diagnostics(self, coerced_from_char):
        """Reference constructor hygiene (R/AllClasses.R:192-285): NA
        checks, character->factor warnings, numeric-variable hints,
        ordered-factor rejection, empty-level dropping, and the
        'control' reference-level hint."""
        if isinstance(self.design, np.ndarray):
            return
        dvars = list(self.design.variables)
        for v in dvars:
            if v not in self.col_data:
                raise ValueError(
                    "all variables in design formula must be columns in "
                    f"colData: missing '{v}'")
            val = self.col_data[v]
            if v in getattr(self, "_cols_with_na", ()) or (
                    not isinstance(val, Factor) and np.any(
                        np.isnan(np.asarray(val, dtype=np.float64)))):
                raise ValueError(
                    f"variables in design formula cannot contain NA: {v}")
        chars = [v for v in dvars if v in coerced_from_char]
        if chars:
            warnings.warn("some variables in design formula are characters, "
                          "converting to factors")
        if len(dvars) == 1:
            val = self.col_data[dvars[0]]
            same = (np.all(val.codes == val.codes[0]) if isinstance(val, Factor)
                    else np.all(np.asarray(val) == np.asarray(val)[0]))
            if len(val) and same:
                raise ValueError(
                    "design has a single variable, with all samples having "
                    "the same value. use instead a design of '~ 1'. "
                    "estimateSizeFactors, rlog and the VST can then be used")
        numeric = [v for v in dvars
                   if not isinstance(self.col_data[v], Factor)]
        if numeric:
            msg_int = any(np.all(self.col_data[v] == np.round(
                np.asarray(self.col_data[v], dtype=np.float64)))
                for v in numeric)
            msg_cs = any(np.mean(self.col_data[v]) > 5
                         or np.std(self.col_data[v], ddof=1) > 5
                         for v in numeric)
            if msg_int:
                _message(
                    "the design formula contains one or more numeric "
                    "variables with integer values, specifying a model with "
                    "increasing fold change for higher values. did you mean "
                    "for this to be a factor? if so, first convert this "
                    "variable to a factor")
            if msg_cs:
                _message(
                    "the design formula contains one or more numeric "
                    "variables that have mean or standard deviation larger "
                    "than 5. Including numeric variables with large mean can "
                    "induce collinearity with the intercept. Users should "
                    "center and scale numeric variables in the design to "
                    "improve GLM convergence.")
        factors = [v for v in dvars if isinstance(self.col_data[v], Factor)]
        import re as _re
        if any(not _re.match(r"^[A-Za-z0-9_.]*$", lv) for v in factors
               for lv in self.col_data[v].levels):
            _message(
                "characters other than letters, numbers, '.' and '_' are "
                "present in the levels of factors in the design formula; "
                "they will be converted to valid names when building "
                "results columns")
        if any(self.col_data[v].ordered for v in factors):
            raise ValueError(
                "the design formula contains an ordered factor. The internal "
                "steps do not work on ordered factors as a formula. Instead "
                "you should provide a matrix to the 'design' slot, "
                "constructed using model.matrix.")
        dropped = False
        for v in factors:
            f = self.col_data[v]
            if any(c == 0 for c in f.table().values()):
                self.col_data[v] = f.droplevels()
                dropped = True
        if dropped:
            _message("factor levels were dropped which had no samples")
        for v in factors:
            f = self.col_data[v]
            if len(f) and np.all(f.codes == f.codes[0]):
                raise ValueError(
                    "design contains one or more variables with all samples "
                    "having the same value, remove these variables from the "
                    "design")
        if factors and dvars and isinstance(self.col_data[dvars[-1]], Factor):
            lvls = self.col_data[dvars[-1]].levels
            for syn in ("control", "Control", "CONTROL"):
                if syn in lvls and syn != lvls[0]:
                    _message(
                        f"it appears that the last variable in the design "
                        f"formula, '{dvars[-1]}', has a factor level, "
                        f"'{syn}', which is not the reference level. we "
                        "recommend to use relevel() to set this as the "
                        "reference level before proceeding.")

    # -- validity ----------------------------------------------------------
    def _validate_design(self):
        if isinstance(self.design, np.ndarray):
            check_full_rank(self.design)
            return
        for v in self.design.variables:
            if v not in self.col_data:
                raise ValueError(
                    f"all variables in design formula must be columns in colData: missing '{v}'")
            val = self.col_data[v]
            if isinstance(val, Factor):
                if any(c == 0 for c in val.table().values()):
                    raise ValueError(
                        "factors in design formula must have samples for each level; "
                        "use droplevels()")
        if self.design.variables:
            mm, _, _ = build_model_matrix(self.design, self.col_data,
                                          n_rows=self.counts.shape[1])
            check_full_rank(mm)

    # -- basic geometry ------------------------------------------------------
    @property
    def n_genes(self):
        return self.counts.shape[0]

    @property
    def n_samples(self):
        return self.counts.shape[1]

    def copy(self, share_counts=False):
        """Copy the dataset.  `share_counts=True` aliases the counts
        buffer instead of duplicating it (R-like copy-on-modify
        economy) — used by the fused engine route, which never mutates
        counts in place; the host stages that do (outlier replacement)
        make their own copy first."""
        new = DESeqDataSet.__new__(DESeqDataSet)
        new.counts = self.counts if share_counts else self.counts.copy()
        new.col_data = {k: (v[slice(None)] if isinstance(v, Factor) else v.copy())
                        for k, v in self.col_data.items()}
        new.design = self.design
        new.row_names = list(self.row_names)
        new.col_names = list(self.col_names)
        new.row_data = {k: v.copy() for k, v in self.row_data.items()}
        new.row_meta = dict(self.row_meta)
        new.assays = {k: v.copy() for k, v in self.assays.items()}
        new.attrs = dict(self.attrs)
        new.metadata = dict(self.metadata)
        new.dispersion_function = _copy.copy(self.dispersion_function)
        new.config = self.config
        # the counts' device copy (engine.device_counts), the same values
        new._counts_dev = getattr(self, "_counts_dev", None)
        return new

    def subset_genes(self, idx):
        """Row-subset (genes); mirrors dds[idx, ] in the reference."""
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.where(idx)[0]
        new = self.copy()
        new.counts = self.counts[idx]
        if new._counts_dev is not None:
            new._counts_dev = new._counts_dev[
                torch.as_tensor(idx, device=new._counts_dev.device)]
        new.row_names = [self.row_names[i] for i in idx]
        new.row_data = {k: v[idx] for k, v in self.row_data.items()}
        new.assays = {k: v[idx] for k, v in self.assays.items()}
        return new

    def subset_samples(self, idx):
        """Column-subset (samples); mirrors dds[, idx] in the reference."""
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.where(idx)[0]
        new = self.copy()
        new.counts = self.counts[:, idx]
        new.col_names = [self.col_names[i] for i in idx]
        new.col_data = {k: v[idx] for k, v in self.col_data.items()}
        new.assays = {k: (v[:, idx] if v.ndim == 2 and
                          v.shape[1] == self.n_samples else v)
                      for k, v in self.assays.items()}
        return new

    # -- accessors mirroring reference R/methods.R --------------------------
    @property
    def size_factors(self):
        return self.col_data.get("sizeFactor")

    @size_factors.setter
    def size_factors(self, sf):
        sf = np.asarray(sf, dtype=np.float64)
        if np.any(~np.isfinite(sf)) or np.any(sf <= 0):
            raise ValueError("size factors must be positive and finite")
        self.col_data["sizeFactor"] = sf

    @property
    def normalization_factors(self):
        return self.assays.get("normalizationFactors")

    @normalization_factors.setter
    def normalization_factors(self, nf):
        nf = np.asarray(nf, dtype=np.float64)
        if np.any(~np.isfinite(nf)) or np.any(nf <= 0):
            raise ValueError("normalization factors must be positive and finite")
        if nf.shape != self.counts.shape:
            raise ValueError("normalization factors must match counts shape")
        self.assays["normalizationFactors"] = nf

    @property
    def dispersions(self):
        return self.row_data.get("dispersion")

    @dispersions.setter
    def dispersions(self, d):
        self.set_row_data("dispersion", np.asarray(d, dtype=np.float64),
                          "input", "final estimate of dispersion")

    def size_or_norm_factors(self):
        """(G,S) matrix of normalization factors (reference
        getSizeOrNormFactors, R/core.R:2221-2228)."""
        if self.normalization_factors is not None:
            return self.normalization_factors
        if self.size_factors is None:
            raise ValueError("first call estimate_size_factors")
        return np.broadcast_to(self.size_factors[None, :], self.counts.shape).copy()

    def counts_normalized(self):
        return self.counts.astype(np.float64) / self.size_or_norm_factors()

    def get_counts(self, normalized=False, replaced=False):
        """Reference counts(dds, normalized=, replaced=) accessor
        (R/methods.R:1-29)."""
        if replaced:
            if "replaceCounts" in self.assays:
                cnts = self.assays["replaceCounts"]
            else:
                warnings.warn(
                    "there are no assays named 'replaceCounts', using "
                    "original. calling deseq() will replace outliers if "
                    "they are detected and store this assay.")
                cnts = self.counts
        else:
            cnts = self.counts
        if not normalized:
            return cnts
        if self.normalization_factors is not None:
            return cnts / self.normalization_factors
        if self.size_factors is None or np.any(np.isnan(self.size_factors)):
            raise ValueError("first calculate size factors, add "
                             "normalizationFactors, or set normalized=FALSE")
        return cnts / self.size_factors[None, :]

    def coef(self, se=False):
        """Matrix of fitted log2 coefficients (or their SEs with
        se=True); reference coef.DESeqDataSet (R/methods.R:749-765)."""
        nms = self.results_names()
        if not nms:
            raise ValueError("no coefficients have been generated yet, "
                             "first call deseq()")
        cols = nms if not se else [f"SE_{n}" for n in nms]
        return np.column_stack([np.asarray(self.row_data[c], np.float64)
                                for c in cols])

    def set_row_data(self, name, values, type_, description):
        self.row_data[name] = np.asarray(values)
        self.row_meta[name] = (type_, description)

    def remove_row_data(self, names):
        for n in names:
            self.row_data.pop(n, None)
            self.row_meta.pop(n, None)

    def remove_results(self):
        res_cols = [n for n, (t, _) in self.row_meta.items() if t == "results"]
        self.remove_row_data(res_cols)

    def results_names(self):
        """Coefficient column names: those described as log2 fold changes
        (reference resultsNames, R/results.R:619-621)."""
        return [n for n, (t, d) in self.row_meta.items()
                if "log2 fold change" in d]

    # -- design matrices -----------------------------------------------------
    def model_matrix(self, formula=None):
        """(S,p) design matrix + R-convention column names.

        Reference getModelMatrix (R/core.R:2689-2695)."""
        design = self.design if formula is None else parse_formula(formula)
        if isinstance(design, np.ndarray):
            names = self.attrs.get("designMatrixNames")
            if names is None:
                names = [f"x{i+1}" for i in range(design.shape[1])]
            return design.astype(np.float64), list(names)
        mm, names, _ = build_model_matrix(design, self.col_data,
                                          n_rows=self.n_samples)
        return mm, names

    def renamed_model_matrix(self, formula=None, rename=True):
        """Model matrix with DESeq2-style column names:
        (Intercept)->Intercept, conditionB->condition_B_vs_A when the design
        has an intercept (reference fitNbinomGLMs.R:47-59)."""
        mm, names = self.model_matrix(formula)
        names = ["Intercept" if n == "(Intercept)" else n for n in names]
        names = make_names(names)
        if rename and not isinstance(self.design, np.ndarray):
            design = self.design if formula is None else parse_formula(formula)
            conv = rename_model_matrix_columns(self.col_data, design)
            names = [conv.get(n, n) for n in names]
        return mm, names

    def design_has_intercept(self):
        if isinstance(self.design, np.ndarray):
            return False
        return self.design.intercept

    def __repr__(self):
        return (f"DESeqDataSet: {self.n_genes} genes x {self.n_samples} samples, "
                f"design {self.design}, "
                f"row_data [{', '.join(self.row_data)}], "
                f"assays [{', '.join(self.assays)}]")


def check_full_rank(model_matrix):
    """Reference checkFullRank (R/core.R:2624-2644)."""
    mm = np.asarray(model_matrix, dtype=np.float64)
    if np.linalg.matrix_rank(mm) < mm.shape[1]:
        if np.any(np.all(mm == 0, axis=0)):
            raise ValueError(
                "the model matrix is not full rank, so the model cannot be fit as "
                "specified. Levels or combinations of levels without any samples have "
                "resulted in column(s) of zeros in the model matrix.")
        raise ValueError(
            "the model matrix is not full rank, so the model cannot be fit as "
            "specified. One or more variables or interaction terms in the design "
            "formula are linear combinations of the others and must be removed.")


def dataset_from_matrix(count_data, col_data, design, row_names=None,
                        col_names=None, tidy=False, **kw):
    """Constructor mirroring DESeqDataSetFromMatrix (R/AllClasses.R:334-382).

    With ``tidy=True`` (reference AllClasses.R:337-342) the first column
    of ``count_data`` holds the gene identifiers (data.frame-style): pass
    a 2-D object/str array or list of rows whose first element is the
    name; the remaining columns must be numeric counts.
    """
    if tidy:
        arr = np.asarray(count_data, dtype=object)
        if arr.ndim != 2 or arr.shape[1] < 2:
            raise ValueError("tidy=True requires a 2-D table whose first "
                             "column holds the gene identifiers")
        row_names = [str(v) for v in arr[:, 0].tolist()]
        count_data = arr[:, 1:].astype(np.float64)
    return DESeqDataSet(count_data, col_data, design,
                        row_names=row_names, col_names=col_names, **kw)


def dataset_from_htseq_count(sample_files, col_data, design, directory=".",
                             **kw):
    """Read htseq-count output files (reference R/AllClasses.R:386-405).

    sample_files: list of file paths (tab-separated gene<TAB>count), one per
    sample.  Rows whose names start with '__' (htseq special counters) are
    dropped.
    """
    import os
    tables = []
    gene_names = None
    for f in sample_files:
        path = os.path.join(directory, f)
        names, vals = [], []
        with open(path) as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) < 2:
                    continue
                names.append(parts[0])
                vals.append(int(float(parts[-1])))
        keep = [i for i, n in enumerate(names) if not n.startswith("__")]
        names = [names[i] for i in keep]
        vals = [vals[i] for i in keep]
        if gene_names is None:
            gene_names = names
        elif names != gene_names:
            raise ValueError("gene names differ between htseq-count files")
        tables.append(vals)
    counts = np.array(tables, dtype=np.int64).T
    return DESeqDataSet(counts, col_data, design, row_names=gene_names, **kw)


def dataset_from_tximport(txi, col_data, design, **kw):
    """Build a dataset from tximport-style quantifications
    (reference DESeqDataSetFromTximport, R/AllClasses.R:409-426).

    txi: dict with 'counts' (genes x samples, float estimated counts),
    optional 'length' (average transcript lengths, same shape) and
    'countsFromAbundance' flag.  Counts are rounded to integers; the
    length matrix is stored as the 'avgTxLength' assay, which
    estimate_size_factors turns into gene x sample normalization factors
    (R/methods.R:383-391).
    """
    counts = np.round(np.asarray(txi["counts"], dtype=np.float64))
    counts = counts.astype(np.int64)
    if np.any(counts < 0):
        raise ValueError("negative counts in tximport input")
    dds = DESeqDataSet(counts, col_data, design, **kw)
    if txi.get("countsFromAbundance", "no") in ("scaledTPM",
                                                "lengthScaledTPM"):
        # lengths must not be used again when counts were already scaled
        pass
    elif "length" in txi and txi["length"] is not None:
        lengths = np.asarray(txi["length"], dtype=np.float64)
        if lengths.shape != counts.shape:
            raise ValueError("txi['length'] must match counts shape")
        if np.any(lengths <= 0):
            raise ValueError("all(lengths > 0) is not TRUE")
        dds.assays["avgTxLength"] = lengths
    return dds
