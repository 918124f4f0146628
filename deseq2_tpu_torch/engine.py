"""Fused-engine routing: the public deseq() runs the fused pipeline on the
card.

Eligible configurations run parallel/fused.py and populate the same
dataset row_data columns, assays and attrs as the host-exact stages would
(names, types and descriptions included), so results() works unchanged.
The fused route covers the Wald test and the LRT, observation weights,
gene x sample normalization factors, use_t, the parametric, local and
mean trends, and betaPrior on a single-factor design with an intercept
(the expanded model matrix, its MAP and MLE_ columns, the prior variance);
what it does not take (fused_ineligibility) runs the host-exact engine
(deseq.py).

Gene x sample assays produced on the device (mu, H, cooks, replaceCounts,
replaceCooks) stay there as DeviceArray wrappers, fetched by whoever
indexes them; the per-gene diagnostic columns are registered lazily in a
LazyRowData and fetched together on first touch.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from . import profiling

LOG2E = np.log2(np.e)

# config fields the fused pipeline hardcodes at the reference defaults
_FROZEN_CONFIG = ("min_disp", "kappa_0", "disp_tol", "maxit_disp",
                  "use_cr", "weight_threshold", "outlier_sd", "niter_disp",
                  "grid_size", "beta_tol", "maxit_beta", "use_qr",
                  "min_mu", "wide_prior_lambda", "beta_large",
                  "cooks_trim")

_LAZY = object()   # sentinel marking a row_data column still on the device


def resolve_device(device, mesh=None):
    """torch.device for an entry point: CUDA unless the caller asks for
    the CPU, or under a gene `mesh` (parallel.sharding.GeneMesh) the
    mesh's first device, which `device` may only name by its type.
    Without a card the entry points raise: there is no silent CPU run."""
    from .parallel.sharding import as_mesh
    if as_mesh(mesh) is not None:
        dev = mesh.first_device
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"device={device!r} does not match the mesh "
                             f"{mesh}")
    else:
        dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    return dev


def resolve_dtype(config):
    """torch dtype of the pipeline from DESeqConfig.dtype."""
    from .config import DEFAULT
    name = (config or DEFAULT).dtype
    if name not in ("float32", "float64"):
        raise ValueError(f"DESeqConfig.dtype must be 'float32' or "
                         f"'float64', not {name!r}")
    return getattr(torch, name)


class DeviceArray:
    """A (G,S) assay left on the device.  The port never mutates one in
    place, so copy() shares the tensor; numpy conversion and row/column
    indexing work as on the host array."""

    def __init__(self, tensor):
        self.tensor = tensor

    @property
    def shape(self):
        return tuple(self.tensor.shape)

    @property
    def ndim(self):
        return self.tensor.dim()

    def copy(self):
        return DeviceArray(self.tensor)

    def _key(self, key):
        if isinstance(key, tuple):
            return tuple(self._key(k) for k in key)
        if isinstance(key, (np.ndarray, list)):
            return torch.as_tensor(np.asarray(key), device=self.tensor.device)
        return key

    def __getitem__(self, key):
        return DeviceArray(self.tensor[self._key(key)])

    def __array__(self, dtype=None, copy=None):
        a = self.tensor.cpu().numpy()
        return a if dtype is None else a.astype(dtype)


class LazyRowData(dict):
    """row_data dict whose bulky diagnostic columns stay on the device
    until first touched: the first access of any lazy column fetches every
    pending one, applies its host-side transform (NaN padding, dtype casts,
    column slices) and stores plain numpy entries.  Columns sharing one
    tensor (the (G,p) beta/SE/stat/p matrices sliced per coefficient) are
    fetched once."""

    def __init__(self, base=()):
        super().__init__(base)
        self._pending = {}   # name -> (tensor, transform|None)

    def set_lazy(self, name, dev, transform=None):
        self._pending[name] = (dev, transform)
        super().__setitem__(name, _LAZY)

    def _materialize(self):
        if not self._pending:
            return
        pend, self._pending = self._pending, {}
        uniq = {}
        with profiling.stage("fused.lazyFetch"):
            for _, (d, _t) in pend.items():
                if id(d) not in uniq:
                    uniq[id(d)] = d.cpu().numpy()
        for k, (d, t) in pend.items():
            arr = uniq[id(d)]
            super().__setitem__(k, t(arr) if t is not None else arr)

    def __getitem__(self, k):
        v = super().__getitem__(k)
        if v is _LAZY:
            self._materialize()
            v = super().__getitem__(k)
        return v

    def get(self, k, default=None):
        if super().get(k, None) is _LAZY:
            self._materialize()
        return super().get(k, default)

    def pop(self, k, *default):
        if super().get(k, None) is _LAZY:
            self._materialize()
        return super().pop(k, *default)

    def items(self):
        self._materialize()
        return super().items()

    def values(self):
        self._materialize()
        return super().values()

    def copy(self):
        self._materialize()
        return dict(super().items())

    def setdefault(self, k, default=None):
        if super().get(k, None) is _LAZY:
            self._materialize()
        return super().setdefault(k, default)


def fused_ineligibility(dds, sf_type, model_matrix, minmu, config,
                        beta_prior=False, model_matrix_type=None,
                        test="Wald", fit_type="parametric"):
    """None when the configuration can run on the fused engine (for
    fit_type="glmGamPoi" the streamed single-cell route), else a one-line
    reason (the JAX package sends those to its host path)."""
    from .config import DEFAULT, DESeqConfig
    from .formula import Factor

    if sf_type == "iterate":
        return "sfType='iterate' alternates with dispersion fits host-side"
    cfgv = config or DEFAULT
    ref = DESeqConfig()
    off = [f for f in _FROZEN_CONFIG
           if getattr(cfgv, f) != getattr(ref, f)]
    if off:
        return f"non-default config field(s) {off}"
    S = dds.n_samples
    mm = model_matrix
    if mm is None and not isinstance(dds.design, np.ndarray):
        try:
            mm = dds.model_matrix()[0]
        except Exception as e:  # malformed designs: host raises richly
            return f"design not resolvable to a model matrix ({e})"
    elif mm is None:
        mm = dds.design
    if mm.shape[1] >= S:
        return "no residual degrees of freedom (samples <= coefficients)"
    if fit_type == "glmGamPoi":
        if test != "LRT":
            return ("glmGamPoi with test='Wald' runs host-side (the "
                    "reference warns against the combination)")
        if "weights" in dds.assays:
            return "glmGamPoi cannot handle weights (host raises)"
        if dds.normalization_factors is not None \
                and _sc_group_mode(dds) is not None:
            return ("glmGamPoi group design with normalization factors "
                    "runs host-side (the streamed group factorization "
                    "assumes shared per-sample factors; covariate "
                    "designs stream the (G,S) factors)")
        if isinstance(dds.design, np.ndarray) or model_matrix is not None:
            return "glmGamPoi with a user model matrix runs host-side"
        if minmu is not None and minmu != 1e-6:
            return "non-default minmu"
        if _sc_group_mode(dds) is None \
                and len({tuple(r) for r in np.asarray(mm)}) == mm.shape[1]:
            # the host gene-est uses linearMu for cell-means designs;
            # the streamed path reproduces that only through the group
            # factorization (single factor + intercept)
            return ("glmGamPoi linearMu design shape (cell-means "
                    "without a single intercept+factor form) runs "
                    "host-side")
        return None
    if minmu is not None and minmu != 0.5:
        return "non-default minmu"
    if beta_prior:
        if isinstance(dds.design, np.ndarray) or model_matrix is not None:
            return "betaPrior with user-supplied model matrix"
        dvars = dds.design.variables
        if model_matrix_type == "standard":
            return "betaPrior with standard model matrix runs host-side"
        if len(dvars) != 1 or not isinstance(dds.col_data.get(dvars[0]),
                                             Factor):
            return ("fused betaPrior supports single-factor designs; "
                    "multi-factor expanded matrices run host-side")
        if not dds.design_has_intercept():
            return "betaPrior requires an intercept design"
    return None


def _sc_group_mode(dds):
    """(cells codes, n_groups) when the design is a single factor with an
    intercept (the streamed group factorization, and the host's linearMu
    rule, applies), else None."""
    from .formula import Factor
    if isinstance(dds.design, np.ndarray):
        return None
    dvars = dds.design.variables
    if (len(dvars) == 1 and dds.design_has_intercept()
            and isinstance(dds.col_data.get(dvars[0]), Factor)
            and all(o < 2 for o in dds.design.term_orders)):
        fac = dds.col_data[dvars[0]]
        return np.asarray(fac.codes, np.int32), fac.nlevels
    return None


def device_counts(dds, device):
    """The dataset's counts on `device`: the tensor the fused deseq()
    uploaded, when the dataset still carries it, else a fresh upload."""
    dev = torch.device(device)
    cached = getattr(dds, "_counts_dev", None)
    if cached is not None and cached.device == dev \
            and tuple(cached.shape) == tuple(np.shape(dds.counts)):
        return cached
    return torch.as_tensor(np.asarray(dds.counts)).to(dev)


def fit_device(dds):
    """The device a fused deseq() ran on: where its mu assay lives."""
    mu = dds.assays.get("mu")
    if isinstance(mu, DeviceArray):
        return mu.tensor.device
    return torch.device("cpu")


def _two_group(dds):
    """Whether the Cook's two-group unmask heuristic applies
    (R/results.R:538-562): single 2-level factor design."""
    from .formula import Factor
    if isinstance(dds.design, np.ndarray):
        return False
    dvars = dds.design.variables
    return (len(dvars) == 1
            and isinstance(dds.col_data.get(dvars[0]), Factor)
            and dds.col_data[dvars[0]].nlevels == 2)


def deseq_fused(dds, device, dtype, test="Wald", fit_type="parametric",
                full=None, reduced=None, quiet=True, use_t=False,
                min_replicates_for_replace=7, model_matrix=None,
                model_matrix_type=None, maxit=100, beta_prior=False,
                mesh=None):
    """Run the fused pipeline on `device` and populate dds as the host
    stages (estimateSizeFactors -> estimateDispersions -> nbinomWaldTest or
    nbinomLRT -> refitWithoutOutliers) would.  A parametric trend that
    comes back invalid is replaced by the local trend, as the host does
    (R/core.R:888-893).  Weights that fail the estimability tests return
    None (parallel/fused.py:validated_weights): deseq() then runs the host
    engine, whose weightsFail bookkeeping flags those rows.  `beta_prior`: the
    stored contract of nbinomWaldTest with betaPrior (the expanded model
    matrix and its MAP columns, MLE_ columns, betaPriorVar).  `mesh`: a
    GeneMesh whose first device is `device`; the pipeline's per-gene
    chains run on its shards and every output lands on `device`, as the
    JAX package gathers a mesh run's results (engine.py:418-427)."""
    from .dataset import DispersionFunction
    from .formula import parse_formula, rename_model_matrix_columns
    from .parallel.fused import (default_grid, design_cells,
                                 fused_wald_pipeline, reduced_args,
                                 validated_weights)

    if model_matrix is None and not isinstance(dds.design, np.ndarray):
        mm, names = dds.renamed_model_matrix(
            rename=dds.design_has_intercept())
        mm_type = model_matrix_type or ("expanded" if beta_prior
                                        else "standard")
    else:
        mm = model_matrix if model_matrix is not None else dds.design
        _, names = dds.model_matrix() if model_matrix is None else \
            (None, [f"x{i+1}" for i in range(mm.shape[1])])
        mm_type = "user-supplied"
    mm = np.asarray(mm, dtype=np.float64)

    reduced_mm = comparison = None
    if test == "LRT":
        if isinstance(reduced, np.ndarray):
            reduced_mm = np.asarray(reduced, np.float64)
            comparison = "full vs reduced"
        else:
            reduced_mm, _ = dds.model_matrix(reduced)
            full_f = dds.design if full is None else parse_formula(full)
            comparison = f"'{full_f}' vs '{parse_formula(reduced)}'"
    x_red, red_int = reduced_args(reduced_mm)

    weights = None
    if "weights" in dds.assays:
        with profiling.stage("fused.weightsUploadValidate",
                             genes=dds.n_genes):
            weights = validated_weights(dds.assays["weights"], mm, device,
                                        dtype, refuse=False)
        if weights is None:
            return None
    nf = dds.normalization_factors
    sf = dds.size_factors
    if beta_prior:
        # the factor's level codes, so that the expanded columns follow
        # makeExpandedModelMatrix's level order
        cells = tuple(int(c) for c in
                      dds.col_data[dds.design.variables[0]].codes)
    else:
        cells = design_cells(mm)
    min_reps = (int(min_replicates_for_replace)
                if np.isfinite(min_replicates_for_replace)
                else dds.n_samples + 1)

    with profiling.stage("fused.upload", genes=dds.n_genes):
        counts_dev = torch.as_tensor(np.asarray(dds.counts)).to(device)
        if nf is not None:
            nf = torch.as_tensor(np.asarray(nf, np.float64)).to(
                device=device, dtype=dtype)
    with profiling.stage("fused.pipeline", genes=dds.n_genes):
        out = fused_wald_pipeline(
            counts_dev, torch.as_tensor(mm),
            None if sf is None else torch.as_tensor(np.asarray(sf)),
            torch.as_tensor(default_grid(dds.n_samples)), maxit=maxit,
            cells=cells, min_replicates=min_reps,
            linear_mu=len(set(cells)) == mm.shape[1],
            two_group=_two_group(dds), dtype=dtype,
            x_reduced=None if x_red is None else torch.as_tensor(x_red),
            reduced_intercept=red_int, use_t=use_t, weights=weights,
            norm_factors=nf, fit_type=fit_type, beta_prior=beta_prior,
            mesh=mesh)
    # one small eager fetch of what the host reads; the (G,S) assays stay
    # on the device and the per-gene diagnostics are registered lazily
    eager = ("allZero", "replace", "trendValid", "trendCoefs", "meanDisp",
             "dispPriorVar", "varLogDispEsts", "betaPriorVar", "sizeFactors",
             "baseMean", "maxCooks", "filterNumRej", "filterTheta",
             "filterCutoffs")
    if fit_type == "local":
        eager = eager + ("dispGeneEst",)
    with profiling.stage("fused.fetch", genes=dds.n_genes):
        fetched = {k: (out[k].cpu().numpy() if torch.is_tensor(out[k])
                       else np.asarray(out[k]))
                   for k in eager if k in out}
    if fit_type == "parametric" and not bool(fetched["trendValid"]):
        # the host/reference substitutes the local regression
        # (R/core.R:888-893)
        if not quiet:
            warnings.warn(
                "the dispersion trend was not well captured by the "
                "parametric function y = a/x + b; a local regression "
                "fit was substituted")
        return deseq_fused(dds, device, dtype, test=test, fit_type="local",
                           full=full, reduced=reduced, quiet=quiet,
                           use_t=use_t,
                           min_replicates_for_replace=(
                               min_replicates_for_replace),
                           model_matrix=model_matrix,
                           model_matrix_type=model_matrix_type, maxit=maxit,
                           beta_prior=beta_prior, mesh=mesh)
    az = np.asarray(fetched["allZero"], bool)

    if sf is None and nf is None:
        dds.size_factors = np.asarray(fetched["sizeFactors"], float)
    if fit_type == "parametric":
        c0, c1 = np.asarray(fetched["trendCoefs"], float)
        disp_fn = DispersionFunction(
            lambda means, a=float(c0), b=float(c1): a + b / means,
            "parametric", coefficients=np.array([c0, c1]))
    elif fit_type == "mean":
        md = float(np.asarray(fetched["meanDisp"]))
        disp_fn = DispersionFunction(
            lambda m, v=md: np.full(np.shape(m), v) if np.ndim(m) else v,
            "mean", mean=md)
    else:   # local: the pipeline's estimator on the host, in float64,
        # over the fetched fit points
        from .parallel.fused import local_trend_eval, local_trend_state
        dge = torch.as_tensor(fetched["dispGeneEst"], dtype=torch.float64)
        ts = local_trend_state(
            torch.as_tensor(fetched["baseMean"], dtype=torch.float64), dge,
            (dge > 100 * 1e-8) & ~torch.as_tensor(az))

        def fn_loc(means, ts=ts):
            m = np.asarray(means, np.float64)
            x0 = torch.log(torch.as_tensor(m.reshape(-1)))
            return local_trend_eval(ts, x0).numpy().reshape(m.shape)
        disp_fn = DispersionFunction(fn_loc, "local")
    disp_fn.disp_prior_var = float(fetched["dispPriorVar"])
    disp_fn.var_log_disp_ests = float(fetched["varLogDispEsts"])
    dds.dispersion_function = disp_fn

    # ---- intermediate columns (estimateDispersions contract) ----
    rd = dds.set_row_data
    dds.row_data = LazyRowData(dds.row_data)

    def rdl(name, key, type_, desc, transform=None):
        dds.row_data.set_lazy(name, out[key], transform)
        dds.row_meta[name] = (type_, desc)

    def ffloat(v):
        return np.asarray(v, float)

    def napad_t(v):
        return np.where(az, np.nan, np.asarray(v, float))

    def colf(j):
        return lambda v: np.asarray(v[:, j], float)

    rd("baseMean", np.asarray(fetched["baseMean"], float), "intermediate",
       "mean of normalized counts for all samples")
    rdl("baseVar", "baseVar", "intermediate",
        "variance of normalized counts for all samples", ffloat)
    rd("allZero", az, "intermediate", "all counts for a gene are zero")
    if fit_type == "local":
        rd("dispGeneEst", np.asarray(fetched["dispGeneEst"], float),
           "intermediate", "gene-wise estimates of dispersion")
    else:
        rdl("dispGeneEst", "dispGeneEst", "intermediate",
            "gene-wise estimates of dispersion", ffloat)
    rdl("dispGeneIter", "dispGeneIter", "intermediate",
        "number of iterations for gene-wise", napad_t)
    rdl("dispFit", "dispFit", "intermediate",
        "fitted values of dispersion", ffloat)
    rdl("dispersion", "dispersion", "intermediate",
        "final estimate of dispersion", ffloat)
    rdl("dispIter", "dispIter", "intermediate",
        "number of iterations", napad_t)
    rdl("dispOutlier", "dispOutlier", "intermediate",
        "dispersion flagged as outlier", lambda v: np.asarray(v, bool))
    rdl("dispMAP", "dispMAP", "intermediate",
        "maximum a posteriori estimate", ffloat)
    if weights is not None:
        dds.attrs["weightsOK"] = True

    # ---- attrs (nbinomWaldTest / nbinomLRT contract) ----
    if beta_prior:
        from .expanded import make_expanded_model_matrix
        mm_store, names_store = make_expanded_model_matrix(dds)
        pv = float(fetched["betaPriorVar"])
        beta_prior_var = np.array([1e6] + [pv] * (len(names_store) - 1))
    else:
        mm_store, names_store = mm, names
        beta_prior_var = np.full(mm.shape[1], 1e6)
    dds.attrs["betaPrior"] = beta_prior
    dds.attrs["betaPriorVar"] = beta_prior_var
    dds.attrs["modelMatrix"] = mm_store
    dds.attrs["modelMatrixNames"] = list(names_store)
    dds.attrs["modelMatrixType"] = mm_type
    dds.attrs["dispModelMatrix"] = mm
    dds.attrs["test"] = test
    dds.attrs["engine"] = "fused"
    if test == "LRT":
        dds.attrs["reducedModelMatrix"] = reduced_mm

    # ---- assays: device-resident gene x sample matrices ----
    azd = torch.as_tensor(az, device=out["mu"].device)[:, None]
    nan = float("nan")
    dds.assays["mu"] = DeviceArray(
        torch.where(azd, torch.full_like(out["mu"], nan), out["mu"]))
    dds.assays["H"] = DeviceArray(
        torch.where(azd, torch.full_like(out["hatDiag"], nan),
                    out["hatDiag"]))
    if "cooks" in out:
        dds.assays["cooks"] = DeviceArray(out["cooks"])

    # ---- results columns ----
    lfc_type = "MAP" if beta_prior else "MLE"
    names_spaces = [n.replace("_", " ") for n in names_store]
    for j, (n, ns) in enumerate(zip(names_store, names_spaces)):
        rdl(n, "beta", "results", f"log2 fold change ({lfc_type}): {ns}",
            colf(j))
        rdl(f"SE_{n}", "betaSE", "results", f"standard error: {ns}",
            colf(j))
    if beta_prior:
        conv = rename_model_matrix_columns(dds.col_data, dds.design)
        for j, n in enumerate([conv.get(n, n) for n in names]):
            rdl(f"MLE_{n}", "mleBeta", "results",
                "MLE " + n.replace("_", " "), colf(j))
    if test == "Wald":
        for j, (n, ns) in enumerate(zip(names_store, names_spaces)):
            rdl(f"WaldStatistic_{n}", "stat", "results",
                f"Wald statistic: {ns}", colf(j))
        for j, (n, ns) in enumerate(zip(names_store, names_spaces)):
            rdl(f"WaldPvalue_{n}", "pvalue", "results",
                f"Wald test p-value: {ns}", colf(j))
        rdl("betaConv", "betaConv", "results", "convergence of betas",
            napad_t)
        rdl("betaIter", "betaIter", "results", "iterations for betas",
            napad_t)
        rdl("deviance", "deviance", "results",
            "deviance for the fitted model", ffloat)
    else:
        rdl("LRTStatistic", "LRTStatistic", "results",
            f"LRT statistic: {comparison}", ffloat)
        rdl("LRTPvalue", "LRTPvalue", "results",
            f"LRT p-value: {comparison}", ffloat)
        rdl("fullBetaConv", "betaConv", "results",
            "convergence of betas for full model", napad_t)
        rdl("reducedBetaConv", "betaIterReduced", "results",
            "convergence of betas for reduced model",
            lambda v: napad_t(np.asarray(v) < maxit))
        rdl("betaIter", "betaIter", "results",
            "iterations for betas for full model", napad_t)
        rdl("deviance", "deviance", "results",
            "deviance of the full model", ffloat)
    if "maxCooks" in fetched:
        rd("maxCooks", np.asarray(fetched["maxCooks"], float), "results",
           "maximum Cook's distance for row")
    if use_t:
        if weights is not None:
            # (sum of max-1-normalized weights) - p, reduced on the device
            df = (weights / weights.max(dim=1, keepdim=True).values).sum(
                dim=1).double().cpu().numpy() - mm.shape[1]
        else:
            df = np.full(dds.n_genes, float(dds.n_samples - mm.shape[1]))
        df = np.where(df > 0, df, np.nan)
        rd("tDegreesFreedom", np.where(az, np.nan, df), "results",
           "t degrees of freedom for Wald test")

    # ---- outlier replacement bookkeeping (refitWithoutOutliers) ----
    cells_np = np.asarray(cells)
    replaceable = np.bincount(cells_np)[cells_np] >= min_reps
    if replaceable.any() and "replace" in fetched:
        replace = np.asarray(fetched["replace"], bool)
        rd("replace", replace, "intermediate", "had counts replaced")
        dds.col_data["replaceable"] = replaceable
        if replace.any() and "replaceCooks" in out:
            dds.assays["replaceCooks"] = DeviceArray(out["replaceCooks"])
            dds.assays["replaceCounts"] = DeviceArray(out["replaceCounts"])

    # the device-computed results tail, served by results() for a default
    # call, and the uploaded counts (getContrast and shrinkage read them);
    # object attributes (not attrs), so copy() drops them
    dds._fused_tail = dict(
        lfc=out["lfcLast"], se=out["seLast"], stat=out["statLast"],
        pvalue=out["pvalueLast"], padjPlain=out["padjLast"],
        filterPadj=out["filterPadj"],
        numRej=np.asarray(fetched["filterNumRej"], float),
        theta=np.asarray(fetched["filterTheta"], float),
        cutoffs=np.asarray(fetched["filterCutoffs"], float),
        alpha=0.1, test=test, useT=use_t, betaPrior=beta_prior,
        name=names_store[-1] if len(names_store) else None)
    if beta_prior:
        lv = dds.col_data[dds.design.variables[0]]
        dds._fused_tail["defaultContrast"] = (
            dds.design.variables[0], lv.levels[-1], lv.levels[0])
    dds._counts_dev = counts_dev
    return dds


def deseq_sc_fused(dds, device, dtype, reduced, full=None, quiet=True,
                   maxit=100, mesh=None):
    """Run deseq(fit_type='glmGamPoi', test='LRT') through the streamed
    single-cell pipeline (parallel/sc.py:fused_sc_results) on `device` in
    `dtype`, and populate the dataset with the host glmGamPoi columns
    (the estimateDispersions glmGamPoi branch and the quasi-likelihood
    F-test, R/core.R:789-816, 1064-1096, 1898-1947).

    No (genes x samples) intermediate is made, so `~ batch + condition`
    at 50k cells fits the card beside its counts.  The mu/H assays are not
    stored (they are (G,S)); results() does not need them, and the
    reference disables the Cook's/outlier machinery for glmGamPoi
    (R/core.R:297-303, maxCooks is NA).  Size factors, when the dataset
    has neither them nor normalization factors, are the port's
    median-of-ratios on the device.  `mesh`: a GeneMesh whose first device
    is `device`, over whose shards the streamed stages run (the JAX
    package's deseq_sc_fused, engine.py:764-784)."""
    from .dataset import DispersionFunction
    from .formula import parse_formula
    from .gampoi import make_closest_index_disp_fn, ql_to_nb_alpha
    from .parallel.fused import size_factors_dev
    from .parallel.sc import fused_sc_results

    mm, names = dds.renamed_model_matrix(rename=dds.design_has_intercept())
    mm = np.asarray(mm, np.float64)
    reduced_mm, _ = dds.model_matrix(reduced)
    full_f = dds.design if full is None else parse_formula(full)
    comparison = f"'{full_f}' vs '{parse_formula(reduced)}'"

    with profiling.stage("fused.upload", genes=dds.n_genes):
        counts_dev = device_counts(dds, device)
    nf = dds.normalization_factors
    sf = dds.size_factors
    if sf is None and nf is None:
        with profiling.stage("estimateSizeFactors", genes=dds.n_genes):
            sf = size_factors_dev(counts_dev.to(dtype), mesh).double().cpu()
        dds.size_factors = sf.numpy()
    elif sf is None:
        sf = np.ones(dds.n_samples)

    grp = _sc_group_mode(dds)
    if grp is not None and not (reduced_mm.shape[1] == 1
                                and np.all(reduced_mm == 1.0)):
        grp = None    # the group mode's reduced model is ~ 1's closed form
    kw = dict(size_factors=sf, test="LRT", fit_type="glmGamPoi",
              maxit=maxit, independent_filtering=False, quiet=quiet,
              device=device, dtype=dtype, mesh=mesh)
    with profiling.stage("fused.scPipeline", genes=dds.n_genes):
        if grp is not None:
            # single factor + intercept: the group factorization (exact
            # linearMu semantics, the host's cell-means mu rule)
            cells, n_groups = grp
            out = fused_sc_results(counts_dev, cells=cells,
                                   n_groups=n_groups, **kw)
        else:
            out = fused_sc_results(counts_dev, design=mm,
                                   reduced_design=reduced_mm,
                                   norm_factors=nf, **kw)

    az = np.asarray(out["allZero"], bool)
    nz = ~az

    def napad(v):
        return np.where(az, np.nan, np.asarray(v, float))

    rd = dds.set_row_data
    rd("baseMean", np.asarray(out["baseMean"], float), "intermediate",
       "mean of normalized counts for all samples")
    rd("baseVar", np.asarray(out["baseVar"], float), "intermediate",
       "variance of normalized counts for all samples")
    rd("allZero", az, "intermediate", "all counts for a gene are zero")
    rd("dispGeneEst", np.asarray(out["dispGeneEst"], float),
       "intermediate", "gene-wise estimates of dispersion")
    rd("dispGeneIter", napad(out["dispGeneIter"]), "intermediate",
       "number of iterations for gene-wise")
    rd("dispFit", np.asarray(out["dispFit"], float), "intermediate",
       "fitted values of dispersion")

    bm = np.asarray(out["baseMean"], float)
    dge = np.asarray(out["dispGeneEst"], float)
    fitv = np.asarray(out["dispFit"], float)
    for name, desc in (("qlDispMLE", "quasi likelihood dispersion MLE"),
                       ("qlDispFit", "quasi likelihood dispersion Trend"),
                       ("qlDispMAP", "quasi likelihood dispersion MAP")):
        rd(name, np.asarray(out[name], float), "intermediate", desc)
    min_disp, max_disp = 1e-8, max(10.0, dds.n_samples)
    with np.errstate(invalid="ignore"):
        fit_corr = np.full(dds.n_genes, np.nan)
        fit_corr[nz] = ql_to_nb_alpha(
            np.asarray(out["qlDispFit"], float)[nz], bm[nz], fitv[nz],
            min_disp, max_disp)
    rd("dispFitQLCorrected", fit_corr, "intermediate",
       "dispersion trend corrected by quasi likelihood")
    dds.attrs["quasiLikelihood_df0"] = float(out["ql_df0"])
    rd("dispersion", np.asarray(out["dispersion"], float),
       "intermediate", "final estimate of dispersion")
    rd("dispIter", napad(np.zeros(dds.n_genes)), "intermediate",
       "number of iterations")
    rd("dispOutlier", np.asarray(out["dispOutlier"], bool),
       "intermediate", "dispersion flagged as outlier")
    rd("dispMAP", np.asarray(out["dispMAP"], float), "intermediate",
       "maximum a posteriori estimate")

    # the trend function: glmGamPoi's closest-index lookup over the
    # fitted medians, rebuilt from the fit values themselves
    use = nz & np.isfinite(dge) & (dge > 100 * min_disp)
    disp_fn = DispersionFunction(
        make_closest_index_disp_fn(bm[use], fitv[use]), "glmGamPoi")
    disp_fn.disp_prior_var = float(np.asarray(out["dispPriorVar"]))
    disp_fn.var_log_disp_ests = float(np.asarray(out["varLogDispEsts"]))
    dds.dispersion_function = disp_fn

    # ---- results columns (the QL F-test; host _nbinom_lrt_gampoi) ----
    beta = np.asarray(out["beta"], float)
    na = np.full(dds.n_genes, np.nan)
    for j, n in enumerate(names):
        ns = n.replace("_", " ")
        rd(n, beta[:, j], "results", f"log2 fold change (MLE): {ns}")
        rd(f"SE_{n}", na.copy(), "results", f"standard error: {ns}")
    rd("LRTStatistic", np.asarray(out["LRTStatistic"], float), "results",
       f"LRT statistic: {comparison}")
    rd("LRTPvalue", np.asarray(out["LRTPvalue"], float), "results",
       f"LRT p-value: {comparison}")
    rd("fullBetaConv", napad(np.ones(dds.n_genes)), "results",
       "convergence of betas for full model")
    rd("reducedBetaConv", napad(np.ones(dds.n_genes)), "results",
       "convergence of betas for reduced model")
    rd("betaIter", na.copy(), "results",
       "iterations for betas for full model")
    rd("deviance", -2.0 * np.asarray(out["llFull"], float), "results",
       "deviance of the full model")
    rd("maxCooks", na.copy(), "results",
       "maximum Cook's distance for row")

    dds.attrs["betaPrior"] = False
    dds.attrs["betaPriorVar"] = np.full(mm.shape[1], 1e6)
    dds.attrs["modelMatrix"] = mm
    dds.attrs["modelMatrixNames"] = list(names)
    dds.attrs["modelMatrixType"] = "standard"
    dds.attrs["reducedModelMatrix"] = reduced_mm
    dds.attrs["dispModelMatrix"] = mm
    dds.attrs["test"] = "LRT"
    dds.attrs["engine"] = "fused-sc"
    dds._counts_dev = counts_dev
    return dds
