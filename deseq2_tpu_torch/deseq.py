"""The DESeq() entry point (reference R/core.R:280-432).

Argument checks mirror the reference.  Two engines, as in the JAX package
(deseq2_tpu/deseq.py:148-242):
- the fused pipeline (engine.deseq_fused): the Wald test or the LRT, with
  or without observation weights, normalization factors and use_t, with
  the parametric, local or mean trend, and the Wald test with betaPrior on
  a single-factor design with an intercept;
- the host-exact engine (sizefactors.py, dispersions.py, wald.py, lrt.py,
  outliers.py): the JAX package's host orchestration, with its batched
  per-gene fits through K1-K3 in float64 on the same device.  It runs
  every other configuration: sfType "iterate", a non-default DESeqConfig
  field or minmu, betaPrior on any design, samples <= coefficients, and
  weights that fail the rank tests (flagged weightsFail).
fit_type="glmGamPoi" with the LRT runs the streamed single-cell pipeline
(engine.deseq_sc_fused, parallel/sc.py) on group and small-p covariate
designs, and the host engine's glmGamPoi branches (the QL shrinkage and
the quasi-likelihood F-test) for the cases the JAX package sends there.
engine="auto" (the default) runs the fused pipeline wherever it is
eligible and the host engine otherwise (with the JAX package's warning
when quiet=False); "fused" and "host" force one.  Both run on "cuda"
unless the caller passes device="cpu".

`mesh` (parallel.gene_mesh; the reference's parallel=TRUE, R/core.R:
407-416, and the JAX package's deseq2_tpu/deseq.py:38-58) shards the genes
axis over its devices on every route: the fused pipeline and the streamed
single-cell one run their per-gene chains block by block on the shards
and their cross-gene steps on the gathered vectors; the host engine runs
under ops/placement.py:use_gene_mesh, every batched fit of every stage
sharded.  The results equal the single-device run's and land on the
mesh's first device, where results() and lfc_shrink() then run.
"""

from __future__ import annotations

import contextlib
import warnings

import numpy as np

from .dataset import check_full_rank
from .formula import parse_formula
from .lrt import check_lrt
from . import profiling


def deseq(dds, test="Wald", fit_type="parametric", sf_type="ratio",
          beta_prior=False, full=None, reduced=None, quiet=True,
          min_replicates_for_replace=None, model_matrix_type=None,
          use_t=False, minmu=None, config=None, mesh=None, engine=None,
          device=None):
    """size factors -> dispersions -> Wald or LRT -> outlier refit, on the
    card.

    `device`: "cuda" (the default) runs the hand-written kernels; "cpu"
    runs their plain PyTorch versions.  Without a card and without
    device="cpu" this raises.  The fused engine's dtype is
    DESeqConfig.dtype ("float64" by default; "float32" is the fast path);
    the host engine runs in float64.  `engine`: "auto" (the default),
    "fused" or "host" (see the module docstring).  `config` defaults to
    the dataset's own.  `mesh`: a GeneMesh (module docstring); `device`
    may then only repeat its first device's type."""
    from .config import cfg
    from .engine import fused_ineligibility, resolve_device, resolve_dtype

    if config is None:
        config = dds.config
    min_replicates_for_replace = cfg(min_replicates_for_replace,
                                     "min_replicates_for_replace", config)
    if engine not in (None, "auto", "fused", "host"):
        raise ValueError("engine must be 'auto', 'fused' or 'host'")
    if test not in ("Wald", "LRT"):
        raise ValueError("test must be 'Wald' or 'LRT'")
    if fit_type not in ("parametric", "local", "mean", "glmGamPoi"):
        raise ValueError("unknown fitType")
    if sf_type not in ("ratio", "poscounts", "iterate"):
        raise ValueError("unknown sfType")
    if minmu is None:
        # reference default: minmu = 1e-6 for glmGamPoi else 0.5
        minmu = 1e-6 if fit_type == "glmGamPoi" else 0.5
    if fit_type == "glmGamPoi":
        min_replicates_for_replace = np.inf
        if test == "Wald" and not quiet:
            warnings.warn("the glmGamPoi dispersion estimator should be "
                          "used in combination with test='LRT'")

    model_as_formula = (full is None or not isinstance(full, np.ndarray)) \
        and not isinstance(dds.design, np.ndarray)

    if test == "LRT":
        if reduced is None:
            raise ValueError("likelihood ratio test requires a 'reduced' "
                             "design, see ?DESeq")
        if beta_prior:
            raise ValueError("test='LRT' does not support use of LFC "
                             "shrinkage, use betaPrior=FALSE")
        if model_matrix_type == "expanded":
            raise ValueError("test='LRT' does not support use of expanded "
                             "model matrix")
        if isinstance(full, np.ndarray) != isinstance(reduced, np.ndarray) \
                and full is not None:
            raise ValueError("if one of 'full' and 'reduced' is a matrix, "
                             "the other must be also a matrix")
        if model_as_formula:
            check_lrt(full if full is not None else dds.design, reduced)
        else:
            check_full_rank(full)
            check_full_rank(reduced)
            if full.shape[1] <= reduced.shape[1]:
                raise ValueError("the number of columns of 'full' should be "
                                 "more than the number of columns of "
                                 "'reduced'")
    if test == "Wald" and reduced is not None:
        raise ValueError("'reduced' ignored when test='Wald'")

    if model_as_formula:
        if full is not None and parse_formula(full) != dds.design:
            raise ValueError("'full' specified as formula should equal "
                             "design(object)")
        if not dds.design.variables:
            warnings.warn("the design is ~ 1 (just an intercept). "
                          "is this intended?")
        from .formula import Factor, make_names
        for v in dds.design.variables:
            val = dds.col_data.get(v)
            if isinstance(val, Factor):
                nms = make_names(val.levels)
                if len(set(nms)) != len(nms):
                    raise ValueError(
                        "levels of factors in the design have non-unique "
                        "level names after make.names() is applied. best "
                        "to only use letters and numbers for levels of "
                        "factors in the design")
        model_matrix = None
    else:
        if beta_prior:
            raise ValueError("betaPrior=TRUE is not supported for "
                             "user-provided model matrices")
        model_matrix = full if full is not None else dds.design
        check_full_rank(model_matrix)

    dev = resolve_device(device, mesh)
    engine = engine or "auto"
    if engine != "host":
        reason = fused_ineligibility(dds, sf_type, model_matrix, minmu,
                                     config, beta_prior, model_matrix_type,
                                     test=test, fit_type=fit_type)
        if reason is None and fit_type == "glmGamPoi":
            return _deseq_sc(dds, dev, resolve_dtype(config), full=full,
                             reduced=reduced, quiet=quiet, mesh=mesh)
        if reason is None:
            routed = _deseq_fused(
                dds, dev, resolve_dtype(config), sf_type, test=test,
                fit_type=fit_type, full=full, reduced=reduced, quiet=quiet,
                use_t=use_t,
                min_replicates_for_replace=min_replicates_for_replace,
                model_matrix=model_matrix,
                model_matrix_type=model_matrix_type, beta_prior=beta_prior,
                mesh=mesh)
            if routed is not None:
                return routed
            reason = ("weights do not allow parameter estimation for "
                      "some rows (weightsFail bookkeeping is host-side)")
        if engine == "fused":
            raise ValueError(f"engine='fused' unavailable: {reason}")
        if not quiet:
            warnings.warn(f"fused engine unavailable ({reason}); "
                          "running the host-exact path")
    from .ops.placement import use_gene_mesh
    with (use_gene_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()):
        return _deseq_host(dds, dev, test, fit_type, sf_type, beta_prior,
                           full, reduced, quiet, min_replicates_for_replace,
                           model_matrix, model_matrix_type, use_t, minmu,
                           config)


def _deseq_fused(dds, dev, dtype, sf_type, **kw):
    """The fused route; poscounts size factors are estimated first, as the
    JAX package's deseq_fused does, and so are a tximport dataset's
    normalization factors (its avgTxLength assay, R/methods.R:383-391),
    which the JAX package's fused route leaves out.  None when the weights
    fail the rank tests (the host engine then runs)."""
    from .engine import deseq_fused
    from .sizefactors import estimate_size_factors
    # the fused route never mutates counts in place, so the copy aliases
    # the counts buffer
    with profiling.stage("deseq.copy"):
        dds = dds.copy(share_counts=True)
    if dds.size_factors is None and dds.normalization_factors is None \
            and (sf_type == "poscounts" or "avgTxLength" in dds.assays):
        with profiling.stage("estimateSizeFactors", genes=dds.n_genes):
            dds = estimate_size_factors(dds, type=sf_type, device=dev)
    with profiling.stage("deseqFused", genes=dds.n_genes):
        return deseq_fused(dds, dev, dtype, **kw)


def _deseq_sc(dds, dev, dtype, **kw):
    """The streamed single-cell route of deseq(fit_type="glmGamPoi",
    test="LRT"); the dataset's copy aliases its counts (the route never
    mutates them)."""
    from .engine import deseq_sc_fused
    with profiling.stage("deseq.copy"):
        dds = dds.copy(share_counts=True)
    dds.attrs["betaPrior"] = False
    with profiling.stage("deseqFusedSC", genes=dds.n_genes):
        return deseq_sc_fused(dds, dev, dtype, **kw)


def _deseq_host(dds, dev, test, fit_type, sf_type, beta_prior, full,
                reduced, quiet, min_replicates_for_replace, model_matrix,
                model_matrix_type, use_t, minmu, config):
    """The host-exact engine (deseq2_tpu/deseq.py:188-242): size factors,
    dispersions, the Wald test or the LRT, and the outlier refit, with the
    batched fits on `dev` in float64."""
    from .dispersions import estimate_dispersions, n_or_more_in_cell
    from .lrt import nbinom_lrt
    from .outliers import refit_without_outliers
    from .sizefactors import estimate_size_factors
    from .wald import nbinom_wald_test

    from .engine import DeviceArray
    from .hostdev import as_t

    with profiling.stage("deseq.copy"):
        dds = dds.copy(share_counts=True)
    if "weights" in dds.assays \
            and not isinstance(dds.assays["weights"], DeviceArray):
        # uploaded once: every stage's dataset copy then shares the tensor
        with profiling.stage("deseq.weightsUpload"):
            dds.assays["weights"] = DeviceArray(as_t(dds.assays["weights"],
                                                     dev))
    dds.attrs["betaPrior"] = beta_prior
    # Single-cell-scale guardrail (the reference's own SC guidance,
    # R/core.R:297-303): the host-exact path materializes several (G,S)
    # float64 intermediates, so covariate designs at tens of thousands
    # of samples can exhaust host/device memory; the streamed path
    # (parallel.sc.fused_sc_results) handles them with (G,p) state
    S_n = dds.n_samples
    if S_n >= 10000:
        mm_chk = np.asarray(model_matrix if model_matrix is not None
                            else dds.model_matrix()[0])
        group_like = len({tuple(r) for r in mm_chk}) == mm_chk.shape[1]
        if not group_like and not quiet:
            warnings.warn(
                f"design with covariates at {S_n} samples takes the "
                "materializing host path (several (genes x samples) "
                "intermediates). For single-cell scale use the streamed "
                "path: parallel.sc.fused_sc_results(design=model_matrix, "
                "reduced_design=..., fit_type='glmGamPoi') handles "
                "arbitrary small-p designs with (G,p) persistent state")
    G = dds.n_genes
    if dds.size_factors is None and dds.normalization_factors is None:
        with profiling.stage("estimateSizeFactors", genes=G):
            dds = estimate_size_factors(dds, type=sf_type, quiet=quiet,
                                        device=dev)
    with profiling.stage("estimateDispersions", genes=G):
        dds = estimate_dispersions(dds, fit_type=fit_type, quiet=quiet,
                                   model_matrix=model_matrix, min_mu=minmu,
                                   config=config, device=dev)
    if test == "Wald":
        with profiling.stage("nbinomWaldTest", genes=G):
            dds = nbinom_wald_test(dds, beta_prior=beta_prior, quiet=quiet,
                                   model_matrix=model_matrix,
                                   model_matrix_type=model_matrix_type,
                                   use_t=use_t, min_mu=minmu, config=config,
                                   device=dev)
    else:
        with profiling.stage("nbinomLRT", genes=G):
            dds = nbinom_lrt(dds,
                             full=full if full is not None else dds.design,
                             reduced=reduced, quiet=quiet, min_mu=minmu,
                             type=("glmGamPoi" if fit_type == "glmGamPoi"
                                   else "DESeq2"), config=config,
                             device=dev)
    if np.isfinite(min_replicates_for_replace):
        sufficient = np.any(n_or_more_in_cell(dds.attrs["modelMatrix"],
                                              min_replicates_for_replace))
        if sufficient:
            with profiling.stage("refitWithoutOutliers", genes=G):
                dds = refit_without_outliers(
                    dds, test=test, beta_prior=beta_prior, full=full,
                    reduced=reduced, quiet=quiet,
                    min_replicates_for_replace=min_replicates_for_replace,
                    model_matrix=model_matrix,
                    model_matrix_type=model_matrix_type, device=dev)
    dds.attrs["engine"] = "host"
    return dds
