"""The DESeq() entry point (reference R/core.R:280-432).

Argument checks mirror the reference; the Wald test or the LRT, with or
without observation weights, normalization factors and use_t, with the
parametric, local or mean trend, and the Wald test with betaPrior on a
single-factor design with an intercept, runs the fused pipeline
(engine.deseq_fused) on the card, or on the CPU with device="cpu".
glmGamPoi, a mesh, the host engine and the configurations the fused engine
does not take (betaPrior on other designs among them) raise
NotImplementedError naming the ROADMAP.md item that will port them.
"""

from __future__ import annotations

import warnings

import numpy as np

from .dataset import check_full_rank
from .formula import parse_formula
from . import profiling


def check_lrt(full, reduced):
    """(reference checkLRT, R/core.R:2475-2481)"""
    full_vars = set(parse_formula(full).variables)
    missing = [v for v in parse_formula(reduced).variables
               if v not in full_vars]
    if missing:
        raise ValueError(
            "the following variables in the reduced formula not in the full "
            "formula: " + ", ".join(missing))


def deseq(dds, test="Wald", fit_type="parametric", sf_type="ratio",
          beta_prior=False, full=None, reduced=None, quiet=True,
          min_replicates_for_replace=None, model_matrix_type=None,
          use_t=False, minmu=None, config=None, mesh=None, engine=None,
          device=None):
    """size factors -> dispersions -> Wald or LRT -> outlier refit, on the
    card.

    `device`: "cuda" (the default) runs the hand-written kernels; "cpu"
    runs their plain PyTorch versions.  Without a card and without
    device="cpu" this raises.  The dtype is DESeqConfig.dtype ("float64"
    by default; "float32" is the fast path).  `config` defaults to the
    dataset's own."""
    from .config import cfg
    from .engine import (deseq_fused, fused_ineligibility, resolve_device,
                         resolve_dtype)
    from .parallel.fused import ROADMAP_HOST, ROADMAP_MESH, not_ported

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
        minmu = 1e-6 if fit_type == "glmGamPoi" else 0.5

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

    # configurations outside this slice
    if engine == "host":
        raise not_ported("engine='host'", ROADMAP_HOST)
    if fit_type == "glmGamPoi":
        raise not_ported("fit_type='glmGamPoi'",
                         "ROADMAP.md queue 1, item 8 (single-cell path)")
    if mesh is not None:
        raise not_ported("a device mesh", ROADMAP_MESH)
    if dds.size_factors is None and dds.normalization_factors is None \
            and sf_type != "ratio":
        raise not_ported(f"sf_type={sf_type!r}", ROADMAP_HOST)
    reason = fused_ineligibility(dds, sf_type, model_matrix, minmu, config,
                                 beta_prior, model_matrix_type)
    if reason is not None:
        raise not_ported(f"this configuration ({reason})", ROADMAP_HOST)

    dev = resolve_device(device)
    dtype = resolve_dtype(config)
    # the fused route never mutates counts in place, so the copy aliases
    # the counts buffer
    with profiling.stage("deseq.copy"):
        dds = dds.copy(share_counts=True)
    with profiling.stage("deseqFused", genes=dds.n_genes):
        return deseq_fused(
            dds, dev, dtype, test=test, fit_type=fit_type, full=full,
            reduced=reduced, quiet=quiet, use_t=use_t,
            min_replicates_for_replace=min_replicates_for_replace,
            model_matrix=model_matrix, model_matrix_type=model_matrix_type,
            beta_prior=beta_prior)
