"""deseq2_tpu_torch: the PyTorch/CUDA port of deseq2_tpu for NVIDIA Hopper.

The public bulk deseq() + results() runs on the card, through one of two
engines, as in the JAX package.  The fused pipeline takes the Wald test or
the LRT (reduced to the intercept, a formula or a matrix), with or without
observation weights, gene x sample normalization factors and t p-values
(use_t), under the parametric, local or mean dispersion trend, and
betaPrior on a single-factor design with an intercept.  The host-exact
engine (engine="host", and the "auto" fallback) takes everything else the
JAX package's host path runs: sfType "poscounts" and "iterate", any
DESeqConfig field and minmu, betaPrior on any design (expanded or
standard), weights that fail the rank tests (flagged weightsFail), with its
stages exported (estimate_size_factors, the estimate_dispersions*
functions, nbinom_wald_test, nbinom_lrt, replace_outliers, ...).  Then
results(contrast=...) in character, list and numeric form, with add_mle,
and lfc_shrink of types "apeglm", "ashr" and "normal".  The transforms
(vst, variance_stabilizing_transformation, rlog, norm_transform; their
payload a DESeqTransform tensor on the device) fit what the reference fits
for them, the gene-wise dispersions and the trend, on the card.  The
utilities (collapse_replicates, fpm, fpkm, unmix, covariance_matrix, the
plots' *_data functions, and the io module's save_dataset/load_dataset/
save_results/load_results, in the JAX package's file format) follow the
JAX package.  The per-gene
solvers (ridge NB IRLS, the dispersion line search and the grid search, in
their weighted, no-Cox-Reid and weight-threshold modes) are hand-written
CUDA kernels built from csrc/ at first use, for designs of up to 8
columns (the IRLS up to 16, from its P = 16 build on a zero-padded
design); wider designs run their plain PyTorch versions on the card.  The
rest is PyTorch.  deseq() and the transforms run on "cuda" unless the
caller passes device="cpu", which runs the kernels' plain PyTorch
versions; results() and lfc_shrink() run where the fit ran.  The fused
engine's dtype, and the transforms' payload dtype, is DESeqConfig.dtype:
"float64" by default, "float32" for the fast path; the host engine runs
in float64.

deseq(fit_type="glmGamPoi") runs the JAX package's routing: the LRT on a
group or small-p covariate design takes the streamed single-cell path
(parallel.sc.fused_sc_results, which streams sample chunks of the int32
counts and keeps (G,p) state; `fused_sc_results` and `fused_sc_pipeline`
are exported from deseq2_tpu_torch.parallel), the rest the host engine's
glmGamPoi branches (the loc-median trend, the quasi-likelihood shrinkage
and F-test, its fits through K1 at minmu = 1e-6).

deseq(mesh=parallel.gene_mesh(n)) shards the genes axis over n devices on
every route (the fused pipeline, the host engine, the streamed single-cell
path), with the single-device run's results on the mesh's first device;
a mesh may also span processes (gene_mesh(process_group=...), over
torch.distributed).
"""

import torch as _torch

# Full-precision float32 products: reduced-precision (TF32) X'WX turns the
# IRLS fixpoint into a limit cycle (genes oscillate to maxit).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import profiling  # noqa: E402
from .config import DESeqConfig  # noqa: E402
from .convert import dataset_from_arrays  # noqa: E402
from .dataset import (DESeqDataSet, dataset_from_htseq_count,  # noqa: E402
                      dataset_from_matrix, dataset_from_tximport)
from .deseq import deseq  # noqa: E402
from .dispersions import (estimate_dispersions,  # noqa: E402
                          estimate_dispersions_fit,
                          estimate_dispersions_gene_est,
                          estimate_dispersions_map,
                          estimate_dispersions_prior_var)
from .formula import Factor, Formula, parse_formula  # noqa: E402
from .helper import (collapse_replicates, covariance_matrix,  # noqa: E402
                     fpkm, fpm, integrate_with_single_cell,
                     normalize_gene_length, unmix)
from .lrt import nbinom_lrt  # noqa: E402
from .outliers import replace_outliers  # noqa: E402
from .results import DESeqResults, remove_results, results  # noqa: E402
from .results import results_names  # noqa: E402
from .shrink import lfc_shrink  # noqa: E402
from .simulate import make_example_dataset  # noqa: E402
from .transforms import (DESeqTransform, norm_transform,  # noqa: E402
                         rlog, variance_stabilizing_transformation, vst)
from .sizefactors import (estimate_size_factors,  # noqa: E402
                          size_factors_for_matrix)
from .wald import (estimate_beta_prior_var,  # noqa: E402
                   estimate_mle_for_beta_prior_var, nbinom_wald_test)
from . import io  # noqa: E402
from .io import (load_dataset, load_results, save_dataset,  # noqa: E402
                 save_results)

__version__ = "0.1.0"

__all__ = [
    "DESeqConfig", "DESeqDataSet", "DESeqResults", "DESeqTransform",
    "Factor", "Formula", "collapse_replicates", "covariance_matrix",
    "dataset_from_arrays", "dataset_from_htseq_count",
    "dataset_from_matrix", "dataset_from_tximport", "deseq",
    "estimate_beta_prior_var", "estimate_dispersions",
    "estimate_dispersions_fit", "estimate_dispersions_gene_est",
    "estimate_dispersions_map", "estimate_dispersions_prior_var",
    "estimate_mle_for_beta_prior_var", "estimate_size_factors", "fpkm",
    "fpm", "integrate_with_single_cell", "lfc_shrink", "load_dataset",
    "load_results", "make_example_dataset", "nbinom_lrt",
    "nbinom_wald_test", "norm_transform", "normalize_gene_length",
    "parse_formula", "profiling", "remove_results", "replace_outliers",
    "results", "results_names", "rlog", "save_dataset", "save_results",
    "size_factors_for_matrix", "unmix",
    "variance_stabilizing_transformation", "vst",
]
