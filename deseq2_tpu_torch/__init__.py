"""deseq2_tpu_torch: the PyTorch/CUDA port of deseq2_tpu for NVIDIA Hopper.

The public bulk deseq() + results() runs on the card: the Wald test or the
LRT (reduced to the intercept, a formula or a matrix), with or without
observation weights, gene x sample normalization factors and t p-values
(use_t), under the parametric, local or mean dispersion trend; betaPrior
on a single-factor design with an intercept (the expanded model matrix);
results(contrast=...) in character, list and numeric form, with add_mle;
and lfc_shrink of types "apeglm", "ashr" and "normal" (contrast mode).
The per-gene solvers (ridge NB IRLS, the dispersion line search and the
grid search, each unweighted or weighted) are hand-written CUDA kernels
built from csrc/ at first use; the rest is PyTorch.  deseq() runs on
"cuda" unless the caller passes device="cpu", which runs the kernels'
plain PyTorch versions; results() and lfc_shrink() run where the fit
ran.  The dtype is DESeqConfig.dtype: "float64" by default, "float32" for
the fast path.

What is not ported raises NotImplementedError naming the ROADMAP.md item
that owns it: the host engine, betaPrior on other designs and the
normal-shrink cases the JAX package runs on its host Wald test (item 7),
glmGamPoi (item 8), the transforms (item 9) and a device mesh (item 11).
Weights that fail the estimability tests raise ValueError (the host
path's weightsFail bookkeeping is item 7).
"""

import torch as _torch

# Full-precision float32 products: reduced-precision (TF32) X'WX turns the
# IRLS fixpoint into a limit cycle (genes oscillate to maxit).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from . import profiling  # noqa: E402
from .config import DESeqConfig  # noqa: E402
from .convert import dataset_from_arrays  # noqa: E402
from .dataset import DESeqDataSet, dataset_from_matrix  # noqa: E402
from .deseq import deseq  # noqa: E402
from .formula import Factor, Formula, parse_formula  # noqa: E402
from .results import DESeqResults, remove_results, results  # noqa: E402
from .results import results_names  # noqa: E402
from .shrink import lfc_shrink  # noqa: E402
from .simulate import make_example_dataset  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "DESeqConfig", "DESeqDataSet", "DESeqResults", "Factor", "Formula",
    "dataset_from_arrays", "dataset_from_matrix", "deseq", "lfc_shrink",
    "make_example_dataset", "parse_formula", "profiling", "remove_results",
    "results", "results_names",
]
