"""deseq2_tpu_torch: the PyTorch/CUDA port of deseq2_tpu for NVIDIA Hopper.

The public bulk deseq() + results() runs on the card: the Wald test or the
LRT (reduced to the intercept, a formula or a matrix), with or without
observation weights, gene x sample normalization factors and t p-values
(use_t), under the parametric, local or mean dispersion trend.  The
per-gene solvers (ridge NB IRLS, the dispersion line search and the grid
search, each unweighted or weighted) are hand-written CUDA kernels built
from csrc/ at first use; the rest is PyTorch.  Every entry point runs on
"cuda" unless the caller passes device="cpu", which runs the kernels'
plain PyTorch versions.  The dtype is DESeqConfig.dtype: "float64" by
default, "float32" for the fast path.

betaPrior, contrasts, the host engine, glmGamPoi and a device mesh raise
NotImplementedError naming the ROADMAP.md item that ports them; weights
that fail the estimability tests raise ValueError (the host path's
weightsFail bookkeeping is not ported).
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
from .simulate import make_example_dataset  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "DESeqConfig", "DESeqDataSet", "DESeqResults", "Factor", "Formula",
    "dataset_from_arrays", "dataset_from_matrix", "deseq",
    "make_example_dataset", "parse_formula", "profiling", "remove_results",
    "results", "results_names",
]
