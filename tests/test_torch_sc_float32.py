"""The port's streamed single-cell path in float32 against its float64
call (bench.py's single-cell gate), and its float32 searches on request:
tests/test_torch_sc.py's single-cell tests at bench.py's gate size, in a
file of their own so that the suite's workers take them apart from the
rest of that file.
"""

import numpy as np
import pytest
import torch

from deseq2_tpu_torch.ops import checks
from deseq2_tpu_torch.parallel import sc as tsc
from test_torch_sc import CPU, FLOOR
from torch_threads import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# float32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("design", ["group", "covariate"])
def test_float32_follows_float64(design):
    """bench.py's gate fixtures at its size (2,048 x 4,096): the port's
    float32 call against its float64 call with the histogram order
    matched, held to bench.py's limits (|dLFC| < 0.02, log10 p excess <
    1.0, no confident flips, rejection-set Jaccard >= 0.94).  The
    dispersion estimation runs in float64 in both (sc.SEARCH_DTYPE); the
    float32 call's GLM, test and tail in float32."""
    if design == "group":
        counts, cells, sf = checks.sc_gate_inputs(2048, 4096)
        kw = dict(cells=cells, n_groups=2)
    else:
        counts, x, red, sf = checks.sc_cov_gate_inputs(2048, 4096)
        kw = dict(design=x, reduced_design=red)
    run = dict(size_factors=sf, test="LRT", fit_type="glmGamPoi", **kw,
               **CPU)
    o32 = tsc.fused_sc_results(counts, dtype=torch.float32, **run)
    o64 = tsc.fused_sc_results(counts, dtype=torch.float64, use_hist=True,
                               **run)
    assert o32["log2FoldChange"].dtype == np.float32
    r = checks.sc_gate(o32, o64)
    assert r["ok"], r


def test_float32_searches_on_request(monkeypatch):
    """With sc.SEARCH_DTYPE rebound to float32 a float32 call runs the JAX
    package's float32 searches (its stall exit and 50 eps |lp| stopping
    rule): their gene-wise estimates sit apart from the float64 searches'
    on the gate fixture, within the few percent that rule allows on the
    genes both converge."""
    counts, cells, sf = checks.sc_gate_inputs(512, 1024)
    kw = dict(cells=cells, n_groups=2, size_factors=sf, test="LRT",
              fit_type="glmGamPoi", dtype=torch.float32, **CPU)
    b = tsc.fused_sc_results(counts, **kw)
    monkeypatch.setattr(tsc, "SEARCH_DTYPE", torch.float32)
    a = tsc.fused_sc_results(counts, **kw)
    conv = (a["dispGeneIter"] < 100) & (b["dispGeneIter"] < 100) \
        & (a["dispGeneEst"] > FLOOR) & (b["dispGeneEst"] > FLOOR)
    rel = np.abs(a["dispGeneEst"][conv] / b["dispGeneEst"][conv] - 1.0)
    assert 0 < rel.max() and np.median(rel) < 0.01
