"""The port's streamed single-cell path against the JAX package's where
the searches' and the IRLS's straggler caps fire, and the port against
itself over chunk widths: tests/test_torch_sc.py's comparisons (its
tolerance and floor rule), in a file of their own so that the suite's
workers take them apart from the rest of that file.
"""

import numpy as np
import pytest

from deseq2_tpu.parallel import sc as jsc
from deseq2_tpu_torch.ops import checks
from deseq2_tpu_torch.parallel import sc as tsc
from test_torch_sc import CPU, _cmp_disp, _cmp_outputs, _nf
from torch_threads import one_torch_thread  # noqa: F401


# ---------------------------------------------------------------------------
# the straggler cascade, chunk widths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["group", "covariate_nf"])
def test_straggler_cascade_matches_jax(case):
    """Gene counts at which the searches' and the IRLS's cascades of
    straggler caps fire (G = 6,000: caps 1,024 and 512; G = 1,200: 512),
    so the late iterations run on blocks of their gathered rows: every
    column against the JAX package's.  The group case is tests/test_sc.py:
    test_sc_mixed_dense_budget_exact's counts (three groups); the
    covariate case adds (G,S) normalization factors.

    Iteration counts are equal but for a few group genes whose line search
    ends on a step gaining within rounding of its 1e-6 tolerance, so that
    rounding decides the count: the chunk width alone moves it in either
    package.  On one x86 CPU four genes differed at the default chunk (one
    chunk of 200 samples); their JAX / port counts at chunks of 7, 64 and
    200: gene 2773 12 / 18 / 14 and 12 / 12 / 12, gene 4119 12 / 12 / 13
    and 12 / 12 / 12, gene 4558 12 / 13 / 12 and 13 / 12 / 14, gene 5644
    13 / 17 / 13 and 13 / 12 / 12; their estimates agreed to 8.1e-9,
    2.8e-8, 7.4e-9 and 2.3e-8 relative.  The JAX package's own count is
    not steady from run to run: gene 5644 read 13 there at the default
    chunk, and 17 / 17 / 13 at chunks of 200 / 64 / 7 in another run,
    where the port read 12 / 12 / 13.  So a gene may
    differ only where its count also moves between the default chunk and
    chunks of 64 or 7 in one of the packages, at most 0.1% of the genes
    may, and their estimates are held to the tolerance every other gene
    meets (_cmp_disp)."""
    if case == "group":
        rng = np.random.default_rng(11)
        G, S = 6000, 200
        counts = rng.negative_binomial(2, 0.3, size=(G, S)).astype(np.int64)
        kw = dict(cells=rng.integers(0, 3, S).astype(np.int32), n_groups=3,
                  size_factors=np.ones(S))
    else:
        rng = np.random.default_rng(4)
        G, S = 1200, 30
        counts = rng.negative_binomial(2, 0.3, size=(G, S)).astype(np.int32)
        x = np.column_stack([np.ones(S), np.arange(S) % 2,
                             (np.arange(S) // 2) % 2])
        kw = dict(design=x, norm_factors=_nf((G, S)),
                  size_factors=np.ones(S), test="LRT",
                  reduced_design=x[:, :2], fit_type="glmGamPoi")
    assert tsc._caps(G, (2, 8, 32), 512)
    j = jsc.fused_sc_results(counts, **kw)
    o = tsc.fused_sc_results(counts, **kw, **CPU)
    assert set(o) == set(j)
    it_o, it_j = o.pop("dispGeneIter"), np.asarray(j.pop("dispGeneIter"))
    _cmp_outputs(o, j)
    off = np.where(it_o != it_j)[0]
    if case == "group":
        moved = np.zeros(G, bool)
        for chunk in (64, 7):
            moved |= np.asarray(jsc.fused_sc_results(
                counts, chunk=chunk, **kw)["dispGeneIter"]) != it_j
            moved |= tsc.fused_sc_results(
                counts, chunk=chunk, **kw, **CPU)["dispGeneIter"] != it_o
        assert moved[off].all(), off[~moved[off]]
        assert len(off) <= G // 1000, off
    else:
        assert list(off) == [], off
    _cmp_disp(o["dispGeneEst"][off], np.asarray(j["dispGeneEst"])[off],
              "dispGeneEst")


def test_chunk_widths_agree():
    """Chunks of 7, 64 and S samples (a ragged last chunk, several chunks,
    one) change only the summation order: 1e-10 in float64, on the group
    QL path and on the histogram path."""
    counts, cells, sf = checks.sc_gate_inputs(300, 130, seed=5)
    for use_hist in (None, True):
        outs = [tsc.fused_sc_results(counts, cells, sf, n_groups=2,
                                     test="LRT", fit_type="glmGamPoi",
                                     chunk=ck, use_hist=use_hist, **CPU)
                for ck in (7, 64, 130)]
        for k in ("dispGeneEst", "dispersion", "log2FoldChange",
                  "LRTStatistic", "pvalue", "padj"):
            for o in outs[1:]:
                np.testing.assert_allclose(o[k], outs[0][k], rtol=1e-10,
                                           atol=1e-12, err_msg=k)
