"""The paired design ~ subject + condition, the DESeq2 vignette's design
for paired samples (p = subjects + 1: 10 and 16 here, past the templated
kernels' 8 columns, on the wide kernels on a card), through the public
deseq() + results() on the CPU, the port's fused and host engines against
deseq2_tpu's host engine.

float64 on both sides, counts made with numpy from a seed
(ops/checks.py:paired_gate_counts: samples round-robin over the subjects,
the condition alternating within each subject), at rtol 1e-6 on the genes
whose betaConv is true on both sides (tests/test_torch_host.py's rule).
"""

import numpy as np
import pytest

import deseq2_tpu as jdt
import deseq2_tpu_torch as tdt
from deseq2_tpu_torch.ops import checks

RTOL, ATOL = 1e-6, 1e-9

# the paired fixture: genes x samples, and p -> subjects
PAIRED_SHAPE = (200, 40)
SUBJECTS = {10: 9, 16: 15}
COLS = ("baseMean", "log2FoldChange", "lfcSE", "stat", "pvalue", "padj")
DISP = ("dispGeneEst", "dispFit", "dispersion")
_PAIRED = {}


def _paired(p):
    """deseq2_tpu's host engine and the port's fused and host engines on
    the paired counts, computed once per p."""
    if p not in _PAIRED:
        G, S = PAIRED_SHAPE
        counts, subj, cond = checks.paired_gate_counts(G, S, SUBJECTS[p],
                                                       seed=p)
        cd = {"subject": subj, "condition": cond}
        design = "~ subject + condition"
        jf = jdt.deseq(jdt.DESeqDataSet(counts, dict(cd), design),
                       engine="host")
        runs = {"jax": (jf, jdt.results(jf))}
        for engine in ("fused", "host"):
            tf = tdt.deseq(tdt.dataset_from_arrays(counts, dict(cd), design),
                           engine=engine, device="cpu")
            runs[engine] = (tf, tdt.results(tf))
        _PAIRED[p] = runs
    return _PAIRED[p]


@pytest.mark.parametrize("engine", ["fused", "host"])
@pytest.mark.parametrize("p", [10, 16])
def test_paired_design_matches_jax(p, engine):
    """deseq() + results() on ~ subject + condition, p = 10 and 16, the
    port's fused and host engines on the CPU against deseq2_tpu's host
    engine: the six results columns and the three dispersions at rtol 1e-6
    on the genes whose betaConv is true on both sides."""
    runs = _paired(p)
    (jf, jr), (tf, tr) = runs["jax"], runs[engine]
    assert tf.attrs["engine"] == engine
    assert list(tf.attrs["modelMatrixNames"]) == \
        list(jf.attrs["modelMatrixNames"])
    assert len(tf.attrs["modelMatrixNames"]) == p
    keep = np.asarray(tf.row_data["betaConv"], bool) \
        & np.asarray(jf.row_data["betaConv"], bool)
    assert keep.mean() > 0.95
    for src, cols in (((tr, jr), COLS),
                      ((tf.row_data, jf.row_data), DISP)):
        for c in cols:
            a = np.asarray(src[0][c], float)[keep]
            b = np.asarray(src[1][c], float)[keep]
            assert np.array_equal(np.isnan(a), np.isnan(b)), c
            m = ~np.isnan(b)
            np.testing.assert_allclose(a[m], b[m], rtol=RTOL, atol=ATOL,
                                       err_msg=f"p={p} {engine} {c}")
