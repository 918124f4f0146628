"""results(contrast=...) in the port against the JAX package: character
contrasts (reference and non-reference levels), list contrasts with
list_values, numeric contrasts, the zero-zero rules, use_t, the LRT with a
contrast, add_mle under betaPrior, every reference ValueError, and the
fused pipeline's numeric-contrast branch.

float64 on the CPU on both sides; the JAX side runs deseq(...,
engine="fused") (its results() then takes getContrast's maxit=0 re-entry)
or fused_results(contrast=...).  Tolerance rtol 1e-6, atol 1e-9 with equal
NaN patterns, as in tests/test_fused_exact.py.
"""

import numpy as np
import pytest
import torch

import deseq2_tpu as jdt
import deseq2_tpu_torch as tdt
from deseq2_tpu.parallel import fused as jfused
from deseq2_tpu_torch.results import DESeqResults, _device_filtering
from deseq2_tpu_torch.parallel import fused as tfused

COLS = ("baseMean", "log2FoldChange", "lfcSE", "stat", "pvalue", "padj")


def _cmp(a, b, name, rtol=1e-6, atol=1e-9):
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    assert np.array_equal(np.isnan(a), np.isnan(b)), \
        f"{name}: NaN pattern differs"
    m = ~np.isnan(a)
    np.testing.assert_allclose(a[m], b[m], rtol=rtol, atol=atol,
                               err_msg=name)


def _pair(n=240, m=12, seed=21, counts_fn=None, sf=None):
    """The JAX and port datasets of the example counts on a three-level
    condition (A, B, C in blocks of m/3)."""
    j = jdt.make_example_dataset(n=n, m=m, beta_sd=1.0, seed=seed)
    lab = np.repeat(["A", "B", "C"], m // 3)
    j.col_data["condition"] = jdt.Factor(lab, levels=["A", "B", "C"])
    counts = np.asarray(j.counts).copy()
    if counts_fn is not None:
        counts_fn(counts)
        j.counts[:] = counts
    t = tdt.dataset_from_arrays(counts, {"condition": lab}, "~ condition")
    if sf is not None:
        j.size_factors = sf
        t.size_factors = sf
    return j, t


def _same_results(tr, jr, cols=COLS):
    for col in cols:
        _cmp(tr[col], jr[col], col)
    assert tr.descriptions == jr.descriptions


@pytest.fixture(scope="module")
def fits():
    j, t = _pair()
    return jdt.deseq(j, engine="fused"), tdt.deseq(t, device="cpu")


CONTRASTS = {
    "char_vs_ref": ("condition", "B", "A"),
    "char_ref_num": ("condition", "A", "C"),
    "char_nonref": ("condition", "C", "B"),
    "list": [["condition_C_vs_A"], ["condition_B_vs_A"]],
    "list_one_side": [["condition_B_vs_A"]],
    "numeric": np.array([0.0, -1.0, 1.0]),
    "numeric_coef": np.array([0.0, 1.0, 0.0]),
}


@pytest.mark.parametrize("which", sorted(CONTRASTS))
def test_contrast_matches_jax(fits, which):
    jf, tf = fits
    c = CONTRASTS[which]
    _same_results(tdt.results(tf, contrast=c), jdt.results(jf, contrast=c))


@pytest.mark.parametrize("list_values", [(1, -1), (0.5, -0.5), (2, -1)])
def test_list_values_match_jax(fits, list_values):
    jf, tf = fits
    c = [["condition_C_vs_A"], ["condition_B_vs_A"]]
    _same_results(tdt.results(tf, contrast=c, list_values=list_values),
                  jdt.results(jf, contrast=c, list_values=list_values))


def test_contrast_alt_hypothesis_matches_jax(fits):
    """A contrast with lfcThreshold runs the contrast flow, then the
    thresholded test on its LFC and SE."""
    jf, tf = fits
    kw = dict(contrast=("condition", "C", "B"), lfc_threshold=0.5,
              alt_hypothesis="greater")
    _same_results(tdt.results(tf, **kw), jdt.results(jf, **kw))


def _zero_counts(counts):
    counts[5, 4:] = 0        # zero in B and C: C vs B all zero
    counts[6, :8] = 0        # zero in A and B
    counts[9, :] = 0         # an all-zero row stays NaN


@pytest.fixture(scope="module")
def zero_fits():
    j, t = _pair(n=200, seed=22, counts_fn=_zero_counts)
    return jdt.deseq(j, engine="fused"), tdt.deseq(t, device="cpu")


@pytest.mark.parametrize("c", [("condition", "C", "B"),
                               np.array([0.0, -1.0, 1.0]),
                               [["condition_B_vs_A"], []],
                               ("condition", "B", "A")],
                         ids=["char", "numeric", "list", "char_ref"])
def test_zero_zero_rule_matches_jax(zero_fits, c):
    """The character rule (both levels all zero) and the numeric rule
    (contrastAllZeroNumeric) zero the LFC and stat and set p to 1."""
    jf, tf = zero_fits
    tr, jr = tdt.results(tf, contrast=c), jdt.results(jf, contrast=c)
    _same_results(tr, jr)
    assert np.isnan(tr["pvalue"][9])
    if isinstance(c, tuple) and c[1:] == ("C", "B") or \
            isinstance(c, np.ndarray):
        assert tr["log2FoldChange"][5] == 0.0 and tr["pvalue"][5] == 1.0


def test_use_t_with_contrast_matches_jax():
    """use_t: getContrast takes the stored tDegreesFreedom (the fixture of
    test_fused_use_t_with_contrast)."""
    j, t = _pair(n=200, m=9, seed=24)
    jf = jdt.deseq(j, engine="fused", use_t=True)
    tf = tdt.deseq(t, device="cpu", use_t=True)
    for c in (np.array([0.0, -1.0, 1.0]), ("condition", "C", "B")):
        _same_results(tdt.results(tf, contrast=c),
                      jdt.results(jf, contrast=c))


def test_lrt_with_contrast_matches_jax():
    """Under the LRT a contrast sets the LFC and SE, and the stored LRT
    statistic and p-value stand."""
    j, t = _pair(n=200, seed=27, counts_fn=_zero_counts)
    jf = jdt.deseq(j, engine="fused", test="LRT", reduced="~ 1")
    tf = tdt.deseq(t, device="cpu", test="LRT", reduced="~ 1")
    for c in (("condition", "C", "B"), np.array([0.0, -1.0, 1.0]),
              ("condition", "B", "A")):
        tr, jr = tdt.results(tf, contrast=c), jdt.results(jf, contrast=c)
        _same_results(tr, jr)
        _cmp(tr["stat"], np.asarray(tf.row_data["LRTStatistic"]), "LRT")


def test_weights_and_norm_factors_with_contrast_match_jax():
    """getContrast with observation weights (row-max normalized) and with
    gene x sample normalization factors."""
    rng = np.random.default_rng(31)
    w = rng.uniform(0.3, 1.0, (200, 12))
    nf = np.exp(rng.normal(0.0, 0.2, (200, 12)))
    nf /= np.exp(np.log(nf).mean(axis=1))[:, None]
    for prep in ("weights", "nf"):
        j, t = _pair(n=200, seed=32)
        for d in (j, t):
            if prep == "weights":
                d.assays["weights"] = w
            else:
                d.normalization_factors = nf
        jf = jdt.deseq(j, engine="fused")
        tf = tdt.deseq(t, device="cpu")
        for c in (("condition", "C", "B"), np.array([0.0, 1.0, -1.0])):
            _same_results(tdt.results(tf, contrast=c),
                          jdt.results(jf, contrast=c))


def test_add_mle_matches_jax():
    """add_mle under betaPrior: the lfcMLE column from the MLE_ columns,
    zeroed with an all-zero contrast."""
    j, t = _pair(n=200, seed=23, counts_fn=_zero_counts)
    jf = jdt.deseq(j, engine="fused", beta_prior=True)
    tf = tdt.deseq(t, device="cpu", beta_prior=True)
    for c in (("condition", "C", "B"), ("condition", "C", "A"),
              ("condition", "A", "B")):
        tr = tdt.results(tf, contrast=c, add_mle=True)
        jr = jdt.results(jf, contrast=c, add_mle=True)
        _same_results(tr, jr)
        _cmp(tr["lfcMLE"], jr["lfcMLE"], "lfcMLE")
    assert tdt.results(tf, contrast=("condition", "C", "B"),
                       add_mle=True)["lfcMLE"][5] == 0.0


ERRORS = {
    "two_element_character": dict(contrast=("condition", "B")),
    "same_level_twice": dict(contrast=("condition", "B", "B")),
    "all_zero_numeric": dict(contrast=np.zeros(3)),
    "wrong_length": dict(contrast=np.array([0.0, 1.0])),
    "list_not_names": dict(contrast=[["condition_D_vs_A"], []]),
    "list_both_sides": dict(contrast=[["condition_B_vs_A"],
                                      ["condition_B_vs_A"]]),
    "not_a_factor": dict(contrast=("batch", "B", "A")),
    "unknown_level": dict(contrast=("condition", "D", "B")),
    "add_mle_without_prior": dict(contrast=("condition", "B", "A"),
                                  add_mle=True),
}


@pytest.mark.parametrize("which", sorted(ERRORS))
def test_contrast_errors_match_jax(fits, which):
    """Every reference error of checkContrast / cleanContrast, with the JAX
    package's message."""
    jf, tf = fits
    with pytest.raises(ValueError) as ej:
        jdt.results(jf, **ERRORS[which])
    with pytest.raises(ValueError) as et:
        tdt.results(tf, **ERRORS[which])
    assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# the fused pipeline's numeric-contrast branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(reduced="~ 1"),
                                dict(use_t=True)],
                         ids=["wald", "lrt", "use_t"])
def test_fused_results_contrast_matches_jax(kw):
    """fused_results(contrast=c): the sandwich at the final fit, the numeric
    zero-zero rule, and under the LRT only the LFC and SE from it."""
    j, _ = _pair(n=200, seed=22, counts_fn=_zero_counts)
    counts = np.asarray(j.counts)
    x = np.asarray(j.model_matrix()[0])
    c = np.array([0.0, 1.0, -1.0])
    ref = jfused.fused_results(counts, x, None, contrast=c, **kw)
    got = tfused.fused_results(counts, x, None, contrast=c, device="cpu",
                               **kw)
    for col in COLS:
        _cmp(got[col], ref[col], col)
    assert got["log2FoldChange"][5] == 0.0


def test_device_filtering_matches_host(fits):
    """The independent-filtering grid results() runs on the card for a fit
    with 16,384 genes or more equals the host grid (run here on CPU
    tensors)."""
    _, tf = fits
    r = tdt.results(tf, contrast=("condition", "C", "B"))
    dev = _device_filtering(
        DESeqResults(r.base_mean, r.log2_fold_change, r.lfc_se, r.stat,
                     r.pvalue), 0.1, torch.device("cpu"))
    _cmp(dev.padj, r.padj, "padj", rtol=1e-12)
    for k in ("filterTheta", "filterThreshold"):
        assert dev.metadata[k] == pytest.approx(r.metadata[k], rel=1e-12)
