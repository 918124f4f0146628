"""lfc_shrink in the port against the JAX package's lfc_shrink on the same
fits: type="apeglm" (coef by name and 1-based, svalue, lfc_threshold),
type="ashr", type="normal" through its device arm (without and with
replaced rows; the JAX side forced onto its device arm with
DESEQ2_TPU_ENGINE=fused, as tests/test_shrink.py does), the argument errors
of tests/test_shrink.py.  The normal-shrink cases the JAX package sends
to its host Wald test run the port's host engine
(tests/test_torch_host.py:test_normal_host_cases_match_jax).

float64 on the CPU on both sides; tolerance rtol 1e-6, atol 1e-9 with equal
NaN patterns, as in tests/test_fused_exact.py.
"""

import numpy as np
import pytest

import deseq2_tpu as jdt
import deseq2_tpu_torch as tdt
from deseq2_tpu.shrink import lfc_shrink as jshrink

COLS = ("baseMean", "log2FoldChange", "lfcSE", "stat", "pvalue", "padj")


def _cmp(a, b, name, rtol=1e-6, atol=1e-9):
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    assert np.array_equal(np.isnan(a), np.isnan(b)), \
        f"{name}: NaN pattern differs"
    m = ~np.isnan(a)
    np.testing.assert_allclose(a[m], b[m], rtol=rtol, atol=atol,
                               err_msg=name)


def _same(tr, jr, cols):
    for col in cols:
        if jr[col] is None:
            assert tr[col] is None, col
        else:
            _cmp(tr[col], jr[col], col)
    assert tr.descriptions == jr.descriptions


def _pair_fit(n=300, m=12, seed=42, levels=None, counts_fn=None):
    j = jdt.make_example_dataset(n=n, m=m, beta_sd=1.0, seed=seed)
    if levels is None:
        cond = j.col_data["condition"]
        lab = np.asarray(cond.levels)[cond.codes]
    else:
        lab = np.repeat(levels, m // len(levels))
        j.col_data["condition"] = jdt.Factor(lab, levels=list(levels))
    counts = np.asarray(j.counts).copy()
    if counts_fn is not None:
        counts_fn(counts)
        j.counts[:] = counts
    t = tdt.dataset_from_arrays(counts, {"condition": lab}, "~ condition")
    return jdt.deseq(j, engine="fused"), tdt.deseq(t, device="cpu")


@pytest.fixture(scope="module")
def fits():
    """tests/test_shrink.py's fixture."""
    return _pair_fit()


@pytest.mark.parametrize("kw", [dict(coef="condition_B_vs_A"),
                                dict(coef=2),
                                dict(coef=2, svalue=True),
                                dict(coef=2, lfc_threshold=0.5)],
                         ids=["name", "one_based", "svalue", "threshold"])
def test_apeglm_matches_jax(fits, kw):
    """The damped Newton's posterior mode and SD (float64, 50 steps), the
    prior scale from the results table, the s-values and the FSOS
    s-values under lfc_threshold."""
    jf, tf = fits
    jr = jshrink(jf, type="apeglm", **kw)
    tr = tdt.lfc_shrink(tf, type="apeglm", **kw)
    _same(tr, jr, COLS + ("svalue",))
    assert tr.prior_info["prior_scale"] == pytest.approx(
        jr.prior_info["prior_scale"], rel=1e-12)


def test_apeglm_return_fit_matches_jax(fits):
    jf, tf = fits
    _, jfit = jshrink(jf, coef=2, type="apeglm", return_fit=True)
    _, tfit = tdt.lfc_shrink(tf, coef=2, type="apeglm", return_fit=True)
    _cmp(tfit["map"], jfit["map"], "map")
    _cmp(tfit["sd"], jfit["sd"], "sd")


@pytest.mark.parametrize("kw", [dict(coef="condition_B_vs_A"),
                                dict(coef=2, svalue=True),
                                dict(contrast=("condition", "A", "B")),
                                dict(coef=2, lfc_threshold=0.5)],
                         ids=["coef", "svalue", "contrast", "threshold"])
def test_ashr_matches_jax(fits, kw):
    """The mixture's EM (on the fit's device) and its analytic posterior.
    The JAX package's ashr under lfc_threshold needs the threshold as a
    numpy scalar (its cdf_post_mixture calls .astype on x >= 0)."""
    jf, tf = fits
    jkw = dict(kw)
    if "lfc_threshold" in kw:
        jkw["lfc_threshold"] = np.float64(kw["lfc_threshold"])
    jr = jshrink(jf, type="ashr", **jkw)
    tr = tdt.lfc_shrink(tf, type="ashr", **kw)
    _same(tr, jr, COLS + ("svalue",))
    _cmp(tr.prior_info["fitted_g"]["pi"], jr.prior_info["fitted_g"]["pi"],
         "pi")


def _replaced_counts(counts):
    rng = np.random.default_rng(4)
    for i in rng.choice(counts.shape[0], 6, replace=False):
        counts[i, int(rng.integers(counts.shape[1]))] = \
            int(counts[i].mean() * 40 + 500)


@pytest.mark.parametrize("case", ["two_levels", "replaced_rows",
                                  "three_levels"])
def test_normal_device_arm_matches_jax(monkeypatch, case):
    """type="normal" with a character contrast: the prior variance from the
    stored MLEs, one expanded K1 refit (the plain version here) and the
    contrast sandwich, against the JAX package's device arm; with replaced
    rows (m = 16, tests/test_shrink.py's fixture) the refit reads the
    original counts at the post-replacement dispersions."""
    if case == "two_levels":
        jf, tf = _pair_fit()
        c = ("condition", "B", "A")
    elif case == "replaced_rows":
        jf, tf = _pair_fit(n=250, m=16, seed=9, counts_fn=_replaced_counts)
        assert np.nansum(tf.row_data["replace"]) > 0
        c = ("condition", "B", "A")
    else:
        jf, tf = _pair_fit(n=240, seed=21, levels=("A", "B", "C"))
        c = ("condition", "C", "B")
    monkeypatch.setenv("DESEQ2_TPU_ENGINE", "fused")
    jr = jshrink(jf, contrast=c, type="normal")
    tr = tdt.lfc_shrink(tf, contrast=c, type="normal")
    _same(tr, jr, COLS)
    _cmp(tr.prior_info["betaPriorVar"], jr.prior_info["betaPriorVar"],
         "betaPriorVar")


ERRORS = {
    "unknown_type": dict(coef=2, type="bayes"),
    "coef_zero": dict(coef=0, type="ashr"),
    "apeglm_with_contrast": dict(contrast=("condition", "B", "A"),
                                 type="apeglm"),
    "no_coef_no_contrast": dict(type="normal"),
    "apeglm_without_coef": dict(contrast=None, res="res", type="apeglm"),
    "normal_without_coef": dict(res="res", type="normal"),
}


@pytest.mark.parametrize("which", sorted(ERRORS))
def test_errors_match_jax(fits, which):
    """The argument errors of tests/test_shrink.py, with the JAX
    package's messages."""
    jf, tf = fits
    kw = dict(ERRORS[which])
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("res") == "res":
        jkw["res"], tkw["res"] = jdt.results(jf), tdt.results(tf)
    with pytest.raises(ValueError) as ej:
        jshrink(jf, **jkw)
    with pytest.raises(ValueError) as et:
        tdt.lfc_shrink(tf, **tkw)
    assert str(et.value) == str(ej.value)


def test_beta_prior_fit_and_missing_se_raise():
    """lfc_shrink refuses a betaPrior fit and a table without standard
    errors, with the JAX package's messages."""
    j = jdt.make_example_dataset(n=60, m=6, beta_sd=1.0, seed=3)
    cond = j.col_data["condition"]
    t = tdt.dataset_from_arrays(np.asarray(j.counts), {
        "condition": np.asarray(cond.levels)[cond.codes]}, "~ condition")
    jf = jdt.deseq(j, engine="fused", beta_prior=True)
    tf = tdt.deseq(t, device="cpu", beta_prior=True)
    with pytest.raises(ValueError) as ej:
        jshrink(jf, coef=2)
    with pytest.raises(ValueError) as et:
        tdt.lfc_shrink(tf, coef=2)
    assert str(et.value) == str(ej.value)
    jf = jdt.deseq(j, engine="fused")
    tf = tdt.deseq(t, device="cpu")
    jr, tr = jdt.results(jf), tdt.results(tf)
    jr.lfc_se = np.full_like(jr.lfc_se, np.nan)
    tr.lfc_se = np.full_like(tr.lfc_se, np.nan)
    with pytest.raises(ValueError) as ej:
        jshrink(jf, coef=2, res=jr)
    with pytest.raises(ValueError) as et:
        tdt.lfc_shrink(tf, coef=2, res=tr)
    assert str(et.value) == str(ej.value)


