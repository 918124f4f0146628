"""betaPrior in the port against the JAX package on the same numpy inputs:
the device weighted quantile (parallel/priordev.py), the copied expanded
model matrices and prior estimator (expanded.py, wald.py), the fused
betaPrior pipeline (the expanded-design K1 refit and its contrast, the
Cook's refit with the saved prior, weights, normalization factors) and the
public deseq(beta_prior=True) + results().

float64 on the CPU on both sides (the port's kernels run their plain
versions); tolerance rtol 1e-6, atol 1e-9 with equal NaN patterns, as in
tests/test_fused_exact.py.  The JAX side runs its fused pipeline on its CPU
backend (fused_wald_pipeline, or deseq(..., engine="fused")).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import deseq2_tpu as jdt
import deseq2_tpu_torch as tdt
from deseq2_tpu import expanded as jexp
from deseq2_tpu import wald as jwald
from deseq2_tpu.parallel import fused as jfused
from deseq2_tpu.parallel import priordev as jprior
from deseq2_tpu_torch import expanded as texp
from deseq2_tpu_torch import wald as twald
from deseq2_tpu_torch.parallel import fused as tfused
from deseq2_tpu_torch.parallel import priordev as tprior
from deseq2_tpu_torch.quantiles import \
    match_weighted_upper_quantile_for_variance
from torch_threads import one_torch_thread  # noqa: F401


def _cmp(a, b, name, rtol=1e-6, atol=1e-9):
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    assert a.shape == b.shape, f"{name}: shape {a.shape} != {b.shape}"
    assert np.array_equal(np.isnan(a), np.isnan(b)), \
        f"{name}: NaN pattern differs"
    m = ~np.isnan(a)
    np.testing.assert_allclose(a[m], b[m], rtol=rtol, atol=atol,
                               err_msg=name)


# ---------------------------------------------------------------------------
# the weighted quantile
# ---------------------------------------------------------------------------

def _quantile_case(case):
    rng = np.random.default_rng(3)
    n = 401
    beta = rng.normal(0.0, 1.5, n)
    w = rng.uniform(0.2, 3.0, n)
    if case == "ties":
        beta = np.round(beta, 1)          # many equal |beta|
        w[::7] = w[1]
    elif case == "zero_weights":
        w[rng.random(n) < 0.3] = 0.0
    elif case == "large_excluded":
        beta[::9] = rng.choice([10.0, -12.5, np.inf, -np.inf, np.nan],
                               len(beta[::9]))
    return beta, w


@pytest.mark.parametrize("case", ["ties", "zero_weights",
                                  "large_excluded"])
def test_weighted_quantile_matches_jax_and_host(case):
    """match_weighted_upper_quantile_var_dev against the JAX device
    version, and against the host Hmisc port on the entries it keeps (w >
    0, finite, |beta| < 10): searchsorted(right=False) picks the same
    step on ties and skips zero weights."""
    beta, w = _quantile_case(case)
    got = float(tprior.match_weighted_upper_quantile_var_dev(
        torch.as_tensor(beta), torch.as_tensor(w)))
    ref = float(jprior.match_weighted_upper_quantile_var_dev(
        jnp.asarray(beta), jnp.asarray(w)))
    _cmp(got, ref, "prior variance", rtol=1e-12)
    keep = np.isfinite(beta) & (np.abs(beta) < 10) & (w > 0)
    host = match_weighted_upper_quantile_for_variance(beta[keep], w[keep])
    _cmp(got, host, "host prior variance", rtol=1e-12)
    # the raw quantile, in float64
    q = tprior.wtd_quantile_dev(torch.as_tensor(np.abs(np.nan_to_num(
        beta, posinf=0.0, neginf=0.0))), torch.as_tensor(
            np.where(keep, w, 0.0)), 0.95)
    qj = jprior.wtd_quantile_dev(jnp.abs(jnp.asarray(np.nan_to_num(
        beta, posinf=0.0, neginf=0.0))), jnp.asarray(np.where(keep, w, 0.0)),
        0.95)
    _cmp(float(q), float(qj), "quantile", rtol=1e-12)


# ---------------------------------------------------------------------------
# expanded matrices, averaged priors, the host prior estimator
# ---------------------------------------------------------------------------

def _design_pair(design, col_data, n=60, seed=4):
    rng = np.random.default_rng(seed)
    S = len(next(iter(col_data.values())))
    counts = rng.poisson(20.0, (n, S))
    jd = jdt.DESeqDataSet(counts, {k: jdt.Factor(v) for k, v in
                                   col_data.items()}, design)
    td = tdt.DESeqDataSet(counts, {k: tdt.Factor(v) for k, v in
                                   col_data.items()}, design)
    return jd, td


DESIGNS = {
    "three_levels": ("~ condition",
                     {"condition": list("AAAABBBBCCCC")}),
    "two_factors": ("~ batch + condition",
                    {"batch": list("xyxyxyxyxyxy"),
                     "condition": list("AAAABBBBCCCC")}),
}


@pytest.mark.parametrize("which", sorted(DESIGNS))
def test_expanded_matrix_and_priors_match_jax(which):
    """make_expanded_model_matrix (columns and make_names output),
    add_all_contrasts and average_priors_over_levels equal the JAX
    package's."""
    jd, td = _design_pair(*DESIGNS[which])
    mj, nj = jexp.make_expanded_model_matrix(jd)
    mt, nt = texp.make_expanded_model_matrix(td)
    assert nt == nj
    np.testing.assert_array_equal(mt, mj)
    rng = np.random.default_rng(1)
    beta = rng.normal(size=(30, len(nj)))
    bj, cj = jexp.add_all_contrasts(jd, beta, nj)
    bt, ct = texp.add_all_contrasts(td, beta, nt)
    assert ct == cj
    np.testing.assert_array_equal(bt, bj)
    pv = rng.uniform(0.5, 2.0, len(cj))
    aj, naj = jexp.average_priors_over_levels(jd, pv, cj)
    at, nat = texp.average_priors_over_levels(td, pv, ct)
    assert nat == naj
    np.testing.assert_array_equal(at, aj)


def test_estimate_beta_prior_var_matches_jax():
    """The copied host estimator (wald.estimate_beta_prior_var) on the same
    MLE_ columns, standard and expanded."""
    jd, td = _design_pair(*DESIGNS["three_levels"], n=200)
    rng = np.random.default_rng(8)
    cols = {"MLE_Intercept": rng.normal(5, 1, 200),
            "MLE_condition_B_vs_A": rng.normal(0, 1, 200),
            "MLE_condition_C_vs_A": rng.normal(0, 0.5, 200)}
    cols["MLE_condition_C_vs_A"][:5] = 15.0     # excluded, |beta| >= 10
    cols["baseMean"] = rng.uniform(1, 500, 200)
    cols["dispFit"] = rng.uniform(0.05, 0.5, 200)
    for d in (jd, td):
        for k, v in cols.items():
            d.set_row_data(k, v, "results", k)
    for mtype in ("standard", "expanded"):
        jd.attrs["modelMatrixType"] = td.attrs["modelMatrixType"] = mtype
        vj, nj = jwald.estimate_beta_prior_var(jd)
        vt, nt = twald.estimate_beta_prior_var(td)
        assert nt == nj
        _cmp(vt, vj, f"betaPriorVar {mtype}", rtol=1e-12)


# ---------------------------------------------------------------------------
# the fused betaPrior pipeline
# ---------------------------------------------------------------------------

def _example(n, m, seed, levels=2):
    """The example dataset's counts, the standard design of a `levels`-level
    factor over equal blocks of samples and its level codes."""
    dds = jdt.make_example_dataset(n=n, m=m, beta_sd=1.0, seed=seed)
    counts = np.asarray(dds.counts).copy()
    codes = np.repeat(np.arange(levels), m // levels)
    x = np.column_stack([np.ones(m)] + [(codes == lv).astype(float)
                                        for lv in range(1, levels)])
    return counts, x, tuple(int(c) for c in codes)


def _prior_case(name):
    """(counts, x, cells, pipeline kwargs) of a betaPrior fixture."""
    if name == "default":
        c, x, cells = _example(300, 12, 17)
        return c, x, cells, {}
    if name == "three_levels_explicit":
        c, x, cells = _example(250, 12, 25, levels=3)
        return c, x, cells, dict(contrast=(0.0, -1.0, 1.0, 0.0))
    if name == "three_levels_default":
        c, x, cells = _example(250, 12, 26, levels=3)
        return c, x, cells, {}
    if name == "outlier_refit":
        # m = 14 (7 per cell): the replacement + refit runs, with the prior
        c, x, cells = _example(300, 14, 7)
        rng = np.random.default_rng(3)
        for i in rng.choice(300, 8, replace=False):
            c[i, int(rng.integers(14))] = int(c[i].mean() * 40 + 500)
        return c, x, cells, {}
    if name == "weights":
        c, x, cells = _example(200, 12, 34, levels=3)
        w = np.random.default_rng(34).uniform(0.4, 1.0, c.shape)
        return c, x, cells, dict(weights=w)
    if name == "norm_factors":
        c, x, cells = _example(200, 12, 35)
        rng = np.random.default_rng(35)
        nf = np.exp(rng.normal(0.0, 0.2, c.shape))
        nf /= np.exp(np.log(nf).mean(axis=1))[:, None]
        return c, x, cells, dict(norm_factors=nf)
    raise KeyError(name)


PRIOR_CASES = ["default", "three_levels_explicit", "three_levels_default",
               "outlier_refit", "weights", "norm_factors"]
PRIOR_KEYS = ("baseMean", "dispersion", "dispMAP", "beta", "betaSE", "stat",
              "pvalue", "betaIter", "deviance", "mleBeta", "betaPriorVar",
              "lfcLast", "seLast", "statLast", "pvalueLast", "padjLast",
              "maxCooks", "replace", "filterNumRej")


@pytest.fixture(scope="module", params=PRIOR_CASES)
def prior_pipelines(request):
    counts, x, cells, kw = _prior_case(request.param)
    S = counts.shape[1]
    grid = np.linspace(np.log(1e-8), np.log(max(10.0, S)), 20)
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    ref = jfused.fused_wald_pipeline(
        jnp.asarray(counts), jnp.asarray(x), jnp.ones(S), jnp.asarray(grid),
        cells=cells, linear_mu="weights" not in kw, beta_prior=True,
        estimate_sf="norm_factors" not in kw, **jkw)
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    got = tfused.fused_wald_pipeline(
        torch.as_tensor(counts), torch.as_tensor(x), None,
        torch.as_tensor(grid), cells=cells, linear_mu=True,
        beta_prior=True, **tkw)
    return request.param, got, {k: np.asarray(v) for k, v in ref.items()}


def test_prior_pipeline_keys_match(prior_pipelines):
    _, got, ref = prior_pipelines
    assert set(got) == set(ref)


@pytest.mark.parametrize("key", PRIOR_KEYS)
def test_prior_pipeline_columns_match(prior_pipelines, key):
    """Every output the betaPrior branch writes or overwrites: the expanded
    MAP betas, their SEs and Wald columns, the contrast's LFC/SE/stat/p and
    padj, the prior variance, the MLE betas and the Cook's columns."""
    name, got, ref = prior_pipelines
    if name == "outlier_refit":
        assert np.asarray(ref["replace"]).any()
    _cmp(got[key].cpu().numpy(), ref[key], f"{name} {key}")


# ---------------------------------------------------------------------------
# the public entry points
# ---------------------------------------------------------------------------

def _public_pair(n, m, seed, levels=3):
    j = jdt.make_example_dataset(n=n, m=m, beta_sd=1.0, seed=seed)
    lv = ["A", "B", "C"][:levels]
    lab = np.repeat(lv, m // levels)
    j.col_data["condition"] = jdt.Factor(lab, levels=lv)
    t = tdt.dataset_from_arrays(np.asarray(j.counts), {"condition": lab},
                                "~ condition")
    return j, t


@pytest.fixture(scope="module")
def public_prior():
    j, t = _public_pair(240, 12, 51)
    jf = jdt.deseq(j, beta_prior=True, engine="fused")
    tf = tdt.deseq(t, beta_prior=True, device="cpu")
    return jf, tf


def test_public_beta_prior_contract(public_prior):
    """The stored contract: the expanded model matrix and its names,
    betaPriorVar, the MAP/MLE descriptions, the MLE_ columns."""
    jf, tf = public_prior
    assert tf.results_names() == jf.results_names() == \
        ["Intercept", "conditionA", "conditionB", "conditionC"]
    for k in ("modelMatrixNames", "modelMatrixType", "betaPrior"):
        assert tf.attrs[k] == jf.attrs[k], k
    np.testing.assert_array_equal(tf.attrs["modelMatrix"],
                                  jf.attrs["modelMatrix"])
    _cmp(tf.attrs["betaPriorVar"], jf.attrs["betaPriorVar"], "betaPriorVar")
    for k, meta in jf.row_meta.items():
        if k in ("trueIntercept", "trueBeta", "trueDisp", "dispGeneIter"):
            continue
        assert tf.row_meta[k] == meta, k
        _cmp(tf.row_data[k], jf.row_data[k], k)
    assert [k for k in tf.row_data if k.startswith("MLE_")] == \
        ["MLE_Intercept", "MLE_condition_B_vs_A", "MLE_condition_C_vs_A"]


@pytest.mark.parametrize("contrast", [None, ("condition", "C", "A"),
                                      ("condition", "B", "A"),
                                      ("condition", "C", "B")],
                         ids=["default", "C_A", "B_A", "C_B"])
def test_public_beta_prior_results_match(public_prior, contrast):
    """results() under betaPrior: the default (last level vs first, from the
    device tail), the same contrast named, and the getContrast ones."""
    jf, tf = public_prior
    kw = {} if contrast is None else dict(contrast=contrast)
    jr, tr = jdt.results(jf, **kw), tdt.results(tf, **kw)
    for col in ("baseMean", "log2FoldChange", "lfcSE", "stat", "pvalue",
                "padj"):
        _cmp(tr[col], jr[col], col)
    assert tr.descriptions == jr.descriptions
    _cmp(tr.prior_info["betaPriorVar"], jr.prior_info["betaPriorVar"],
         "prior_info")
    assert tr.metadata["filterTheta"] == pytest.approx(
        jr.metadata["filterTheta"], rel=1e-12)


def test_public_beta_prior_two_levels_matches_fused_results():
    """deseq(beta_prior=True) + results() on the two-level example equals
    the JAX fused_results (test_beta_prior_fused_matches_host's fixture)."""
    j = jdt.make_example_dataset(n=300, m=12, beta_sd=1.0, seed=17)
    cond = j.col_data["condition"]
    lab = np.asarray(cond.levels)[cond.codes]
    t = tdt.dataset_from_arrays(np.asarray(j.counts), {"condition": lab},
                                "~ condition")
    res = tdt.results(tdt.deseq(t, beta_prior=True, device="cpu"))
    x_std, _ = j.model_matrix()
    ref = jfused.fused_results(np.asarray(j.counts), x_std, None,
                               two_group=True, beta_prior=True)
    for col in ("baseMean", "log2FoldChange", "lfcSE", "stat", "pvalue",
                "padj"):
        _cmp(res[col], ref[col], col)


def test_beta_prior_reference_errors():
    """The reference errors stay: the LRT with betaPrior, and betaPrior with
    a user model matrix (same messages as the JAX package)."""
    j, t = _public_pair(40, 6, 5)
    x = np.asarray(t.model_matrix()[0])
    for kw in (dict(test="LRT", reduced="~ 1", beta_prior=True),
               dict(full=x, beta_prior=True)):
        with pytest.raises(ValueError) as ej:
            jdt.deseq(j, engine="fused", **kw)
        with pytest.raises(ValueError) as et:
            tdt.deseq(t, device="cpu", **kw)
        assert str(et.value) == str(ej.value)


def test_float32_map_betas_follow_float64():
    """In float32 the expanded design's null direction n = (1, -1, -1, -1)
    is held only by the ridge, and rounding moves an IRLS fit along it by
    up to ~0.07 natural-log units at S = 1,024; prior_fit projects the
    betas back onto n'R b = 0, which every IRLS step satisfies exactly.
    So the float32 MAP betas of the port's pipeline follow its float64
    ones (bench.py's float32 gate bound on |dLFC|, 0.01, over every
    coefficient, log2 scale)."""
    rng = np.random.default_rng(0)
    S, G = 512, 300
    codes = np.repeat([0, 1, 2], [256, 128, 128])
    x = np.column_stack([np.ones(S), codes == 1, codes == 2]).astype(float)
    mu = 2.0 ** rng.normal(4.0, 2.0, G)[:, None] * 2.0 ** (
        rng.normal(0.0, 1.0, (G, 3))[:, codes])
    disp = 4.0 / mu.mean(axis=1, keepdims=True) + 0.1
    counts = rng.negative_binomial(1.0 / disp, 1.0 / (1.0 + disp * mu))
    grid = np.linspace(np.log(1e-8), np.log(S), 20)
    out = {dt: tfused.fused_wald_pipeline(
        torch.as_tensor(counts), torch.as_tensor(x), torch.ones(S),
        torch.as_tensor(grid), cells=tuple(int(c) for c in codes),
        beta_prior=True, dtype=dt) for dt in (torch.float32, torch.float64)}
    b32 = out[torch.float32]["beta"].double()
    b64 = out[torch.float64]["beta"]
    assert (b32 - b64).abs().nan_to_num().max().item() < 0.01
