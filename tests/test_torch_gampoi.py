"""The port's glmGamPoi path against the JAX package's, on the same numpy
inputs, in float64 on the CPU: the copied gampoi.py functions, deseq(
fit_type="glmGamPoi") through "auto" (the streamed single-cell route,
engine "fused-sc") and through engine="host" (the QL shrinkage and the
quasi-likelihood F-test, K1 at minmu = 1e-6), with results(); the routing
reasons of the JAX package's fused_ineligibility, word for word; a
glmGamPoi fit moving through io both ways; and the plain K1 at minmu =
1e-6 against the Pallas kernel in interpret mode.

Tolerance: rtol 1e-6, atol 1e-9, equal NaN patterns; gene-wise estimates
at the 1e-8 floor by tests/test_torch_host.py:cmp_disp's rule (both within
10 x minDisp), and their iteration counts not compared.
"""

import numpy as np
import pytest
import torch

import deseq2_tpu as jdt
import deseq2_tpu_torch as tdt
from deseq2_tpu import gampoi as jg
from deseq2_tpu_torch import gampoi as tg
from torch_threads import one_torch_thread  # noqa: F401

FLOOR = 1e-7
CPU = dict(device="cpu")


def _cmp(got, want, name, rtol=1e-6, atol=1e-9, skip=None):
    got = np.asarray(got, dtype=float)
    want = np.asarray(want, dtype=float)
    assert np.array_equal(np.isnan(got), np.isnan(want)), name
    m = ~np.isnan(want)
    if skip is not None:
        m &= ~skip
    np.testing.assert_allclose(got[m], want[m], rtol=rtol, atol=atol,
                               err_msg=name)


# ---------------------------------------------------------------------------
# gampoi.py
# ---------------------------------------------------------------------------

def _xy(n, seed=0):
    rng = np.random.default_rng(seed)
    x = np.exp(rng.normal(0, 2, n))
    y = np.exp(rng.normal(-1, 1, n))
    y[::7] = y[3]            # ties
    return x, y


@pytest.mark.parametrize("n", [50, 4096, 5000])
@pytest.mark.parametrize("weighted", [True, False])
def test_loc_median_fit_matches_jax(n, weighted):
    x, y = _xy(n)
    np.testing.assert_array_equal(tg.loc_median_fit(x, y, weighted=weighted),
                                  jg.loc_median_fit(x, y, weighted=weighted))


def test_sliding_median_vec_matches_jax():
    _, y = _xy(6000, 1)
    for npoints in (2, 600, 6000):
        args = (y, len(y), npoints, npoints // 2, True)
        np.testing.assert_array_equal(tg._sliding_median_vec(*args),
                                      jg._sliding_median_vec(*args))


def test_closest_index_fn_matches_jax():
    x, y = _xy(300, 2)
    q = np.concatenate([x[:50], [0.0, 1e-9, 1e9], x[:20] * 1.0001])
    np.testing.assert_array_equal(tg.make_closest_index_disp_fn(x, y)(q),
                                  jg.make_closest_index_disp_fn(x, y)(q))


@pytest.mark.parametrize("v", [0.05, 0.5, 2.0, 10.0, 100.0])
def test_trigamma_inverse_matches_jax(v):
    assert tg.trigamma_inverse(v) == jg.trigamma_inverse(v)


@pytest.mark.parametrize("trend", [False, True])
def test_fit_f_dist_and_squeeze_var_match_jax(trend):
    rng = np.random.default_rng(3)
    s2 = rng.chisquare(8, 500) / 8 * np.exp(rng.normal(0, 0.3, 500))
    s2[:3] = [0.0, np.nan, np.inf]
    t = np.exp(rng.normal(0, 0.1, 500)) if trend else None
    s20, df0 = tg.fit_f_dist(s2, 8, t)
    s20j, df0j = jg.fit_f_dist(s2, 8, t)
    assert df0 == df0j
    np.testing.assert_array_equal(s20, s20j)
    np.testing.assert_array_equal(tg.squeeze_var(s2, 8, s20, df0),
                                  jg.squeeze_var(s2, 8, s20j, df0j))
    np.testing.assert_array_equal(tg.squeeze_var(s2, 8, s20, np.inf),
                                  jg.squeeze_var(s2, 8, s20j, np.inf))


def test_overdispersion_shrinkage_and_ql_to_nb_alpha_match_jax():
    rng = np.random.default_rng(4)
    m = np.exp(rng.normal(0, 2, 800))
    trend = 0.1 + 4.0 / m
    est = trend * np.exp(rng.normal(0, 0.5, 800))
    a = tg.overdispersion_shrinkage(est, m, 30, trend)
    b = jg.overdispersion_shrinkage(est, m, 30, trend)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_array_equal(
        tg.ql_to_nb_alpha(a["ql_disp_shrunken"], m, trend, 1e-8, 30.0),
        jg.ql_to_nb_alpha(b["ql_disp_shrunken"], m, trend, 1e-8, 30.0))


@pytest.mark.parametrize("df0", [12.5, np.inf])
def test_ql_f_test_matches_jax(df0):
    rng = np.random.default_rng(5)
    llf = -rng.random(200) * 100
    llr = llf - rng.chisquare(1, 200) / 2
    llr[:5] = llf[:5] + 0.1               # negative deviance drop
    ql = np.exp(rng.normal(0, 0.2, 200))
    for a, b in zip(tg.ql_f_test(llf, llr, 1, ql, df0, 18),
                    jg.ql_f_test(llf, llr, 1, ql, df0, 18)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# deseq(fit_type="glmGamPoi") + results()
# ---------------------------------------------------------------------------

def _labels(f):
    return np.asarray(f.levels)[f.codes]


def _pair(n, m, seed, batch=False, nf=False):
    """The JAX package's example dataset and its twin in the port (same
    counts and column data), optionally ~ batch + condition and (G,S)
    normalization factors."""
    j = jdt.make_example_dataset(n=n, m=m, beta_sd=1.0, seed=seed)
    cd = {"condition": _labels(j.col_data["condition"])}
    design = "~ condition"
    if batch:
        cd["batch"] = np.array(["X", "Y"])[np.arange(m) % 2]
        j.col_data["batch"] = jdt.Factor(cd["batch"])
        design = "~ batch + condition"
        j.design = jdt.parse_formula(design)
    t = tdt.dataset_from_matrix(np.asarray(j.counts), cd, design)
    if nf:
        rng = np.random.default_rng(6)
        f = np.exp(rng.normal(0, 0.2, j.counts.shape))
        f /= np.exp(np.mean(np.log(f), axis=1))[:, None]
        j.normalization_factors = f
        t.normalization_factors = f
    return j, t


def _cmp_fits(tf, jf, tr, jr):
    """Every row_data column the JAX fit has (but its simulation truth),
    their descriptions, the attrs, and the results table."""
    keys = [k for k in jf.row_data if not k.startswith("true")]
    assert set(keys) <= set(tf.row_data)
    dge_t = np.asarray(tf.row_data["dispGeneEst"], float)
    dge_j = np.asarray(jf.row_data["dispGeneEst"], float)
    floor = (dge_t <= FLOOR) | (dge_j <= FLOOR)
    for k in keys:
        assert tf.row_meta[k] == jf.row_meta[k], k
        if k == "dispGeneEst":
            off = ~np.isclose(dge_t, dge_j, rtol=1e-6, atol=0.0) \
                & ~np.isnan(dge_j)
            assert np.all(floor[off]), np.where(off)[0]
        elif k == "dispGeneIter":
            _cmp(tf.row_data[k], jf.row_data[k], k, skip=floor)
        else:
            _cmp(tf.row_data[k], jf.row_data[k], k)
    for k in ("quasiLikelihood_df0",):
        assert tf.attrs[k] == pytest.approx(jf.attrs[k], rel=1e-9)
    for k in ("modelMatrix", "reducedModelMatrix", "betaPriorVar"):
        np.testing.assert_array_equal(tf.attrs[k], jf.attrs[k])
    assert tf.attrs["modelMatrixNames"] == jf.attrs["modelMatrixNames"]
    assert tf.attrs["test"] == jf.attrs["test"] == "LRT"
    assert tf.dispersion_function.fit_type == "glmGamPoi"
    m = np.asarray(jf.row_data["baseMean"], float)
    m = m[np.isfinite(m) & (m > 0)]
    np.testing.assert_allclose(tf.dispersion_function(m),
                               jf.dispersion_function(m), rtol=1e-6)
    for c in jr.column_names:
        _cmp(tr[c], jr[c], f"results {c}")


CASES = {
    # name: (dataset, deseq keyword arguments)
    "group": (dict(n=300, m=20, seed=31), dict(reduced="~ 1")),
    "covariate": (dict(n=250, m=20, seed=17, batch=True),
                  dict(reduced="~ batch")),
    "covariate_nf": (dict(n=220, m=20, seed=19, batch=True, nf=True),
                     dict(reduced="~ batch")),
}


@pytest.mark.parametrize("engine", ["auto", "host"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_glmgampoi_deseq_matches_jax(case, engine):
    """"auto" takes the streamed route (fused-sc) and is held to the JAX
    package's engine="fused"; engine="host" to its host engine."""
    data, kw = CASES[case]
    j, t = _pair(**data)
    jf = jdt.deseq(j, test="LRT", fit_type="glmGamPoi",
                   engine="fused" if engine == "auto" else "host", **kw)
    tf = tdt.deseq(t, test="LRT", fit_type="glmGamPoi",
                   engine=None if engine == "auto" else "host", **kw, **CPU)
    assert tf.attrs["engine"] == ("fused-sc" if engine == "auto"
                                  else "host")
    if engine == "auto":
        assert jf.attrs["engine"] == "fused-sc"
    _cmp_fits(tf, jf, tdt.results(tf), jdt.results(jf))


@pytest.mark.parametrize("case", ["wald", "group_nf"])
def test_glmgampoi_auto_host_cases_match_jax(case):
    """What "auto" sends to the host engine: the Wald test, and a group
    design with normalization factors."""
    if case == "wald":
        j, t = _pair(200, 12, 7)
        kw = dict(test="Wald")
    else:
        j, t = _pair(200, 12, 7, nf=True)
        kw = dict(test="LRT", reduced="~ 1")
    jf = jdt.deseq(j, fit_type="glmGamPoi", engine="host", **kw)
    tf = tdt.deseq(t, fit_type="glmGamPoi", **kw, **CPU)
    assert tf.attrs["engine"] == "host"
    tr, jr = tdt.results(tf), jdt.results(jf)
    for k in ("dispGeneEst", "dispFit", "dispersion", "qlDispMAP",
              "dispFitQLCorrected"):
        dge = np.asarray(jf.row_data["dispGeneEst"], float)
        _cmp(tf.row_data[k], jf.row_data[k], k,
             skip=dge <= FLOOR if k == "dispGeneEst" else None)
    for c in jr.column_names:
        _cmp(tr[c], jr[c], f"results {c}")


def test_glmgampoi_stages_host_engine():
    """The exported stages: estimate_dispersions(fit_type="glmGamPoi")
    then nbinom_lrt(type="glmGamPoi"), against the JAX package's."""
    j, t = _pair(200, 12, 3)
    jd = jdt.estimate_dispersions(jdt.estimate_size_factors(j),
                                  fit_type="glmGamPoi")
    td = tdt.estimate_dispersions(tdt.estimate_size_factors(t, **CPU),
                                  fit_type="glmGamPoi", **CPU)
    for k in ("qlDispMLE", "qlDispFit", "qlDispMAP", "dispFitQLCorrected",
              "dispersion", "dispMAP", "dispIter"):
        _cmp(td.row_data[k], jd.row_data[k], k)
    jl = jdt.nbinom_lrt(jd, reduced="~ 1", type="glmGamPoi")
    tl = tdt.nbinom_lrt(td, reduced="~ 1", type="glmGamPoi", **CPU)
    for k in ("LRTStatistic", "LRTPvalue", "deviance", "condition_B_vs_A"):
        _cmp(tl.row_data[k], jl.row_data[k], k)
    with pytest.raises(ValueError, match="requires first calling"):
        tdt.nbinom_lrt(tdt.estimate_dispersions(
            tdt.estimate_size_factors(t, **CPU), **CPU), reduced="~ 1",
            type="glmGamPoi", **CPU)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def _reason_cases():
    def ds(pkg, design="~ condition", batch=False, m=12):
        j = jdt.make_example_dataset(n=60, m=m, seed=2)
        cd = {"condition": _labels(j.col_data["condition"])}
        if batch:
            cd["batch"] = np.array(["X", "Y"])[np.arange(m) % 2]
        return pkg.dataset_from_matrix(np.asarray(j.counts), cd, design)

    def weights(pkg):
        d = ds(pkg)
        d.assays["weights"] = np.ones(d.counts.shape)
        return d

    def nf(pkg):
        d = ds(pkg)
        d.normalization_factors = np.ones(d.counts.shape)
        return d

    def matrix(pkg):
        d = ds(pkg)
        d.design = np.asarray(d.model_matrix()[0])
        return d

    return {
        "eligible": (lambda p: ds(p), {}),
        "eligible_covariate": (lambda p: ds(p, "~ batch + condition", True),
                               {}),
        "wald": (lambda p: ds(p), dict(test="Wald")),
        "weights": (weights, {}),
        "group_nf": (nf, {}),
        "user_matrix": (matrix, {}),
        "minmu": (lambda p: ds(p), dict(minmu=0.5)),
        "cell_means": (lambda p: ds(p, "~ 0 + condition"), {}),
        "no_df": (lambda p: ds(p, m=2), {}),
    }


@pytest.mark.parametrize("case", sorted(_reason_cases()))
def test_routing_reasons_match_jax(case):
    """engine.py:251-274's glmGamPoi rules: the same reason (or None) in
    both packages, word for word."""
    from deseq2_tpu.engine import fused_ineligibility as jfi
    from deseq2_tpu_torch.engine import fused_ineligibility as tfi
    make, kw = _reason_cases()[case]
    test = kw.get("test", "LRT")
    minmu = kw.get("minmu", 1e-6)
    jd, td = make(jdt), make(tdt)
    want = jfi(jd, test, "glmGamPoi", "ratio", False, None, None, minmu,
               None)
    got = tfi(td, "ratio", None, minmu, None, test=test,
              fit_type="glmGamPoi")
    assert got == want
    assert (got is None) == case.startswith("eligible")


def test_fused_engine_refusal_as_jax():
    """engine="fused" on a configuration the streamed route does not take
    raises the JAX package's ValueError."""
    j, t = _pair(100, 10, 3, nf=True)
    with pytest.raises(ValueError, match="group design with normal"):
        jdt.deseq(j, test="LRT", reduced="~ 1", fit_type="glmGamPoi",
                  engine="fused")
    with pytest.raises(ValueError, match="group design with normal"):
        tdt.deseq(t, test="LRT", reduced="~ 1", fit_type="glmGamPoi",
                  engine="fused", **CPU)


def test_weights_raise_as_jax():
    j, t = _pair(100, 10, 3)
    j.assays["weights"] = np.ones(j.counts.shape)
    t.assays["weights"] = np.ones(t.counts.shape)
    with pytest.raises(ValueError, match="cannot handle weights"):
        jdt.deseq(j, test="LRT", reduced="~ 1", fit_type="glmGamPoi")
    with pytest.raises(ValueError, match="cannot handle weights"):
        tdt.deseq(t, test="LRT", reduced="~ 1", fit_type="glmGamPoi", **CPU)


@pytest.mark.parametrize("engine", ["auto", "host"])
def test_glmgampoi_deseq_on_mesh_matches_single_and_jax(engine):
    """The public glmGamPoi LRT over an 8-shard gene mesh of CPU devices
    (tests/test_torch_sharding.py) at 300 genes, which 8 does not divide:
    the streamed route ("auto": every block streams its rows) and the
    host engine (its K1/K2/K3 calls sharded) give the single-device fit's
    columns and results at rtol 1e-8 (atol 1e-10), and the JAX package's
    by _cmp_fits."""
    from deseq2_tpu_torch.parallel import gene_mesh
    data, kw = CASES["group"]
    j, t = _pair(**data)
    assert t.n_genes % 8
    run = dict(test="LRT", fit_type="glmGamPoi",
               engine=None if engine == "auto" else "host", **kw, **CPU)
    tf = tdt.deseq(t, mesh=gene_mesh(devices=["cpu"] * 8), **run)
    one = tdt.deseq(t, **run)
    assert tf.attrs["engine"] == one.attrs["engine"] == (
        "fused-sc" if engine == "auto" else "host")
    for k in one.row_data:
        np.testing.assert_allclose(
            np.asarray(tf.row_data[k], float),
            np.asarray(one.row_data[k], float), rtol=1e-8, atol=1e-10,
            equal_nan=True, err_msg=k)
    tr, r1 = tdt.results(tf), tdt.results(one)
    for c in r1.column_names:
        np.testing.assert_allclose(np.asarray(tr[c], float),
                                   np.asarray(r1[c], float), rtol=1e-8,
                                   atol=1e-10, equal_nan=True, err_msg=c)
    jf = jdt.deseq(j, test="LRT", fit_type="glmGamPoi",
                   engine="fused" if engine == "auto" else "host", **kw)
    _cmp_fits(tf, jf, tr, jdt.results(jf))


# ---------------------------------------------------------------------------
# io, and K1 at minmu = 1e-6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_glmgampoi_fit_moves_through_io(tmp_path, writer):
    j, t = _pair(150, 12, 5)
    jf = jdt.deseq(j, test="LRT", reduced="~ 1", fit_type="glmGamPoi",
                   engine="fused")
    tf = tdt.deseq(t, test="LRT", reduced="~ 1", fit_type="glmGamPoi",
                   **CPU)
    src, dst = (jdt, tdt) if writer == "jax" else (tdt, jdt)
    fit = jf if writer == "jax" else tf
    path = tmp_path / "ql.npz"
    src.save_dataset(fit, path)
    back = dst.load_dataset(path)
    for k in fit.row_data:
        np.testing.assert_array_equal(np.asarray(back.row_data[k], float),
                                      np.asarray(fit.row_data[k], float),
                                      err_msg=k)
    assert back.attrs["quasiLikelihood_df0"] == \
        fit.attrs["quasiLikelihood_df0"]
    assert back.attrs["engine"] == "fused-sc"
    assert back.dispersion_function.fit_type == "glmGamPoi"
    for c in ("log2FoldChange", "pvalue", "padj"):
        np.testing.assert_array_equal(np.asarray(dst.results(back)[c]),
                                      np.asarray(src.results(fit)[c]),
                                      err_msg=c)


@pytest.mark.parametrize("p", [2, 3])
def test_plain_irls_min_mu_1e6_matches_pallas(p):
    """The plain K1 at the QL fits' minmu = 1e-6, on inputs whose first
    ten genes count zero in one group (mu at the clamp, X'WX at its
    ridge), against fit_beta_pallas in interpret mode: beta, its variance,
    the deviance and the iteration counts where both converge, and the
    same convergence flags."""
    import jax.numpy as jnp
    from deseq2_tpu.ops.pallas_irls import fit_beta_pallas
    from deseq2_tpu_torch.ops import checks, irls
    d = checks.zero_group_inputs(64, 24, p, seed=p)
    args = (d["y"], d["x"], np.ones(24), d["alpha"], d["b0"],
            np.full(p, 1e-6 / np.log(2.0) ** 2))
    ref = {k: np.asarray(v) for k, v in fit_beta_pallas(
        *(jnp.asarray(a) for a in args), maxit=100, min_mu=1e-6,
        interpret=True).items()}
    got = {k: v.numpy() for k, v in irls.fit_beta_plain(
        *(torch.as_tensor(a) for a in args), maxit=100,
        min_mu=1e-6).items()}
    conv = (ref["iter"] < 100) & (got["iter"] < 100)
    np.testing.assert_array_equal(got["iter"] < 100, ref["iter"] < 100)
    # the zero-group rows: mu at the clamp on the treated samples
    assert (got["mu"][:10][:, d["x"][:, 1] > 0] < 1e-5).mean() > 0.9
    np.testing.assert_allclose(got["beta"][conv], ref["beta"][conv],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["beta_var"][conv], ref["beta_var"][conv],
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got["deviance"][conv], ref["deviance"][conv],
                               rtol=1e-8, atol=1e-6)
    assert (got["iter"][conv] == ref["iter"][conv]).mean() > 0.98
