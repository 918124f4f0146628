"""The port's public entry points: deseq(dds, device="cpu") + results()
against the JAX package's fused_results on the same arrays, for the
default Wald route and each variant (LRT, local and mean trends, use_t,
observation weights, normalization factors, the parametric trend's
fallback to the local one), and the refusals of what the port does not
cover yet (weights that fail the rank tests, once refused here, run the
host engine: tests/test_torch_host.py).

float64 on the CPU on both sides; tolerance rtol 1e-6, atol 1e-9 with
equal NaN patterns, as in tests/test_fused_exact.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import deseq2_tpu as jdt
import deseq2_tpu_torch as tdt
from deseq2_tpu.parallel import fused as jfused
from torch_threads import one_torch_thread  # noqa: F401


def _cmp(a, b, name, rtol=1e-6, atol=1e-9):
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    assert np.array_equal(np.isnan(a), np.isnan(b)), \
        f"{name}: NaN pattern differs"
    m = ~np.isnan(a)
    np.testing.assert_allclose(a[m], b[m], rtol=rtol, atol=atol,
                               err_msg=name)


def _arrays(n=400, m=12, seed=42):
    """The JAX package's example dataset as plain numpy arrays."""
    dds = jdt.make_example_dataset(n=n, m=m, beta_sd=1.0, seed=seed)
    cond = dds.col_data["condition"]
    labels = np.asarray(cond.levels)[cond.codes]
    x, _ = dds.model_matrix()
    return np.asarray(dds.counts), labels, np.asarray(x, float)


def _port_dataset(counts, labels, **kw):
    return tdt.dataset_from_arrays(counts, {"condition": labels},
                                   "~ condition", **kw)


@pytest.fixture(scope="module")
def public_run():
    counts, labels, x = _arrays()
    fit = tdt.deseq(_port_dataset(counts, labels), device="cpu")
    res = tdt.results(fit)
    ref = jfused.fused_results(counts, x, None, two_group=True)
    return fit, res, ref


@pytest.mark.parametrize("col", ["baseMean", "log2FoldChange", "lfcSE",
                                 "stat", "pvalue", "padj"])
def test_results_columns_match_jax(public_run, col):
    _, res, ref = public_run
    _cmp(res[col], ref[col], col)


def test_filter_theta_and_size_factors_match_jax(public_run):
    fit, res, ref = public_run
    assert res.metadata["filterTheta"] == pytest.approx(ref["filterTheta"],
                                                        rel=1e-12)
    assert res.metadata["filterThreshold"] == pytest.approx(
        ref["filterThreshold"], rel=1e-9)
    _cmp(fit.size_factors, ref["sizeFactors"], "sizeFactors", rtol=1e-12)


def test_row_data_and_assays_populated(public_run):
    """The dataset carries the host stages' columns: the lazily fetched
    diagnostics and the device-resident assays read back as numpy."""
    fit, _, ref = public_run
    _cmp(fit.row_data["dispersion"], ref["dispersion"], "dispersion")
    _cmp(fit.row_data["dispGeneEst"], ref["dispGeneEst"], "dispGeneEst")
    _cmp(fit.row_data["maxCooks"], ref["maxCooks"], "maxCooks")
    mu = np.asarray(fit.assays["mu"])
    assert mu.shape == fit.counts.shape
    assert np.isfinite(mu[~np.asarray(fit.row_data["allZero"])]).all()
    assert fit.attrs["test"] == "Wald" and fit.attrs["engine"] == "fused"


def test_non_default_results_call_runs_host_flow(public_run):
    """A results() call the device tail did not compute (alpha=0.05,
    lfcThreshold) runs the copied host flow on the fetched columns."""
    fit, res, _ = public_run
    r05 = tdt.results(fit, alpha=0.05)
    _cmp(r05["pvalue"], res["pvalue"], "pvalue")
    assert np.nansum(r05["padj"] < 0.05) <= np.nansum(res["padj"] < 0.1)
    thr = tdt.results(fit, lfc_threshold=0.5)
    p = np.asarray(thr["pvalue"])
    ok = np.isfinite(p) & np.isfinite(res["pvalue"])
    assert np.all(p[ok] >= res["pvalue"][ok] - 1e-12)


def test_float32_config_runs():
    counts, labels, _ = _arrays(n=200, seed=3)
    dds = _port_dataset(counts, labels)
    dds.config = tdt.DESeqConfig(dtype="float32")
    res = tdt.results(tdt.deseq(dds, device="cpu"))
    ref = tdt.results(tdt.deseq(_port_dataset(counts, labels),
                                device="cpu"))
    both = np.isfinite(res["log2FoldChange"]) & \
        np.isfinite(ref["log2FoldChange"])
    assert both.mean() > 0.95
    # bench.py's float32-vs-float64 gate bound on |dLFC|
    np.testing.assert_allclose(res["log2FoldChange"][both],
                               ref["log2FoldChange"][both], atol=1e-2)


def test_deseq_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    counts, labels, _ = _arrays(n=50)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdt.deseq(_port_dataset(counts, labels))


def _public_vs_jax(counts, labels, x, deseq_kw, ref_kw, prep=None):
    """Port deseq(device="cpu") + results() against JAX fused_results on
    the same arrays: the five results columns and padj."""
    dds = _port_dataset(counts, labels)
    if prep is not None:
        prep(dds)
    fit = tdt.deseq(dds, device="cpu", **deseq_kw)
    res = tdt.results(fit)
    ref = jfused.fused_results(counts, x, None, two_group=True, **ref_kw)
    for col in ("baseMean", "log2FoldChange", "lfcSE", "stat", "pvalue",
                "padj"):
        _cmp(res[col], ref[col], col)
    return fit, res


def test_lrt_public():
    """deseq(test="LRT", reduced="~ 1") + results(): the LRT statistic and
    p-value, the JAX package's LRT columns and descriptions."""
    counts, labels, x = _arrays(n=200, seed=11)
    fit, res = _public_vs_jax(counts, labels, x,
                              dict(test="LRT", reduced="~ 1"),
                              dict(reduced="~ 1"))
    assert fit.attrs["test"] == "LRT"
    assert fit.row_meta["LRTPvalue"][1] == \
        "LRT p-value: '~ condition' vs '~ 1'"
    for col in ("LRTStatistic", "fullBetaConv", "reducedBetaConv",
                "deviance"):
        assert col in fit.row_data
    _cmp(fit.row_data["LRTStatistic"], res["stat"], "LRTStatistic")
    wald = tdt.results(fit, test="Wald")
    _cmp(wald["log2FoldChange"], res["log2FoldChange"], "Wald LFC")
    p = np.asarray(wald["pvalue"])
    assert np.isfinite(p).mean() > 0.9


def test_lrt_reduced_matrix_public():
    """A reduced model matrix with a full model matrix (both user-supplied)
    takes the reduced IRLS fit."""
    counts, labels, x = _arrays(n=150, seed=12)
    dds = _port_dataset(counts, labels)
    fit = tdt.deseq(dds, device="cpu", test="LRT", full=x,
                    reduced=np.ones((x.shape[0], 1)))
    res = tdt.results(fit)
    ref = jfused.fused_results(counts, x, None, two_group=True,
                               reduced=np.ones((x.shape[0], 1)))
    _cmp(res["stat"], ref["stat"], "LRT stat")
    _cmp(res["pvalue"], ref["pvalue"], "LRT pvalue")
    assert fit.row_meta["LRTStatistic"][1] == \
        "LRT statistic: full vs reduced"
    with pytest.raises(ValueError, match="more than the number of columns"):
        tdt.deseq(dds, device="cpu", test="LRT", full=x[:, :1],
                  reduced=np.ones((x.shape[0], 1)))


@pytest.mark.parametrize("fit_type", ["local", "mean"])
def test_trend_fit_types_public(fit_type):
    """tests/test_fused_exact.py:test_fused_local_and_mean_trend_match_host's
    fixture."""
    counts, labels, x = _arrays(n=300, seed=11)
    fit, _ = _public_vs_jax(counts, labels, x, dict(fit_type=fit_type),
                            dict(fit_type=fit_type))
    fn = fit.dispersion_function
    assert fn.fit_type == fit_type
    bm = np.asarray(fit.row_data["baseMean"])
    live = bm > 0
    # the host-side trend function (for local, the pipeline's
    # local_trend_eval over the fetched fit points) reproduces the
    # pipeline's dispFit; equal to the last bit for local on the CPU
    _cmp(fn(bm[live]), np.asarray(fit.row_data["dispFit"])[live],
         "dispersion_function", rtol=1e-12)


def test_use_t_public():
    counts, labels, x = _arrays(n=200, m=8, seed=23)
    fit, res = _public_vs_jax(counts, labels, x, dict(use_t=True),
                              dict(use_t=True))
    df = np.asarray(fit.row_data["tDegreesFreedom"])
    assert np.all(df[np.isfinite(df)] == 8 - 2)
    # a non-default call runs the host flow with t tails
    thr = tdt.results(fit, lfc_threshold=0.5)
    ok = np.isfinite(thr["pvalue"]) & np.isfinite(res["pvalue"])
    assert np.all(np.asarray(thr["pvalue"])[ok] >= res["pvalue"][ok] - 1e-12)


def test_weights_public():
    """A weights assay runs the weighted path (weighted K1/K2 on the card)
    and matches the JAX package, use_t with per-gene df included."""
    counts, labels, x = _arrays(n=150, seed=33)
    w = np.random.default_rng(33).uniform(0.3, 1.0, counts.shape)

    def prep(dds):
        dds.assays["weights"] = w
    fit, _ = _public_vs_jax(counts, labels, x, dict(use_t=True),
                            dict(weights=w, use_t=True), prep)
    assert fit.attrs["weightsOK"] is True
    wn = w / w.max(axis=1, keepdims=True)
    df = np.asarray(fit.row_data["tDegreesFreedom"])
    live = np.isfinite(df)
    _cmp(df[live], (wn.sum(axis=1) - 2)[live], "tDegreesFreedom",
         rtol=1e-12)


def test_norm_factors_public():
    counts, labels, x = _arrays(n=200, seed=11)
    rng = np.random.default_rng(5)
    nf = np.exp(rng.normal(0.0, 0.2, counts.shape))
    nf = nf / np.exp(np.mean(np.log(nf), axis=1))[:, None]

    def prep(dds):
        dds.normalization_factors = nf
    fit, _ = _public_vs_jax(counts, labels, x, dict(test="LRT",
                                                    reduced="~ 1"),
                            dict(norm_factors=nf, reduced="~ 1"), prep)
    assert fit.size_factors is None


def test_contrast_raises(public_run):
    """Contrasts run now (tests/test_torch_contrast.py); one that names the
    same level twice raises the reference's ValueError."""
    fit, _, _ = public_run
    with pytest.raises(ValueError, match="A and A should be different "
                                         "level names"):
        tdt.results(fit, contrast=("condition", "A", "A"))


def test_parametric_trend_failure_raises():
    """Poisson counts make the parametric gamma fit leave its valid range;
    the port then substitutes the local trend as the JAX package's engine
    does (engine.py:495-509), warning when quiet=False, and matches JAX's
    local run column for column."""
    rng = np.random.default_rng(0)
    counts = rng.poisson(np.exp(rng.normal(5, 1, (200, 1)))
                         * np.ones((1, 12)))
    labels = np.repeat(["A", "B"], 6)
    x = np.column_stack([np.ones(12), np.repeat([0.0, 1.0], 6)])
    ref = jfused.fused_wald_pipeline(
        jnp.asarray(counts), jnp.asarray(x), jnp.ones(12),
        jnp.asarray(np.linspace(np.log(1e-8), np.log(12.0), 20)),
        cells=jfused.design_cells(x))
    assert not bool(ref["trendValid"])
    with pytest.warns(UserWarning, match="local regression fit was "
                                         "substituted"):
        fit = tdt.deseq(_port_dataset(counts, labels,
                                      size_factors=np.ones(12)),
                        device="cpu", quiet=False)
    assert fit.dispersion_function.fit_type == "local"
    res = tdt.results(fit)
    jres = jfused.fused_results(counts, x, np.ones(12), two_group=True,
                                fit_type="local")
    for col in ("log2FoldChange", "lfcSE", "stat", "pvalue", "padj"):
        _cmp(res[col], jres[col], col)
    _cmp(fit.row_data["dispFit"], jres["dispFit"], "dispFit")
