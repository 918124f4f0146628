"""The port's transforms against the JAX package's, on the same seeded
numpy inputs (both packages' make_example_dataset draw the same counts):
varianceStabilizingTransformation in its three trends, vst with its nsub
pick, normTransform, rlog (fitted intercept, frozen intercept, all-zero
rows), the arrow IRLS against the dense GLM solver, the transforms of a
deseq() fit (blind=False), the float32 payload against the JAX package's
device functions, and the dispersion step's failures propagating.

float64 on the CPU on both sides, held at rtol 1e-6 (atol 1e-9 on values
near 0).  The float32 payload is held to the JAX package's float32 device
path (run on the CPU with its `_use_device` gate forced on, as
tests/test_transforms.py does) at 1e-4 log2 units for the closed forms
(float32 carries ~7 digits of values up to ~20) and at 1e-2 for rlog
(bench.py's |dLFC| limit: the JAX package's float32 IRLS stops at a
relative deviance change of 1e-4, so its rounding can end a gene one
sweep earlier or later); the port's float32 rlog (a float64 fit, cast)
is held to its float64 one at 1e-4.
"""

import warnings

import numpy as np
import pytest
import torch

import deseq2_tpu as jdt
import deseq2_tpu.transforms as jtf
import deseq2_tpu_torch as tdt
import deseq2_tpu_torch.transforms as ttf
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-6, 1e-9
F32_VST, F32_RLOG = 1e-4, 1e-2


def pair(**kw):
    a = jdt.make_example_dataset(**kw)
    b = tdt.make_example_dataset(**kw)
    assert np.array_equal(a.counts, b.counts)
    return a, b


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def base():
    return pair(n=400, m=12, beta_sd=0.7, seed=11)


@pytest.fixture(scope="module")
def wide():
    return pair(n=1200, m=10, intercept_mean=6.0, intercept_sd=1.0, seed=3)


@pytest.mark.parametrize("fit_type", ["parametric", "mean", "local"])
def test_vst_matches_jax(base, fit_type):
    a, b = base
    want = jdt.variance_stabilizing_transformation(a, fit_type=fit_type)
    got = tdt.variance_stabilizing_transformation(b, fit_type=fit_type,
                                                  device="cpu")
    assert torch.is_tensor(got.matrix_device)
    assert got.matrix_device.dtype == torch.float64
    assert got.shape == a.counts.shape
    close(got.matrix, want.matrix)
    assert isinstance(got.matrix, np.ndarray)
    assert got.row_names == want.row_names
    assert got.col_names == want.col_names


@pytest.mark.parametrize("fit_type", ["parametric", "local"])
def test_vst_with_normalization_factors_matches_jax(base, fit_type):
    """Gene x sample factors: the closed form divides by them, and the
    local trend's grid takes their per-sample geometric means."""
    a, b = base
    rng = np.random.default_rng(4)
    nf = np.exp(rng.normal(0.0, 0.2, a.counts.shape))
    nf /= np.exp(np.log(nf).mean(axis=1, keepdims=True))
    a, b = a.copy(), b.copy()
    a.normalization_factors = nf
    b.normalization_factors = nf
    close(tdt.variance_stabilizing_transformation(
        b, fit_type=fit_type, device="cpu").matrix,
        jdt.variance_stabilizing_transformation(a,
                                                fit_type=fit_type).matrix)


@pytest.mark.parametrize("fit_type", ["parametric", "local"])
def test_vst_nsub_matches_jax(wide, fit_type):
    a, b = wide
    close(tdt.vst(b, nsub=1000, fit_type=fit_type, device="cpu").matrix,
          jdt.vst(a, nsub=1000, fit_type=fit_type).matrix)


def test_vst_nsub_pick_and_trend(wide):
    """R's o[round(seq(1, length(o), length = nsub))] over the genes with
    mean normalized count > 5: the subset's trend is the full trend."""
    a, b = wide
    nsub = 300
    d = tdt.estimate_size_factors(b, device="cpu")
    bm = d.counts_normalized().mean(axis=1)
    sub = np.where(bm > 5)[0]
    o = np.argsort(bm[sub], kind="stable")
    pick = sub[o[np.round(np.linspace(1, len(o), nsub)).astype(int) - 1]]
    assert len(np.unique(pick)) == nsub
    sub_dds = d.subset_genes(pick)
    sub_dds.design = tdt.parse_formula("~ 1")
    fit = tdt.estimate_dispersions_fit(tdt.estimate_dispersions_gene_est(
        sub_dds, device="cpu"), device="cpu")
    a_, ep = fit.dispersion_function.coefficients
    q = d.counts_normalized()
    want = np.log((1 + ep + 2 * a_ * q + 2 * np.sqrt(a_ * q * (1 + ep
                                                                + a_ * q)))
                  / (4 * a_)) / np.log(2)
    close(tdt.vst(b, nsub=nsub, device="cpu").matrix, want)
    close(tdt.vst(b, nsub=nsub, device="cpu").matrix,
          jdt.vst(a, nsub=nsub).matrix)


def test_vst_nsub_errors_as_jax(base):
    a, b = base
    for kw in (dict(nsub=401), dict(nsub=400)):
        with pytest.raises(ValueError) as je:
            jdt.vst(a, **kw)
        with pytest.raises(ValueError) as te:
            tdt.vst(b, device="cpu", **kw)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("pc", [1, 0.5])
def test_norm_transform_matches_jax(base, pc):
    a, b = base
    got = tdt.norm_transform(b, pc=pc, device="cpu")
    assert torch.is_tensor(got.matrix_device)
    close(got.matrix, jdt.norm_transform(a, pc=pc).matrix)
    close(tdt.norm_transform(b, f=torch.log, pc=pc, device="cpu").matrix,
          jdt.norm_transform(a, f=np.log, pc=pc).matrix)


def test_get_variance_stabilized_data_matches_jax(base):
    a, b = base
    ja = jdt.estimate_dispersions(jdt.estimate_size_factors(a))
    tb = tdt.estimate_dispersions(tdt.estimate_size_factors(
        b, device="cpu"), device="cpu")
    got = ttf.get_variance_stabilized_data(tb, device="cpu")
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    close(got, jtf.get_variance_stabilized_data(ja))
    with pytest.raises(ValueError, match="call estimate_dispersions"):
        ttf.get_variance_stabilized_data(b, device="cpu")


@pytest.mark.parametrize("fit_type", ["parametric", "mean"])
def test_rlog_matches_jax(base, fit_type):
    a, b = base
    want = jdt.rlog(a, fit_type=fit_type)
    got = tdt.rlog(b, fit_type=fit_type, device="cpu")
    assert torch.is_tensor(got.matrix_device)
    close(got.matrix, want.matrix)
    close(got.attrs["betaPriorVar"], want.attrs["betaPriorVar"])
    close(got.attrs["rlogIntercept"], want.attrs["rlogIntercept"])


def test_rlog_all_zero_rows_match_jax():
    a, b = pair(n=120, m=6, seed=2)
    a.counts[[5, 40]] = 0
    b.counts[[5, 40]] = 0
    want = jdt.rlog(a)
    got = tdt.rlog(b, device="cpu")
    np.testing.assert_array_equal(got.matrix[[5, 40]], 0.0)
    assert np.all(got.attrs["rlogIntercept"][[5, 40]] == -np.inf)
    close(got.matrix, want.matrix)
    close(got.attrs["betaPriorVar"], want.attrs["betaPriorVar"])
    close(got.attrs["rlogIntercept"], want.attrs["rlogIntercept"])


@pytest.mark.parametrize("prior", ["given", "estimated"])
def test_rlog_frozen_intercept_matches_jax(prior):
    """rlog(intercept=...) on a fitted object: the design I_S, the
    intercept folded into the normalization factors, infinite intercepts
    flagging all-zero rows (R/rlog.R:200-213); with and without a given
    betaPriorVar."""
    a, b = pair(n=150, m=6, seed=9)
    a.counts[7] = 0
    b.counts[7] = 0
    first = jdt.rlog(a)
    intercept = first.attrs["rlogIntercept"]
    assert intercept[7] == -np.inf
    bpv = first.attrs["betaPriorVar"] if prior == "given" else None

    def fitted(dt, d, **kw):
        d = dt.estimate_size_factors(d, **kw)
        d.design = dt.parse_formula("~ 1")
        d = dt.estimate_dispersions_gene_est(d, quiet=True, **kw)
        return dt.estimate_dispersions_fit(d, quiet=True, **kw)

    want = jdt.rlog(fitted(jdt, a), blind=False, intercept=intercept,
                    beta_prior_var=bpv)
    got = tdt.rlog(fitted(tdt, b, device="cpu"), blind=False,
                   intercept=intercept, beta_prior_var=bpv, device="cpu")
    assert "rlogIntercept" not in got.attrs
    close(got.matrix, want.matrix)
    close(got.attrs["betaPriorVar"], want.attrs["betaPriorVar"])
    with pytest.raises(ValueError, match="as long as the number of rows"):
        tdt.rlog(fitted(tdt, b, device="cpu"), blind=False,
                 intercept=intercept[:-1], device="cpu")


@pytest.mark.parametrize("has_intercept", [True, False])
def test_arrow_irls_matches_jax(base, has_intercept):
    """The one PyTorch arrow IRLS against the JAX package's host
    (float64) arrow IRLS, with shared size factors and with a (G,S)
    factor matrix."""
    a, _ = base
    d = jdt.estimate_dispersions_fit(jdt.estimate_dispersions_gene_est(
        jdt.estimate_size_factors(a)))
    nz = ~d.row_data["allZero"]
    obj = d.subset_genes(nz)
    alpha = obj.row_data["dispFit"]
    lam0, lam1 = 1e-6 / np.log(2) ** 2, (1 / 0.7) / np.log(2) ** 2
    for nf in (obj.size_factors, obj.size_or_norm_factors()):
        xb, b0, it = jtf._rlog_arrow_irls(obj.counts, nf, alpha, lam0, lam1,
                                          has_intercept)
        txb, tb0, tit = ttf.rlog_arrow_irls(
            torch.as_tensor(obj.counts, dtype=torch.float64),
            torch.as_tensor(nf), torch.as_tensor(alpha), lam0, lam1,
            has_intercept)
        close(txb.numpy(), xb)
        close(tb0.numpy(), b0)
        np.testing.assert_array_equal(tit.numpy(), it)


def test_arrow_irls_equals_dense_solver():
    """The O(S) arrow IRLS reaches the penalized optimum of the generic
    dense (S+1)-column fitBeta (the JAX package's fit_nbinom_glms)."""
    from deseq2_tpu.glm import fit_nbinom_glms
    a, _ = pair(n=80, m=10, seed=9)
    d = jdt.estimate_dispersions_fit(jdt.estimate_dispersions_gene_est(
        jdt.estimate_size_factors(a)))
    obj = d.subset_genes(~d.row_data["allZero"])
    S = obj.n_samples
    mm = np.column_stack([np.ones(S), np.eye(S)])
    names = ["Intercept"] + [f"samples{j+1}" for j in range(S)]
    pv = 0.5
    lam = np.full(S + 1, 1.0 / pv)
    lam[0] = 1e-6
    fit = fit_nbinom_glms(obj, model_matrix=mm, model_matrix_names=names,
                          lam=lam, rename_cols=False,
                          alpha_hat=obj.row_data["dispFit"],
                          beta_tol=1e-4, use_optim=False, use_qr=True)
    dense = fit["beta_matrix"] @ mm.T          # log2 fitted values
    xbeta, _, _ = ttf.rlog_arrow_irls(
        torch.as_tensor(obj.counts, dtype=torch.float64),
        torch.as_tensor(obj.size_factors),
        torch.as_tensor(obj.row_data["dispFit"]),
        1e-6 / np.log(2.0) ** 2, (1.0 / pv) / np.log(2.0) ** 2, True)
    np.testing.assert_allclose(np.log2(np.e) * xbeta.numpy(), dense,
                               rtol=1e-4, atol=1e-4)


def test_transforms_of_a_fit_match_jax(base):
    """blind=False after deseq(): the fit's trend and size factors, no
    new dispersion step (the port's fit from its fused engine, its
    columns still on the device until touched)."""
    a, b = base
    ja = jdt.deseq(a)
    tb = tdt.deseq(b, device="cpu")
    for fn in ("variance_stabilizing_transformation", "rlog"):
        close(getattr(tdt, fn)(tb, blind=False, device="cpu").matrix,
              getattr(jdt, fn)(ja, blind=False).matrix)
    close(tdt.vst(tdt.deseq(pair(n=1200, m=10, intercept_mean=6.0,
                                 intercept_sd=1.0, seed=3)[1],
                            device="cpu"), blind=False, device="cpu").matrix,
          jdt.vst(jdt.deseq(pair(n=1200, m=10, intercept_mean=6.0,
                                 intercept_sd=1.0, seed=3)[0]),
                  blind=False).matrix)


def test_blind_transforms_run_no_glm_fit(base, monkeypatch):
    """The blind dispersion step is the gene-wise estimate and the trend:
    no IRLS, MAP, Wald or Cook's stage runs."""
    from deseq2_tpu_torch import dispersions, glm
    from deseq2_tpu_torch.ops import cuda_irls

    def refuse(*a, **k):
        raise AssertionError("a blind transform ran a GLM fit or MAP")

    monkeypatch.setattr(cuda_irls, "fit_beta", refuse)
    monkeypatch.setattr(glm, "fit_glm_tensors", refuse)
    monkeypatch.setattr(dispersions, "fit_glm_tensors", refuse)
    monkeypatch.setattr(dispersions, "estimate_dispersions_map", refuse)
    _, b = base
    tdt.variance_stabilizing_transformation(b, device="cpu")
    tdt.rlog(b, device="cpu")
    tdt.vst(pair(n=1200, m=10, intercept_mean=6.0, intercept_sd=1.0,
                 seed=3)[1], device="cpu")


@pytest.mark.parametrize("where", ["line_search", "grid"])
def test_dispersion_step_failure_raises(base, monkeypatch, where):
    """A failure in the dispersion step (here the K2 or K3 wrapper)
    reaches the caller: no host fallback returns a result instead."""
    from deseq2_tpu_torch.ops import cuda_grid, cuda_ls

    def fail(*a, **k):
        raise RuntimeError("device failure")

    mod, name = ((cuda_ls, "fit_disp_line_search") if where == "line_search"
                 else (cuda_grid, "fit_disp_grid"))
    monkeypatch.setattr(mod, name, fail)
    _, b = base
    cfg = tdt.DESeqConfig(maxit_disp=2)     # leaves genes to the grid
    b = b.copy()
    b.config = cfg
    for call in (tdt.variance_stabilizing_transformation, tdt.rlog):
        with pytest.raises(RuntimeError, match="device failure"):
            call(b, device="cpu")


def test_entry_points_need_a_card_or_the_cpu(base):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, b = base
    for call in (tdt.variance_stabilizing_transformation, tdt.rlog,
                 tdt.norm_transform):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call(b)


def test_sparse_warning_as_jax():
    a, b = pair(n=200, m=8, seed=5)
    for d in (a, b):
        d.counts[:40, 0] += 5000
    with pytest.warns(UserWarning, match="rlog assumes") as jw:
        jdt.rlog(a)
    with pytest.warns(UserWarning, match="rlog assumes") as tw:
        tdt.rlog(b, device="cpu")
    msg = [str(w.message) for w in jw if "rlog assumes" in str(w.message)]
    assert msg == [str(w.message) for w in tw
                   if "rlog assumes" in str(w.message)]


def test_float32_payload_matches_jax_device_path(base, monkeypatch):
    """DESeqConfig(dtype="float32"): the payload in float32 on the
    device, held to the JAX package's float32 device functions."""
    a, b = base
    b = b.copy()
    b.config = tdt.DESeqConfig(dtype="float32")
    monkeypatch.setattr(jtf, "_use_device", lambda d: True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jv = jdt.variance_stabilizing_transformation(a)
        jm = jdt.variance_stabilizing_transformation(a, fit_type="mean")
        jr = jdt.rlog(a)
    tv = tdt.variance_stabilizing_transformation(b, device="cpu")
    tm = tdt.variance_stabilizing_transformation(b, fit_type="mean",
                                                 device="cpu")
    tr = tdt.rlog(b, device="cpu")
    assert not isinstance(jv.matrix_device, np.ndarray)
    for t in (tv, tm, tr):
        assert t.matrix_device.dtype == torch.float32
    assert np.max(np.abs(tv.matrix - jv.matrix)) <= F32_VST
    assert np.max(np.abs(tm.matrix - jm.matrix)) <= F32_VST
    assert np.max(np.abs(tr.matrix - jr.matrix)) <= F32_RLOG
    np.testing.assert_allclose(tr.attrs["betaPriorVar"],
                               jr.attrs["betaPriorVar"], rtol=F32_RLOG)
    # the float32 payload against the float64 one
    b64 = base[1]
    assert np.max(np.abs(tv.matrix - tdt.variance_stabilizing_transformation(
        b64, device="cpu").matrix)) <= F32_VST
    assert np.max(np.abs(tr.matrix - tdt.rlog(b64, device="cpu").matrix)) \
        <= F32_VST


def test_rlog_prior_var_matches_host_quantile(base):
    """The device weighted quantile (one sort, no duplicate collapse)
    equals Hmisc's wtd.quantile over the same entries, ties and zero
    weights included."""
    from deseq2_tpu.quantiles import \
        match_weighted_upper_quantile_for_variance as host
    rng = np.random.default_rng(3)
    x = np.round(rng.normal(0, 1, (300, 7)), 1)        # many ties
    bm = np.exp(rng.normal(2, 1, 300))
    bm[:5] = 0.0                                        # zero weights
    dfit = np.exp(rng.normal(-2, 0.5, 300))
    q = 2.0 ** (x + np.log2(bm + 0.5)[:, None]) - 0.5
    with np.errstate(divide="ignore"):
        w = 1.0 / (1.0 / bm + dfit)
    lfc = np.log2(q + 0.5) - np.log2(bm + 0.5)[:, None]
    want = host(lfc.ravel(order="F"), np.tile(w, 7))
    got = ttf._rlog_prior_var(torch.as_tensor(q), torch.as_tensor(bm),
                              torch.as_tensor(dfit))
    close(got, want)


def test_dispersion_step_hands_k2_a_p1_design(base):
    """A blind transform's dispersion step calls K2 (and, with maxit_disp
    = 2, K3) once each on the nonzero genes, at p = 1 in float64; the
    recording used to hold them against their plain versions on the card
    (ops/checks.py:recorded_disp_calls) leaves the wrappers in place."""
    from deseq2_tpu_torch.ops import checks, cuda_grid, cuda_ls
    _, b = base
    b = b.copy()
    b.config = tdt.DESeqConfig(maxit_disp=2)
    originals = (cuda_ls.fit_disp_line_search, cuda_grid.fit_disp_grid)
    with checks.recorded_disp_calls() as calls:
        got = tdt.variance_stabilizing_transformation(b, device="cpu")
    assert (cuda_ls.fit_disp_line_search, cuda_grid.fit_disp_grid) == \
        originals
    assert len(calls["ls"]) == 1 and len(calls["grid"]) == 1
    nz = int((b.counts.sum(axis=1) > 0).sum())
    for kind in ("ls", "grid"):
        d, use_prior, prior_var = checks.recorded_case(kind,
                                                       calls[kind][0])
        assert d["x"].shape == (b.n_samples, 1) and not use_prior
        assert d["mu"].dtype == torch.float64 and prior_var == 1.0
    assert calls["ls"][0][0][0].shape[0] == nz
    assert calls["ls"][0][1]["maxit"] == 2
    assert np.isfinite(got.matrix).all()


def test_local_trend_matches_jax_loop():
    """The host engine's local trend (the VST's fit_type="local"), now
    evaluated by the fused engine's estimator, against the JAX package's
    point-by-point loop: inside, between and beyond the fit points, with
    estimates under 10 x minDisp left out of the fit."""
    from deseq2_tpu.dispersions import local_dispersion_fit as jloc
    from deseq2_tpu_torch.dispersions import local_dispersion_fit as tloc
    rng = np.random.default_rng(12)
    means = np.exp(rng.normal(3.0, 2.0, 700))
    disps = np.exp(rng.normal(np.log(0.1 + 4 / means), 0.5))
    disps[:20] = 1e-8
    at = np.concatenate([means, np.exp(np.linspace(-6, 14, 200)),
                         [means.min(), means.max()]])
    jf, _ = jloc(means, disps, 1e-8)
    tf_, _ = tloc(means, disps, 1e-8)
    close(tf_(at), jf(at))
    assert np.shape(tf_(5.0)) == ()
    low, _ = tloc(means, np.full(700, 5e-8), 1e-8)
    np.testing.assert_array_equal(low(at), 1e-8)
