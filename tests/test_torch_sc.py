"""The port's streamed single-cell path (deseq2_tpu_torch/parallel/sc.py)
against the JAX package's (deseq2_tpu/parallel/sc.py) on the same numpy
inputs, on the CPU in float64: the fixtures of tests/test_sc.py.

Tolerance: rtol 1e-6, atol 1e-9, equal NaN patterns, and the floor rule of
tests/test_torch_host.py:cmp_disp: a gene-wise estimate at the 1e-8 floor
(where the posterior is flat to within lgamma's rounding) may differ if
both sides sit within 10 x minDisp, and such genes' iteration counts are
not compared.  The port against itself (histogram path, chunk widths):
1e-10 where the summation order changes.
"""

import numpy as np
import pytest
import torch

import deseq2_tpu as jdt
from deseq2_tpu.formula import Factor
from deseq2_tpu.parallel import sc as jsc
from deseq2_tpu_torch import gampoi as tg
from deseq2_tpu_torch.parallel import sc as tsc
from torch_threads import one_torch_thread  # noqa: F401

MIN_DISP = 1e-8
FLOOR = 10 * MIN_DISP
CPU = dict(device="cpu")


def _cmp(got, want, name, rtol=1e-6, atol=1e-9, skip=None):
    got = np.asarray(got, dtype=float)
    want = np.asarray(want, dtype=float)
    assert got.shape == want.shape, name
    assert np.array_equal(np.isnan(got), np.isnan(want)), \
        f"{name}: NaN pattern differs"
    m = ~np.isnan(want)
    if skip is not None:
        m &= ~skip.reshape(m.shape[0], *([1] * (m.ndim - 1)))
    np.testing.assert_allclose(got[m], want[m], rtol=rtol, atol=atol,
                               err_msg=name)


def _floor_rows(a, b):
    """Genes whose gene-wise estimate sits at the floor on either side."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    return (a <= FLOOR) | (b <= FLOOR)


def _cmp_disp(got, want, name):
    """cmp_disp's floor rule: off at rtol 1e-6 only where both sit within
    10 x minDisp."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert np.array_equal(np.isnan(got), np.isnan(want)), name
    m = ~np.isnan(want)
    off = m & ~np.isclose(got, want, rtol=1e-6, atol=0.0)
    assert np.all(got[off] <= FLOOR) and np.all(want[off] <= FLOOR), \
        (name, np.where(off)[0])


def _cmp_outputs(o, j, floor_genes=None):
    """Every column of the JAX package's output against the port's."""
    dge_o, dge_j = o.get("dispGeneEst"), j.get("dispGeneEst")
    skip = floor_genes
    if skip is None and dge_o is not None:
        skip = _floor_rows(dge_o, dge_j)
    for k, v in j.items():
        if v is None:
            assert o[k] is None, k
            continue
        assert k in o, k
        if k == "ql_df0":
            assert o[k] == pytest.approx(float(v), rel=1e-9), k
        elif k in ("filterTheta", "filterThreshold"):
            assert o[k] == pytest.approx(float(v), rel=1e-12), k
        elif k == "dispGeneEst":
            _cmp_disp(o[k], v, k)
        elif k in ("dispGeneIter",):
            _cmp(o[k], v, k, skip=skip)
        else:
            _cmp(o[k], v, k)


def _np(out):
    return {k: (v.numpy() if torch.is_tensor(v) else v)
            for k, v in out.items()}


# ---------------------------------------------------------------------------
# fused_sc_pipeline and fused_sc_results against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipeline_pair():
    """tests/test_sc.py:host_and_sc's inputs: chunk 7 does not divide S =
    20 (the JAX package's pad path; the port's ragged last chunk)."""
    import jax.numpy as jnp
    dds = jdt.estimate_size_factors(
        jdt.make_example_dataset(n=300, m=20, beta_sd=1.0, seed=21))
    cells = np.asarray(dds.col_data["condition"].codes, np.int32)
    counts = np.asarray(dds.counts)
    grid = np.linspace(np.log(1e-8), np.log(max(10.0, 20)), 20)
    j = jsc.fused_sc_pipeline(jnp.asarray(counts), jnp.asarray(cells),
                              jnp.asarray(dds.size_factors),
                              jnp.asarray(grid), n_groups=2, min_mu=0.5,
                              chunk=7)
    o = tsc.fused_sc_pipeline(counts, cells, dds.size_factors, grid,
                              n_groups=2, min_mu=0.5, chunk=7, **CPU)
    return _np(o), {k: (None if v is None else np.asarray(v))
                    for k, v in j.items()}


@pytest.mark.parametrize("col", [
    "baseMean", "baseVar", "allZero", "dispGeneEst", "dispFit",
    "dispersion", "dispMAP", "dispOutlier", "trendCoefs", "dispPriorVar",
    "varLogDispEsts", "beta", "betaSE", "stat", "pvalue", "betaIter",
    "betaConv", "deviance", "padjLast"])
def test_pipeline_matches_jax(pipeline_pair, col):
    o, j = pipeline_pair
    if col == "dispGeneEst":
        _cmp_disp(o[col], j[col], col)
    else:
        _cmp(o[col], j[col], col)


def _example(n, m, seed, batch=False):
    dds = jdt.make_example_dataset(n=n, m=m, beta_sd=1.0, seed=seed)
    if batch:
        dds.col_data["batch"] = Factor(np.array(["X", "Y"])[np.arange(m)
                                                            % 2])
        dds.design = jdt.parse_formula("~ batch + condition")
    return jdt.estimate_size_factors(dds)


def _group_args(dds):
    return (np.asarray(dds.counts),
            np.asarray(dds.col_data["condition"].codes, np.int32),
            dds.size_factors)


# name -> (fixture: tests/test_sc.py's, keyword arguments)
RESULTS_CASES = {
    "group_ql": ((300, 20, 31), dict(chunk=7, test="LRT",
                                     fit_type="glmGamPoi")),
    "group_lrt": ((250, 18, 32), dict(min_mu=0.5, test="LRT",
                                      fit_type="parametric")),
    "group_wald": ((200, 16, 33), dict(test="Wald")),
}


@pytest.mark.parametrize("case", sorted(RESULTS_CASES))
def test_results_group_matches_jax(case):
    """Every column, ql_df0, filterTheta, filterThreshold, filterNumRej."""
    (n, m, seed), kw = RESULTS_CASES[case]
    counts, cells, sf = _group_args(_example(n, m, seed))
    j = jsc.fused_sc_results(counts, cells, sf, n_groups=2, **kw)
    o = tsc.fused_sc_results(counts, cells, sf, n_groups=2, **kw, **CPU)
    assert set(o) == set(j)
    _cmp_outputs(o, j)


def _nf(shape):
    rng = np.random.default_rng(6)
    nf = np.exp(rng.normal(0, 0.2, shape))
    return nf / np.exp(np.mean(np.log(nf), axis=1))[:, None]


@pytest.mark.parametrize("case", ["ql_batch", "ql_intercept", "wald",
                                  "ql_batch_nf"])
def test_results_covariate_matches_jax(case):
    """~ batch + condition at single-cell scale: QL against ~ batch (a
    second streamed fit) and against ~ 1 (the closed form), the
    parametric Wald test, and (G,S) normalization factors (tests/test_sc.py
    fixtures: seeds 17, 17, 23, 19)."""
    seed = {"ql_batch": 17, "ql_intercept": 17, "wald": 23,
            "ql_batch_nf": 19}[case]
    n = {17: 250, 23: 181, 19: 220}[seed]
    dds = _example(n, 20, seed, batch=True)
    mm, _ = dds.model_matrix()
    counts = np.asarray(dds.counts)
    kw = dict(size_factors=dds.size_factors, design=mm, chunk=7,
              test="LRT", fit_type="glmGamPoi")
    if case == "ql_batch":
        kw["reduced_design"] = dds.model_matrix("~ batch")[0]
    elif case == "ql_intercept":
        kw["reduced_design"] = np.ones((20, 1))
    elif case == "wald":
        kw.update(test="Wald", fit_type="parametric", min_mu=0.5)
    else:
        kw.update(reduced_design=dds.model_matrix("~ batch")[0],
                  norm_factors=_nf(counts.shape), size_factors=np.ones(20))
    j = jsc.fused_sc_results(counts, **kw)
    o = tsc.fused_sc_results(counts, **kw, **CPU)
    assert set(o) == set(j)
    _cmp_outputs(o, j)


# ---------------------------------------------------------------------------
# the histogram path
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hist_fixture():
    """tests/test_sc.py:test_sc_histogram_fast_path_exact's counts: UMI-like
    with ten guaranteed overflow genes (mean 200)."""
    rng = np.random.default_rng(3)
    G, S = 400, 300
    cells = (np.arange(S) % 2).astype(np.int32)
    mu0 = np.maximum(2.0 ** rng.normal(-1.0, 2.0, G), 0.01)
    mu0[:10] = 200.0
    disp = np.minimum(4.0 / mu0 + 0.3, 20.0)
    size = 1.0 / disp[:, None]
    counts = rng.negative_binomial(
        size, size / (size + mu0[:, None]), size=(G, S)).astype(np.int32)
    grid = np.linspace(np.log(1e-8), np.log(max(10.0, S)), 20)
    n_ovf = int((counts.max(axis=1) >= tsc.HIST_K).sum())
    assert n_ovf >= 10
    cap = 1 << (max(n_ovf, 16) - 1).bit_length()
    return counts, cells, grid, cap


def _port_env(counts, cells, chunk=64):
    c = torch.as_tensor(cells).long()
    return tsc._setup(torch.as_tensor(counts),
                      tsc._group_design(c, 2, torch.float64),
                      torch.ones(counts.shape[1], dtype=torch.float64),
                      chunk, torch.float64, cells=c)


def test_histogram_path_matches_jax_and_exact(hist_fixture):
    """The port's histogram stage 1 and MAP stage (with the exact redo of
    the overflow genes) against the JAX package's with use_hist=True
    (rtol 1e-6), and against the port's own per-sample path (1e-10)."""
    import jax.numpy as jnp
    counts, cells, grid, cap = hist_fixture
    S = counts.shape[1]
    kw = dict(n_groups=2, maxit=100, min_disp_pow=-8, min_mu=1e-6,
              chunk=64, mesh=None)
    args = (jnp.asarray(counts), jnp.asarray(cells),
            jnp.asarray(np.ones(S)), jnp.asarray(grid))
    jh = jsc._sc_stage1(*args, use_hist=True, ovf_cap=cap, **kw)
    env = _port_env(counts, cells)
    g = torch.as_tensor(grid)
    pk = dict(maxit=100, min_disp=MIN_DISP, min_mu=1e-6)
    th = tsc._sc_stage1(env, g, 2, use_hist=True, ovf_cap=cap, **pk)
    te = tsc._sc_stage1(env, g, 2, **pk)
    _cmp_disp(th["disp_gene_est"].numpy(), np.asarray(jh["disp_gene_est"]),
              "hist stage1 vs JAX")
    np.testing.assert_allclose(th["disp_gene_est"].numpy(),
                               te["disp_gene_est"].numpy(), rtol=1e-10)
    fit = np.full(counts.shape[0], 0.4)
    jm = jsc._sc_stage_map(*args, jh["q"], jh["all_zero"],
                           jh["disp_gene_est"], jnp.asarray(fit),
                           jnp.asarray(0.5), use_hist=True, ovf_cap=cap,
                           **kw)
    mkw = pk
    tm = tsc._sc_stage_map(env, g, th["q"], th["all_zero"],
                           th["disp_gene_est"], torch.as_tensor(fit),
                           torch.tensor(0.5, dtype=torch.float64),
                           use_hist=True, ovf_cap=cap, **mkw)
    tme = tsc._sc_stage_map(env, g, th["q"], th["all_zero"],
                            th["disp_gene_est"], torch.as_tensor(fit),
                            torch.tensor(0.5, dtype=torch.float64), **mkw)
    _cmp(tm.numpy(), np.asarray(jm), "hist MAP vs JAX")
    np.testing.assert_allclose(tm.numpy(), tme.numpy(), rtol=1e-10)


def test_count_tails_are_the_histogram(hist_fixture):
    counts, cells, _, _ = hist_fixture
    tails, mx = tsc._count_tails(_port_env(counts, cells, chunk=37))
    want = np.stack([(counts > k).sum(axis=1)
                     for k in range(tsc.HIST_K)], axis=1)
    np.testing.assert_array_equal(tails.numpy(), want)
    np.testing.assert_array_equal(mx.numpy(), counts.max(axis=1))


def test_histogram_declined_past_a_quarter():
    """The JAX package's refusal: more than a quarter of the genes with a
    count >= HIST_K turns the histogram path off."""
    c = torch.zeros((8, 5), dtype=torch.int32)
    c[:3, 0] = tsc.HIST_K
    assert tsc._hist_plan(c, None, torch.float32)[0] is False
    c[2, 0] = 1
    on, cap, n = tsc._hist_plan(c, None, torch.float32)
    assert on and n == 2 and cap == 8
    assert tsc._hist_plan(c, None, torch.float64)[0] is False
    assert tsc._hist_plan(c, True, torch.float64)[0] is True
    assert tsc._hist_plan(c, False, torch.float32)[0] is False


# ---------------------------------------------------------------------------
# the trend's window, a mesh
# ---------------------------------------------------------------------------

def _window_weights(n, npoints):
    half_w = npoints // 2
    lo = np.clip(np.arange(n) - half_w, 0, n - npoints)
    rel = (np.arange(npoints)[None, :] - (np.arange(n) - lo)[:, None]) \
        / max(half_w, 1)
    return lo, (1.0 - np.minimum(np.abs(rel), 1.0) ** 3) ** 3


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_loc_median_window_matches_jax_bitwise(dtype):
    """Bit for bit, but for a float32 pick whose window weight below it
    lies within float32 rounding of half the window's weight: there the
    first crossing is decided by the order in which XLA and torch sum the
    float32 weights (2 of 5,000 points at npoints = 500 on the CPU)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(1)
    ys = np.exp(rng.normal(0, 1, 5000))
    ys[100:140] = ys[99]        # ties
    for npoints in (2, 500, 5000):
        want = np.asarray(jsc._loc_median_window_dev(
            jnp.asarray(ys, getattr(jnp, dtype)), npoints))
        got = tg._loc_median_window_dev(
            torch.as_tensor(ys).to(getattr(torch, dtype)), npoints).numpy()
        off = np.where(got != want)[0]
        if dtype == "float64":
            assert off.size == 0, off
            continue
        assert off.size <= 2, off
        lo, w = _window_weights(len(ys), npoints)
        y32 = ys.astype(np.float32)
        for i in off:
            win = y32[lo[i]:lo[i] + npoints]
            below = w[i][win < max(got[i], want[i])].sum()
            tie = 0.5 * w[i].sum()
            assert abs(below - tie) <= npoints * 2.0 ** -23 * tie, (i, below,
                                                                    tie)


def test_loc_median_fit_dev_matches_host():
    """At 4,096 points or more the window runs on the device: in float64
    it equals gampoi.loc_median_fit."""
    rng = np.random.default_rng(2)
    x = np.exp(rng.normal(0, 2, 5000))
    y = np.exp(rng.normal(0, 1, 5000))
    np.testing.assert_array_equal(
        tg.loc_median_fit_dev(x, y, "cpu", torch.float64),
        tg.loc_median_fit(x, y))


def _cmp_single(o, ref, name):
    """A mesh run's columns against the single-device run's: rtol 1e-8,
    atol 1e-10, equal NaN patterns (tests/test_sharding.py's limits)."""
    assert set(o) == set(ref), name
    for k, v in ref.items():
        if v is None:
            assert o[k] is None, (name, k)
        elif np.ndim(v):
            np.testing.assert_allclose(np.asarray(o[k], float),
                                       np.asarray(v, float), rtol=1e-8,
                                       atol=1e-10, equal_nan=True,
                                       err_msg=f"{name} {k}")
        else:
            assert float(o[k]) == pytest.approx(float(v), rel=1e-8,
                                                nan_ok=True), (name, k)


@pytest.mark.parametrize("case", ["group_ql", "covariate_nf", "group_hist"])
def test_mesh_matches_single_and_jax(case, hist_fixture):
    """fused_sc_results over an 8-shard gene mesh of CPU devices (the
    tests' stand-in for several cards, tests/test_torch_sharding.py) at a
    gene count 8 does not divide: every column equals the single-device
    run's (_cmp_single), and the JAX package's single-device outputs
    (_cmp_outputs).  The group QL and covariate cases are
    test_results_group_matches_jax's and
    test_results_covariate_matches_jax's fixtures; group_hist runs the
    histogram path with its overflow redo (hist_fixture, 397 genes) in
    each block, against the port's single-device run only."""
    from deseq2_tpu_torch.parallel import gene_mesh
    mesh = gene_mesh(devices=["cpu"] * 8)
    if case == "group_ql":
        (n, m, seed), kw = RESULTS_CASES["group_ql"]
        counts, cells, sf = _group_args(_example(n, m, seed))
        kw = dict(kw, cells=cells, size_factors=sf, n_groups=2)
    elif case == "covariate_nf":
        dds = _example(220, 20, 19, batch=True)
        counts = np.asarray(dds.counts)
        kw = dict(size_factors=np.ones(20), design=dds.model_matrix()[0],
                  reduced_design=dds.model_matrix("~ batch")[0],
                  norm_factors=_nf(counts.shape), chunk=7, test="LRT",
                  fit_type="glmGamPoi")
    else:
        counts, cells, _, _ = hist_fixture
        counts = counts[:397]
        kw = dict(cells=cells, n_groups=2, size_factors=np.ones(300),
                  test="LRT", fit_type="glmGamPoi", use_hist=True)
    assert counts.shape[0] % 8
    info = {}
    o = tsc.fused_sc_results(counts, mesh=mesh, info=info, **kw, **CPU)
    _cmp_single(o, tsc.fused_sc_results(counts, **kw, **CPU), case)
    if case == "group_hist":
        assert info["use_hist"] and info["hist_overflow_genes"] >= 10
        return
    _cmp_outputs(o, jsc.fused_sc_results(counts, **kw))


def test_sc_pipeline_mesh_matches_single():
    """fused_sc_pipeline (the parametric Wald chain, device tensors) over
    an 8-shard CPU mesh equals its single-device run on pipeline_pair's
    inputs (300 genes), which test_pipeline_matches_jax holds to the JAX
    package's."""
    from deseq2_tpu_torch.parallel import gene_mesh
    dds = jdt.estimate_size_factors(
        jdt.make_example_dataset(n=300, m=20, beta_sd=1.0, seed=21))
    cells = np.asarray(dds.col_data["condition"].codes, np.int32)
    grid = np.linspace(np.log(1e-8), np.log(20.0), 20)
    args = (np.asarray(dds.counts), cells, dds.size_factors, grid)
    kw = dict(n_groups=2, min_mu=0.5, chunk=7, **CPU)
    o = tsc.fused_sc_pipeline(*args, mesh=gene_mesh(devices=["cpu"] * 8),
                              **kw)
    _cmp_single(_np(o), _np(tsc.fused_sc_pipeline(*args, **kw)), "pipeline")


def test_counts_must_be_integers():
    with pytest.raises(ValueError, match="integer counts"):
        tsc.fused_sc_results(np.ones((4, 6)), cells=np.arange(6) % 2,
                             n_groups=2, size_factors=np.ones(6), **CPU)
