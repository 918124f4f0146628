"""The port's fused pipeline against the JAX package's, column for column.

deseq2_tpu_torch.parallel.fused.fused_wald_pipeline / fused_results run on
device="cpu" in float64 (the kernels' plain versions); the JAX package's
run on its CPU backend in float64 (the XLA cores).  Both get the same numpy
counts, design and size factors.  Every output key of the default chain is
compared at rtol 1e-6, atol 1e-9 with equal NaN patterns (_cmp, as in
tests/test_fused_exact.py), and the outlier-replacement mask exactly.

Fixtures: make_example_dataset(n=400, m=12, seed=42) (no cell reaches 7
replicates, so no replacement); the m = 14 fixture with injected count
outliers of tests/test_fused_exact.py, so the replacement and refit run;
and a ~ batch + condition design, whose four design cells exceed its
three coefficients, so the dispersion mu comes from a GLM fit (K1) rather
than the linear projection.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import deseq2_tpu as jdt
from deseq2_tpu.parallel import fused as jfused
from deseq2_tpu_torch.parallel import fused as tfused
from torch_threads import one_torch_thread  # noqa: F401

# solver iteration counts are compared where the gene-wise dispersion is
# off its floor: a gene whose posterior is flat toward alpha -> 0 runs to
# the min-log-alpha exit along a path that rounding decides, and both land
# on the clamp min_disp = 1e-8 whatever the number of steps
ITER_KEYS = ("dispGeneIter", "dispIter", "betaIter")


def _cmp(a, b, name, rtol=1e-6, atol=1e-9):
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    assert a.shape == b.shape, f"{name}: shape {a.shape} != {b.shape}"
    assert np.array_equal(np.isnan(a), np.isnan(b)), \
        f"{name}: NaN pattern differs"
    m = ~np.isnan(a)
    np.testing.assert_allclose(a[m], b[m], rtol=rtol, atol=atol,
                               err_msg=name)


def _host(v):
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _run_both(counts, x, sf, two_group):
    cells = jfused.design_cells(x)
    grid = np.linspace(np.log(1e-8), np.log(max(10.0, x.shape[0])), 20)
    lin_mu = len(set(cells)) == x.shape[1]
    j = jfused.fused_wald_pipeline(
        jnp.asarray(counts), jnp.asarray(x), jnp.asarray(sf),
        jnp.asarray(grid), cells=cells, two_group=two_group,
        linear_mu=lin_mu)
    t = tfused.fused_wald_pipeline(
        torch.as_tensor(counts), torch.as_tensor(x), torch.as_tensor(sf),
        torch.as_tensor(grid), cells=cells, two_group=two_group,
        linear_mu=lin_mu, dtype=torch.float64)
    return ({k: np.asarray(v) for k, v in j.items()},
            {k: _host(v) for k, v in t.items()})


def _outlier_counts():
    """tests/test_fused_exact.py:test_outlier_refit_matches_host."""
    dds = jdt.make_example_dataset(n=300, m=14, beta_sd=1.0, seed=7)
    counts = np.asarray(dds.counts).copy()
    rng = np.random.default_rng(3)
    for i in rng.choice(300, 8, replace=False):
        j = int(rng.integers(14))
        counts[i, j] = int(counts[i].mean() * 40 + 500)
    dds.counts[:] = counts
    return dds, counts


def _batch_dataset():
    dds = jdt.make_example_dataset(n=300, m=12, beta_sd=1.0, seed=21)
    dds.col_data["batch"] = jdt.Factor(np.tile(["1", "2"], 6),
                                       levels=["1", "2"])
    dds.design = jdt.parse_formula("~ batch + condition")
    return dds


def _fixture(name):
    if name == "m12":
        dds = jdt.make_example_dataset(n=400, m=12, beta_sd=1.0, seed=42)
        counts = np.asarray(dds.counts)
    elif name == "outliers_m14":
        dds, counts = _outlier_counts()
    else:
        dds = _batch_dataset()
        counts = np.asarray(dds.counts)
    dds = jdt.estimate_size_factors(dds)
    x, _ = dds.model_matrix()
    return counts, np.asarray(x, float), np.asarray(dds.size_factors), \
        name != "batch"


FIXTURES = ("m12", "outliers_m14", "batch")


@pytest.fixture(scope="module", params=FIXTURES)
def both(request):
    counts, x, sf, two_group = _fixture(request.param)
    j, t = _run_both(counts, x, sf, two_group)
    return request.param, j, t


def test_pipeline_keys_match(both):
    _, j, t = both
    assert set(j) == set(t)


def test_pipeline_columns_match(both):
    name, j, t = both
    floor = ~(j["dispGeneEst"] > 100 * 1e-8)
    for k in sorted(j):
        if k in ITER_KEYS:
            assert np.array_equal(j[k][~floor], t[k][~floor]), k
        else:
            _cmp(t[k], j[k], f"{name}:{k}")


def test_replacement_runs_where_expected(both):
    name, j, t = both
    assert np.array_equal(j["replace"], t["replace"])
    if name == "outliers_m14":
        assert t["replace"].sum() >= 4
        assert "replaceCounts" in t
        np.testing.assert_array_equal(t["replaceCounts"], j["replaceCounts"])
    else:
        assert not t["replace"].any()


@pytest.mark.parametrize("estimate_sf", [False, True])
def test_fused_results_match(estimate_sf):
    """fused_results (deseq() + results() in one call) on the outlier
    fixture, with given size factors and with the on-device
    median-of-ratios estimate."""
    counts, x, sf, _ = _fixture("outliers_m14")
    sf_in = None if estimate_sf else sf
    j = jfused.fused_results(counts, x, sf_in, two_group=True)
    t = tfused.fused_results(counts, x, sf_in, two_group=True, device="cpu")
    assert set(j) == set(t)
    for k in j:
        if k == "replace":
            assert np.array_equal(np.asarray(j[k]), t[k])
        else:
            _cmp(t[k], j[k], k)
    if estimate_sf:
        _cmp(t["sizeFactors"], sf, "sizeFactors vs host estimate",
             rtol=1e-12)


def test_frozen_state_runs_one_stage():
    """dataset_from_arrays carries a JAX run's frozen state (size factors,
    trend, dispPriorVar, varLogDispEsts) into the port's dataset; the port
    then runs the MAP + IRLS stage alone on it and matches the JAX
    pipeline's columns."""
    import deseq2_tpu_torch as tdt

    counts, x, sf, _ = _fixture("m12")
    grid = np.linspace(np.log(1e-8), np.log(12.0), 20)
    j = jfused.fused_wald_pipeline(
        jnp.asarray(counts), jnp.asarray(x), jnp.asarray(sf),
        jnp.asarray(grid), cells=jfused.design_cells(x), two_group=True)
    j = {k: np.asarray(v) for k, v in j.items()}
    dds = tdt.dataset_from_arrays(
        counts, {"condition": np.where(x[:, 1] > 0, "B", "A")},
        "~ condition", size_factors=sf, trend_coefs=j["trendCoefs"],
        disp_prior_var=j["dispPriorVar"],
        var_log_disp_ests=j["varLogDispEsts"])
    fn = dds.dispersion_function
    st = tfused.Stages(torch.as_tensor(x), torch.as_tensor(dds.size_factors),
                       torch.as_tensor(grid))
    est = st.gene_est(torch.as_tensor(counts, dtype=torch.float64))
    post = st.post_trend(est, torch.as_tensor(fn.coefficients),
                         fn.disp_prior_var,
                         torch.tensor(fn.var_log_disp_ests,
                                      dtype=torch.float64))
    live = ~j["allZero"]
    _cmp(post["disp_map"].numpy()[live], j["dispMAP"][live], "dispMAP")
    _cmp(post["dispersion"].numpy()[live], j["dispersion"][live],
         "dispersion")
    _cmp(tfused.LOG2E * post["beta"].numpy()[live], j["beta"][live], "beta")


def test_median_averages_the_middle_pair():
    """torch.nanmedian takes the lower middle value; the port's median
    (size factors, MAD) averages the two, as jnp.nanmedian does."""
    v = torch.tensor([[1.0, 4.0], [2.0, float("nan")], [10.0, 8.0],
                      [3.0, 6.0]], dtype=torch.float64)
    np.testing.assert_array_equal(tfused.nanmedian(v, dim=0).numpy(),
                                  np.nanmedian(v.numpy(), axis=0))
