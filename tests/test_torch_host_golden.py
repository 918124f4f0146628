"""The port's host-exact engine against the committed JAX host goldens:
deseq(engine="host", device="cpu") + results() on the fixtures of
tests/golden/make_goldens.py reproduce the six results columns and
dispGeneEst, dispFit and dispersion of each tests/golden/golden_*.npz at
rtol 1e-6 (atol 1e-12, equal NaN patterns).  The goldens are read only;
no JAX run is needed.

The one exception is a gene-wise estimate at the 1e-8 floor of the
betaPrior fixture (gene 100): there the posterior is flat to within
lgamma's rounding at 1/alpha = 1e8, so the grid search's pick depends on
how the lgamma implementation rounds; the golden holds 1e-8 and the port
1.26e-8.  It is held within 10 x minDisp of the floor, and counted.
"""

import os

import numpy as np
import pytest

import deseq2_tpu_torch as tdt

HERE = os.path.join(os.path.dirname(__file__), "golden")
RES_COLS = ("baseMean", "log2FoldChange", "lfcSE", "stat", "pvalue",
            "padj")
ROW_COLS = ("dispGeneEst", "dispFit", "dispersion")
MIN_DISP = 1e-8
# gene-wise estimates at the floor per fixture (module docstring)
FLOOR_ROWS = {"betaprior": [100]}


def _wald():
    dds = tdt.make_example_dataset(n=200, m=12, beta_sd=1.0, seed=101)
    return tdt.deseq(dds, engine="host", device="cpu")


def _lrt():
    dds = tdt.make_example_dataset(n=150, m=10, beta_sd=1.0, seed=102)
    return tdt.deseq(dds, test="LRT", reduced="~ 1", engine="host",
                     device="cpu")


def _beta_prior():
    dds = tdt.make_example_dataset(n=150, m=12, beta_sd=1.0, seed=103)
    return tdt.deseq(dds, beta_prior=True, engine="host", device="cpu")


def _weighted():
    dds = tdt.make_example_dataset(n=120, m=10, beta_sd=1.0, seed=104)
    rng = np.random.default_rng(104)
    dds.assays["weights"] = rng.uniform(0.5, 1.0, dds.counts.shape)
    return tdt.deseq(dds, engine="host", device="cpu")


def _use_t():
    dds = tdt.make_example_dataset(n=120, m=8, beta_sd=1.0, seed=105)
    return tdt.deseq(dds, use_t=True, engine="host", device="cpu")


MAKERS = {"wald": _wald, "lrt": _lrt, "betaprior": _beta_prior,
          "weights": _weighted, "uset": _use_t}
_FITS = {}


def fit_and_table(name):
    if name not in _FITS:
        fit = MAKERS[name]()
        _FITS[name] = (fit, tdt.results(fit))
    return _FITS[name]


def _gold(name):
    return np.load(os.path.join(HERE, f"golden_{name}.npz"))


@pytest.mark.parametrize("col", RES_COLS)
@pytest.mark.parametrize("name", sorted(MAKERS))
def test_host_results_column_matches_golden(name, col):
    _, res = fit_and_table(name)
    got = np.asarray(res[col], np.float64)
    want = _gold(name)[col]
    assert np.array_equal(np.isnan(got), np.isnan(want)), \
        f"{name}.{col}: NaN pattern"
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=1e-6, atol=1e-12,
                               err_msg=f"{name}.{col}")


@pytest.mark.parametrize("col", ROW_COLS)
@pytest.mark.parametrize("name", sorted(MAKERS))
def test_host_dispersion_column_matches_golden(name, col):
    fit, _ = fit_and_table(name)
    got = np.asarray(fit.row_data[col], np.float64)
    want = _gold(name)[f"row_{col}"]
    assert np.array_equal(np.isnan(got), np.isnan(want)), \
        f"{name}.{col}: NaN pattern"
    m = ~np.isnan(want)
    off = m & ~np.isclose(got, want, rtol=1e-6, atol=1e-12)
    floor = FLOOR_ROWS.get(name, []) if col == "dispGeneEst" else []
    assert np.where(off)[0].tolist() == floor, (name, col)
    assert np.all(got[off] <= 10 * MIN_DISP) \
        and np.all(want[off] <= 10 * MIN_DISP)


@pytest.mark.parametrize("name", sorted(MAKERS))
def test_host_golden_fit_ran_host_engine(name):
    """Each golden fixture ran the host engine, with the JAX host path's
    stored contract (the results columns, Cook's maxima, betaConv)."""
    fit, res = fit_and_table(name)
    assert fit.attrs["engine"] == "host"
    conv = "fullBetaConv" if fit.attrs["test"] == "LRT" else "betaConv"
    assert "maxCooks" in fit.row_data and conv in fit.row_data
    assert len(res["padj"]) == fit.n_genes
