"""The port's utilities against the JAX package's, on the same seeded numpy
inputs (after tests/test_helper.py and tests/test_txi.py):
collapse_replicates (and a deseq() of the collapsed data), fpm, fpkm,
unmix, covariance_matrix of a fit from the port's fused engine (its
columns still on the device until touched), integrate_with_single_cell,
normalize_gene_length, make_counts_from_abundance and the tximport
ingestion; and the port's exports against deseq2_tpu.__all__.

float64 on the CPU on both sides, held at rtol 1e-6 (atol 1e-9).
"""

import warnings

import numpy as np
import pytest
import torch

import deseq2_tpu as jdt
import deseq2_tpu.helper as jh
import deseq2_tpu_torch as tdt
import deseq2_tpu_torch.helper as th

RTOL, ATOL = 1e-6, 1e-9
COLS = ("baseMean", "log2FoldChange", "lfcSE", "stat", "pvalue", "padj")


def pair(**kw):
    a = jdt.make_example_dataset(**kw)
    b = tdt.make_example_dataset(**kw)
    assert np.array_equal(a.counts, b.counts)
    return a, b


def close(got, want, rtol=RTOL, atol=ATOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=rtol, atol=atol)


def test_port_exports_every_jax_name():
    missing = sorted(set(jdt.__all__) - set(tdt.__all__))
    assert not missing, f"deseq2_tpu_torch lacks {missing}"
    for name in jdt.__all__:
        assert getattr(tdt, name) is not None
    assert hasattr(tdt.io, "save_dataset")


@pytest.mark.parametrize("rename_cols", [True, False])
def test_collapse_replicates_matches_jax(rename_cols):
    a, b = pair(n=50, m=8, seed=1)
    groups = ["s1", "s1", "s2", "s2", "s3", "s3", "s4", "s4"]
    run = [f"r{j}" for j in range(8)]
    want = jh.collapse_replicates(a, groups, run=run,
                                  rename_cols=rename_cols)
    got = th.collapse_replicates(b, groups, run=run,
                                 rename_cols=rename_cols)
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.col_names == want.col_names
    assert list(got.col_data["runsCollapsed"]) == \
        list(want.col_data["runsCollapsed"])
    assert list(got.col_data["condition"].as_strings()) == \
        list(want.col_data["condition"].as_strings())


def test_collapse_then_deseq_matches_jax():
    """The collapsed dataset carries no device copy of the source's
    counts (another shape): deseq() uploads its own and matches JAX."""
    a, b = pair(n=300, m=16, seed=4)
    groups = np.repeat([f"g{j}" for j in range(8)], 2)
    a = jdt.deseq(a)
    b = tdt.deseq(b, device="cpu")          # leaves the counts' device copy
    assert b._counts_dev is not None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ca = jh.collapse_replicates(a, groups)
        cb = th.collapse_replicates(b, groups)
    assert cb._counts_dev is None
    assert cb.assays == {}
    ra = jdt.results(jdt.deseq(ca))
    rb = tdt.results(tdt.deseq(cb, device="cpu"))
    for c in COLS:
        close(rb[c], ra[c])


def test_collapse_replicates_errors_as_jax():
    a, b = pair(n=20, m=6, seed=1)
    for kw in (dict(groupby=["a"] * 5), dict(groupby=["a", "b"] * 3,
                                             run=["x"] * 5)):
        with pytest.raises(ValueError) as je:
            jh.collapse_replicates(a, **kw)
        with pytest.raises(ValueError) as te:
            th.collapse_replicates(b, **kw)
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("robust", [True, False])
def test_fpm_matches_jax(robust):
    sf = np.array([0.5, 1.0, 2.0, 1.0, 1.0, 1.0])
    a, b = pair(n=200, m=6, size_factors=sf, seed=3)
    close(th.fpm(b, robust=robust, device="cpu"), jh.fpm(a, robust=robust))
    close(th.fpm(tdt.estimate_size_factors(b, device="cpu"), robust=robust),
          jh.fpm(jdt.estimate_size_factors(a), robust=robust))


@pytest.mark.parametrize("robust", [True, False])
def test_fpkm_matches_jax(robust):
    a, b = pair(n=80, m=4, seed=4)
    bp = np.random.default_rng(0).uniform(300, 3000, 80)
    for d in (a, b):
        d.set_row_data("basepairs", bp, "input", "gene length")
    close(th.fpkm(b, robust=robust, device="cpu"),
          jh.fpkm(a, robust=robust))
    a2, b2 = pair(n=30, m=4, seed=5)
    with pytest.raises(ValueError, match="basepairs"):
        th.fpkm(b2, device="cpu")


def _txi(seed=8, G=60, S=6):
    rng = np.random.default_rng(seed)
    length = rng.uniform(300.0, 3000.0, (G, S))
    abundance = rng.gamma(2.0, 20.0, (G, S))
    counts = abundance * length / 1000.0 * rng.uniform(0.8, 1.2, (1, S))
    return dict(counts=counts, abundance=abundance, length=length,
                countsFromAbundance="no")


def _coldata(S=6):
    return {"condition": np.repeat(["A", "B"], S // 2)}


@pytest.mark.parametrize("robust", [True, False])
def test_fpkm_avg_tx_length_matches_jax(robust):
    txi = _txi()
    a = jdt.dataset_from_tximport(txi, _coldata(), "~ condition")
    b = tdt.dataset_from_tximport(txi, _coldata(), "~ condition")
    close(th.fpkm(b, robust=robust, device="cpu"),
          jh.fpkm(a, robust=robust))


def test_tximport_pipeline_matches_jax():
    """avgTxLength -> gene x sample normalization factors -> deseq(), on
    the port's fused engine, which estimates the factors first as the
    host engine does."""
    txi = _txi()
    a = jdt.dataset_from_tximport(txi, _coldata(), "~ condition")
    b = tdt.dataset_from_tximport(txi, _coldata(), "~ condition")
    na = jdt.estimate_size_factors(a)
    nb = tdt.estimate_size_factors(b, device="cpu")
    assert nb.size_factors is None
    close(nb.normalization_factors, na.normalization_factors)
    ra = jdt.results(jdt.deseq(a))
    rb = tdt.results(tdt.deseq(b, device="cpu"))
    for c in COLS:
        close(rb[c], ra[c])


@pytest.mark.parametrize("mode", ["scaledTPM", "lengthScaledTPM"])
def test_counts_from_abundance_matches_jax(mode):
    txi = _txi()
    want = jh.make_counts_from_abundance(txi["counts"], txi["abundance"],
                                         txi["length"], mode)
    got = th.make_counts_from_abundance(txi["counts"], txi["abundance"],
                                        txi["length"], mode)
    np.testing.assert_array_equal(got, want)
    t2 = dict(txi, counts=got, countsFromAbundance=mode)
    b = tdt.dataset_from_tximport(t2, _coldata(), "~ condition")
    assert "avgTxLength" not in b.assays
    with pytest.raises(ValueError, match="countsFromAbundance"):
        th.make_counts_from_abundance(txi["counts"], txi["abundance"],
                                      txi["length"], "no")


@pytest.mark.parametrize("kw", [dict(alpha=0.05), dict(shift=0.5),
                                dict(alpha=0.05, power=2)],
                         ids=["alpha", "shift", "power2"])
def test_unmix_matches_jax(kw):
    rng = np.random.default_rng(7)
    pure = np.exp(rng.normal(4.0, 1.0, (300, 3)))
    props = np.array([[0.7, 0.2, 0.1], [0.2, 0.5, 0.3], [0.1, 0.1, 0.8]])
    x = pure @ props.T * np.exp(rng.normal(0.0, 0.05, (300, 3)))
    want = jh.unmix(x, pure, return_details=True, **kw)
    got = th.unmix(x, pure, return_details=True, **kw)
    for k in ("mix", "cor", "fitted"):
        close(got[k], want[k])
    assert np.max(np.abs(got["mix"] - props)) < 0.1


def test_unmix_errors_as_jax():
    pure, x = np.ones((10, 2)), np.ones((10, 1))
    for args, kw in (((x, pure), {}), ((x, pure), dict(alpha=1, shift=1)),
                     ((x, np.ones((10, 1))), dict(alpha=1.0)),
                     ((x, pure), dict(alpha=1.0, power=3))):
        with pytest.raises(ValueError) as je:
            jh.unmix(*args, **kw)
        with pytest.raises(ValueError) as te:
            th.unmix(*args, **kw)
        assert str(te.value) == str(je.value)


def test_covariance_matrix_of_fused_fit_matches_jax():
    """The fused engine's fit keeps its columns on the device until
    touched; covariance_matrix reads them and matches JAX, and its
    diagonal is the stored SE^2."""
    a, b = pair(n=80, m=8, seed=11)
    ja = jdt.deseq(a)
    tb = tdt.deseq(b, device="cpu")
    from deseq2_tpu_torch.engine import LazyRowData
    assert isinstance(tb.row_data, LazyRowData)
    for row in (0, 3, 41):
        got = tdt.covariance_matrix(tb, row)
        close(got, jdt.covariance_matrix(ja, row))
        se = np.array([float(tb.row_data[f"SE_{c}"][row])
                       for c in tb.results_names()])
        np.testing.assert_allclose(np.sqrt(np.diag(got)), se, rtol=1e-5)
    bp = tdt.deseq(b, beta_prior=True, device="cpu")
    with pytest.raises(ValueError, match="standard model matrices"):
        tdt.covariance_matrix(bp, 0)


def test_integrate_with_single_cell_as_jax():
    a, b = pair(n=40, m=6, seed=2)
    names = [f"ENSMUSG{i:011d}" for i in range(40)]
    rb = tdt.results(tdt.deseq(b, device="cpu"))
    rb.row_names = names
    ra = jdt.results(jdt.deseq(a))
    ra.row_names = names
    got = tdt.integrate_with_single_cell(rb, b)
    want = jdt.integrate_with_single_cell(ra, a)
    assert got["org"] == want["org"] == "mouse"
    assert got["datasets"] == want["datasets"] and got["datasets"]
    b.metadata["txomeInfo"] = {"organism": "Homo sapiens"}
    assert tdt.integrate_with_single_cell(rb, b, csv_table=[
        dict(org="human", pkg="p")])["datasets"] == [dict(org="human",
                                                          pkg="p")]
    b.metadata["txomeInfo"] = {"organism": "Danio rerio"}
    with pytest.raises(ValueError, match="human and mouse"):
        tdt.integrate_with_single_cell(rb, b)


def test_normalize_gene_length_deprecated():
    with pytest.raises(NotImplementedError, match="deprecated"):
        tdt.normalize_gene_length()


def test_helpers_need_a_card_or_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    _, b = pair(n=30, m=4, seed=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.fpm(b)
