"""The port's plot data functions against the JAX package's, on the same
seeded inputs (after tests/test_plots.py): plotDispEsts, plotMA, plotPCA
(on a transform whose payload is still a tensor: the top-variance genes
are picked where it lies), plotCounts and plotSparsity.  Drawing is
checked only where matplotlib is installed.

float64 on the CPU on both sides, held at rtol 1e-6 (atol 1e-9); the PCA
coordinates up to the sign of each component (an SVD's sign is
arbitrary).
"""

import numpy as np
import pytest
import torch

import deseq2_tpu as jdt
import deseq2_tpu.plots as jp
import deseq2_tpu_torch as tdt
import deseq2_tpu_torch.plots as tp

RTOL, ATOL = 1e-6, 1e-9


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol)


@pytest.fixture(scope="module")
def fitted():
    kw = dict(n=1100, m=8, beta_sd=1.0, intercept_mean=6.0, intercept_sd=1.0,
              seed=31)
    a = jdt.deseq(jdt.make_example_dataset(**kw))
    b = tdt.deseq(tdt.make_example_dataset(**kw), device="cpu")
    return a, b, jdt.results(a), tdt.results(b)


def test_plot_disp_ests_data_matches_jax(fitted):
    a, b, _, _ = fitted
    want, got = jp.plot_disp_ests_data(a), tp.plot_disp_ests_data(b)
    for k in ("base_mean", "gene_est", "fitted", "final"):
        close(got[k], want[k])
    np.testing.assert_array_equal(got["outlier"], want["outlier"])
    with pytest.raises(ValueError, match="estimate_dispersions"):
        tp.plot_disp_ests_data(tdt.make_example_dataset(n=10, m=4))


def test_plot_ma_data_matches_jax(fitted):
    _, _, ra, rb = fitted
    for alpha in (None, 0.05):
        want = jp.plot_ma_data(ra, alpha=alpha)
        got = tp.plot_ma_data(rb, alpha=alpha)
        close(got["mean"], want["mean"])
        close(got["lfc"], want["lfc"])
        np.testing.assert_array_equal(got["is_de"], want["is_de"])
        assert got["alpha"] == want["alpha"]
        assert got["is_de"].sum() > 0


@pytest.mark.parametrize("payload", ["tensor", "host"])
def test_plot_pca_data_matches_jax(fitted, payload):
    a, b, _, _ = fitted
    ja = jdt.vst(a, nsub=1000)
    tb = tdt.vst(b, nsub=1000, device="cpu")
    if payload == "host":
        tb.matrix                      # downloads: the numpy branch
        assert isinstance(tb.matrix_device, np.ndarray)
    else:
        assert torch.is_tensor(tb.matrix_device)
    want = jp.plot_pca_data(ja, intgroup="condition", ntop=200)
    got = tp.plot_pca_data(tb, intgroup="condition", ntop=200)
    for k in ("x", "y"):
        s = np.sign(np.dot(got[k], want[k]))
        close(s * got[k], want[k])
    close(got["percent_var"], want["percent_var"])
    assert list(got["group"]) == list(want["group"])
    assert got["sample_names"] == want["sample_names"]
    if payload == "tensor":
        assert torch.is_tensor(tb.matrix_device)   # .matrix not touched
    with pytest.raises(ValueError, match="intgroup"):
        tp.plot_pca_data(tb, intgroup="missing_column")


def test_plot_pca_data_float32_payload_matches_host():
    """A float32 payload on the device: the same PCs as the float64 host
    computation, up to sign, at float32 precision (5e-4 absolute on
    coordinates of order 10; the same top genes)."""
    b = tdt.make_example_dataset(n=300, m=10, beta_sd=1.0, seed=6)
    t64 = tdt.norm_transform(b, device="cpu")
    b32 = b.copy()
    b32.config = tdt.DESeqConfig(dtype="float32")
    t32 = tdt.norm_transform(b32, device="cpu")
    assert t32.matrix_device.dtype == torch.float32
    host = tdt.DESeqTransform(t64.matrix, t64.col_data, t64.row_names,
                              t64.col_names)
    want = tp.plot_pca_data(host, ntop=100)
    got = tp.plot_pca_data(t32, ntop=100)
    for k in ("x", "y"):
        a, c = np.asarray(want[k]), np.asarray(got[k])
        assert min(np.max(np.abs(a - c)), np.max(np.abs(a + c))) < 5e-4
    np.testing.assert_allclose(got["percent_var"], want["percent_var"],
                               atol=1e-5)


def test_plot_counts_data_matches_jax(fitted):
    a, b, _, _ = fitted
    for gene in (0, "gene5"):
        for kw in (dict(), dict(normalized=False, transform=False),
                   dict(replaced=True)):
            want = jp.plot_counts_data(a, gene, **kw)
            got = tp.plot_counts_data(b, gene, **kw)
            close(got["count"], want["count"])
            assert list(got["group"]) == list(want["group"])
            assert got["gene"] == want["gene"]
    with pytest.raises(ValueError, match="not found"):
        tp.plot_counts_data(b, "not_a_gene")
    raw = tdt.make_example_dataset(n=50, m=6, seed=2)
    close(tp.plot_counts_data(raw, 3, device="cpu")["count"],
          jp.plot_counts_data(jdt.make_example_dataset(n=50, m=6, seed=2),
                              3)["count"])


@pytest.mark.parametrize("normalized", [True, False])
def test_plot_sparsity_data_matches_jax(normalized):
    a = jdt.make_example_dataset(n=200, m=6, seed=4)
    b = tdt.make_example_dataset(n=200, m=6, seed=4)
    want = jp.plot_sparsity_data(a, normalized=normalized)
    got = tp.plot_sparsity_data(b, normalized=normalized, device="cpu")
    for k in ("sum", "max_prop"):
        close(got[k], want[k])


def test_drawing(fitted):
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    _, b, _, rb = fitted
    assert tp.plot_disp_ests(b) is not None
    assert tp.plot_ma(rb, ylim=(-3, 3)) is not None
    assert tp.plot_pca(tdt.vst(b, nsub=1000, device="cpu")) is not None
    assert tp.plot_counts(b, "gene5") is not None
    assert tp.plot_sparsity(b) is not None
