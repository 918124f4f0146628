"""Checkpoint files move between the two packages both ways: a dataset or
results table saved by deseq2_tpu loads in deseq2_tpu_torch and the
reverse, at each pipeline stage (raw, size factors, dispersions with the
parametric and local trends, a whole fit, a results table), including a
dataset fitted by the port's fused engine, whose assays and columns are
still on the device when it is saved.  A loaded dataset carries no device
state, and the pipeline resumes from it.

The same .npz + JSON format on both sides: arrays round-trip bit for bit
(rtol 0); a resumed pipeline is held to the straight-through one at rtol
1e-6 (atol 1e-9), float64 on the CPU.
"""

import numpy as np
import pytest
import torch

import deseq2_tpu as jdt
import deseq2_tpu_torch as tdt
from deseq2_tpu_torch.engine import DeviceArray, LazyRowData
from torch_threads import one_torch_thread  # noqa: F401

PKGS = {"jax": jdt, "torch": tdt}
KW = {"jax": {}, "torch": {"device": "cpu"}}


def _fitted(name, stage):
    dt, kw = PKGS[name], KW[name]
    dds = dt.make_example_dataset(n=120, m=8, seed=11)
    if stage == "raw":
        return dds
    dds = dt.estimate_size_factors(dds, **kw)
    if stage == "size_factors":
        return dds
    if stage.startswith("dispersions"):
        fit_type = stage.split("_")[1]
        return dt.estimate_dispersions(dds, fit_type=fit_type, **kw)
    return dt.deseq(dds, **kw)


def _host(v):
    return np.asarray(v.tensor.cpu() if isinstance(v, DeviceArray) else v)


def _assert_same(a, b, fn_ref=None):
    """`b` holds `a`'s arrays bit for bit; its dispersion function equals
    `fn_ref`'s (the writer's own reload: the file keeps a local trend as a
    dense log-log grid, so any reload is held to the reload)."""
    np.testing.assert_array_equal(np.asarray(a.counts), np.asarray(b.counts))
    assert a.row_names == b.row_names and a.col_names == b.col_names
    assert str(a.design) == str(b.design)
    assert set(a.row_data) == set(b.row_data)
    for k in a.row_data:
        np.testing.assert_array_equal(
            np.asarray(a.row_data[k], np.float64),
            np.asarray(b.row_data[k], np.float64), err_msg=k)
    assert set(a.assays) == set(b.assays)
    for k in a.assays:
        np.testing.assert_array_equal(_host(a.assays[k]), _host(b.assays[k]),
                                      err_msg=k)
    for k, v in a.col_data.items():
        w = b.col_data[k]
        if hasattr(v, "levels"):
            assert list(v.levels) == list(w.levels)
            np.testing.assert_array_equal(v.codes, w.codes)
        else:
            np.testing.assert_array_equal(np.asarray(v), np.asarray(w))
    fa, fb = (fn_ref or a).dispersion_function, b.dispersion_function
    assert (fa is None) == (fb is None)
    if fa is not None:
        assert fa.fit_type == fb.fit_type
        m = np.array([0.5, 1.0, 10.0, 300.0])
        np.testing.assert_allclose(fb(m), fa(m), rtol=1e-12)


STAGES = ["raw", "size_factors", "dispersions_parametric",
          "dispersions_local", "deseq"]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
@pytest.mark.parametrize("stage", STAGES)
def test_dataset_moves_between_packages(tmp_path, writer, reader, stage):
    dds = _fitted(writer, stage)
    path = tmp_path / "dds.npz"
    PKGS[writer].save_dataset(dds, path)
    back = PKGS[reader].load_dataset(path)
    assert type(back).__module__.startswith(
        "deseq2_tpu_torch" if reader == "torch" else "deseq2_tpu.")
    assert getattr(back, "_counts_dev", None) is None
    ref = PKGS[writer].load_dataset(path)
    _assert_same(dds, back, ref)
    if stage != "dispersions_local":
        _assert_same(dds, back)
    # and back again, into the writer's package
    again = tmp_path / "again.npz"
    PKGS[reader].save_dataset(back, again)
    _assert_same(dds, PKGS[writer].load_dataset(again), ref)


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_results_move_between_packages(tmp_path, writer, reader):
    dt, kw = PKGS[writer], KW[writer]
    res = dt.results(dt.deseq(dt.make_example_dataset(n=120, m=8, seed=11),
                              **kw))
    path = tmp_path / "res.npz"
    dt.save_results(res, path)
    back = PKGS[reader].load_results(path)
    assert back.column_names == res.column_names
    for c in res.column_names:
        np.testing.assert_array_equal(np.asarray(back[c], np.float64),
                                      np.asarray(res[c], np.float64),
                                      err_msg=c)
    assert back.row_names == res.row_names
    assert back.prior_info == jdt.io._jsonable(res.prior_info)
    assert back.metadata.keys() == \
        PKGS[writer].load_results(path).metadata.keys()


def test_fused_fit_with_device_state_saves(tmp_path):
    """The port's fused engine leaves its assays as DeviceArrays, its
    per-gene columns in a LazyRowData and the counts' device copy on the
    fit: all are downloaded before writing, the JAX package loads the file
    to the same columns as its own fit, and the reloaded port dataset
    carries no device state and resumes to the same Wald test."""
    b = tdt.deseq(tdt.make_example_dataset(n=120, m=8, seed=11),
                  device="cpu")
    assert isinstance(b.row_data, LazyRowData) and b._counts_dev is not None
    assert isinstance(b.assays["mu"], DeviceArray)
    path = tmp_path / "fused.npz"
    tdt.save_dataset(b, path)
    j = jdt.load_dataset(path)
    h = jdt.deseq(jdt.make_example_dataset(n=120, m=8, seed=11))
    for k in ("dispersion", "dispGeneEst", "dispFit", "baseMean",
              "condition_B_vs_A", "SE_condition_B_vs_A"):
        np.testing.assert_allclose(np.asarray(j.row_data[k], float),
                                   np.asarray(h.row_data[k], float),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(np.asarray(j.assays["mu"]),
                               np.asarray(h.assays["mu"]), rtol=1e-6)
    t = tdt.load_dataset(path)
    assert getattr(t, "_counts_dev", None) is None
    assert not any(isinstance(v, DeviceArray) for v in t.assays.values())
    assert not any(torch.is_tensor(v) for v in t.row_data.values())
    resumed = tdt.nbinom_wald_test(t, device="cpu")
    for k in ("WaldStatistic_condition_B_vs_A",
              "WaldPvalue_condition_B_vs_A"):
        np.testing.assert_allclose(resumed.row_data[k], b.row_data[k],
                                   rtol=1e-6, atol=1e-9, err_msg=k)


def test_tensor_attrs_are_downloaded(tmp_path):
    b = tdt.make_example_dataset(n=30, m=6, seed=2)
    b.attrs["someMatrix"] = torch.arange(6.0)
    b.assays["extra"] = DeviceArray(torch.ones(30, 6, dtype=torch.float64))
    path = tmp_path / "t.npz"
    tdt.save_dataset(b, path)
    j = jdt.load_dataset(path)
    np.testing.assert_array_equal(j.attrs["someMatrix"], np.arange(6.0))
    np.testing.assert_array_equal(j.assays["extra"], np.ones((30, 6)))


def test_frozen_vst_across_packages(tmp_path):
    """A trend saved by the JAX package re-applies in the port's VST
    (blind=False) as in the JAX package's (R/vst.R:69-77)."""
    a = jdt.estimate_dispersions(jdt.estimate_size_factors(
        jdt.make_example_dataset(n=120, m=8, seed=11)))
    path = tmp_path / "fit.npz"
    jdt.save_dataset(a, path)
    want = jdt.variance_stabilizing_transformation(a, blind=False).matrix
    got = tdt.variance_stabilizing_transformation(
        tdt.load_dataset(path), blind=False, device="cpu").matrix
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)


def test_newer_format_refused(tmp_path):
    import json
    b = tdt.make_example_dataset(n=10, m=4, seed=1)
    path = tmp_path / "new.npz"
    tdt.save_dataset(b, path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays["__meta__"]).decode())
    meta["format_version"] = tdt.io._FORMAT_VERSION + 1
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez_compressed(path, **arrays)
    with pytest.raises(ValueError, match="newer"):
        tdt.load_dataset(path)
    assert tdt.io._FORMAT_VERSION == jdt.io._FORMAT_VERSION
