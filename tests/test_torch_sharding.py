"""The port's gene mesh (deseq2_tpu_torch/parallel/sharding.py) on the CPU.

Meshes of 8 CPU shards stand in for 8 devices, as the JAX tests' 8 forced
host-platform devices do (tests/conftest.py): a GeneMesh may list one
device more than once.  Gene counts are ones 8 does not divide.  The mesh
run is held against the port's single-device run at tests/test_sharding.py's
limits (rtol 1e-8, atol 1e-10, equal NaN patterns) and against the JAX
package's single-device run at the port tests' (rtol 1e-6, atol 1e-9,
tests/test_torch_fused.py).  Iteration counts are compared with the rest:
with no straggler caps on the bulk route, a block iterates each gene as
the whole does.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import deseq2_tpu as jdt
from deseq2_tpu.parallel import fused as jfused
import deseq2_tpu_torch as tdt
from deseq2_tpu_torch.ops import checks
from deseq2_tpu_torch.ops.cuda_grid import fit_disp_grid
from deseq2_tpu_torch.ops.cuda_irls import fit_beta
from deseq2_tpu_torch.ops.cuda_ls import fit_disp_line_search
from deseq2_tpu_torch.ops.placement import active_gene_mesh, use_gene_mesh
from deseq2_tpu_torch.parallel import fused as tfused
from deseq2_tpu_torch.parallel import gene_mesh, sc as tsc
from deseq2_tpu_torch.parallel.sharding import GeneMesh, replicated

CPU = dict(device="cpu")


def _mesh(n=8):
    return gene_mesh(devices=["cpu"] * n)


def _host(v):
    return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _same(got, want, name):
    """The mesh run against the single-device run."""
    np.testing.assert_allclose(np.asarray(got, float),
                               np.asarray(want, float), rtol=1e-8,
                               atol=1e-10, equal_nan=True, err_msg=name)


def _cmp(got, want, name):
    """The port against the JAX package (tests/test_torch_fused.py)."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert got.shape == want.shape, name
    assert np.array_equal(np.isnan(got), np.isnan(want)), name
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=1e-6, atol=1e-9,
                               err_msg=name)


def _sim(G, S, seed):
    """tests/test_sharding.py:_sim."""
    rng = np.random.default_rng(seed)
    S2 = S // 2
    x = np.column_stack([np.ones(S), np.repeat([0.0, 1.0], [S2, S - S2])])
    mu0 = 2.0 ** rng.normal(4.0, 2.0, G)
    disp = 4.0 / mu0 + 0.1
    mu = mu0[:, None] * np.ones((1, S))
    size = 1.0 / disp[:, None]
    counts = rng.negative_binomial(size, size / (size + mu)).astype(np.int64)
    return counts, x, np.ones(S)


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------

def test_blocks_follow_the_jax_layout():
    """Blocks of ceil(G/n) rows, the last ones short or empty (the JAX
    package pads to them); this process runs the non-empty ones, and
    gather undoes split."""
    mesh = _mesh()
    assert mesh.size == 8 and mesh.first_device == torch.device("cpu")
    assert mesh.bounds(251) == [(32 * k, min(32 * k + 32, 251))
                                for k in range(8)]
    assert mesh.bounds(10) == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 10),
                               (10, 10), (10, 10), (10, 10)]
    assert [(lo, hi) for lo, hi, _ in mesh.shards(10)] == mesh.bounds(10)[:5]
    t = torch.arange(30.0).reshape(10, 3)
    parts = mesh.split(t)
    assert [p.shape[0] for p in parts] == [2] * 5
    assert torch.equal(mesh.gather(parts, 10), t)
    assert mesh.split(None, 10) == [None] * 5
    assert [r.shape for r in replicated(mesh, t[0], 10)] == [(3,)] * 5
    with pytest.raises(ValueError, match="at least one device"):
        GeneMesh([])


@pytest.mark.parametrize("entry", ["deseq", "deseq_glmgampoi",
                                   "fused_results", "fused_sc_results",
                                   "use_gene_mesh"])
def test_mesh_must_be_a_gene_mesh(entry):
    counts, x, sf = _sim(40, 6, 1)
    dds = tdt.dataset_from_matrix(counts, {"condition": np.repeat(
        ["A", "B"], 3)}, "~ condition")
    bad = object()
    with pytest.raises(TypeError, match="GeneMesh"):
        if entry == "deseq":
            tdt.deseq(dds, mesh=bad, **CPU)
        elif entry == "deseq_glmgampoi":
            tdt.deseq(dds, test="LRT", reduced="~ 1", fit_type="glmGamPoi",
                      mesh=bad, **CPU)
        elif entry == "fused_results":
            tfused.fused_results(counts, x, mesh=bad, **CPU)
        elif entry == "fused_sc_results":
            tsc.fused_sc_results(counts.astype(np.int32),
                                 cells=np.repeat([0, 1], 3), n_groups=2,
                                 size_factors=sf, mesh=bad, **CPU)
        else:
            with use_gene_mesh(bad):
                pass
    assert active_gene_mesh() is None


def test_mesh_and_device_must_agree():
    counts, x, _ = _sim(40, 6, 1)
    with pytest.raises(ValueError, match="does not match the mesh"):
        tfused.fused_results(counts, x, mesh=_mesh(), device="cuda")


# ---------------------------------------------------------------------------
# the kernel wrappers under use_gene_mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_wrappers_split_under_use_gene_mesh(weighted):
    """K1, K2 and K3 through their wrappers under use_gene_mesh (8 CPU
    shards, 101 genes): each block on its shard, the outputs gathered
    onto the input's device, equal to the call without the mesh."""
    d = checks.as_tensors(checks.solver_inputs(101, 24, 2, 5,
                                               weighted=weighted),
                          torch.float64, "cpu")
    calls = {"irls": lambda: checks.run_irls(fit_beta, d),
             "ls": lambda: checks.run_ls(fit_disp_line_search, d, True),
             "grid": lambda: checks.run_grid(fit_disp_grid, d, True)}
    for name, call in calls.items():
        want = call()
        with use_gene_mesh(_mesh()):
            got = call()
        if torch.is_tensor(want):
            got, want = {"out": got}, {"out": want}
        assert set(got) == set(want)
        for k in want:
            assert got[k].shape == want[k].shape, (name, k)
            _same(got[k], want[k], f"{name} {k}")


# ---------------------------------------------------------------------------
# the fused route
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def wald_runs():
    """tests/test_sharding.py's fixture cut to 251 genes: the JAX
    package's single-device pipeline, the port's single-device run and its
    8-shard mesh run (two-group Cook's, estimated size factors)."""
    counts, x, _ = _sim(256, 8, 13)
    counts = counts[:251]
    cells = tfused.design_cells(x)
    grid = tfused.default_grid(8)
    j = jfused.fused_wald_pipeline(
        jnp.asarray(counts), jnp.asarray(x), jnp.asarray(np.ones(8)),
        jnp.asarray(grid), cells=cells, two_group=True, estimate_sf=True)
    kw = dict(cells=cells, two_group=True, dtype=torch.float64)
    args = (torch.as_tensor(counts), torch.as_tensor(x), None,
            torch.as_tensor(grid))
    one = tfused.fused_wald_pipeline(*args, **kw)
    mesh = tfused.fused_wald_pipeline(*args, mesh=_mesh(), **kw)
    return ({k: np.asarray(v) for k, v in j.items()},
            {k: _host(v) for k, v in one.items()},
            {k: _host(v) for k, v in mesh.items()})


def test_fused_wald_pipeline_mesh_matches_single(wald_runs):
    """Every output, per-gene columns, (G,S) assays and the cross-gene
    scalars (size factors, trend, prior variance, filtering grid)."""
    _, one, mesh = wald_runs
    assert set(mesh) == set(one)
    for k in one:
        assert mesh[k].shape == one[k].shape, k
        _same(mesh[k], one[k], k)


def test_fused_wald_pipeline_mesh_matches_jax(wald_runs):
    j, _, mesh = wald_runs
    floor = ~(j["dispGeneEst"] > 100 * 1e-8)
    for k in sorted(set(j) & set(mesh)):
        if k in ("dispGeneIter", "dispIter", "betaIter"):
            assert np.array_equal(j[k][~floor], mesh[k][~floor]), k
        else:
            _cmp(mesh[k], j[k], k)


def _variant(name, G=301, S=12):
    """(counts, x, keyword arguments) of a run_fused_sharded variant."""
    rng = np.random.default_rng(7)
    counts, x, sf = _sim(G, S, 23)
    if name == "weights":
        w = rng.uniform(0.3, 1.0, counts.shape)
        return counts, x, dict(weights=w, size_factors=sf)
    batch = np.tile([0.0, 1.0], S // 2)
    xb = np.column_stack([x[:, 0], batch, x[:, 1]])
    if name == "lrt_nf":
        nf = np.exp(rng.normal(0, 0.2, counts.shape))
        nf /= np.exp(np.mean(np.log(nf), axis=1))[:, None]
        return counts, xb, dict(reduced=xb[:, :2], norm_factors=nf,
                                size_factors=None)
    if name == "beta_prior":
        return counts, x, dict(beta_prior=True, size_factors=sf)
    return counts, xb, dict(reduced="~ 1", use_t=True, size_factors=None)


@pytest.mark.parametrize("name", ["weights", "lrt_nf", "beta_prior",
                                  "lrt_use_t"])
def test_run_fused_sharded_matches_single(name):
    """run_fused_sharded with observation weights, the LRT against a
    reduced matrix with (G,S) normalization factors, betaPrior (the beta
    prior's quantile over the gathered MLE betas, the expanded refit per
    block) and the LRT against ~ 1 with t p-values: every output of the
    single-device pipeline."""
    counts, x, kw = _variant(name)
    sf = kw.pop("size_factors")
    cells = tfused.design_cells(x)
    out = tfused.run_fused_sharded(counts, x, sf, _mesh(), cells=cells,
                                   **kw)
    red = kw.pop("reduced", None)
    x_red, red_int = tfused.reduced_args(red)
    one = tfused.fused_wald_pipeline(
        torch.as_tensor(counts), torch.as_tensor(x),
        None if sf is None else torch.as_tensor(sf),
        torch.as_tensor(tfused.default_grid(x.shape[0])), cells=cells,
        linear_mu=len(set(cells)) == x.shape[1],
        x_reduced=None if x_red is None else torch.as_tensor(x_red),
        reduced_intercept=red_int, **kw)
    assert set(out) == set(one)
    for k, v in one.items():
        _same(out[k], _host(v), f"{name} {k}")


def test_fused_results_on_mesh_matches_single_and_jax():
    """fused_results with independent filtering: the theta grid and the
    filtering quantiles over the gathered G genes (no padding rows to
    leave out), so padj and the chosen threshold equal the single-device
    run's, and the JAX package's; the outlier fixture of
    tests/test_torch_fused.py (refits in some blocks only)."""
    dds = jdt.make_example_dataset(n=300, m=14, beta_sd=1.0, seed=7)
    counts = np.asarray(dds.counts).copy()
    rng = np.random.default_rng(3)
    for i in rng.choice(300, 8, replace=False):
        counts[i, int(rng.integers(14))] = int(counts[i].mean() * 40 + 500)
    x = np.asarray(jdt.DESeqDataSet(counts, dict(dds.col_data),
                                    dds.design).model_matrix()[0], float)
    got = tfused.fused_results(counts, x, two_group=True, mesh=_mesh(),
                               **CPU)
    one = tfused.fused_results(counts, x, two_group=True, **CPU)
    j = jfused.fused_results(counts, x, None, two_group=True)
    assert set(got) == set(one) == set(j)
    assert got["replace"].sum() >= 4
    for k in one:
        _same(got[k], one[k], k)
        if k == "replace":
            assert np.array_equal(np.asarray(j[k]), got[k])
        else:
            _cmp(got[k], j[k], k)


# ---------------------------------------------------------------------------
# the public deseq() on every route
# ---------------------------------------------------------------------------

def _datasets():
    j = jdt.make_example_dataset(n=300, m=12, beta_sd=1.0, seed=42)
    counts = np.asarray(j.counts)
    labels = np.asarray(j.col_data["condition"].levels)[
        j.col_data["condition"].codes]
    return j, tdt.dataset_from_matrix(counts, {"condition": labels},
                                      "~ condition")


@pytest.mark.parametrize("engine", ["fused", "host", "auto"])
def test_deseq_on_mesh_matches_single_and_jax(engine):
    """deseq(mesh=...) + results(): the fused route, the host engine (its
    batched fits under use_gene_mesh) and "auto" falling back to the host
    engine with the mesh (two rows whose weights fail the rank tests)
    give the single-device fit's row_data and results, and the JAX
    package's single-device ones (engine "fused" or "host")."""
    j, t = _datasets()
    if engine == "auto":
        w = np.ones(j.counts.shape)
        w[3, 6:] = 0.0
        w[10, :6] = 0.0
        j.assays["weights"] = w
        t.assays["weights"] = w
    fit = tdt.deseq(t, engine=None if engine == "auto" else engine,
                    mesh=_mesh(), **CPU)
    one = tdt.deseq(t, engine=None if engine == "auto" else engine, **CPU)
    assert fit.attrs["engine"] == one.attrs["engine"] == (
        "fused" if engine == "fused" else "host")
    assert fit.assays["mu"].shape == one.assays["mu"].shape
    for k in one.row_data:
        _same(fit.row_data[k], one.row_data[k], k)
    res, r1 = tdt.results(fit), tdt.results(one)
    jf = jdt.deseq(j, engine="fused" if engine == "fused" else "host")
    jr = jdt.results(jf)
    for c in r1.column_names:
        _same(res[c], r1[c], f"results {c}")
        _cmp(res[c], jr[c], f"results {c} vs JAX")
    if engine == "auto":
        assert np.where(fit.row_data["weightsFail"])[0].tolist() == [3, 10]
    shr = tdt.lfc_shrink(fit, coef="condition_B_vs_A", type="normal")
    _same(shr["log2FoldChange"],
          tdt.lfc_shrink(one, coef="condition_B_vs_A",
                         type="normal")["log2FoldChange"], "lfc_shrink")
