"""The port's fused pipeline variants against the JAX package's, on each
fixture of tests/test_fused_exact.py that covers them: observation
weights (alone, with use_t, with the LRT), gene x sample normalization
factors (alone and with the LRT), the LRT against '~ 1', a one-column
ones matrix and a two-column reduced matrix, use_t, and the local and
mean trends.

Both sides run in float64 on the CPU (the port on device="cpu", its
kernels' plain versions; the JAX package on its XLA cores) on the same
numpy arrays.  Every output of fused_wald_pipeline is compared at rtol
1e-6, atol 1e-9 with equal NaN patterns, the iteration counters exactly
where the gene-wise dispersion is off its floor, and fused_results'
columns likewise.

Weighted fixtures: the gene-wise line search of a gene whose posterior is
flat toward alpha -> 0 can land a little differently (measured on the
weights + use_t / LRT fixture: genes 106 and 193 of 200, where the port
lands on the 1e-8 floor and JAX at 1.188e-8, a relative gap of 0.158 in
dispGeneEst; ROADMAP.md section 3).  There the port's landing must have a
log posterior at least as high as JAX's, in float64; every other column
is held at 1e-6.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import deseq2_tpu as jdt
from deseq2_tpu.parallel import fused as jfused
from deseq2_tpu_torch.ops import disp as tdisp
from deseq2_tpu_torch.parallel import fused as tfused
from torch_threads import one_torch_thread  # noqa: F401

ITER_KEYS = ("dispGeneIter", "dispIter", "betaIter", "betaIterReduced")


def _cmp(a, b, name, rtol=1e-6, atol=1e-9, skip=None):
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    assert a.shape == b.shape, f"{name}: shape {a.shape} != {b.shape}"
    assert np.array_equal(np.isnan(a), np.isnan(b)), \
        f"{name}: NaN pattern differs"
    m = ~np.isnan(a)
    if skip is not None:
        m &= ~skip
    np.testing.assert_allclose(a[m], b[m], rtol=rtol, atol=atol,
                               err_msg=name)


def _sf(dds):
    return np.asarray(jdt.estimate_size_factors(dds).size_factors)


def _example(n, m, seed):
    dds = jdt.make_example_dataset(n=n, m=m, beta_sd=1.0, seed=seed)
    return dds, np.asarray(dds.counts), np.asarray(dds.model_matrix()[0])


def _norm_factors(shape, seed, sd):
    nf = np.exp(np.random.default_rng(seed).normal(0.0, sd, shape))
    return nf / np.exp(np.mean(np.log(nf), axis=1))[:, None]


def _variant(name):
    """(counts, x, size factors, fused_results keyword arguments) of the
    tests/test_fused_exact.py fixture `name`."""
    if name in ("weights",):
        dds, c, x = _example(250, 12, 33)
        w = np.random.default_rng(33).uniform(0.3, 1.0, (250, 12))
        return c, x, _sf(dds), dict(two_group=True, weights=w)
    if name in ("weights_use_t", "weights_lrt"):
        dds, c, x = _example(200, 10, 34)
        w = np.random.default_rng(34).uniform(0.4, 1.0, (200, 10))
        kw = dict(use_t=True) if name == "weights_use_t" \
            else dict(reduced="~ 1")
        return c, x, _sf(dds), dict(two_group=True, weights=w, **kw)
    if name == "norm_factors":
        dds, c, x = _example(250, 12, 11)
        return c, x, None, dict(two_group=True, norm_factors=_norm_factors(
            c.shape, 5, 0.2))
    if name == "norm_factors_lrt":
        dds, c, x = _example(181, 10, 13)
        return c, x, None, dict(two_group=True, reduced="~ 1",
                                norm_factors=_norm_factors(c.shape, 7, 0.15))
    if name == "lrt_intercept":
        dds, c, x = _example(300, 12, 11)
        return c, x, _sf(dds), dict(two_group=True, reduced="~ 1")
    if name == "lrt_ones_matrix":
        dds, c, x = _example(200, 12, 12)
        return c, x, _sf(dds), dict(two_group=True, reduced=np.ones((12, 1)))
    if name == "lrt_two_columns":
        dds, _, _ = _example(200, 12, 13)
        dds.col_data["batch"] = jdt.Factor(np.tile(["1", "2"], 6),
                                           levels=["1", "2"])
        dds.design = jdt.parse_formula("~ batch + condition")
        x = np.asarray(dds.model_matrix()[0])
        return np.asarray(dds.counts), x, _sf(dds), dict(reduced=x[:, :2])
    if name == "use_t":
        dds, c, x = _example(250, 8, 23)
        return c, x, _sf(dds), dict(two_group=True, use_t=True)
    dds, c, x = _example(300, 12, 11)
    return c, x, _sf(dds), dict(two_group=True, fit_type=name)


VARIANTS = ("weights", "weights_use_t", "weights_lrt", "norm_factors",
            "norm_factors_lrt", "lrt_intercept", "lrt_ones_matrix",
            "lrt_two_columns", "use_t", "local", "mean")


def _pipeline_kwargs(kw, x, side):
    """fused_results' arguments as fused_wald_pipeline takes them on
    `side` (jnp for the JAX package, torch for the port)."""
    arr = jnp.asarray if side == "jax" else torch.as_tensor
    out = dict(two_group=kw.get("two_group", False),
               use_t=kw.get("use_t", False),
               fit_type=kw.get("fit_type", "parametric"))
    x_red, red_int = tfused.reduced_args(kw.get("reduced"))
    out.update(x_reduced=None if x_red is None else arr(x_red),
               reduced_intercept=red_int)
    for k in ("weights", "norm_factors"):
        out[k] = None if kw.get(k) is None else arr(kw[k])
    cells = jfused.design_cells(x)
    out["cells"] = cells
    out["linear_mu"] = (kw.get("weights") is None
                        and len(set(cells)) == x.shape[1])
    if side == "jax":
        out["estimate_sf"] = False
    return out


@pytest.fixture(scope="module", params=VARIANTS)
def variant(request):
    c, x, sf, kw = _variant(request.param)
    grid = tfused.default_grid(x.shape[0])
    sf_j = np.ones(x.shape[0]) if sf is None else sf
    j = jfused.fused_wald_pipeline(
        jnp.asarray(c), jnp.asarray(x), jnp.asarray(sf_j), jnp.asarray(grid),
        **_pipeline_kwargs(kw, x, "jax"))
    t = tfused.fused_wald_pipeline(
        torch.as_tensor(c), torch.as_tensor(x),
        torch.as_tensor(sf_j), torch.as_tensor(grid),
        dtype=torch.float64, **_pipeline_kwargs(kw, x, "torch"))
    j = {k: np.asarray(v) for k, v in j.items()}
    t = {k: (v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v))
         for k, v in t.items()}
    return request.param, (c, x, sf, kw), j, t


def _landing_gap(c, x, sf, kw, la_port, la_jax):
    """Genes whose gene-wise dispersion differs beyond 1e-6, and whether
    the port's landing has a log posterior >= JAX's there (float64, at
    the weights and mu the search ran with)."""
    gap = ~np.isclose(la_port, la_jax, rtol=1e-6, atol=1e-9) \
        & ~np.isnan(la_jax)
    if not gap.any():
        return gap, True
    xt = torch.as_tensor(x)
    st = tfused.Stages(xt, torch.as_tensor(sf), torch.as_tensor(
        tfused.default_grid(x.shape[0])), linear_mu=False)
    w = torch.as_tensor(kw["weights"])
    est = st.dispersion_init(torch.as_tensor(c, dtype=torch.float64), w)
    w_ge = torch.clamp(w / w.max(dim=1, keepdim=True).values, min=1e-6)
    rm, cm = tdisp.make_cr_masks(xt, w_ge)

    def lp(disp):
        la = torch.log(torch.as_tensor(disp))
        return tdisp.log_posterior(la, est["y_safe"], est["mu_safe"], xt,
                                   la * 0.0, 1.0, False, w_ge, rm,
                                   cm).numpy()
    lp_p, lp_j = lp(la_port), lp(la_jax)
    return gap, bool(np.all(lp_p[gap] >= lp_j[gap] - 1e-9))


def test_variant_keys_match(variant):
    _, _, j, t = variant
    assert set(j) == set(t)


def test_variant_columns_match(variant):
    name, (c, x, sf, kw), j, t = variant
    floor = ~(j["dispGeneEst"] > 100 * 1e-8)
    skip = None
    if kw.get("weights") is not None:
        skip, higher = _landing_gap(c, x, sf, kw, t["dispGeneEst"],
                                    j["dispGeneEst"])
        assert higher, f"{name}: the port's gene-wise landing is lower"
        assert skip.sum() <= 0.02 * len(skip), int(skip.sum())
    for k in sorted(j):
        if k in ITER_KEYS:
            live = ~floor if skip is None else ~floor & ~skip
            assert np.array_equal(j[k][live], t[k][live]), k
        elif k in ("dispGeneEst",) and skip is not None:
            _cmp(t[k], j[k], f"{name}:{k}", skip=skip)
        else:
            _cmp(t[k], j[k], f"{name}:{k}")


def test_variant_results_match(variant):
    """fused_results (deseq() + results() in one call) on both sides."""
    name, (c, x, sf, kw), _, _ = variant
    jr = jfused.fused_results(c, x, sf, **kw)
    tr = tfused.fused_results(c, x, sf, device="cpu", **kw)
    assert set(jr) == set(tr)
    for k in jr:
        if k == "dispGeneEst" and kw.get("weights") is not None:
            gap, higher = _landing_gap(c, x, sf, kw, tr[k], jr[k])
            assert higher
            _cmp(tr[k], jr[k], f"{name}:{k}", skip=gap)
        elif k in ("replace", "filterNumRej"):
            assert np.array_equal(np.asarray(jr[k]), np.asarray(tr[k])), k
        else:
            _cmp(tr[k], jr[k], f"{name}:{k}")


def test_degenerate_weights_raise():
    """tests/test_fused_exact.py:test_fused_weights_rejects_degenerate_rows:
    a row whose weights empty a design level is refused, naming the row and
    the weightsFail bookkeeping that is not ported."""
    dds = jdt.make_example_dataset(n=50, m=12, beta_sd=1.0, seed=35)
    w = np.ones((50, 12))
    w[3, 6:] = 0.0
    with pytest.raises(ValueError, match=r"weightsFail.*first rows: \[3\]"):
        tfused.fused_results(np.asarray(dds.counts), dds.model_matrix()[0],
                             np.ones(12), two_group=True, weights=w,
                             device="cpu")
    with pytest.raises(ValueError, match="weightsFail"):
        jfused.fused_results(np.asarray(dds.counts), dds.model_matrix()[0],
                             np.ones(12), two_group=True, weights=w)


@pytest.mark.parametrize("case", ["negative", "all_zero_row"])
def test_invalid_weights_raise_as_jax(case):
    dds = jdt.make_example_dataset(n=30, m=8, beta_sd=1.0, seed=36)
    w = np.ones((30, 8))
    if case == "negative":
        w[2, 1] = -0.5
    else:
        w[4] = 0.0
    args = (np.asarray(dds.counts), dds.model_matrix()[0], np.ones(8))
    with pytest.raises(ValueError) as jerr:
        jfused.fused_results(*args, weights=w)
    with pytest.raises(ValueError) as terr:
        tfused.fused_results(*args, weights=w, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_t_p_values_match_jax_betainc():
    """t_two_sided_p (scipy's betainc on the host) against the JAX
    package's jax.scipy.special.betainc at rtol 1e-10, for a shared and a
    per-gene (weighted) df, with NaN statistics and df passing through."""
    from jax.scipy.special import betainc
    rng = np.random.default_rng(0)
    stat = rng.normal(0.0, 4.0, (300, 3))
    stat[5, 1] = np.nan
    df_gene = rng.uniform(0.5, 30.0, 300)
    df_gene[7] = np.nan
    for df in (6.0, df_gene):
        got = tfused.t_two_sided_p(torch.as_tensor(stat), df if isinstance(
            df, float) else torch.as_tensor(df)).numpy()
        d = df if isinstance(df, float) else df[:, None]
        ref = np.asarray(betainc(jnp.asarray(d) / 2.0, 0.5,
                                 jnp.asarray(d / (d + stat * stat))))
        _cmp(got, ref, "t p-values", rtol=1e-10, atol=1e-300)


def test_local_trend_tiles_do_not_change_the_fit():
    """local_trend_eval's row tiles are independent: a tile budget of a few
    rows gives the single-tile answer bit for bit."""
    rng = np.random.default_rng(1)
    bm = torch.as_tensor(np.exp(rng.normal(3.0, 2.0, 500)))
    dge = torch.as_tensor(np.exp(rng.normal(-2.0, 1.0, 500)))
    use = torch.as_tensor(rng.random(500) > 0.1)
    ts = tfused.local_trend_state(bm, dge, use)
    x0 = torch.log(bm)
    whole = tfused.local_trend_eval(ts, x0)
    tiled = tfused.local_trend_eval(ts, x0, tile_bytes=7 * 500 * 8)
    assert torch.equal(whole, tiled)


def test_weights_ok_dev_chunks_match_jax():
    """weights_ok_dev takes its eigenvalues in chunks of EIGH_CHUNK
    matrices (the card's batched eigvalsh refuses large batches and takes
    0.5 MiB of workspace per matrix): over
    more than one chunk, with rank-deficient rows on both sides of the
    chunk boundary and rows whose Cox-Reid column drops out, its mask is
    JAX _weights_ok_dev's."""
    G, S = tfused.EIGH_CHUNK + 616, 8
    rng = np.random.default_rng(37)
    cond = np.repeat([0.0, 1.0], 4)
    x = np.column_stack([np.ones(S), cond, np.tile([0.0, 1.0], 4)])
    w = rng.uniform(0.3, 1.0, (G, S))
    bad = [5, tfused.EIGH_CHUNK - 1, tfused.EIGH_CHUNK, G - 1]
    w[np.ix_(bad, np.where(cond > 0)[0])] = 0.0
    w[np.ix_([6, tfused.EIGH_CHUNK + 1], np.where(cond > 0)[0])] = 1e-3
    ok, neg, nopos = tfused.weights_ok_dev(torch.as_tensor(w),
                                           torch.as_tensor(x))
    jok, jneg, jnopos = jfused._weights_ok_dev(jnp.asarray(w), jnp.asarray(x))
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    assert np.where(~ok.numpy())[0].tolist() == bad
    assert (neg, nopos) == (bool(jneg), bool(jnopos)) == (False, False)
