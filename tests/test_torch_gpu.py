"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card.  Marked `gpu`: without a card each test skips (the check runs in
a fixture, not at import).  Run them on a machine with one:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

The inputs, readings and limits are those of chip_smoke.py's kernel phase,
from deseq2_tpu_torch/ops/checks.py: float64 holds the kernels to the plain
versions' trajectories; float32 holds kernel and plain version alike
against the plain version run in float64.  Every kernel runs unweighted
and weighted (observation weights, with forced Cox-Reid column drops for
p >= 2).  Every kernel also runs at checks.EDGES (sample counts where a
warp's lanes wrap, p = 5 and 8), where the float32 readings that rounding
alone fails (checks.ROUNDING_BOUND) hold K1 to the float64 fit and leave
K2's and K3's out, and twice on the same inputs, where its outputs must be
the same bit for bit.  K2 and K3 also run in their other modes (without
the Cox-Reid term; the weighted row cut at 0.5), the wrappers' p > 8
routes (the wide kernels for p <= 16, the plain version past 16) are held
to the CPU, a paired p = 10 call on a 2-block mesh to the single-device
call, and the host engine's deseq(engine="host") on the card to the same
call with device="cpu".  K1 at the quasi-likelihood
fits' minmu = 1e-6 is held to its plain version, and the streamed
single-cell path on the card to the CPU (float64) and to bench.py's
single-cell gate (float32).
"""

import numpy as np
import pytest
import torch

from deseq2_tpu_torch.ops import checks, disp, irls
from deseq2_tpu_torch.ops.cuda_grid import fit_disp_grid
from deseq2_tpu_torch.ops.cuda_irls import fit_beta
from deseq2_tpu_torch.ops.cuda_ls import fit_disp_line_search

pytestmark = pytest.mark.gpu

MIN_LA = checks.MIN_LA


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


def _inputs(G, S, p, seed, dtype, dev, weighted=False):
    return checks.as_tensors(checks.solver_inputs(G, S, p, seed,
                                                  weighted=weighted),
                             dtype, dev)


CASES = [(dt, p, S, G, wt) for wt in (False, True)
         for dt in (torch.float32, torch.float64)
         for p in (1, 2, 3) for S, G in checks.SHAPES]
EDGE_CASES = [(dt, p, S, G, wt) for wt in (False, True)
              for dt in (torch.float32, torch.float64)
              for S, G, p in checks.EDGES]


def _rounding_bound(kernel, case, use_prior=None):
    dt, p, S, _, wt = case
    return dt == torch.float32 and (kernel, S, p, wt,
                                    use_prior) in checks.ROUNDING_BOUND


LS_CASES = [(c, u) for c in CASES + EDGE_CASES for u in (False, True)
            if not _rounding_bound("disp_ls", c, u)]
# K3 also at sample counts where a gene's x, y and mu (and weights) take
# just under 48 KB, the shared memory a block gets without opting in
WIDE_GRID_CASES = [(dt, p, S, 64, wt) for wt in (False, True)
                   for dt, p, S in ((torch.float32, 2, 3072),
                                    (torch.float64, 2, 1536),
                                    (torch.float32, 1, 4096),
                                    (torch.float64, 1, 2048))]
GRID_CASES = [(c, u) for c in CASES + EDGE_CASES for u in (False, True)
              if not _rounding_bound("disp_grid", c, u)] + [
                  (c, False) for c in WIDE_GRID_CASES]


def _id(c):
    return f"{str(c[0])[6:]}-p{c[1]}-S{c[2]}" + ("-w" if c[4] else "")


def _counter(fn, weighted):
    return fn.launches_weighted if weighted else fn.launches


@pytest.mark.parametrize("case", CASES + EDGE_CASES, ids=_id)
def test_irls_kernel_matches_plain(cuda, case):
    dt, p, S, G, wt = case
    d = _inputs(G, S, p, 10 * p + S, dt, cuda, wt)
    n0 = _counter(fit_beta, wt)
    k = checks.run_irls(fit_beta, d)
    torch.cuda.synchronize()
    assert _counter(fit_beta, wt) == n0 + 1
    pl = checks.run_irls(irls.fit_beta_plain, d)
    if _rounding_bound("irls", case):
        ref = checks.run_irls(irls.fit_beta_plain,
                              _inputs(G, S, p, 10 * p + S, torch.float64,
                                      cuda, wt))
        r = checks.check_irls_f64(k, pl, ref)
    else:
        r = checks.check_irls(k, pl)
    assert r["ok"], r
    if dt == torch.float64:
        conv = (k["iter"] < 100) & (pl["iter"] < 100)
        torch.testing.assert_close(k["hat_diag"][conv], pl["hat_diag"][conv],
                                   rtol=1e-7, atol=1e-10)
        torch.testing.assert_close(k["beta_var"][conv], pl["beta_var"][conv],
                                   rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("case,use_prior", LS_CASES,
                         ids=[f"{u}-{_id(c)}" for c, u in LS_CASES])
def test_line_search_kernel_matches_plain(cuda, case, use_prior):
    dt, p, S, G, wt = case
    d = _inputs(G, S, p, 10 * p + S, dt, cuda, wt)
    n0 = _counter(fit_disp_line_search, wt)
    k = checks.run_ls(fit_disp_line_search, d, use_prior)
    torch.cuda.synchronize()
    assert _counter(fit_disp_line_search, wt) == n0 + 1
    pl = checks.run_ls(disp.fit_disp_line_search_plain, d, use_prior)
    ref = (checks.line_search_reference(d, use_prior)
           if dt == torch.float32 else None)
    r = checks.check_ls(k, pl, d, use_prior, ref=ref)
    assert r["ok"], r


@pytest.mark.parametrize("case,use_prior", GRID_CASES,
                         ids=[f"{_id(c)}-{u}" for c, u in GRID_CASES])
def test_grid_kernel_matches_plain(cuda, case, use_prior):
    dt, p, S, G, wt = case
    d = _inputs(G, S, p, 10 * p + S, dt, cuda, wt)
    n0 = _counter(fit_disp_grid, wt)
    k = checks.run_grid(fit_disp_grid, d, use_prior)
    torch.cuda.synchronize()
    assert _counter(fit_disp_grid, wt) == n0 + 1
    pl = checks.run_grid(disp.fit_disp_grid_plain, d, use_prior)
    ref = (checks.grid_reference(d, use_prior)
           if dt == torch.float32 else None)
    r = checks.check_grid(k, pl, d, use_prior, ref=ref)
    assert r["ok"], r


@pytest.mark.parametrize("weighted", [False, True])
def test_empty_call_not_counted(cuda, weighted):
    """A call with no genes launches no kernel, and no counter moves."""
    d = _inputs(8, 24, 2, 0, torch.float64, cuda, weighted)
    e = {k: v if k in ("x", "grid") else v[:0] for k, v in d.items()}
    calls = ((fit_beta, lambda: checks.run_irls(fit_beta, e)),
             (fit_disp_line_search,
              lambda: checks.run_ls(fit_disp_line_search, e, True)),
             (fit_disp_grid,
              lambda: {"log_alpha": checks.run_grid(fit_disp_grid, e, True)}))
    for fn, call in calls:
        n0 = _counter(fn, weighted)
        out = call()
        assert all(len(v) == 0 for v in out.values()), fn.__name__
        assert _counter(fn, weighted) == n0, fn.__name__


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dt", [torch.float32, torch.float64],
                         ids=["float32", "float64"])
def test_kernels_repeatable(cuda, dt, weighted):
    """Two launches of K1, of K2 and of K3 on the same inputs give the
    same outputs bit for bit (no atomics in any sum; which warp takes which
    gene or grid point changes no result), at few, wrapping and many
    samples."""
    def grid(d):
        return {"log_alpha": checks.run_grid(fit_disp_grid, d, True)}

    for S, G, p in ((24, 333, 2),) + checks.EDGES[1::3] + ((3000, 301, 3),):
        d = _inputs(G, S, p, 10 * p + S, dt, cuda, weighted)
        pairs = [(checks.run_irls(fit_beta, d), checks.run_irls(fit_beta, d)),
                 (checks.run_ls(fit_disp_line_search, d, True),
                  checks.run_ls(fit_disp_line_search, d, True)),
                 (grid(d), grid(d))]
        for a, b in pairs:
            assert checks.differing_outputs(a, b) == [], (S, p)


def test_wrapper_refuses_unsupported(cuda):
    """A dtype the kernels do not take raises; a design wider than 16
    columns is not refused: K2 takes the p > 16 route (the plain version
    on the card, counted in launches_plain)."""
    d = _inputs(8, 24, 2, 0, torch.float32, cuda)
    with pytest.raises(TypeError):
        fit_disp_grid(d["y"].half(), d["x"].half(), d["mu"].half(),
                      d["grid"].half(), d["pm"].half(), 1.0)
    x17 = torch.ones(24, 17, device=cuda)
    n0 = fit_disp_line_search.launches_plain
    out = fit_disp_line_search(d["y"], x17, d["mu"], d["la0"], d["pm"], 1.0,
                               MIN_LA)
    assert out["log_alpha"].is_cuda
    assert fit_disp_line_search.launches_plain == n0 + 1


# K2's and K3's other modes (checks.MODES): without the Cox-Reid term,
# unweighted and weighted, and the weighted Cox-Reid row cut at 0.5
MODE_CASES = [(m, c, u) for m, wt in (("nocr", False), ("nocr", True),
                                      ("thr", True))
              for c in CASES + EDGE_CASES if c[4] == wt
              for u in (False, True)]
MODE_COUNTER = {("nocr", False): "launches_nocr",
                ("nocr", True): "launches_weighted_nocr",
                ("thr", True): "launches_threshold"}


@pytest.mark.parametrize("mode,case,use_prior", MODE_CASES,
                         ids=[f"{m}-{u}-{_id(c)}" for m, c, u in MODE_CASES])
def test_kernel_modes_match_plain(cuda, mode, case, use_prior):
    """K2 and K3 without the Cox-Reid term and at the 0.5 weight threshold
    against their plain versions in the same mode (phase 3's readings and
    limits), each launch counted in its mode's counter."""
    dt, p, S, G, wt = case
    d = checks.with_mode(_inputs(G, S, p, 10 * p + S + 7, dt, cuda, wt),
                         mode)
    counter = MODE_COUNTER[(mode, wt)]
    n2 = getattr(fit_disp_line_search, counter)
    n3 = getattr(fit_disp_grid, counter)
    k2 = checks.run_ls(fit_disp_line_search, d, use_prior)
    k3 = checks.run_grid(fit_disp_grid, d, use_prior)
    torch.cuda.synchronize()
    assert getattr(fit_disp_line_search, counter) == n2 + 1
    assert getattr(fit_disp_grid, counter) == n3 + 1
    f32 = dt == torch.float32
    r2 = checks.check_ls(
        k2, checks.run_ls(disp.fit_disp_line_search_plain, d, use_prior), d,
        use_prior, ref=checks.line_search_reference(d, use_prior)
        if f32 else None)
    r3 = checks.check_grid(
        k3, checks.run_grid(disp.fit_disp_grid_plain, d, use_prior), d,
        use_prior, ref=checks.grid_reference(d, use_prior) if f32 else None)
    assert r2["ok"], r2
    assert r3["ok"], r3


@pytest.mark.parametrize("p", [9, 10, 16, 17])
@pytest.mark.parametrize("weighted", [False, True])
def test_wide_route_on_card_matches_cpu(cuda, weighted, p):
    """Past p = 8 each wrapper takes its route by p: for p <= 16 the wide
    kernels (K1 counted in launches_wide, K2 and K3 in their mode's
    _wide count), past 16 the plain version on the card
    (launches_plain).  Each is held to the same wrapper on the CPU (its
    plain version) with phase 3's float64 readings (checks.check_irls,
    check_ls, check_grid), and output by output: K1's deviance and every
    gene's K2 and K3 log alpha as before, and K1's beta, beta_var,
    hat_diag and mu, on the genes converged on both, off the first ten
    genes, whose weights put 1e-3 on half the samples
    (checks.solver_inputs): their wide weighted designs are
    ill-conditioned enough that the card's and the CPU's rounding moves a
    beta by ~4e-6 relative, and the deviance by ~1.3e-8 relative."""
    from deseq2_tpu_torch.ops.cuda_ls import mode_counter
    raw = checks.solver_inputs(64, 40, p, 5, weighted=weighted)
    card = checks.as_tensors(raw, torch.float64, cuda)
    cpu = checks.as_tensors(raw, torch.float64, torch.device("cpu"))
    w = card.get("w")
    names = ["launches_wide" if p <= 16 else "launches_plain"]
    names += [mode_counter(w, True, checks.CR_WEIGHT_THRESHOLD, p)
              if p <= 16 else "launches_plain"] * 2
    fns = (fit_beta, fit_disp_line_search, fit_disp_grid)
    before = [getattr(f, n) for f, n in zip(fns, names)]
    k1 = {k: v.cpu() for k, v in checks.run_irls(fit_beta, card).items()}
    k2 = {k: v.cpu() for k, v in checks.run_ls(fit_disp_line_search, card,
                                               True).items()}
    k3 = checks.run_grid(fit_disp_grid, card, True).cpu()
    assert [getattr(f, n) for f, n in zip(fns, names)] == \
        [v + 1 for v in before]
    c1 = checks.run_irls(fit_beta, cpu)
    c2 = checks.run_ls(fit_disp_line_search, cpu, True)
    c3 = checks.run_grid(fit_disp_grid, cpu, True)
    for r in (checks.check_irls(k1, c1), checks.check_ls(k2, c2, cpu, True),
              checks.check_grid(k3, c3, cpu, True)):
        assert r["ok"], r
    well = slice(10 if weighted else 0, None)
    conv = (k1["iter"] < 100) & (c1["iter"] < 100)
    for key, rows, tol in (("beta", well, 1e-6), ("deviance", well, 1e-9),
                           ("deviance", slice(None), 1e-7),
                           ("beta_var", well, 1e-6),
                           ("hat_diag", well, 1e-6),
                           ("mu", well, 1e-6)):
        torch.testing.assert_close(k1[key][rows][conv[rows]],
                                   c1[key][rows][conv[rows]], rtol=tol,
                                   atol=1e-8, equal_nan=True, msg=key)
    for a, b in ((k2["log_alpha"], c2["log_alpha"]), (k3, c3)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8,
                                   equal_nan=True)


@pytest.mark.parametrize("engine", ["fused", "host"])
def test_paired_mesh_on_card_matches_single(cuda, engine):
    """The paired design ~ subject + condition at p = 10 (the wide
    kernels) through deseq(mesh=...) + results() on a 2-block mesh of
    cuda:0, in float64: every per-gene column and result equal to the
    single-device call's bit for bit (each gene's kernel arithmetic does
    not depend on the genes beside it), the wide K1 and K2 launched in
    each block."""
    import deseq2_tpu_torch as dt
    from deseq2_tpu_torch.parallel import gene_mesh
    counts, subj, cond = checks.paired_gate_counts(501, 40, 9, seed=3)
    dds = dt.dataset_from_arrays(counts, {"subject": subj,
                                          "condition": cond},
                                 "~ subject + condition")
    one = dt.deseq(dds, engine=engine)
    r1 = dt.results(one)
    n0 = (fit_beta.launches_wide, fit_disp_line_search.launches_wide)
    fit = dt.deseq(dds, engine=engine, mesh=gene_mesh(devices=[cuda] * 2))
    assert fit_beta.launches_wide - n0[0] >= 2
    assert fit_disp_line_search.launches_wide - n0[1] >= 2
    res = dt.results(fit)
    for col in ("dispGeneEst", "dispersion", "betaIter"):
        np.testing.assert_array_equal(np.asarray(fit.row_data[col], float),
                                      np.asarray(one.row_data[col], float),
                                      err_msg=col)
    for col in r1.column_names:
        np.testing.assert_array_equal(np.asarray(res[col], float),
                                      np.asarray(r1[col], float),
                                      err_msg=col)


HOST_CASES = {
    "default": dict(),
    "no_cr_niter2": dict(config=dict(use_cr=False, niter_disp=2)),
    "threshold": dict(config=dict(weight_threshold=0.5), weights=True),
    "weights_fail": dict(weights="fail"),
    "beta_prior_multi": dict(beta_prior=True, batch=True,
                             sf_type="poscounts"),
    "p10": dict(levels=10),
}


@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_engine_on_card_matches_cpu(cuda, case):
    """deseq(engine="host") + results() on the card in float64 against
    device="cpu", for the engine's modes: the default, useCR = FALSE with
    two gene-wise iterations, the weighted row cut at 0.5, weights that
    fail the rank tests, betaPrior on ~ batch + condition with poscounts
    size factors, and a 10-level factor (the p > 8 route)."""
    import deseq2_tpu_torch as dt
    kw = dict(HOST_CASES[case])
    levels = kw.pop("levels", 2)
    rng = np.random.default_rng(6)
    m = 30 if levels > 2 else 12
    dds = dt.make_example_dataset(n=300, m=m, beta_sd=1.0, seed=6)
    if levels > 2:
        dds.col_data["condition"] = dt.Factor(
            np.array([f"L{j % levels}" for j in range(m)]),
            levels=[f"L{j}" for j in range(levels)])
    if kw.pop("batch", False):
        dds.col_data["batch"] = dt.Factor(np.tile(["1", "2", "3"], 4),
                                          levels=["1", "2", "3"])
        dds.design = dt.parse_formula("~ batch + condition")
    w = kw.pop("weights", None)
    if w is not None:
        wts = rng.uniform(0.2, 1.0, dds.counts.shape)
        if w == "fail":
            wts[[4, 90], 6:] = 0.0
        dds.assays["weights"] = wts
    if "config" in kw:
        kw["config"] = dt.DESeqConfig(**kw["config"])
    before = {f: dict(vars(f)) for f in (fit_beta, fit_disp_line_search)}
    on_card = dt.deseq(dds, engine="host", **kw)
    moved = [f.__name__ for f in before
             if any(getattr(f, k) != v for k, v in before[f].items()
                    if k.startswith("launches"))]
    assert moved == ["fit_beta", "fit_disp_line_search"]
    on_cpu = dt.deseq(dds, engine="host", device="cpu", **kw)
    if w == "fail":
        assert np.where(on_card.row_data["weightsFail"])[0].tolist() \
            == [4, 90]
    rc, rp = dt.results(on_card), dt.results(on_cpu)
    for col in ("log2FoldChange", "lfcSE", "stat", "pvalue", "padj"):
        a, b = np.asarray(rc[col]), np.asarray(rp[col])
        assert np.array_equal(np.isnan(a), np.isnan(b)), col
        mk = ~np.isnan(a)
        np.testing.assert_allclose(a[mk], b[mk], rtol=1e-6, atol=1e-8,
                                   err_msg=col)


def test_weights_ok_dev_on_card_matches_cpu(cuda):
    """The weights' rank tests on the card at the main path's 60,000
    genes (more than one batch of the card's eigvalsh) give the CPU's
    mask, rank-deficient rows included."""
    from deseq2_tpu_torch.parallel.fused import weights_ok_dev
    rng = np.random.default_rng(3)
    w = rng.uniform(0.3, 1.0, (60000, 24))
    w[[7, 31000, 59999], 12:] = 0.0
    x = np.column_stack([np.ones(24), np.repeat([0.0, 1.0], 12)])
    ok, _, _ = weights_ok_dev(torch.as_tensor(w, device=cuda),
                              torch.as_tensor(x, device=cuda))
    ref, _, _ = weights_ok_dev(torch.as_tensor(w), torch.as_tensor(x))
    assert ok.is_cuda
    assert torch.equal(ok.cpu(), ref)
    assert torch.nonzero(~ref).squeeze(1).tolist() == [7, 31000, 59999]


def test_public_path_on_card_matches_cpu(cuda):
    """deseq() + results() on the card in float64 against device="cpu"."""
    import deseq2_tpu_torch as dt
    dds = dt.make_example_dataset(n=500, m=12, beta_sd=1.0, seed=1)
    n0 = fit_disp_line_search.launches
    on_card = dt.results(dt.deseq(dds))
    on_cpu = dt.results(dt.deseq(dds, device="cpu"))
    assert fit_disp_line_search.launches >= n0 + 2
    for col in ("log2FoldChange", "lfcSE", "pvalue", "padj"):
        a, b = np.asarray(on_card[col]), np.asarray(on_cpu[col])
        assert np.array_equal(np.isnan(a), np.isnan(b)), col
        m = ~np.isnan(a)
        np.testing.assert_allclose(a[m], b[m], rtol=1e-6, atol=1e-8,
                                   err_msg=col)


@pytest.mark.parametrize("variant", ["weights", "lrt_norm_factors"])
def test_public_variant_on_card_matches_cpu(cuda, variant):
    """deseq() + results() on the card in float64 against device="cpu" for
    a weighted Wald run (weighted K1 and K2) and an LRT with gene x sample
    normalization factors on a ~ batch + condition design."""
    import deseq2_tpu_torch as dt
    dds = dt.make_example_dataset(n=400, m=12, beta_sd=1.0, seed=2)
    rng = np.random.default_rng(2)
    kw = {}
    if variant == "weights":
        dds.assays["weights"] = rng.uniform(0.3, 1.0, dds.counts.shape)
        fns = (fit_beta, fit_disp_line_search)
        before = [f.launches_weighted for f in fns]
    else:
        dds.col_data["batch"] = dt.Factor(np.tile(["1", "2"], 6),
                                          levels=["1", "2"])
        dds.design = dt.parse_formula("~ batch + condition")
        nf = np.exp(rng.normal(0.0, 0.2, dds.counts.shape))
        dds.normalization_factors = nf / np.exp(
            np.log(nf).mean(axis=1))[:, None]
        kw = dict(test="LRT", reduced="~ batch")
        fns = (fit_beta,)
        before = [fit_beta.launches]
    on_card = dt.results(dt.deseq(dds, **kw))
    after = [f.launches_weighted if variant == "weights" else f.launches
             for f in fns]
    assert all(a > b for a, b in zip(after, before))
    on_cpu = dt.results(dt.deseq(dds, device="cpu", **kw))
    for col in ("log2FoldChange", "lfcSE", "stat", "pvalue", "padj"):
        a, b = np.asarray(on_card[col]), np.asarray(on_cpu[col])
        assert np.array_equal(np.isnan(a), np.isnan(b)), col
        m = ~np.isnan(a)
        np.testing.assert_allclose(a[m], b[m], rtol=1e-6, atol=1e-8,
                                   err_msg=col)


EXPANDED_CASES = [(dt, S, G, lv, wt) for wt in (False, True)
                  for dt in (torch.float32, torch.float64)
                  for S, G, lv in checks.EXPANDED]


@pytest.mark.parametrize(
    "case", EXPANDED_CASES,
    ids=[f"{str(c[0])[6:]}-p{c[3] + 1}-S{c[1]}" + ("-w" if c[4] else "")
         for c in EXPANDED_CASES])
def test_irls_kernel_expanded_matches_plain(cuda, case):
    """K1 at the betaPrior refit's expanded design (p = 3 and 4, the
    intercept the sum of the level columns, held up by the prior's
    ridge), against its plain version: float64 to the plain trajectory,
    float32 against the float64 fit off the design's null direction
    (checks.check_irls_expanded)."""
    dt, S, G, lv, wt = case
    raw = checks.expanded_inputs(G, S, lv, 7 + S + lv, weighted=wt)
    d = checks.as_tensors(raw, dt, cuda)
    n0 = _counter(fit_beta, wt)
    k = checks.run_irls(fit_beta, d)
    torch.cuda.synchronize()
    assert _counter(fit_beta, wt) == n0 + 1
    pl = checks.run_irls(irls.fit_beta_plain, d)
    ref = checks.run_irls(irls.fit_beta_plain,
                          checks.as_tensors(raw, torch.float64, cuda))
    r = checks.check_irls_expanded(k, pl, ref)
    assert r["ok"], r


@pytest.fixture(scope="module")
def prior_fits(cuda):
    """deseq() and deseq(beta_prior=True) of a three-level example in
    float64, on the card and on the CPU, with the K1 launches of the card's
    betaPrior fit."""
    import deseq2_tpu_torch as dt
    dds = dt.make_example_dataset(n=400, m=12, beta_sd=1.0, seed=4)
    dds.col_data["condition"] = dt.Factor(np.repeat(["A", "B", "C"], 4),
                                          levels=["A", "B", "C"])
    n0 = fit_beta.launches
    card_bp = dt.deseq(dds, beta_prior=True)
    k1 = fit_beta.launches - n0
    return dict(card=dt.deseq(dds), cpu=dt.deseq(dds, device="cpu"),
                card_bp=card_bp, cpu_bp=dt.deseq(dds, beta_prior=True,
                                                  device="cpu"), k1=k1)


PRIOR_CALLS = {
    "beta_prior": ("bp", lambda dt, f: dt.results(f)),
    "beta_prior_C_B": ("bp", lambda dt, f: dt.results(
        f, contrast=("condition", "C", "B"))),
    "contrast_C_B": ("", lambda dt, f: dt.results(
        f, contrast=("condition", "C", "B"))),
    "contrast_list": ("", lambda dt, f: dt.results(
        f, contrast=[["condition_C_vs_A"], ["condition_B_vs_A"]])),
    "contrast_numeric": ("", lambda dt, f: dt.results(
        f, contrast=np.array([0.0, -1.0, 1.0]))),
    "apeglm": ("", lambda dt, f: dt.lfc_shrink(f, coef="condition_B_vs_A",
                                                type="apeglm")),
    "normal": ("", lambda dt, f: dt.lfc_shrink(
        f, contrast=("condition", "C", "A"), type="normal")),
    "ashr": ("", lambda dt, f: dt.lfc_shrink(f, coef="condition_B_vs_A",
                                              type="ashr")),
}


@pytest.mark.parametrize("call", sorted(PRIOR_CALLS))
def test_prior_contrast_shrink_on_card_matches_cpu(prior_fits, call):
    """betaPrior, contrasts and lfc_shrink on the card in float64 against
    the same calls on the port's CPU fit; the betaPrior deseq() and the
    normal shrinkage launch K1 on the card."""
    import deseq2_tpu_torch as dt
    which, fn = PRIOR_CALLS[call]
    assert prior_fits["k1"] >= 2
    n0 = fit_beta.launches
    on_card = fn(dt, prior_fits["card" + ("_bp" if which else "")])
    if call == "normal":
        assert fit_beta.launches == n0 + 1
    on_cpu = fn(dt, prior_fits["cpu" + ("_bp" if which else "")])
    for col in ("log2FoldChange", "lfcSE", "stat", "pvalue", "padj"):
        a, b = np.asarray(on_card[col]), np.asarray(on_cpu[col])
        assert np.array_equal(np.isnan(a), np.isnan(b)), col
        m = ~np.isnan(a)
        np.testing.assert_allclose(a[m], b[m], rtol=1e-6, atol=1e-8,
                                   err_msg=col)


def _transform_dataset(G, S, seed, config=None):
    import deseq2_tpu_torch as dt
    counts, _ = checks.bench_counts(G, S, seed)
    return dt.dataset_from_matrix(
        counts, {"condition": np.repeat(["A", "B"], [S // 2, S - S // 2])},
        "~ condition", config=config or dt.DESeqConfig())


@pytest.mark.parametrize("maxit", [100, 10])
def test_transform_disp_kernels_p1_match_plain(cuda, maxit):
    """K2 and K3 at p = 1 as a blind VST's dispersion step hands them
    their inputs (recorded there), each held against its plain version on
    those inputs with the float64 readings; the step launches no K1.
    maxit_disp = 10 leaves genes to the grid (K3)."""
    import deseq2_tpu_torch as dt
    dds = _transform_dataset(4000, 96, 5, dt.DESeqConfig(maxit_disp=maxit))
    n1, n2, n3 = (fit_beta.launches, fit_disp_line_search.launches,
                  fit_disp_grid.launches)
    with checks.recorded_disp_calls() as calls:
        dt.variance_stabilizing_transformation(dds)
    assert fit_beta.launches == n1
    assert fit_disp_line_search.launches == n2 + len(calls["ls"]) >= n2 + 1
    assert fit_disp_grid.launches == n3 + len(calls["grid"])
    if maxit == 10:
        assert calls["grid"], "maxit_disp = 10 sent no gene to the grid"
    for kind, k_fn, p_fn, check in (
            ("ls", fit_disp_line_search, disp.fit_disp_line_search_plain,
             checks.check_ls),
            ("grid", fit_disp_grid, disp.fit_disp_grid_plain,
             checks.check_grid)):
        for call in calls[kind]:
            a, kw = call
            assert a[1].shape[1] == 1 and a[2].is_cuda
            assert a[2].dtype == torch.float64
            k, pl = k_fn(*a, **kw), p_fn(*a, **kw)
            d, use_prior, prior_var = checks.recorded_case(kind, call)
            r = check(k, pl, d, use_prior, prior_var=prior_var)
            assert r["ok"], (kind, r)


TRANSFORM_CALLS = {
    "vst": lambda dt, d, dev: dt.vst(d, nsub=1000, device=dev),
    "VST parametric": lambda dt, d, dev:
        dt.variance_stabilizing_transformation(d, device=dev),
    "VST mean": lambda dt, d, dev: dt.variance_stabilizing_transformation(
        d, fit_type="mean", device=dev),
    "VST local": lambda dt, d, dev: dt.variance_stabilizing_transformation(
        d, fit_type="local", device=dev),
    "rlog": lambda dt, d, dev: dt.rlog(d, device=dev),
    "normTransform": lambda dt, d, dev: dt.norm_transform(d, device=dev),
}


@pytest.mark.parametrize("dtype_name", ["float64", "float32"])
@pytest.mark.parametrize("call", sorted(TRANSFORM_CALLS))
def test_transforms_on_card_match_cpu(cuda, call, dtype_name):
    """The public transforms on the card against the port in float64 on
    the CPU, at chip_smoke phase 9's limits (checks.TRANSFORM_TOL)."""
    import deseq2_tpu_torch as dt
    fn = TRANSFORM_CALLS[call]
    cpu = fn(dt, _transform_dataset(2048, 128, 7), "cpu").matrix
    dds = _transform_dataset(2048, 128, 7, dt.DESeqConfig(dtype=dtype_name))
    t = fn(dt, dds, None)
    assert t.matrix_device.is_cuda
    assert t.matrix_device.dtype == getattr(torch, dtype_name)
    tol = checks.TRANSFORM_TOL[
        "rlog_float64" if call == "rlog" and dtype_name == "float64"
        else dtype_name]
    assert np.max(np.abs(t.matrix - cpu)) <= tol


# ---------------------------------------------------------------------------
# the single-cell path: K1 at the QL fits' minmu = 1e-6, the streamed path
# ---------------------------------------------------------------------------

MIN_MU_CASES = [(dt, p, S, G, False) for dt in (torch.float32, torch.float64)
                for p in (2, 3) for S, G in checks.SHAPES]


@pytest.mark.parametrize("case", MIN_MU_CASES, ids=_id)
def test_irls_kernel_min_mu_matches_plain(cuda, case):
    """K1 at minmu = 1e-6 (the host glmGamPoi LRT's fits), its first ten
    genes counting zero in one group: against its plain version by
    phase 3's readings and limits (checks.TOL), in float32 on the genes
    with counts in both groups (checks.check_irls_min_mu)."""
    dt, p, S, G, _ = case
    d = checks.as_tensors(checks.zero_group_inputs(G, S, p, 7 * p + S), dt,
                          cuda)
    n0 = fit_beta.launches
    k = checks.run_irls(fit_beta, d, min_mu=checks.MIN_MU_QL)
    torch.cuda.synchronize()
    assert fit_beta.launches == n0 + 1
    pl = checks.run_irls(irls.fit_beta_plain, d, min_mu=checks.MIN_MU_QL)
    r = checks.check_irls_min_mu(k, pl)
    assert r["ok"], r


SC_CARD_CASES = {
    "group_ql": dict(test="LRT", fit_type="glmGamPoi"),
    "group_wald": dict(test="Wald", min_mu=0.5),
    "covariate_ql_nf": dict(test="LRT", fit_type="glmGamPoi", nf=True),
}


@pytest.mark.parametrize("case", sorted(SC_CARD_CASES))
def test_sc_on_card_matches_cpu(cuda, case):
    """fused_sc_results in float64 on the card against the same call on
    the CPU (rtol 1e-6; gene-wise estimates at the 1e-8 floor within 10 x
    minDisp)."""
    from deseq2_tpu_torch.parallel import sc
    kw = dict(SC_CARD_CASES[case])
    counts, cells, sf = checks.sc_gate_inputs(400, 300, seed=3)
    if case.startswith("covariate"):
        x = np.column_stack([np.ones(300), (np.arange(300) // 2) % 2, cells])
        rng = np.random.default_rng(6)
        nf = np.exp(rng.normal(0.0, 0.2, counts.shape))
        kw.update(design=x, reduced_design=x[:, :2], norm_factors=nf)
    else:
        kw.update(cells=cells, n_groups=2)
    kw.pop("nf", None)
    card = sc.fused_sc_results(counts, size_factors=sf, device=cuda, **kw)
    cpu = sc.fused_sc_results(counts, size_factors=sf, device="cpu", **kw)
    floor = (cpu["dispGeneEst"] <= 1e-7) | (card["dispGeneEst"] <= 1e-7)
    for k in ("baseMean", "dispGeneEst", "dispFit", "dispersion",
              "log2FoldChange", "stat", "pvalue", "padj"):
        a, b = np.asarray(card[k], float), np.asarray(cpu[k], float)
        assert np.array_equal(np.isnan(a), np.isnan(b)), k
        m = ~np.isnan(b) & ~floor
        np.testing.assert_allclose(a[m], b[m], rtol=1e-6, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("design", ["group", "covariate"])
def test_sc_float32_card_gate(cuda, design):
    """bench.py's single-cell gate: the float32 call on the card against
    the float64 call on the CPU (histogram order matched), 2,048 x 4,096."""
    from deseq2_tpu_torch.parallel import sc
    if design == "group":
        counts, cells, sf = checks.sc_gate_inputs(2048, 4096)
        kw = dict(cells=cells, n_groups=2)
    else:
        counts, x, red, sf = checks.sc_cov_gate_inputs(2048, 4096)
        kw = dict(design=x, reduced_design=red)
    run = dict(size_factors=sf, test="LRT", fit_type="glmGamPoi", **kw)
    card = sc.fused_sc_results(counts, device=cuda, dtype=torch.float32,
                               **run)
    cpu = sc.fused_sc_results(counts, device="cpu", dtype=torch.float64,
                              use_hist=True, **run)
    r = checks.sc_gate(card, cpu)
    assert r["ok"], r


@pytest.mark.parametrize("engine", ["fused", "host"])
def test_mesh_on_card_matches_single(cuda, engine):
    """deseq(mesh=...) + results() in float64 over 4 shards on cuda:0, and
    over cuda:0 and cuda:1 where a second card exists, against the
    single-device call on the same card: per-gene columns at rtol 1e-8
    (tests/test_sharding.py's limits); every shard's device launches
    K1 and K2."""
    import deseq2_tpu_torch as dt
    from deseq2_tpu_torch.parallel import gene_mesh
    dds = dt.make_example_dataset(n=501, m=12, beta_sd=1.0, seed=1)
    one = dt.deseq(dds, engine=engine)
    r1 = dt.results(one)
    meshes = [gene_mesh(devices=[cuda] * 4)]
    if torch.cuda.device_count() > 1:
        meshes.append(gene_mesh(2))
    for mesh in meshes:
        for f in (fit_beta, fit_disp_line_search):
            f.launches_by_device = {}
        fit = dt.deseq(dds, engine=engine, mesh=mesh)
        for f in (fit_beta, fit_disp_line_search):
            assert all(f.launches_by_device.get(str(d))
                       for d in mesh.devices), (f.__name__,
                                                f.launches_by_device)
        assert fit.assays["mu"].tensor.device == cuda
        res = dt.results(fit)
        for col in ("dispersion", "dispGeneEst"):
            np.testing.assert_allclose(
                np.asarray(fit.row_data[col], float),
                np.asarray(one.row_data[col], float), rtol=1e-8,
                atol=1e-10, equal_nan=True, err_msg=f"{mesh} {col}")
        for col in r1.column_names:
            np.testing.assert_allclose(
                np.asarray(res[col], float), np.asarray(r1[col], float),
                rtol=1e-8, atol=1e-10, equal_nan=True,
                err_msg=f"{mesh} {col}")


def test_row_forms_are_row_invariant_on_card(cuda):
    """parallel/fused.py's per-gene products on the card (rowdot, rowcomb,
    the refit's MIN_ROWS): a block of at least MIN_ROWS rows gets the
    whole call's rows bit for bit, and the forms equal the products to
    rounding."""
    from deseq2_tpu_torch.parallel import fused
    rng = np.random.default_rng(2)
    for dt in (torch.float32, torch.float64):
        a = torch.as_tensor(rng.random((2048, 1024)), dtype=dt, device=cuda)
        x = torch.as_tensor(rng.random((1024, 3)), dtype=dt, device=cuda)
        rtol = 1e-5 if dt == torch.float32 else 1e-12
        np.testing.assert_allclose(fused.rowdot(a, x).cpu(), (a @ x).cpu(),
                                   rtol=rtol)
        np.testing.assert_allclose(fused.rowcomb(a[:, :3], x).cpu(),
                                   (a[:, :3] @ x.T).cpu(), rtol=rtol)
        n = fused.MIN_ROWS
        for lo, hi in ((0, n), (7, 7 + n), (100, 1124), (1024, 2048)):
            assert torch.equal(fused.rowdot(a[lo:hi], x),
                               fused.rowdot(a, x)[lo:hi])
            assert torch.equal(fused.rowcomb(a[lo:hi, :3], x),
                               fused.rowcomb(a[:, :3], x)[lo:hi])
