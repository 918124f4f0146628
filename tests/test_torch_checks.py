"""The kernel checks of deseq2_tpu_torch/ops/checks.py, on the CPU.

chip_smoke.py and tests/test_torch_gpu.py hold each CUDA kernel against
its plain version with these readings.  Here the plain version stands in
for the kernel: it must pass against itself, and answers broken the way a
wrong kernel would break them (a grid search that skips the fine grid, a
line search that lands off the optimum, an IRLS fit off its fixpoint) must
fail, in float32 where the limits are scaled to what float32 resolves.
"""

import pytest
import torch

from deseq2_tpu_torch.ops import checks, disp, irls
from torch_threads import one_torch_thread  # noqa: F401

F32 = torch.float32
CASES = [(24, 333, 2), (3000, 17, 3)]


def _ids(c):
    return f"S{c[0]}-p{c[2]}"


def _data(S, G, p, dtype=F32):
    return checks.as_tensors(checks.solver_inputs(G, S, p, 10 * p + S), dtype,
                             "cpu")


def _ls(d, use_prior):
    return disp.fit_disp_line_search_plain(
        d["y"], d["x"], d["mu"], d["la0"], d["pm"], checks.PRIOR_VAR,
        checks.MIN_LA, use_prior=use_prior)


def _grid(d, use_prior):
    return disp.fit_disp_grid_plain(d["y"], d["x"], d["mu"], d["grid"],
                                    d["pm"], checks.PRIOR_VAR,
                                    use_prior=use_prior)


@pytest.mark.parametrize("use_prior", [False, True])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_line_search_check(case, use_prior):
    d = _data(*case)
    pl = _ls(d, use_prior)
    ref = checks.line_search_reference(d, use_prior)
    assert checks.check_ls(pl, pl, d, use_prior, ref=ref)["ok"]
    off = dict(pl, log_alpha=pl["log_alpha"] + 0.2)
    assert not checks.check_ls(off, pl, d, use_prior, ref=ref)["ok"]


@pytest.mark.parametrize("use_prior", [False, True])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_grid_check(case, use_prior):
    d = _data(*case)
    pl = _grid(d, use_prior)
    ref = checks.grid_reference(d, use_prior)
    r = checks.check_grid(pl, pl, d, use_prior, ref=ref)
    assert r["ok"] and r["n_sep"] > 0
    # the coarse grid's argmax alone, without the fine stage
    G = pl.shape[0]
    lps = torch.stack([checks.lp_at(torch.full((G,), float(a)), d, use_prior)
                       for a in d["grid"]])
    coarse = d["grid"][lps.argmax(0)]
    assert not checks.check_grid(coarse, pl, d, use_prior, ref=ref)["ok"]


@pytest.mark.parametrize("kind", ["ls", "grid"])
@pytest.mark.parametrize("p,weighted,mode", [(10, False, None),
                                             (16, True, "thr")])
def test_within_plain_spread(kind, p, weighted, mode):
    """The wide float32 readings' rule at S = 24: the plain version on
    another order of the samples and columns (a kernel that differs only
    in rounding) is within the plain version's permutation spread; a log
    alpha moved by 0.02 on every gene (K2), or onto the next fine-grid
    point on 5% of the genes (K3), is not."""
    raw = checks.solver_inputs(333, 24, p, checks.seed_of(p, 24, mode),
                               weighted=weighted)
    d = checks.with_mode(checks.as_tensors(raw, F32, "cpu"), mode)
    other = checks.permuted(d, torch.Generator().manual_seed(7))
    noise = torch.randn(333, generator=torch.Generator().manual_seed(0))
    if kind == "ls":
        pl = checks.run_ls(disp.fit_disp_line_search_plain, d, True)
        ref = checks.line_search_reference(d, True)
        good = checks.run_ls(disp.fit_disp_line_search_plain, other, True)
        bad = dict(pl, log_alpha=pl["log_alpha"] + 0.02 * noise)
        read = checks.check_ls
    else:
        pl = checks.run_grid(disp.fit_disp_grid_plain, d, True)
        ref = checks.grid_reference(d, True)
        good = checks.run_grid(disp.fit_disp_grid_plain, other, True)
        step = 2.0 * (d["grid"][1] - d["grid"][0]).item() / 19
        bad = pl + step * (noise.abs() > 1.96).to(F32)
        read = checks.check_grid
    # the permutations' readings depend on pl and d alone: one yardstick
    # for both readings
    spread = checks.plain_spread(kind, pl, d, True, ref)
    for k, ok in ((good, True), (bad, False)):
        r = checks.within_plain_spread(kind, read(k, pl, d, True, ref=ref),
                                       pl, d, True, ref, spread=spread)
        assert r["ok"] == ok, r


def test_float64_checks_hold_trajectories():
    d = _data(24, 333, 2, torch.float64)
    pl = _ls(d, True)
    assert checks.check_ls(pl, pl, d, True)["ok"]
    off = dict(pl, log_alpha=pl["log_alpha"] + 1e-4)
    assert not checks.check_ls(off, pl, d, True)["ok"]
    g = _grid(d, True)
    assert checks.check_grid(g, g, d, True)["ok"]
    step = 2.0 * (d["grid"][1] - d["grid"][0]) / 19
    assert not checks.check_grid(g + step, g, d, True)["ok"]


@pytest.mark.parametrize("dtype", [F32, torch.float64], ids=str)
def test_irls_check(dtype):
    d = _data(24, 333, 2, dtype)
    p = d["x"].shape[1]
    args = (d["y"], d["x"], torch.ones(24, dtype=dtype), d["alpha"], d["b0"],
            checks.ridge_for(p, dtype, "cpu"))
    pl = irls.fit_beta_plain(*args)
    assert checks.check_irls(pl, pl)["ok"]
    off = dict(pl, beta=pl["beta"] * 1.02)
    assert not checks.check_irls(off, pl)["ok"]


def test_irls_check_outputs():
    # `outputs`: every other output and the sweep counts are gated too
    d = _data(24, 333, 2, torch.float64)
    args = (d["y"], d["x"], torch.ones(24, dtype=torch.float64), d["alpha"],
            d["b0"], checks.ridge_for(2, torch.float64, "cpu"))
    pl = irls.fit_beta_plain(*args)
    r = checks.check_irls(pl, pl, outputs=True)
    assert r["ok"] and r["same_iter"] == 1.0
    assert max(r["outputs_rel"].values()) == 0.0
    off = dict(pl, hat_diag=pl["hat_diag"] * (1 + 1e-6))
    assert checks.check_irls(off, pl)["ok"]
    assert not checks.check_irls(off, pl, outputs=True)["ok"]
    slow = dict(pl, iter=pl["iter"] + (torch.arange(333) % 10 == 0).int())
    assert not checks.check_irls(slow, pl, outputs=True)["ok"]


def test_check_irls_min_mu_gates_float32_off_zero_rows():
    """float64 is read on every gene; float32 off the zero-group genes,
    with the every-gene reading beside it."""
    import torch
    from deseq2_tpu_torch.ops import checks
    G = 40
    for dt in (torch.float64, torch.float32):
        beta = torch.ones(G, 2, dtype=dt)
        it = torch.full((G,), 5, dtype=torch.int32)
        off = beta.clone()
        off[:checks.ZERO_ROWS, 1] += 0.5
        r = checks.check_irls_min_mu(dict(beta=off, iter=it),
                                     dict(beta=beta, iter=it))
        if dt == torch.float64:
            assert not r["ok"] and "beta_rel_all_genes" not in r
        else:
            assert r["ok"] and r["beta_rel"] == 0.0
            assert r["beta_rel_all_genes"] == 0.25
            assert "zero_rows_dev_excess_kernel" not in r


def test_check_irls_min_mu_reads_zero_rows_against_float64():
    """Given the float64 fit, the zero-group genes are read against it
    (betas and float64 deviances), and the gate does not move."""
    import torch
    from deseq2_tpu_torch.ops import checks, irls
    inputs = checks.zero_group_inputs(40, 24, 2, 3)
    d64 = checks.as_tensors(inputs, torch.float64, "cpu")
    d32 = checks.as_tensors(inputs, torch.float32, "cpu")
    run = dict(min_mu=checks.MIN_MU_QL)
    ref = checks.run_irls(irls.fit_beta_plain, d64, **run)
    pl = checks.run_irls(irls.fit_beta_plain, d32, **run)
    r = checks.check_irls_min_mu(pl, pl, ref, d64)
    assert r["ok"] == checks.check_irls_min_mu(pl, pl)["ok"]
    assert r["zero_rows_beta_rel_f64_kernel"] \
        == r["zero_rows_beta_rel_f64_plain"] >= 0.0
    z = checks.check_irls_min_mu(dict(pl, beta=ref["beta"].float()), pl,
                                 ref, d64)
    assert abs(z["zero_rows_dev_excess_kernel"]) < 1e-6


def test_edge_stops_read_apart():
    """The spread rule's knife edge (checks.edge_stops): a float32 line
    search that stops one gene early, on the plain version's own path at a
    step whose float64 gain lies within rounding of the tolerance, is read
    apart (n_edge 1, within the plain runs' own count) and then passes; the
    same gene stopped one accepted step earlier, on a gain well over the
    tolerance (a search that quits early for another cause), or off the
    plain path, is not read apart, and fails.  The inputs are the block checks' at p = 17, S = 24,
    weighted, with the prior."""
    raw = checks.solver_inputs(333, 24, 17, checks.seed_of(17, 24),
                               weighted=True)
    d = checks.as_tensors(raw, F32, "cpu")
    plain = disp.fit_disp_line_search_plain
    pl = checks.run_ls(plain, d, True)
    ref = checks.line_search_reference(d, True)
    # the plain path cut after n iterations; its knife-edge steps as
    # edge_stops reads them, the one furthest short of the reference first
    cuts = {n: checks.run_ls(plain, d, True, maxit=n) for n in range(1, 12)}
    eps = torch.finfo(F32).eps
    tol64 = (checks.lp_at(d["la0"], d, True).abs() * 50 * eps).clamp(min=1e-6)
    lref = checks.lp_at(ref["log_alpha"], d, True)
    found = []
    for n in range(2, 12):
        c0, c1 = cuts[n - 1], cuts[n]
        l1 = checks.lp_at(c1["log_alpha"], d, True)
        g = l1 - checks.lp_at(c0["log_alpha"], d, True)
        scale = torch.maximum(checks.EDGE_ULPS * eps * l1.abs().clamp(min=1),
                              (c1["last_change"].double() - g).abs())
        edge = ((c1["iter"] == n) & (c1["iter_accept"] > c0["iter_accept"])
                & (pl["iter"] > n + 1)
                & ((c1["log_alpha"] - pl["log_alpha"]).abs() > 1e-3)
                & ((g - tol64).abs() <= scale))
        found += [(lref[i] - l1[i], i, n) for i in edge.nonzero()[:, 0]]
    assert found
    _, i, n = max(found)
    spread = checks.plain_spread("ls", pl, d, True, ref)
    earlier = max((m for m in range(2, n)
                   if cuts[m]["iter_accept"][i] > cuts[m - 1]["iter_accept"][i]
                   and (cuts[m]["log_alpha"][i] - pl["log_alpha"][i]).abs()
                   > 1e-3), default=1)
    # last, the knife-edge step's iteration count at a log alpha 2e-3 off
    # the plain path: not a stop of that path
    for m, ok, off in ((n, True, 0.0), (earlier, False, 0.0),
                       (n, False, 2e-3)):
        k = {key: v.clone() for key, v in pl.items()}
        for key in k:
            k[key][i] = cuts[m][key][i]
        k["log_alpha"][i] += off
        read = checks.check_ls(k, pl, d, True, ref=ref)
        alone = checks.within_plain_spread("ls", read, pl, d, True, ref,
                                           spread=spread)
        assert not alone["ok"], alone       # the spread alone fails it
        r = checks.within_plain_spread("ls", read, pl, d, True, ref,
                                       spread=spread, k=k)
        assert r["n_edge"] == int(ok) <= r["n_edge_limit"], (m, r)
        assert r["ok"] == ok and r["read_apart"] == int(ok), (m, r)


def test_line_search_per_gene_caps():
    """The plain line search's per-gene maxit caps (checks.edge_stops cuts
    each gene's search at its own count): every gene ends as a run at its
    cap as an int maxit leaves it, bit for bit."""
    d = checks.as_tensors(checks.solver_inputs(120, 24, 17, 3,
                                               weighted=True), F32, "cpu")
    caps = torch.randint(1, 9, (120,),
                         generator=torch.Generator().manual_seed(0))
    plain = disp.fit_disp_line_search_plain
    r = checks.run_ls(plain, d, True, maxit=caps)
    for m in caps.unique().tolist():
        sel = caps == m
        assert not checks.differing_outputs(
            {k: v[sel] for k, v in r.items()},
            {k: v[sel] for k, v in checks.run_ls(plain, d, True,
                                                 maxit=m).items()})
