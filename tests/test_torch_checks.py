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
    for k, ok in ((good, True), (bad, False)):
        r = checks.within_plain_spread(kind, read(k, pl, d, True, ref=ref),
                                       pl, d, True, ref)
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
