"""Plain K2 and K3 (deseq2_tpu_torch.ops.disp, the CPU side of the
fit_disp_line_search and fit_disp_grid wrappers) against the JAX package's
XLA cores and its Pallas kernels in interpret mode.

float64 on the CPU, the fixtures and tolerances of tests/test_pallas_ls.py
and tests/test_pallas.py.  The line search: log alpha agrees for at least
98% of genes, and where a rounding tie sent a trajectory elsewhere the
posterior at the port's solution is as good.  The grid: the same grid
point for every gene (the plain version evaluates the XLA core's formula,
first maximum wins in both).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from deseq2_tpu.ops import disp as jdisp
from deseq2_tpu.ops.pallas_disp import fit_disp_grid_pallas
from deseq2_tpu.ops.pallas_ls import fit_disp_line_search_pallas
from deseq2_tpu_torch.ops import disp as tdisp
from deseq2_tpu_torch.ops.cuda_grid import fit_disp_grid
from deseq2_tpu_torch.ops.cuda_ls import fit_disp_line_search

MIN_LA = float(np.log(1e-9))


def _sim(G=300, S=24, p=2, seed=0):
    """tests/test_pallas_ls.py:_sim as numpy arrays, plus the grid."""
    rng = np.random.default_rng(seed)
    cols = [np.ones(S)]
    for _ in range(p - 1):
        cols.append(rng.permutation([0.0, 1.0] * (S // 2)))
    x = np.column_stack(cols)
    mu0 = np.exp(rng.normal(3.0, 1.5, (G, 1))) * np.ones((1, S))
    alpha = 4.0 / mu0[:, 0] + 0.1
    size = 1.0 / alpha[:, None]
    y = rng.negative_binomial(size, size / (size + mu0)).astype(np.float64)
    mu = np.maximum(mu0, 0.5)
    la0 = np.log(np.clip(alpha * np.exp(rng.normal(0, 0.5, G)), 1e-8, 10.0))
    grid = np.linspace(np.log(1e-8), np.log(max(10.0, S)), 20)
    return y, x, mu, la0, grid


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _lp(la, y, x, mu, pm, pv, use_prior):
    return tdisp.log_posterior(*_t(la, y, mu, x, pm), pv, use_prior).numpy()


@pytest.mark.parametrize("use_prior", [False, True])
def test_posterior_and_derivative_match(use_prior):
    y, x, mu, la0, _ = _sim(G=200, seed=3)
    pm = np.log(np.full(len(y), 0.5))
    for fn in ("log_posterior", "dlog_posterior"):
        t = getattr(tdisp, fn)(*_t(la0, y, mu, x, pm), 1.3,
                               use_prior).numpy()
        j = np.asarray(getattr(jdisp, fn)(*_j(la0, y, mu, x, pm), 1.3,
                                          use_prior))
        np.testing.assert_allclose(t, j, rtol=1e-10, atol=1e-10,
                                   err_msg=fn)


def _check_ls(got, ref, y, x, mu, pm, pv, use_prior, least_share):
    la_ref, la_got = np.asarray(ref["log_alpha"]), got["log_alpha"]
    agree = np.isclose(la_ref, la_got, atol=1e-6)
    assert agree.mean() > least_share, agree.mean()
    lp_ref = _lp(la_ref, y, x, mu, pm, pv, use_prior)
    lp_got = _lp(la_got, y, x, mu, pm, pv, use_prior)
    assert np.all(lp_got >= lp_ref - 1e-6 * np.abs(lp_ref) - 1e-6)
    assert (np.asarray(ref["iter"])[agree] == got["iter"][agree]).mean() \
        > 0.98
    np.testing.assert_allclose(got["initial_lp"],
                               np.asarray(ref["initial_lp"]),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got["last_lp"][agree],
                               np.asarray(ref["last_lp"])[agree],
                               rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize("use_prior", [False, True])
def test_plain_line_search_matches_xla_and_pallas(use_prior):
    y, x, mu, la0, _ = _sim()
    pm = np.log(np.full(len(y), 0.5))
    pv = 1.3
    got = {k: v.numpy() for k, v in fit_disp_line_search(
        *_t(y, x, mu, la0, pm), pv, MIN_LA, maxit=100,
        use_prior=use_prior).items()}
    xla = jdisp._fit_disp_line_search_core(*_j(y, x, mu, la0, pm), pv,
                                           MIN_LA, maxit=100,
                                           use_prior=use_prior)
    pal = fit_disp_line_search_pallas(*_j(y, x, mu, la0, pm), pv, MIN_LA,
                                      maxit=100, use_prior=use_prior,
                                      interpret=True)
    _check_ls(got, xla, y, x, mu, pm, pv, use_prior, 0.98)
    _check_ls(got, pal, y, x, mu, pm, pv, use_prior, 0.98)


@pytest.mark.parametrize("p", [1, 3])
def test_plain_line_search_other_widths(p):
    """p = 3 against both JAX versions; p = 1 (outside the Pallas
    kernel's p >= 2 gate) against the XLA core."""
    y, x, mu, la0, _ = _sim(G=150, S=24, p=p, seed=4)
    pm = np.zeros(len(y))
    got = {k: v.numpy() for k, v in fit_disp_line_search(
        *_t(y, x, mu, la0, pm), 1.0, MIN_LA, maxit=100).items()}
    refs = [jdisp._fit_disp_line_search_core(*_j(y, x, mu, la0, pm), 1.0,
                                             MIN_LA, maxit=100)]
    if p >= 2:
        refs.append(fit_disp_line_search_pallas(*_j(y, x, mu, la0, pm), 1.0,
                                                MIN_LA, maxit=100,
                                                interpret=True))
    for ref in refs:
        _check_ls(got, ref, y, x, mu, pm, 1.0, False, 0.97)


@pytest.mark.parametrize("p,use_prior", [(2, False), (2, True), (3, False),
                                         (1, True)])
def test_plain_grid_matches_xla_and_pallas(p, use_prior):
    y, x, mu, _, grid = _sim(G=200, p=p, seed=5 + p)
    pm = np.log(np.full(len(y), 0.5))
    pv = 1.3
    got = fit_disp_grid(*_t(y, x, mu, grid, pm), pv,
                        use_prior=use_prior).numpy()
    xla = np.asarray(jdisp._fit_disp_grid_core(*_j(y, x, mu, grid, pm), pv,
                                               use_prior=use_prior))
    np.testing.assert_array_equal(got, xla)
    if p >= 2:
        pal = np.asarray(fit_disp_grid_pallas(*_j(y, x, mu, grid, pm), pv,
                                              use_prior=use_prior,
                                              interpret=True))
        # the Pallas kernel's Lanczos lgamma can flip a near-tie (as in
        # tests/test_pallas.py); the posterior at the picks agrees
        assert np.isclose(got, pal, atol=1e-9).mean() > 0.98
        lp_got = _lp(got, y, x, mu, pm, pv, use_prior)
        lp_pal = _lp(pal, y, x, mu, pm, pv, use_prior)
        assert np.all(lp_got >= lp_pal - 1e-6 * np.abs(lp_pal) - 1e-6)


def _weights(y, x, seed=9):
    """tests/test_pallas_ls.py:test_ls_kernel_weighted_matches_xla's
    weights: max-1 rows, with every treated sample of the first 10 genes
    below the Cox-Reid threshold so their treatment column drops out."""
    rng = np.random.default_rng(seed)
    w = np.clip(rng.random(y.shape) + 0.2, 0.0, 1.0)
    treated = x[:, 1] > 0
    w[:10][:, treated] = 1e-3
    w = w / w.max(axis=1, keepdims=True)
    w[:10][:, treated] = 1e-3
    return w


def test_weighted_cr_masks_drop_columns():
    y, x, _, _, _ = _sim(G=40, seed=4)
    w = _weights(y, x)
    rm, cm = tdisp.make_cr_masks(*_t(x, w))
    jrm, jcm = jdisp.make_cr_masks(jnp.asarray(x), jnp.asarray(w), 1e-2, True)
    np.testing.assert_array_equal(rm.numpy(), np.asarray(jrm))
    np.testing.assert_array_equal(cm.numpy(), np.asarray(jcm))
    assert not cm[:10, 1].any() and cm[10:].all()


@pytest.mark.parametrize("fn", ["log_posterior", "dlog_posterior"])
def test_weighted_posterior_matches(fn):
    y, x, mu, la0, _ = _sim(G=200, seed=3)
    w = _weights(y, x)
    pm = np.log(np.full(len(y), 0.5))
    rm, cm = tdisp.make_cr_masks(*_t(x, w))
    t = getattr(tdisp, fn)(*_t(la0, y, mu, x, pm), 1.3, True,
                           torch.as_tensor(w), rm, cm).numpy()
    jrm, jcm = jdisp.make_cr_masks(jnp.asarray(x), jnp.asarray(w), 1e-2, True)
    j = np.asarray(getattr(jdisp, fn)(*_j(la0, y, mu, x, pm), 1.3, True,
                                      weights=jnp.asarray(w),
                                      use_weights=True, row_mask=jrm,
                                      col_mask=jcm))
    np.testing.assert_allclose(t, j, rtol=1e-10, atol=1e-10)


def _wlp(la, y, x, mu, pm, pv, use_prior, w):
    rm, cm = tdisp.make_cr_masks(*_t(x, w))
    return tdisp.log_posterior(*_t(la, y, mu, x, pm), pv, use_prior,
                               torch.as_tensor(w), rm, cm).numpy()


@pytest.mark.parametrize("p,use_prior", [(2, True), (2, False), (3, True),
                                         (1, False)])
def test_weighted_line_search_matches_xla_and_pallas(p, use_prior):
    """tests/test_pallas_ls.py:test_ls_kernel_weighted_matches_xla's recipe
    (forced CR column drops on the first 10 genes) and tolerances: log
    alpha equal to 1e-8 for over 99% of genes, the rest at a posterior at
    least as good."""
    y, x, mu, la0, _ = _sim(G=200, p=p, seed=4)
    w = _weights(y, x) if p > 1 else np.clip(
        np.random.default_rng(9).random(y.shape) + 0.2, 0.0, 1.0)
    pm = np.log(np.full(len(y), 0.5))
    got = {k: v.numpy() for k, v in fit_disp_line_search(
        *_t(y, x, mu, la0, pm), 1.3, MIN_LA, maxit=100,
        use_prior=use_prior, weights=torch.as_tensor(w)).items()}
    refs = [jdisp._fit_disp_line_search_core(
        *_j(y, x, mu, la0, pm), 1.3, MIN_LA, maxit=100, use_prior=use_prior,
        weights=jnp.asarray(w), use_weights=True)]
    if p >= 2:
        refs.append(fit_disp_line_search_pallas(
            *_j(y, x, mu, la0, pm), 1.3, MIN_LA, maxit=100,
            use_prior=use_prior, interpret=True, weights=jnp.asarray(w)))
    for ref in refs:
        la_r = np.asarray(ref["log_alpha"])
        same = np.isclose(la_r, got["log_alpha"], rtol=1e-8, atol=1e-9)
        assert same.mean() > 0.99, (~same).sum()
        lp_r = _wlp(la_r, y, x, mu, pm, 1.3, use_prior, w)
        lp_g = _wlp(got["log_alpha"], y, x, mu, pm, 1.3, use_prior, w)
        assert np.all(lp_g >= lp_r - 1e-6)
        np.testing.assert_allclose(got["initial_lp"],
                                   np.asarray(ref["initial_lp"]),
                                   rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("use_prior", [False, True])
def test_weighted_grid_matches_xla(use_prior):
    """The weighted grid (the JAX package runs it on its XLA core only):
    the same pick for every gene."""
    y, x, mu, _, grid = _sim(G=200, seed=8)
    w = _weights(y, x)
    pm = np.log(np.full(len(y), 0.5))
    got = fit_disp_grid(*_t(y, x, mu, grid, pm), 1.3, use_prior=use_prior,
                        weights=torch.as_tensor(w)).numpy()
    xla = np.asarray(jdisp._fit_disp_grid_core(
        *_j(y, x, mu, grid, pm), 1.3, use_prior=use_prior,
        weights=jnp.asarray(w), use_weights=True))
    np.testing.assert_array_equal(got, xla)


def _lp_dlp_restated(la, y, mu, x, pm, pv, w=None, use_prior=True):
    """K2's lp and dlp as csrc/disp_ls.cu evaluates them, in float64: the
    trial point's constants lgamma(c), log(c) and digamma(c) once per gene
    ((G,1) columns), the per-sample difference form, and one reciprocal
    r = 1/(1 + mu alpha) per sample for w = mu r, mu alpha/(1 + mu alpha)
    = mu alpha r and y/(mu + 1/alpha) = y alpha r.  Returns lp, dlp and the
    magnitude of every piece each one sums, special-function values before
    their difference included (the scale of its rounding).  lp is also
    K3's, as csrc/disp_grid.cu evaluates it."""
    la = torch.as_tensor(la)
    y, mu, x = (torch.as_tensor(a) for a in (y, mu, x))
    alpha = torch.exp(la)[:, None]
    c = 1.0 / alpha
    lgc, logc, dgc = torch.lgamma(c), torch.log(c), torch.digamma(c)
    mua = mu * alpha
    l1p = torch.log1p(mua)
    r = 1.0 / (1.0 + mua)
    lgy, dgy = torch.lgamma(y + c), torch.digamma(y + c)
    ll = lgy - lgc - y * logc - (y + c) * l1p
    s1 = l1p - mua * r + y * alpha * r - (dgy - dgc)
    ll_mag = lgy.abs() + lgc.abs() + (y * logc).abs() + ((y + c) * l1p).abs()
    s1_mag = l1p + mua * r + y * alpha * r + dgy.abs() + dgc.abs()
    wcr = mu * r
    if w is not None:
        w = torch.as_tensor(w)
        ll, s1, ll_mag, s1_mag = w * ll, w * s1, w * ll_mag, w * s1_mag
        wcr = torch.where(w > tdisp.CR_WEIGHT_THRESHOLD, wcr,
                          torch.zeros_like(wcr))
    b = torch.einsum("gs,si,sj->gij", wcr, x, x)
    db = torch.einsum("gs,si,sj->gij", -wcr * wcr, x, x)
    if w is not None:
        cm = (torch.einsum("gs,si->gi", (wcr > 0).double(), x * x)
              > 0).double()
        keep = cm[:, :, None] * cm[:, None, :]
        b = b * keep + torch.diag_embed(1.0 - cm)
        db = db * keep
    L = torch.linalg.cholesky(b)
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(-1)
    binv = torch.cholesky_inverse(L)
    tr_terms = binv * db.transpose(1, 2)
    a = alpha[:, 0]
    prior = -0.5 * (la - torch.as_tensor(pm)) ** 2 / pv * use_prior
    dprior = -(la - torch.as_tensor(pm)) / pv * use_prior
    lp = ll.sum(-1) - 0.5 * logdet + prior
    dlp = (s1.sum(-1) / a ** 2 - 0.5 * tr_terms.sum((1, 2))) * a + dprior
    lp_scale = ll_mag.sum(-1) + 0.5 * logdet.abs() + prior.abs()
    dlp_scale = (s1_mag.sum(-1) / a ** 2
                 + 0.5 * tr_terms.abs().sum((1, 2))) * a + dprior.abs()
    return lp.numpy(), dlp.numpy(), lp_scale.numpy(), dlp_scale.numpy()


@pytest.mark.parametrize("p,weighted", [(2, False), (2, True), (3, False)])
def test_restated_line_search_terms(p, weighted):
    """The per-sample terms in the form the K2 kernel evaluates them give
    the plain log_posterior/dlog_posterior and the JAX package's (the line
    search's core) to 1e-12 of the magnitude of the pieces summed (float64
    lgamma(c) reaches 1.3e7 here, so a difference of two libraries'
    lgamma values is not exact to 1e-12 of the result), over a grid of alphas
    from 1e-6 to 10 that crosses the float32 large-c threshold
    c > 16 max(y, 1) both ways."""
    y, x, mu, _, _ = _sim(G=240, p=p, seed=12)
    la = np.linspace(np.log(1e-6), np.log(10.0), len(y))
    large = 1.0 / np.exp(la)[:, None] > 16.0 * np.maximum(y, 1.0)
    assert 0.2 < large.mean() < 0.8
    pm = np.log(np.full(len(y), 0.5))
    w = _weights(y, x) if weighted else None
    lp, dlp, lp_s, dlp_s = _lp_dlp_restated(la, y, mu, x, pm, 1.3, w)
    tw = None if w is None else torch.as_tensor(w)
    rm, cm = tdisp.make_cr_masks(torch.as_tensor(x), tw)
    jw = {} if w is None else dict(
        weights=jnp.asarray(w), use_weights=True,
        **dict(zip(("row_mask", "col_mask"), jdisp.make_cr_masks(
            jnp.asarray(x), jnp.asarray(w), 1e-2, True))))
    for name, got, scale in (("log_posterior", lp, lp_s),
                             ("dlog_posterior", dlp, dlp_s)):
        plain = getattr(tdisp, name)(*_t(la, y, mu, x, pm), 1.3, True, tw,
                                     rm, cm).numpy()
        jax_v = np.asarray(getattr(jdisp, name)(*_j(la, y, mu, x, pm), 1.3,
                                                True, **jw))
        for ref in (plain, jax_v):
            assert np.all(np.abs(got - ref) <= 1e-12 * scale), name



def _grid_search_restated(lp_fn, grid, G, warps):
    """csrc/disp_grid.cu's two-stage search, in float64: in each stage warp
    w evaluates the points j = w, w + warps, ... in increasing j and keeps
    its first maximum (strict >), and the stage's pick is the largest of
    the warps' candidates, the smallest j on a tie (0 when no point won);
    the fine points lo + span j * (1/(n-1)).  lp_fn: (G,) log alpha -> (G,)
    log posterior."""
    grid = torch.as_tensor(grid)
    n = len(grid)
    delta = grid[1] - grid[0]

    def stage(points):                      # (n, G)
        lps = [lp_fn(points[j]) for j in range(n)]
        pick_lp = torch.zeros(G, dtype=torch.float64)
        pick_j = torch.full((G,), -1)
        for w in range(warps):
            best_lp = torch.full((G,), float("-inf"), dtype=torch.float64)
            best_j = torch.full((G,), -1)
            for j in range(w, n, warps):
                better = lps[j] > best_lp
                best_lp = torch.where(better, lps[j], best_lp)
                best_j = torch.where(better, torch.full_like(best_j, j),
                                     best_j)
            take = (best_j >= 0) & ((pick_j < 0) | (best_lp > pick_lp)
                                    | ((best_lp == pick_lp)
                                       & (best_j < pick_j)))
            pick_lp = torch.where(take, best_lp, pick_lp)
            pick_j = torch.where(take, best_j, pick_j)
        chosen = points.gather(0, pick_j.clamp(min=0)[None])[0]
        return torch.where(pick_j >= 0, chosen, torch.zeros_like(chosen))

    a_hat = stage(grid[:, None].expand(n, G))
    frac = torch.arange(n, dtype=torch.float64) * (1.0 / (n - 1))
    return stage((a_hat[None, :] - delta) + (2.0 * delta) * frac[:, None])


@pytest.mark.parametrize("use_prior", [False, True])
@pytest.mark.parametrize("p,weighted", [(2, False), (2, True), (3, False),
                                        (3, True)])
def test_restated_grid_terms(p, weighted, use_prior):
    """The log posterior in the form the K3 kernel evaluates it (each
    point's lgamma(c), log(c) and 1/c once per gene, w = mu r) equals the
    plain log_posterior and the JAX package's to 1e-12 of the magnitude of
    the pieces summed, at every point of the coarse grid; and the kernel's
    two-stage search on that form, its points spread over 4 warps, picks
    the points of fit_disp_grid_plain and of the JAX package's XLA core,
    and (p >= 2, unweighted) those of its Pallas kernel in interpret mode
    but for the near-ties its Lanczos lgamma flips."""
    y, x, mu, _, grid = _sim(G=200, p=p, seed=20 + p)
    G = len(y)
    pm = np.log(np.full(G, 0.5))
    w = _weights(y, x) if weighted else None
    tw = None if w is None else torch.as_tensor(w)
    rm, cm = tdisp.make_cr_masks(torch.as_tensor(x), tw)
    jw = {} if w is None else dict(
        weights=jnp.asarray(w), use_weights=True,
        **dict(zip(("row_mask", "col_mask"), jdisp.make_cr_masks(
            jnp.asarray(x), jnp.asarray(w), 1e-2, True))))
    for a in grid:
        la = np.full(G, a)
        got, _, scale, _ = _lp_dlp_restated(la, y, mu, x, pm, 1.3, w,
                                            use_prior)
        plain = tdisp.log_posterior(*_t(la, y, mu, x, pm), 1.3, use_prior,
                                    tw, rm, cm).numpy()
        jax_v = np.asarray(jdisp.log_posterior(*_j(la, y, mu, x, pm), 1.3,
                                               use_prior, **jw))
        for ref in (plain, jax_v):
            assert np.all(np.abs(got - ref) <= 1e-12 * scale), a

    def lp_fn(la):
        return torch.as_tensor(_lp_dlp_restated(la.numpy(), y, mu, x, pm,
                                                1.3, w, use_prior)[0])

    got = _grid_search_restated(lp_fn, grid, G, 4).numpy()
    plain = tdisp.fit_disp_grid_plain(*_t(y, x, mu, grid, pm), 1.3,
                                      use_prior=use_prior, weights=tw)
    np.testing.assert_array_equal(got, plain.numpy())
    xla = np.asarray(jdisp._fit_disp_grid_core(
        *_j(y, x, mu, grid, pm), 1.3, use_prior=use_prior,
        **({} if w is None else dict(weights=jnp.asarray(w),
                                     use_weights=True))))
    np.testing.assert_array_equal(got, xla)
    if not weighted:
        pal = np.asarray(fit_disp_grid_pallas(*_j(y, x, mu, grid, pm), 1.3,
                                              use_prior=use_prior,
                                              interpret=True))
        assert np.isclose(got, pal, atol=1e-9).mean() > 0.98
        lp_got = _lp(got, y, x, mu, pm, 1.3, use_prior)
        lp_pal = _lp(pal, y, x, mu, pm, 1.3, use_prior)
        assert np.all(lp_got >= lp_pal - 1e-6 * np.abs(lp_pal) - 1e-6)


def _stepped_posterior(G, seed=0):
    """A log posterior of log alpha made of steps, so that neighbouring
    grid points tie, with NaN on part of the axis for some genes and -inf
    or NaN on all of it for others."""
    rng = np.random.default_rng(seed)
    centre = torch.as_tensor(rng.uniform(-18.0, 3.0, G))
    width = torch.as_tensor(rng.choice([0.07, 0.2, 0.5, 1.5, 3.0], G))
    kind = torch.as_tensor(np.arange(G) % 6)

    def lp(la, *args, **kwargs):
        v = -torch.floor((la - centre).abs() / width)
        v = torch.where((kind == 1) & (la > centre), float("nan"), v)
        v = torch.where((kind == 2) & (la < centre - 2.0), float("-inf"), v)
        v = torch.where(kind == 3, torch.full_like(v, float("-inf")), v)
        v = torch.where(kind == 4, torch.full_like(v, float("nan")), v)
        return torch.where((kind == 5) & (la > centre), float("-inf"), v)

    return lp


@pytest.mark.parametrize("warps", [1, 3, 4, 7, 25])
def test_grid_first_max_any_warps(monkeypatch, warps):
    """The kernel's first-maximum rule with the points spread over `warps`
    warps (each warp's own first maximum, then the largest candidate, the
    smallest index on a tie) picks what fit_disp_grid_plain's strict `>`
    scan in index order picks, on posteriors with ties between
    neighbouring points in both stages, NaN points (which never win) and
    genes whose points are all -inf or NaN (which end at 0)."""
    y, x, mu, _, grid = _sim(G=120, seed=2)
    G = len(y)
    lp = _stepped_posterior(G)
    monkeypatch.setattr(tdisp, "log_posterior", lp)
    plain = tdisp.fit_disp_grid_plain(*_t(y, x, mu, grid,
                                          np.zeros(G)), 1.0).numpy()
    got = _grid_search_restated(lp, grid, G, warps).numpy()
    np.testing.assert_array_equal(got, plain)
    kind = np.arange(G) % 6
    assert np.all(plain[(kind == 3) | (kind == 4)] == 0.0)
