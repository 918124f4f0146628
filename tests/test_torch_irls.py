"""Plain K1 (deseq2_tpu_torch.ops.irls.fit_beta_plain, the CPU side of the
fit_beta wrapper) against the JAX package's XLA core _fit_beta_core and
its Pallas kernel fit_beta_pallas in interpret mode.

float64 on the CPU, the fixture of tests/test_pallas_irls.py, and that
file's tolerances: the deviance trajectories agree to rounding, so every
convergence decision matches and the betas agree to solver tolerance.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from deseq2_tpu.ops.irls import _fit_beta_core
from deseq2_tpu.ops.pallas_irls import fit_beta_pallas
from deseq2_tpu_torch.ops.cuda_irls import fit_beta
from torch_threads import one_torch_thread  # noqa: F401


def _sim(G=300, S=24, p=2, seed=0):
    """tests/test_pallas_irls.py:_sim as numpy arrays."""
    rng = np.random.default_rng(seed)
    cols = [np.ones(S)]
    for _ in range(p - 1):
        cols.append(rng.permutation([0.0, 1.0] * (S // 2)))
    x = np.column_stack(cols)
    beta_true = np.column_stack(
        [rng.normal(3.0, 1.0, G)] +
        [rng.normal(0.0, 1.0, G) for _ in range(p - 1)])
    mu = np.exp(beta_true @ x.T)
    alpha = np.clip(4.0 / mu[:, 0] + 0.1, 0.05, 5.0)
    size = 1.0 / alpha[:, None]
    y = rng.negative_binomial(size, size / (size + mu)).astype(np.float64)
    nf = np.ones((G, S))
    beta_init = np.log(np.maximum(y.mean(axis=1), 0.5))[:, None] * \
        np.concatenate([[1.0], np.zeros(p - 1)])[None, :]
    ridge = np.full(p, 1e-6 / np.log(2.0) ** 2)
    return y, x, nf, alpha, beta_init, ridge


def _torch_fit(args):
    return {k: v.numpy() for k, v in
            fit_beta(*(torch.as_tensor(a) for a in args), maxit=100,
                     min_mu=0.5).items()}


def _assert_matches(got, ref, conv):
    """tests/test_pallas_irls.py:test_irls_kernel_matches_xla's checks."""
    np.testing.assert_allclose(got["beta"][conv], ref["beta"][conv],
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["beta_var"][conv], ref["beta_var"][conv],
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(got["deviance"][conv], ref["deviance"][conv],
                               rtol=1e-8, atol=1e-6)
    np.testing.assert_allclose(got["hat_diag"][conv], ref["hat_diag"][conv],
                               rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got["mu"][conv], ref["mu"][conv],
                               rtol=1e-6, atol=1e-6)
    assert (got["iter"][conv] == ref["iter"][conv]).mean() > 0.98


@pytest.mark.parametrize("p", [2, 3])
def test_plain_irls_matches_xla_and_pallas(p):
    args = _sim(p=p, seed=p)
    got = _torch_fit(args)
    jargs = [jnp.asarray(a) for a in args]
    xla = {k: np.asarray(v) for k, v in
           _fit_beta_core(*jargs, maxit=100, min_mu=0.5).items()}
    pal = {k: np.asarray(v) for k, v in
           fit_beta_pallas(*jargs, maxit=100, min_mu=0.5,
                           interpret=True).items()}
    conv = xla["iter"] < 100
    assert conv.mean() > 0.95
    _assert_matches(got, xla, conv)
    _assert_matches(got, pal, conv)
    # the non-converged verdicts agree too
    assert np.array_equal(got["iter"] < 100, conv)


def test_plain_irls_p1_matches_xla():
    """p = 1 (intercept only): outside the Pallas kernel's p >= 2 gate, so
    held against the XLA core alone."""
    args = _sim(p=1, seed=11)
    got = _torch_fit(args)
    xla = {k: np.asarray(v) for k, v in
           _fit_beta_core(*(jnp.asarray(a) for a in args), maxit=100,
                          min_mu=0.5).items()}
    conv = xla["iter"] < 100
    assert conv.mean() > 0.95
    _assert_matches(got, xla, conv)


def test_plain_irls_nf_row():
    """An (S,) shared normalization row gives the (G,S) matrix's result."""
    y, x, _, alpha, beta_init, ridge = _sim(seed=7)
    sf = np.exp(np.random.default_rng(1).normal(0, 0.3, y.shape[1]))
    full = _torch_fit((y, x, np.broadcast_to(sf[None, :], y.shape).copy(),
                       alpha, beta_init, ridge))
    row = _torch_fit((y, x, sf, alpha, beta_init, ridge))
    for k in full:
        np.testing.assert_allclose(row[k], full[k], rtol=1e-12, atol=1e-12,
                                   err_msg=k)


def test_plain_irls_f32_against_f64():
    """The float32 exits (the 30 eps deviance floor and the beta stall)
    stop where float64 does to float32 resolution."""
    y, x, nf, alpha, beta_init, ridge = _sim(p=2, seed=5)
    ref = _torch_fit((y, x, nf, alpha, beta_init, ridge))
    got = {k: v.numpy() for k, v in fit_beta(
        *(torch.as_tensor(a, dtype=torch.float32)
          for a in (y, x, nf, alpha, beta_init, ridge))).items()}
    conv = (ref["iter"] < 100) & (got["iter"] < 100)
    assert conv.mean() > 0.95
    np.testing.assert_allclose(got["beta"][conv], ref["beta"][conv],
                               rtol=1e-3, atol=1e-3)


def _weights(y, seed=7):
    """tests/test_pallas_irls.py:test_irls_kernel_weighted_matches_xla's
    weights, max-1 normalized."""
    rng = np.random.default_rng(seed)
    w = np.clip(rng.random(y.shape) + 0.25, 0.0, 1.0)
    return w / w.max(axis=1, keepdims=True)


@pytest.mark.parametrize("p", [1, 2, 3])
def test_weighted_irls_matches_xla_and_pallas(p):
    """Weighted plain K1 against the weighted XLA core, and (p >= 2, the
    Pallas kernel's gate) against the weighted Pallas kernel in interpret
    mode, with tests/test_pallas_irls.py's tolerances."""
    y, x, nf, alpha, beta_init, ridge = _sim(p=p, seed=5)
    w = _weights(y)
    got = {k: v.numpy() for k, v in fit_beta(
        *(torch.as_tensor(a) for a in (y, x, nf, alpha, beta_init, ridge)),
        maxit=100, min_mu=0.5, weights=torch.as_tensor(w)).items()}
    jargs = [jnp.asarray(a) for a in (y, x, nf, alpha, beta_init, ridge)]
    refs = [_fit_beta_core(*jargs, maxit=100, min_mu=0.5,
                           weights=jnp.asarray(w), use_weights=True)]
    if p >= 2:
        refs.append(fit_beta_pallas(*jargs, maxit=100, min_mu=0.5,
                                    interpret=True, weights=jnp.asarray(w)))
    conv = np.asarray(refs[0]["iter"]) < 100
    assert conv.mean() > 0.95
    for ref in refs:
        ref = {k: np.asarray(v) for k, v in ref.items()}
        for k, rtol in (("beta", 1e-6), ("beta_var", 1e-5),
                        ("deviance", 1e-8), ("hat_diag", 1e-5)):
            np.testing.assert_allclose(got[k][conv], ref[k][conv],
                                       rtol=rtol, atol=1e-7, err_msg=k)
        assert np.array_equal(got["iter"][conv], ref["iter"][conv])


@pytest.mark.parametrize("nf_kind", ["row", "matrix"])
def test_weighted_irls_norm_factors(nf_kind):
    """Weights with an (S,) row and with gene x sample (G,S) normalization
    factors against the weighted XLA core (which takes the (G,S) matrix)."""
    y, x, _, alpha, beta_init, ridge = _sim(p=2, seed=9)
    rng = np.random.default_rng(2)
    nf_m = np.exp(rng.normal(0.0, 0.2, y.shape))
    nf_m /= np.exp(np.log(nf_m).mean(axis=1))[:, None]
    if nf_kind == "row":
        nf_in = np.exp(rng.normal(0.0, 0.3, y.shape[1]))
        nf_m = np.broadcast_to(nf_in, y.shape).copy()
    else:
        nf_in = nf_m
    w = _weights(y, seed=3)
    got = {k: v.numpy() for k, v in fit_beta(
        *(torch.as_tensor(a) for a in (y, x, nf_in, alpha, beta_init,
                                       ridge)),
        weights=torch.as_tensor(w)).items()}
    ref = {k: np.asarray(v) for k, v in _fit_beta_core(
        *(jnp.asarray(a) for a in (y, x, nf_m, alpha, beta_init, ridge)),
        maxit=100, min_mu=0.5, weights=jnp.asarray(w),
        use_weights=True).items()}
    conv = ref["iter"] < 100
    assert conv.mean() > 0.95
    _assert_matches(got, ref, conv)


def _fused_pass(beta, y, x, nf, alpha, min_mu, w=None):
    """One pass over the rows as csrc/irls.cu makes it per sweep, in
    float64: mu from beta, and at that mu the deviance and X'WX, X'Wz
    together, and the deviance constant with lgamma(size) and size
    log(size) once per gene."""
    y, x, nf, alpha, beta = (torch.as_tensor(a) for a in (y, x, nf, alpha,
                                                          beta))
    size = (1.0 / alpha)[:, None]
    xb = beta @ x.T
    raw = nf * torch.exp(xb)
    clamped = ~(raw > min_mu)
    m = torch.where(clamped, torch.full_like(raw, min_mu), raw)
    lm, lsm = torch.log(m), torch.log(size + m)
    lgs, sls = torch.lgamma(size), size * torch.log(size)
    const = torch.lgamma(y + size) - lgs - torch.lgamma(y + 1.0) + sls
    dev = -size * lsm + torch.where(y > 0, y * (lm - lsm),
                                    torch.zeros_like(y))
    ww = m / (1.0 + alpha[:, None] * m)
    if w is not None:
        w = torch.as_tensor(w)
        const, dev, ww = w * const, w * dev, w * ww
    z = lm - torch.log(nf) + (y - m) / m
    deviance = -2.0 * const.sum(-1) + (-2.0) * dev.sum(-1)
    return (torch.einsum("gs,si,sj->gij", ww, x, x),
            torch.einsum("gs,si->gi", ww * z, x), deviance, clamped)


def _two_passes(beta, y, x, nf, alpha, min_mu, w=None):
    """The same three quantities the way ops/irls.py:fit_beta_plain forms
    them: mu stored by the deviance pass, then the normal equations read it
    back with z = log(mu) - log(nf) + (y - mu)/mu."""
    from deseq2_tpu_torch.ops.irls import xx_flat
    from deseq2_tpu_torch.ops.nb import nb_lgamma_const
    y, x, nf, alpha, beta = (torch.as_tensor(a) for a in (y, x, nf, alpha,
                                                          beta))
    size = (1.0 / alpha)[:, None]
    wts = None if w is None else torch.as_tensor(w)

    def wsum(t):
        return (t if wts is None else wts * t).sum(-1)

    mu = torch.clamp(nf * torch.exp(beta @ x.T), min=min_mu)
    tt = torch.where(y > 0, y * (torch.log(mu) - torch.log(size + mu)),
                     torch.zeros_like(y))
    deviance = (-2.0 * wsum(nb_lgamma_const(y, alpha[:, None]))
                + (-2.0) * wsum(-size * torch.log(size + mu) + tt))
    ww = mu / (1.0 + alpha[:, None] * mu)
    ww = ww if wts is None else wts * ww
    z = torch.log(mu) - torch.log(nf) + (y - mu) / mu
    p = x.shape[1]
    return (ww @ xx_flat(x)).reshape(-1, p, p), (ww * z) @ x, deviance


@pytest.mark.parametrize("weighted", [False, True])
def test_fused_sweep_matches_two_passes(weighted):
    """K1's one pass per sweep gives the X'WX, X'Wz and deviance of the
    plain version's two passes to 1e-12 relative, with gene x sample
    factors and with samples on the min_mu clamp."""
    y, x, _, alpha, _, _ = _sim(p=3, seed=13)
    rng = np.random.default_rng(4)
    nf = np.exp(rng.normal(0.0, 0.3, y.shape))
    beta = np.column_stack([rng.normal(1.0, 2.0, len(y)),
                            rng.normal(0.0, 1.0, (len(y), 2))])
    w = _weights(y, seed=5) if weighted else None
    xtwx, xtwz, dev, clamped = _fused_pass(beta, y, x, nf, alpha, 0.5, w)
    assert 0.05 < clamped.double().mean() < 0.5
    ref = _two_passes(beta, y, x, nf, alpha, 0.5, w)
    for got, want, name in zip((xtwx, xtwz, dev), ref,
                               ("X'WX", "X'Wz", "deviance")):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=0, err_msg=name)
