"""deseq2_tpu_torch.ops.nb / ops.linalg against deseq2_tpu.ops.nb / linalg.

Both packages get the same numpy inputs (the simulate() fixture of
tests/test_kernels.py) and run in float64 on the CPU, where every function
here is the same closed form: they agree to rounding (1e-12).  float32
takes the large-c series branches in both; there the two agree to float32
rounding.  digamma_pos (the CUDA kernels' digamma, CUDA's math library has
none) is held against scipy as tests/test_pallas_ls.py holds the Pallas
one.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.special import digamma as scipy_digamma
from scipy.special import gammaln, polygamma

from deseq2_tpu.ops import linalg as jlinalg
from deseq2_tpu.ops import nb as jnb
from deseq2_tpu_torch.ops import linalg as tlinalg
from deseq2_tpu_torch.ops import nb as tnb
from torch_threads import one_torch_thread  # noqa: F401


def simulate(G=60, S=8, p=2, seed=0):
    """tests/test_kernels.py:simulate (unweighted)."""
    rng = np.random.default_rng(seed)
    x = np.column_stack([np.ones(S),
                         np.repeat([0.0, 1.0], [S // 2, S - S // 2])])[:, :p]
    if p > 2:
        x = np.column_stack([x, rng.normal(size=(S, p - 2))])
    beta_true = np.column_stack([rng.normal(3, 1, G),
                                 rng.normal(0, 1, (G, p - 1))])
    alpha = np.exp(rng.normal(-2.5, 0.7, G))
    mu = np.exp(x @ beta_true.T).T
    y = rng.negative_binomial(1.0 / alpha[:, None],
                              1.0 / (1.0 + alpha[:, None] * mu))
    return y.astype(np.float64), x, alpha, mu


def _pair(fn_name, y, c, dtype):
    t = getattr(tnb, fn_name)(torch.as_tensor(y, dtype=dtype),
                              torch.as_tensor(c, dtype=dtype)).numpy()
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    j = np.asarray(getattr(jnb, fn_name)(jnp.asarray(y, jdt),
                                         jnp.asarray(c, jdt)))
    return t, j


@pytest.mark.parametrize("fn_name", ["lgamma_diff_centered", "digamma_diff",
                                     "trigamma_diff"])
def test_nb_differences_f64(fn_name):
    y, _, alpha, _ = simulate(G=200, S=12, seed=1)
    c = np.broadcast_to((1.0 / alpha)[:, None], y.shape)
    t, j = _pair(fn_name, y, c, torch.float64)
    np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fn_name", ["lgamma_diff_centered", "digamma_diff",
                                     "trigamma_diff"])
def test_nb_differences_f32_series_branch(fn_name):
    """c from 1 to 1e8: both branches of the float32 crossover."""
    rng = np.random.default_rng(2)
    y = rng.integers(0, 200, 4000).astype(np.float64)
    c = 10.0 ** rng.uniform(0, 8, 4000)
    t, j = _pair(fn_name, y, c, torch.float32)
    large = c > 16.0 * np.maximum(y, 1.0)
    assert 0.3 < large.mean() < 0.9
    # series branch: both evaluate the same polynomial
    np.testing.assert_allclose(t[large], j[large], rtol=1e-5, atol=1e-30)
    # direct branch: a difference of two float32 special-function values
    # (each library's own), so the error scales with their size
    terms = {"lgamma_diff_centered": lambda v: np.abs(gammaln(v)),
             "digamma_diff": lambda v: np.abs(scipy_digamma(v)),
             "trigamma_diff": lambda v: np.abs(polygamma(1, v))}[fn_name]
    floor = 16 * np.finfo(np.float32).eps * (terms(y + c) + terms(c)
                                             + np.abs(y * np.log(c)))
    assert np.all(np.abs(t - j)[~large] <= floor[~large] + 1e-6
                  * np.abs(j[~large]))


def test_trigamma_accuracy():
    z = np.concatenate([np.linspace(1e-3, 5, 300), np.logspace(1, 8, 200)])
    ours = tnb.trigamma(torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(ours, polygamma(1, z), rtol=1e-13, atol=0)


def test_nb_lgamma_const():
    y, _, alpha, _ = simulate(G=200, S=12, seed=3)
    a = alpha[:, None]
    t = tnb.nb_lgamma_const(torch.as_tensor(y), torch.as_tensor(a)).numpy()
    j = np.asarray(jnb.nb_lgamma_const(jnp.asarray(y), jnp.asarray(a)))
    np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-12)


def test_digamma_pos_accuracy():
    z = np.concatenate([np.linspace(4.5e-5, 5, 300), np.logspace(1, 8, 200)])
    ours = tnb.digamma_pos(torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(ours, scipy_digamma(z), rtol=5e-11,
                               atol=5e-11)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_linalg_matches(p):
    y, x, alpha, mu = simulate(G=80, S=10, p=max(p, 2), seed=4 + p)
    x = x[:, :p]
    w = mu / (1.0 + alpha[:, None] * mu)
    a = np.einsum("gs,si,sj->gij", w, x, x) + 1e-3 * np.eye(p)
    b = np.einsum("gs,si->gi", w * np.log(y + 1.0), x)[..., None]
    at, bt = torch.as_tensor(a), torch.as_tensor(b)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(tlinalg.chol_solve(at, bt).numpy(),
                               np.asarray(jlinalg.chol_solve(aj, bj)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tlinalg.spd_inverse(at).numpy(),
                               np.asarray(jlinalg.spd_inverse(aj)),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tlinalg.spd_logdet(at).numpy(),
                               np.asarray(jlinalg.spd_logdet(aj)),
                               rtol=1e-12, atol=1e-12)


def test_chol_solve_not_spd_gives_nan():
    """A matrix that is not positive definite gives NaN for its own gene
    (as jnp.linalg.cholesky does) and leaves the rest of the batch."""
    a = torch.stack([torch.eye(2, dtype=torch.float64),
                     -torch.eye(2, dtype=torch.float64)])
    out = tlinalg.chol_solve(a, torch.ones(2, 2, 1, dtype=torch.float64))
    assert torch.equal(out[0], torch.ones(2, 1, dtype=torch.float64))
    assert torch.isnan(out[1]).all()
