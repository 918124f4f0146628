"""Ridge-penalized NB GLM IRLS over the genes axis: the plain version of
kernel K1 (csrc/irls.cu).

Same contract as the reference's fitBeta (src/DESeq2.cpp:282-465):

    mu    = nf * exp(X beta)           clamped at min_mu
    W     = mu / (1 + alpha mu)
    z     = log(mu/nf) + (y - mu)/mu
    A     = X'WX + diag(ridge);  beta <- A^-1 X'Wz
    dev   = -2 sum dnbinom_mu(y; 1/alpha, mu)
    stop when |dev - dev_old| / (|dev| + 0.1) < max(tol, 30 eps)
    |beta| > 30 (or a NaN deviance test) -> iter := maxit

Observation weights (`weights`, (G,S), max-1 normalized by the caller)
multiply W, the deviance terms, the sandwich's X'WX and the hat diagonal
(cpp:337-341, 365-373).

plus, in float32 only, an exit once beta stops moving at f32 resolution
(the deviance is a sum of S large terms whose rounding noise can exceed
the relative tolerance).  After the fit: the sandwich variance
diag(A^-1 X'WX A^-1), the hat diagonal w x' A^-1 x and the clamped mu.

Every gene is independent, so each sweep runs only on the genes still
iterating, gathered with torch.nonzero: the result equals a lockstep loop
over all genes.
"""

from __future__ import annotations

import torch

from .linalg import chol_solve, spd_inverse
from .nb import nb_lgamma_const

LARGE_BETA = 30.0


def xx_flat(x):
    """(S,p) design -> (S, p*p) per-sample outer products x_s x_s'."""
    S, p = x.shape
    return (x[:, :, None] * x[:, None, :]).reshape(S, p * p)


def fit_beta_plain(y, x, nf, alpha, beta_init, ridge, tol=1e-8, maxit=100,
                   min_mu=0.5, weights=None):
    """y: (G,S); x: (S,p); nf: (S,) shared row or (G,S); alpha: (G,);
    beta_init: (G,p); ridge: (p,); weights: (G,S) or None.  Returns
    dict(beta, beta_var, iter, hat_diag, deviance, mu); the dtype is
    beta_init's."""
    G, S = y.shape
    p = x.shape[1]
    dtype = beta_init.dtype
    y = y.to(dtype)
    x = x.to(dtype)
    nf = nf.to(dtype)
    alpha = alpha.to(dtype)
    nf_row = nf.dim() == 1
    size = 1.0 / alpha
    wts = None if weights is None else weights.to(dtype)

    def wsum(terms, idx=None):
        if wts is None:
            return terms.sum(-1)
        return ((wts if idx is None else wts[idx]) * terms).sum(-1)

    def wmul(w, idx=None):
        return w if wts is None else (wts if idx is None else wts[idx]) * w

    dev_const = -2.0 * wsum(nb_lgamma_const(y, alpha[:, None]))
    log_nf = torch.log(nf)
    ridge_mat = torch.diag(ridge.to(dtype))
    xx = xx_flat(x)

    def rows(a, idx):
        return a if nf_row else a[idx]

    def compute_mu(beta, nf_b):
        return torch.clamp(nf_b * torch.exp(beta @ x.T), min=min_mu)

    mu = compute_mu(beta_init, nf)
    eps = torch.finfo(dtype).eps
    tol = max(tol, 30.0 * eps)
    beta = beta_init.to(dtype).clone()
    dev_old = torch.zeros(G, dtype=dtype, device=y.device)
    dev = torch.zeros(G, dtype=dtype, device=y.device)
    iters = torch.zeros(G, dtype=torch.int32, device=y.device)
    active = torch.ones(G, dtype=torch.bool, device=y.device)

    for t in range(maxit):
        idx = torch.nonzero(active).squeeze(1)
        if idx.numel() == 0:
            break
        yb, mub, ab = y[idx], mu[idx], alpha[idx]
        iters[idx] += 1
        w = wmul(mub / (1.0 + ab[:, None] * mub), idx)
        z = torch.log(mub) - rows(log_nf, idx) + (yb - mub) / mub
        A = (w @ xx).reshape(-1, p, p) + ridge_mat
        rhs = (w * z) @ x
        beta_new = chol_solve(A, rhs[..., None])[..., 0]
        diverged = torch.any(beta_new.abs() > LARGE_BETA, dim=-1)
        beta_prev = beta[idx]
        beta[idx] = beta_new
        cont = ~diverged
        mu_new = compute_mu(beta_new, rows(nf, idx))
        sz = size[idx, None]
        tt = torch.where(yb > 0, yb * (torch.log(mu_new)
                                       - torch.log(sz + mu_new)),
                         torch.zeros_like(yb))
        dev_new = dev_const[idx] + (-2.0) * wsum(
            -sz * torch.log(sz + mu_new) + tt, idx)
        mu[idx] = torch.where(cont[:, None], mu_new, mub)
        dev[idx] = torch.where(cont, dev_new, dev[idx])
        do = dev_old[idx]
        conv_test = (dev_new - do).abs() / (dev_new.abs() + 0.1)
        bad = torch.isnan(conv_test)
        converged = (conv_test < tol) & (t > 0)
        if eps > 1e-10:
            dbeta = (beta_new - beta_prev).abs().amax(-1)
            scale = 1.0 + beta_new.abs().amax(-1)
            converged = converged | ((dbeta < 32.0 * eps * scale) & (t > 0))
        iters[idx] = torch.where(diverged | bad,
                                 torch.full_like(iters[idx], maxit),
                                 iters[idx])
        active[idx] = cont & ~bad & ~converged
        dev_old[idx] = torch.where(cont, dev_new, do)

    # post-fit quantities from the final (beta, mu) (cpp:429-455)
    w = wmul(mu / (1.0 + alpha[:, None] * mu))
    xtwx = (w @ xx).reshape(G, p, p)
    ainv = spd_inverse(xtwx + ridge_mat)
    hat_diag = w * (ainv.reshape(G, p * p) @ xx.T)
    sigma = ainv @ xtwx @ ainv
    beta_var = torch.diagonal(sigma, dim1=-2, dim2=-1)
    return dict(beta=beta, beta_var=beta_var, iter=iters, hat_diag=hat_diag,
                deviance=dev, mu=mu)
