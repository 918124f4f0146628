"""Batched dispersion estimation: the plain versions of kernels K2
(csrc/disp_ls.cu, the line search) and K3 (csrc/disp_grid.cu, the grid).

The NB log posterior of log(alpha) with the Cox-Reid adjustment
(src/DESeq2.cpp:31-107), its derivative, the Armijo backtracking ascent
with the reference's accept/step rules (cpp:163-277) and the two-stage grid
search (cpp:468-513), all batched over genes.  The log-likelihood keeps the
reference's form without the lgamma(y+1) constant: the gene-wise
"noIncrease" rule compares raw lp values (R/core.R:827-830).

With observation weights (`weights`, (G,S)) the likelihood terms are
weighted, and the Cox-Reid term is not: it keeps the design rows whose
weight exceeds `weight_threshold` (CR_WEIGHT_THRESHOLD by default) and
drops, per gene, the columns left without support, with a unit diagonal so
the kept submatrix's log determinant survives (cpp:38-44; the JAX
package's make_cr_masks and _cr_b_matrices).  `use_cr=False` drops the
Cox-Reid term altogether (the reference's useCR).

Every gene is independent, so each line-search trip runs only on the genes
still iterating, gathered with torch.nonzero: the result equals a lockstep
loop over all genes.
"""

from __future__ import annotations

import torch

from .irls import xx_flat
from .linalg import spd_inverse, spd_logdet
from .nb import digamma_diff, lgamma_diff_centered

EPSILON_ARMIJO = 1.0e-4  # cpp:175
# the weighted Cox-Reid term's row threshold (cpp:38-44; cr_keeps in
# csrc/common.cuh)
CR_WEIGHT_THRESHOLD = 1e-2


def make_cr_masks(x, weights, weight_threshold=CR_WEIGHT_THRESHOLD):
    """Row mask (G,S) and column mask (G,p) of the weighted Cox-Reid term:
    the rows with weight > weight_threshold, and the columns with nonzero
    x on some kept row.  (None, None) without weights."""
    if weights is None:
        return None, None
    row_mask = weights > weight_threshold
    col_mask = (row_mask.to(x.dtype) @ x.abs()) > 0.0
    return row_mask, col_mask


def _cr_b(x, w, row_mask=None, col_mask=None, embed=False):
    """b = X' diag(w_g) X for every gene: (G,S),(S,p) -> (G,p,p), over the
    masked rows and columns; `embed` puts a unit diagonal on the dropped
    columns (for b itself, not its derivative)."""
    p = x.shape[1]
    if row_mask is not None:
        w = torch.where(row_mask, w, torch.zeros_like(w))
    b = (w @ xx_flat(x)).reshape(-1, p, p)
    if col_mask is not None:
        cm = col_mask.to(b.dtype)
        b = b * (cm[:, :, None] * cm[:, None, :])
        if embed:
            b = b + torch.diag_embed(1.0 - cm)
    return b


def _wsum(terms, weights):
    return (terms if weights is None else weights * terms).sum(-1)


def log_posterior(log_alpha, y, mu, x, prior_mean, prior_var, use_prior,
                  weights=None, row_mask=None, col_mask=None, use_cr=True):
    """Batched NB log posterior of dispersion (cpp:31-64).

    log_alpha, prior_mean: (G,); y, mu: (G,S); x: (S,p); prior_var scalar;
    weights (G,S) with the masks of make_cr_masks, or None; `use_cr`
    adds the Cox-Reid term.
    """
    alpha = torch.exp(log_alpha)[:, None]
    inv_alpha = 1.0 / alpha
    if use_cr:
        w = 1.0 / (1.0 / mu + alpha)
        cr = -0.5 * spd_logdet(_cr_b(x, w, row_mask, col_mask, embed=True))
    else:
        cr = 0.0
    l1p = torch.log1p(mu * alpha)
    ll = _wsum(lgamma_diff_centered(y, inv_alpha) - (y + inv_alpha) * l1p,
               weights)
    if use_prior:
        return ll + (-0.5 * (log_alpha - prior_mean) ** 2 / prior_var) + cr
    return ll + 0.0 + cr


def dlog_posterior(log_alpha, y, mu, x, prior_mean, prior_var, use_prior,
                   weights=None, row_mask=None, col_mask=None, use_cr=True):
    """d/d(log alpha) of the log posterior (cpp:68-107)."""
    alpha_v = torch.exp(log_alpha)
    alpha = alpha_v[:, None]
    inv_alpha = 1.0 / alpha
    if use_cr:
        denom = 1.0 / mu + alpha
        w = 1.0 / denom
        dw = -1.0 / denom ** 2
        b_inv = spd_inverse(_cr_b(x, w, row_mask, col_mask, embed=True))
        dcr = -0.5 * torch.einsum("gpq,gqp->g", b_inv,
                                  _cr_b(x, dw, row_mask, col_mask))
    else:
        dcr = 0.0
    terms = (torch.log1p(mu * alpha)
             - mu * alpha / (1.0 + mu * alpha)
             - digamma_diff(y, inv_alpha) + y / (mu + inv_alpha))
    ll_part = _wsum(terms, weights) / alpha_v ** 2
    out = (ll_part + dcr) * alpha_v
    if use_prior:
        return out + (-(log_alpha - prior_mean) / prior_var)
    return out + 0.0


def _gene_rows(weights, x, dtype, weight_threshold):
    """The per-gene (weights, row mask, column mask) triple, or Nones."""
    if weights is None:
        return None, None, None
    weights = weights.to(dtype)
    rm, cm = make_cr_masks(x, weights, weight_threshold)
    return weights, rm, cm


def _take(t, idx):
    return None if t is None else t[idx]


def fit_disp_line_search_plain(y, x, mu, log_alpha_init, prior_mean,
                               prior_var, min_log_alpha, kappa_0=1.0,
                               tol=1e-6, maxit=100, use_prior=False,
                               weights=None, use_cr=True,
                               weight_threshold=CR_WEIGHT_THRESHOLD):
    """Batched Armijo backtracking ascent on log(alpha) (cpp:163-277).

    maxit is an int, or a (G,) integer tensor of per-gene caps (each gene
    stops after its own count, as a run at that int maxit would).
    Returns dict(log_alpha, iter, iter_accept, last_change, initial_lp,
    initial_dlp, last_lp, last_dlp); the dtype is mu's."""
    G = y.shape[0]
    dtype = mu.dtype
    dev = mu.device
    y = y.to(dtype)
    x = x.to(dtype)
    prior_mean = prior_mean.to(dtype)
    a = log_alpha_init.to(dtype).clone()
    wts, rm, cm = _gene_rows(weights, x, dtype, weight_threshold)

    def lp_fn(la, idx):
        return log_posterior(la, y[idx], mu[idx], x, prior_mean[idx],
                             prior_var, use_prior, _take(wts, idx),
                             _take(rm, idx), _take(cm, idx), use_cr)

    def dlp_fn(la, idx):
        return dlog_posterior(la, y[idx], mu[idx], x, prior_mean[idx],
                              prior_var, use_prior, _take(wts, idx),
                              _take(rm, idx), _take(cm, idx), use_cr)

    every = torch.arange(G, device=dev)
    lp0 = lp_fn(a, every)
    dlp0 = dlp_fn(a, every)
    eps = torch.finfo(dtype).eps
    # in float32 an absolute lp change below |lp| eps is rounding noise
    tol_eff = torch.clamp(lp0.abs() * 50.0 * eps, min=tol)

    kappa = torch.full((G,), kappa_0, dtype=dtype, device=dev)
    lp, dlp = lp0.clone(), dlp0.clone()
    iters = torch.zeros(G, dtype=torch.int32, device=dev)
    iter_accept = torch.zeros(G, dtype=torch.int32, device=dev)
    change = torch.full((G,), -1.0, dtype=dtype, device=dev)
    done = torch.zeros(G, dtype=torch.bool, device=dev)

    caps = maxit.to(dev) if torch.is_tensor(maxit) else None
    if caps is not None:
        done |= caps <= 0
    steps = maxit if caps is None else int(caps.max()) if G else 0
    for _ in range(steps):
        idx = torch.nonzero(~done).squeeze(1)
        if idx.numel() == 0:
            break
        iters[idx] += 1
        a_i, k_i, lp_i, dlp_i = a[idx], kappa[idx], lp[idx], dlp[idx]
        a_propose = a_i + k_i * dlp_i
        # step clamps so log alpha stays in [-30, 10] (cpp:216-224)
        k_i = torch.where(a_propose < -30.0, (-30.0 - a_i) / dlp_i, k_i)
        k_i = torch.where(a_propose > 10.0, (10.0 - a_i) / dlp_i, k_i)
        a_new = a_i + k_i * dlp_i
        lp_new = lp_fn(a_new, idx)
        accept = -lp_new <= -lp_i - k_i * EPSILON_ARMIJO * dlp_i ** 2
        acc_i = iter_accept[idx] + accept.to(torch.int32)
        change_new = lp_new - lp_i
        tol_i = tol_eff[idx]
        conv = change_new < tol_i
        under = a_new < min_log_alpha
        a_i = torch.where(accept, a_new, a_i)
        change[idx] = torch.where(accept, change_new, change[idx])
        lp[idx] = torch.where(accept & (conv | ~under), lp_new, lp_i)
        if eps > 1e-10:
            stalled = ~accept & (k_i * dlp_i ** 2 < tol_i)
        else:
            stalled = torch.zeros_like(accept)
        newly_done = (accept & (conv | under)) | stalled
        cont_accept = accept & ~conv & ~under
        dlp_next = dlp_fn(a_i, idx)
        dlp[idx] = torch.where(cont_accept, dlp_next, dlp_i)
        kap_acc = torch.clamp(k_i * 1.1, max=kappa_0)
        kap_acc = torch.where(acc_i % 5 == 0, kap_acc / 2.0, kap_acc)
        kappa[idx] = torch.where(cont_accept, kap_acc,
                                 torch.where(~accept, k_i / 2.0, k_i))
        a[idx] = a_i
        iter_accept[idx] = acc_i
        done[idx] = newly_done if caps is None \
            else newly_done | (iters[idx] >= caps[idx])
    return dict(log_alpha=a, iter=iters, iter_accept=iter_accept,
                last_change=change, initial_lp=lp0, initial_dlp=dlp0,
                last_lp=lp, last_dlp=dlp)


def grid_fractions(n, dtype, device):
    """The fine grid's offsets j/(n-1) in [0, 1], computed as numpy's
    linspace does, j * (1/(n-1)) (torch.linspace and j/(n-1) differ from
    it in the last bit)."""
    frac = torch.arange(n, dtype=torch.float64) * (1.0 / (n - 1))
    return frac.to(device=device, dtype=dtype)


def fit_disp_grid_plain(y, x, mu, disp_grid, prior_mean, prior_var,
                        use_prior=False, weights=None, use_cr=True,
                        weight_threshold=CR_WEIGHT_THRESHOLD):
    """Two-stage grid search over log alpha (cpp:468-513): the shared
    coarse grid, then n points spanning the gene's argmax +- one coarse
    step; the first maximum wins.  Returns (G,) log alpha."""
    G = y.shape[0]
    dtype = mu.dtype
    y = y.to(dtype)
    x = x.to(dtype)
    disp_grid = disp_grid.to(dtype)
    prior_mean = prior_mean.to(dtype)
    n = disp_grid.shape[0]
    delta = disp_grid[1] - disp_grid[0]
    wts, rm, cm = _gene_rows(weights, x, dtype, weight_threshold)

    def argmax_over(points):
        best_lp = torch.full((G,), float("-inf"), dtype=dtype,
                             device=mu.device)
        best_a = torch.zeros(G, dtype=dtype, device=mu.device)
        for a_row in points:
            lp = log_posterior(a_row, y, mu, x, prior_mean, prior_var,
                               use_prior, wts, rm, cm, use_cr)
            better = lp > best_lp
            best_lp = torch.where(better, lp, best_lp)
            best_a = torch.where(better, a_row, best_a)
        return best_a

    a_hat = argmax_over(disp_grid[:, None].expand(n, G))
    frac = grid_fractions(n, dtype, mu.device)
    fine = (a_hat[None, :] - delta) + (2.0 * delta) * frac[:, None]
    return argmax_over(fine)
