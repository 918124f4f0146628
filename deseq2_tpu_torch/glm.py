"""Batched NB GLM fits: the fitNbinomGLMs equivalent (the JAX package's
glm.py).

Reference: R/fitNbinomGLMs.R:29-236 (the fits), 340-407 (optim fallback),
R/core.R:2697-2752 (weights checking).  The heavy lifting is kernel K1
(ops/cuda_irls.py: the hand-written IRLS on the card for p <= 8, its plain
version on the card for p > 8 or on the CPU), in float64; this module
supplies the beta initialization, the intercept-only closed form, the
log2 <-> natural-log conversions, the unclamped returned mu and the
log-likelihood, all on the counts' device, and the per-row L-BFGS-B
fallback for the rows the IRLS could not fit (host scipy, the same
Fortran L-BFGS-B that R's optim uses; typically O(10) rows, whose (S,)
rows alone are fetched).
"""

from __future__ import annotations

import warnings

import numpy as np
import scipy.optimize
import torch
from scipy.special import gammaln

from .engine import resolve_device
from .formula import make_names, parse_formula, rename_model_matrix_columns
from .hostdev import F64, as_t, counts_t, factors_t, full_factors, rows, to_np

LOG2E = np.log2(np.e)
LN2 = np.log(2.0)


def nb_logpmf_np(y, mu, alpha):
    size = 1.0 / alpha
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(y > 0, y * (np.log(mu) - np.log(size + mu)), 0.0)
        out = (gammaln(y + size) - gammaln(size) - gammaln(y + 1.0)
               + size * (np.log(size) - np.log(size + mu)) + t)
    return out


def nb_logpmf(y, mu, alpha):
    """nb_logpmf_np on tensors: the reference's dnbinom_mu form, term for
    term (y, mu (G,S); alpha (G,1))."""
    size = 1.0 / alpha
    t = torch.where(y > 0, y * (torch.log(mu) - torch.log(size + mu)),
                    torch.zeros_like(y))
    return (torch.lgamma(y + size) - torch.lgamma(size)
            - torch.lgamma(y + 1.0)
            + size * (torch.log(size) - torch.log(size + mu)) + t)


def log_likelihood(y, mu, alpha, weights=None):
    """Row sums of the NB log-pmf (weighted when `weights` is given)."""
    ll = nb_logpmf(y, mu, alpha[:, None])
    return (ll if weights is None else weights * ll).sum(dim=1)


def weights_ok(weights, x, weight_threshold):
    """The per-gene estimability tests of getAndCheckWeights on weights'
    device: for a full-rank design, full rank of the weighted design and
    of the design rows above the Cox-Reid threshold (the batched eigenvalue
    tests of parallel/fused.py:weights_ok_dev, which flag the same rows as
    the JAX package's per-gene matrix_rank loop,
    tests/test_torch_host.py); otherwise, no column all zero after
    weighting.  Returns a (G,) bool numpy array."""
    from .parallel.fused import weights_ok_dev
    m = x.shape[1]
    xt = as_t(x, weights.device)
    if np.linalg.matrix_rank(x) == m:
        ok, _, _ = weights_ok_dev(weights, xt, weight_threshold)
        return to_np(ok)
    ok = torch.ones(weights.shape[0], dtype=torch.bool,
                    device=weights.device)
    for j in range(m):
        num_zero = ((weights * xt[None, :, j]) == 0).sum(dim=1)
        ok &= num_zero != x.shape[0]
    return to_np(ok)


def get_and_check_weights(dds, model_matrix, weight_threshold=1e-2,
                          device=None):
    """Reference getAndCheckWeights (R/core.R:2697-2752).

    Normalizes weights rows to max 1; rows whose weights produce a
    rank-deficient design (or break the CR subset) are flagged
    weightsFail and demoted to allZero.
    Returns (dds, weights (G,S) tensor on `device` or None, use_weights).
    """
    if "weights" not in dds.assays:
        return dds, None, False
    dev = resolve_device(device)
    weights = as_t(dds.assays["weights"], dev)
    if bool((weights < 0).any()):
        raise ValueError("weights must be non-negative")
    weights = weights / weights.max(dim=1, keepdim=True).values
    if not dds.attrs.get("weightsOK"):
        ok = weights_ok(weights, np.asarray(model_matrix, np.float64),
                        weight_threshold)
        if not np.all(ok):
            if "allZero" in dds.row_data:
                dds.row_data["allZero"] = dds.row_data["allZero"] | ~ok
            dds.set_row_data("weightsFail", ~ok, "intermediate",
                             "weights fail to allow parameter estimation")
            warnings.warn(
                f"for {int((~ok).sum())} row(s), the weights as "
                "supplied won't allow parameter estimation, producing a "
                "degenerate design matrix. These rows have been flagged "
                "in mcols(dds)$weightsFail and treated as if the row "
                "contained all zeros (mcols(dds)$allZero set to TRUE). "
                "If you are blocking for donors/organisms, consider "
                "design = ~0+donor+condition.")
        dds.attrs["weightsOK"] = True
    return dds, weights, True


def fit_nbinom_glms(dds, model_matrix=None, model_matrix_names=None,
                    model_formula=None, alpha_hat=None, lam=None,
                    rename_cols=True, beta_tol=None, maxit=None,
                    use_optim=None, use_qr=None, force_optim=False,
                    warn_nonpos_var=True, min_mu=None, config=None,
                    device=None):
    """Batched fitNbinomGLMs (reference R/fitNbinomGLMs.R:29-236).

    Operates over the rows of `dds` as given (callers pass the non-zero
    subset).  Coefficients and SEs are returned on the log2 scale as
    numpy; mu and the hat diagonals as (G,S) float64 tensors on `device`.
    """
    from .config import cfg
    beta_tol = cfg(beta_tol, "beta_tol", config)
    maxit = cfg(maxit, "maxit_beta", config)
    use_optim = cfg(use_optim, "use_optim", config)
    min_mu = cfg(min_mu, "min_mu", config)
    dev = resolve_device(device)
    just_intercept = False
    if model_matrix is None:
        formula = dds.design if model_formula is None else \
            parse_formula(model_formula)
        if isinstance(formula, np.ndarray):
            model_matrix = formula.astype(np.float64)
            names = [f"x{i+1}" for i in range(model_matrix.shape[1])]
        else:
            model_matrix, names = dds.model_matrix(formula)
            just_intercept = (not formula.terms) and formula.intercept
    else:
        model_matrix = np.asarray(model_matrix, dtype=np.float64)
        names = (list(model_matrix_names) if model_matrix_names is not None
                 else [f"x{i+1}" for i in range(model_matrix.shape[1])])
        just_intercept = (model_matrix.shape[1] == 1
                          and np.all(model_matrix == 1.0))
    if np.any(np.abs(model_matrix).sum(axis=0) == 0):
        raise ValueError("model matrix has all-zero column")

    names = ["Intercept" if n == "(Intercept)" else n for n in names]
    names = make_names(names)
    if rename_cols and not isinstance(dds.design, np.ndarray):
        conv = rename_model_matrix_columns(
            dds.col_data,
            dds.design if model_formula is None else model_formula)
        names = [conv.get(n, n) for n in names]

    if alpha_hat is None:
        alpha_hat = dds.row_data.get("dispersion")
        if alpha_hat is None:
            raise ValueError("no dispersions: first call "
                             "estimate_dispersions")
    alpha_hat = np.asarray(alpha_hat, dtype=np.float64)
    if len(alpha_hat) != dds.n_genes:
        raise ValueError("alpha_hat needs length nrow(object)")
    p = model_matrix.shape[1]
    if lam is None:
        lam = np.full(p, 1e-6)
    lam = np.asarray(lam, dtype=np.float64)

    dds, weights, use_weights = get_and_check_weights(dds, model_matrix,
                                                      device=dev)
    disp_col = dds.row_data.get("dispersion")
    out = fit_glm_tensors(
        counts_t(dds, dev), factors_t(dds, dev), model_matrix, names,
        alpha_hat, lam, weights=weights, disp_for_ll=disp_col,
        just_intercept=just_intercept, beta_tol=beta_tol, maxit=maxit,
        use_optim=use_optim, force_optim=force_optim, min_mu=min_mu,
        warn_nonpos_var=warn_nonpos_var)
    return out


def fit_glm_tensors(y, nf, model_matrix, names, alpha_hat, lam,
                    weights=None, disp_for_ll=None, just_intercept=False,
                    beta_tol=1e-8, maxit=100, use_optim=True,
                    force_optim=False, min_mu=0.5, warn_nonpos_var=True):
    """fitNbinomGLMs on tensors: y (G,S) float64 counts and nf (S,) or
    (G,S) factors on one device, weights (G,S) (max-1 normalized) or None;
    alpha_hat, lam and `disp_for_ll` (the dispersions the returned
    log-likelihood uses, or None) numpy."""
    from .ops.cuda_irls import fit_beta

    dev = y.device
    G, S = y.shape
    p = model_matrix.shape[1]
    use_weights = weights is not None
    alpha_t = torch.as_tensor(alpha_hat, dtype=F64, device=dev)
    nf_full = full_factors(nf, G)
    norm_counts = y / nf

    # ---- intercept-only closed form (fitNbinomGLMs.R:99-137) -------------
    if just_intercept and np.all(lam <= 1e-6):
        if use_weights:
            beta = torch.log2((weights * norm_counts).sum(dim=1)
                              / weights.sum(dim=1))
        else:
            beta = torch.log2(norm_counts.mean(dim=1))
        mu = nf_full * (2.0 ** beta)[:, None]
        log_like = log_likelihood(y, mu, alpha_t, weights)
        w = 1.0 / (1.0 / mu + alpha_t[:, None])
        if use_weights:
            w = weights * w
        xtwx = w.sum(dim=1)
        sigma = 1.0 / xtwx
        beta_se = (LOG2E * torch.sqrt(sigma))[:, None]
        hat = w / xtwx[:, None]
        return dict(log_like=to_np(log_like), beta_conv=np.ones(G, bool),
                    beta_matrix=to_np(beta)[:, None], beta_se=to_np(beta_se),
                    mu=mu, beta_iter=np.ones(G, int),
                    model_matrix=np.ones((S, 1)),
                    model_matrix_names=["Intercept"], nterms=1,
                    hat_diagonals=hat)

    x = torch.as_tensor(model_matrix, dtype=F64, device=dev)
    # ---- beta initialization (fitNbinomGLMs.R:139-155) --------------------
    if np.linalg.matrix_rank(model_matrix) == p:
        q, r = np.linalg.qr(model_matrix)
        ylog = torch.log(norm_counts + 0.1)
        qy = ylog @ torch.as_tensor(q, dtype=F64, device=dev)
        beta_init = torch.linalg.solve(
            torch.as_tensor(r, dtype=F64, device=dev), qy.T).T
    else:
        if "Intercept" in names:
            beta_init = torch.zeros((G, p), dtype=F64, device=dev)
            beta_init[:, names.index("Intercept")] = \
                torch.log(norm_counts.mean(dim=1))
        else:
            beta_init = torch.ones((G, p), dtype=F64, device=dev)

    lambda_nat = lam / LN2 ** 2
    res = fit_beta(y, x, nf, alpha_t, beta_init,
                   torch.as_tensor(lambda_nat, dtype=F64, device=dev),
                   tol=beta_tol, maxit=maxit, min_mu=min_mu,
                   weights=weights)
    beta_t = res["beta"]
    # the returned mu is recomputed unclamped (fitNbinomGLMs.R:180)
    mu = nf_full * torch.exp(beta_t @ x.T)
    log_like = None
    if disp_for_ll is not None:
        log_like = to_np(log_likelihood(
            y, mu, torch.as_tensor(np.asarray(disp_for_ll, np.float64),
                                   dtype=F64, device=dev), weights))
    beta_nat = to_np(beta_t)
    beta_var = to_np(res["beta_var"])
    beta_iter = to_np(res["iter"]).astype(np.int64)

    row_stable = ~np.any(np.isnan(beta_nat), axis=1)
    row_var_positive = ~np.any(beta_var <= 0, axis=1)
    beta_conv = beta_iter < maxit
    beta_matrix = LOG2E * beta_nat
    with np.errstate(invalid="ignore"):
        beta_se = LOG2E * np.sqrt(np.maximum(beta_var, 0.0))

    if force_optim:
        rows_for_optim = np.arange(G)
    elif use_optim:
        rows_for_optim = np.where(~beta_conv | ~row_stable
                                  | ~row_var_positive)[0]
    else:
        rows_for_optim = np.where(~row_stable | ~row_var_positive)[0]

    fit_glm_tensors.optim_rows += len(rows_for_optim)
    if len(rows_for_optim) > 0:
        ri = torch.as_tensor(rows_for_optim, device=dev)
        wr = None if weights is None else to_np(weights[ri])
        mu_rows, ll_rows = _fit_glms_optim(
            to_np(y[ri]), model_matrix, lam, rows_for_optim, row_stable,
            to_np(rows(nf_full, ri)), alpha_hat, wr, beta_matrix, beta_se,
            beta_conv, to_np(beta_init[ri]), min_mu=min_mu)
        mu = mu.clone()
        mu[ri] = torch.as_tensor(mu_rows, dtype=F64, device=dev)
        if log_like is not None:
            log_like[rows_for_optim] = ll_rows

    if np.any(np.isnan(beta_se)):
        raise AssertionError("NA in beta standard errors")
    n_nonpos = np.sum(np.any(beta_se == 0, axis=1))
    if warn_nonpos_var and n_nonpos > 0:
        warnings.warn(f"{n_nonpos} rows had non-positive estimates of "
                      "variance for coefficients")
    return dict(log_like=log_like, beta_conv=beta_conv,
                beta_matrix=beta_matrix, beta_se=beta_se, mu=mu,
                beta_iter=beta_iter, model_matrix=model_matrix,
                model_matrix_names=names, nterms=p,
                hat_diagonals=res["hat_diag"])


# rows sent to L-BFGS-B since the count was last set to 0 (a diagnostic)
fit_glm_tensors.optim_rows = 0


def _fit_glms_optim(counts, x, lam, rows, row_stable, nf, alpha_hat,
                    weights, beta_matrix, beta_se, beta_conv, beta_init_nat,
                    min_mu=0.5):
    """Per-row L-BFGS-B fallback on the log2-scale penalized likelihood
    (reference fitNbinomGLMsOptim, R/fitNbinomGLMs.R:340-407).  counts,
    nf, weights and beta_init_nat hold the optim rows only (in `rows`'
    order); beta_matrix, beta_se and beta_conv are updated in place.
    Returns the rows' unclamped mu and their log-likelihoods."""
    lambda_nat = lam / LN2 ** 2
    large = 30.0
    sd_prior = np.sqrt(1.0 / lam)
    mu_out = np.empty((len(rows), x.shape[0]))
    ll_out = np.empty(len(rows))
    for i, row in enumerate(rows):
        if row_stable[row] and np.all(np.abs(beta_matrix[row]) < large):
            beta_row = beta_matrix[row].copy()
        else:
            beta_row = beta_init_nat[i].copy()
        nfr = nf[i]
        k = counts[i].astype(np.float64)
        alpha = alpha_hat[row]
        wr = weights[i] if weights is not None else None

        def objective(pvec):
            with np.errstate(over="ignore"):
                mu_row = nfr * 2.0 ** (x @ pvec)
            llv = nb_logpmf_np(k, mu_row, alpha)
            ll = np.sum(wr * llv) if wr is not None else np.sum(llv)
            log_prior = np.sum(-0.5 * np.log(2 * np.pi * sd_prior ** 2)
                               - 0.5 * (pvec / sd_prior) ** 2)
            neg = -(ll + log_prior)
            return neg if np.isfinite(neg) else 1e300

        o = scipy.optimize.minimize(objective, beta_row, method="L-BFGS-B",
                                    bounds=[(-large, large)] * x.shape[1])
        if o.success:
            beta_conv[row] = True
        beta_matrix[row] = o.x
        with np.errstate(over="ignore"):
            mu_row = nfr * 2.0 ** (x @ o.x)
        mu_out[i] = mu_row
        mu_row = np.maximum(mu_row, min_mu)
        w = 1.0 / (1.0 / mu_row + alpha)
        if wr is not None:
            w = wr * w
        xtwx = x.T @ (x * w[:, None])
        ridge = np.diag(lambda_nat) if len(lambda_nat) > 1 else \
            np.array([[lambda_nat[0]]])
        inv = np.linalg.inv(xtwx + ridge)
        sigma = inv @ xtwx @ inv
        beta_se[row] = LOG2E * np.sqrt(np.maximum(np.diag(sigma), 0.0))
        # note: the reference recomputes logLike here from the *clamped* mu
        # and alpha_hat (not the dispersion column), fitNbinomGLMs.R:398-403
        llv = nb_logpmf_np(k, mu_row, alpha)
        ll_out[i] = np.sum(wr * llv) if wr is not None else np.sum(llv)
    return mu_out, ll_out
