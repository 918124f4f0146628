"""LFC shrinkage: the normal prior's expanded-design refit, apeglm-style
adaptive-t posterior modes, ashr-style normal-mixture posterior means.

Reference: lfcShrink (R/lfcShrink.R:145-520), ported from the JAX
package's shrink.py.  Every arm runs on the device the fit ran on (the
"cuda" card unless deseq() was called with device="cpu"):

- type="normal", contrast mode: the prior variance from the stored MLEs
  (the host estimator, over (G,p) scalars), then one ridge refit on the
  expanded design through K1 (ops/cuda_irls.py) on the original counts at
  the stored dispersions, and the contrast sandwich.  The cases the JAX
  package sends to its host Wald test (coef mode, weights, numeric or
  list contrasts, lfc_threshold > 0, a user model matrix, a prior that
  does not cover the expanded columns) run the host engine's
  nbinom_wald_test(beta_prior=True) (wald.py) on the fit's device, then
  results();
- type="apeglm": a heavy-tailed (Cauchy) prior on the coefficient of
  interest, its scale from the MLEs, posterior mode and SD by a damped
  Newton in float64 on the device; genes still iterating are gathered
  with torch.nonzero each step (exact: genes are independent);
- type="ashr": a zero-centred normal mixture prior fitted by EM on
  (betahat, sebetahat) (the EM on the device, float64), analytic
  posterior mean, SD and lfsr on the host.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.stats import norm

from .results import DESeqResults, results

LOG2E = np.log2(np.e)
LN2 = np.log(2.0)


def lfc_shrink(dds, coef=None, contrast=None, res=None, type="apeglm",
               lfc_threshold=0.0, svalue=False, return_fit=False,
               quiet=True, prior_df=1.0):
    """(reference lfcShrink, R/lfcShrink.R:145-520)"""
    if type not in ("apeglm", "ashr", "normal"):
        raise ValueError("unknown shrinkage type")
    if len(dds.results_names()) == 0:
        raise ValueError("first run deseq() before lfc_shrink()")
    if dds.attrs.get("betaPrior"):
        raise ValueError("lfc_shrink() should be used downstream of deseq() "
                         "with betaPrior=FALSE (the default)")
    res_names = dds.results_names()
    coef_num = None
    coef_alpha = None
    if coef is not None:
        if isinstance(coef, (int, np.integer)):
            # 1-based like the reference (R/lfcShrink.R:206-215) so that
            # reference scripts port unchanged; coef=0 is a loud error
            # rather than a silent off-by-one
            if coef < 1:
                raise ValueError(
                    "numeric coef is 1-based as in the reference "
                    "(lfcShrink(dds, coef=2) is the first non-intercept "
                    "coefficient); use a name from results_names() to be "
                    "explicit")
            coef_num = int(coef) - 1
            coef_alpha = res_names[coef_num]
        else:
            coef_alpha = coef
            coef_num = res_names.index(coef)
    if res is None:
        if coef is not None:
            res = results(dds, name=coef_alpha)
        elif contrast is not None:
            res = results(dds, contrast=contrast)
        else:
            raise ValueError("one of coef or contrast required if 'res' is "
                             "missing")
    if np.all(np.isnan(res.lfc_se)):
        raise ValueError("lfc_shrink requires standard errors")

    if type == "normal":
        return _shrink_normal(dds, coef, contrast, res, coef_alpha,
                              lfc_threshold)
    if type == "apeglm":
        if contrast is not None:
            raise ValueError("type='apeglm' shrinkage only for use with "
                             "'coef'")
        if coef is None:
            raise ValueError("type='apeglm' requires 'coef'")
        return _shrink_apeglm(dds, coef_num, coef_alpha, res, lfc_threshold,
                              svalue, return_fit, prior_df=prior_df)
    return _shrink_ashr(dds, res, lfc_threshold, svalue, return_fit)


# ---------------------------------------------------------------------------
# normal
# ---------------------------------------------------------------------------

def _shrink_normal(dds, coef, contrast, res, coef_alpha, lfc_threshold):
    """(reference R/lfcShrink.R:221-327): the device arm, or the host Wald
    test for the cases the JAX package sends there
    (deseq2_tpu/shrink.py:93-160)."""
    if coef is None and contrast is None:
        raise ValueError("type='normal' requires either 'coef' or "
                         "'contrast'")
    if not isinstance(dds.design, np.ndarray):
        if any(o > 1 for o in dds.design.term_orders):
            raise ValueError("LFC shrinkage type='normal' not implemented "
                             "for designs with interactions")
    if not any("log2 fold change (MLE)" in d
               for _, d in dds.row_meta.values()):
        raise ValueError("lfc_shrink type='normal' requires MLE "
                         "coefficients from deseq(beta_prior=False)")
    if _normal_host_reason(dds, contrast, lfc_threshold) is None:
        out = _shrink_normal_fused(dds, contrast, res, lfc_threshold)
        if out is not None:
            return out
    return _shrink_normal_host(dds, contrast, res, coef_alpha,
                               lfc_threshold)


def _shrink_normal_host(dds, contrast, res, coef_alpha, lfc_threshold):
    """The JAX package's host arm: the prior variance from the stored
    MLEs, the host engine's nbinom_wald_test(beta_prior=True) on the
    standard (coef mode) or expanded (contrast mode) matrix, on the fit's
    device, then results() of the shrunken fit."""
    from .engine import fit_device
    from .wald import estimate_beta_prior_var, nbinom_wald_test

    dds = dds.copy()
    model_matrix_type = "standard" if contrast is None else "expanded"
    dds.attrs["modelMatrixType"] = model_matrix_type
    # rename the MLE coefficient columns (description "log2 fold change
    # (MLE)") to MLE_* for estimate_beta_prior_var, as the reference does
    # (R/lfcShrink.R:264-269)
    beta_cols = [n for n, (t, d) in dds.row_meta.items()
                 if "log2 fold change (MLE)" in d]
    if not any(n.startswith("MLE_") for n in beta_cols):
        for n in beta_cols:
            dds.row_data[f"MLE_{n}"] = dds.row_data.pop(n)
            dds.row_meta[f"MLE_{n}"] = dds.row_meta.pop(n)
    nz = ~np.asarray(dds.row_data["allZero"], bool)
    obj_nz = dds.copy(share_counts=True)
    obj_nz.assays = {}
    obj_nz.row_data = {k: np.asarray(v)[nz]
                       for k, v in obj_nz.row_data.items()}
    beta_prior_var, _ = estimate_beta_prior_var(obj_nz)
    dds_shr = nbinom_wald_test(dds, beta_prior=True,
                               beta_prior_var=beta_prior_var,
                               model_matrix_type=model_matrix_type,
                               quiet=True, device=fit_device(dds))
    if contrast is None:
        res_shr = results(dds_shr, name=coef_alpha,
                          lfc_threshold=lfc_threshold)
    else:
        res_shr = results(dds_shr, contrast=contrast,
                          lfc_threshold=lfc_threshold)
    out = DESeqResults(base_mean=res.base_mean,
                       log2_fold_change=res_shr.log2_fold_change,
                       lfc_se=res_shr.lfc_se,
                       stat=(res_shr.stat if lfc_threshold > 0 else res.stat),
                       pvalue=(res_shr.pvalue if lfc_threshold > 0
                               else res.pvalue),
                       padj=(res_shr.padj if lfc_threshold > 0 else res.padj),
                       row_names=res.row_names)
    out.metadata["lfcThreshold"] = lfc_threshold
    out.prior_info = dict(type="normal", package="deseq2_tpu",
                          betaPriorVar=beta_prior_var)
    return out


def _normal_host_reason(dds, contrast, lfc_threshold):
    """Why the JAX package runs this normal shrinkage on its host Wald test
    (shrink.py:_shrink_normal_fused's fallbacks), or None."""
    from .formula import Factor
    if contrast is None:
        return "coef (the standard model matrix)"
    if lfc_threshold != 0:
        return "lfc_threshold > 0"
    if "weights" in dds.assays:
        return "observation weights"
    if isinstance(dds.design, np.ndarray):
        return "a user-supplied model matrix"
    if not (isinstance(contrast, (tuple, list)) and len(contrast) == 3
            and all(isinstance(c, str) for c in contrast)):
        return "a numeric or list contrast"
    fac = dds.col_data.get(contrast[0])
    if not isinstance(fac, Factor) or contrast[1] == contrast[2]:
        return "a contrast that is not between two levels of a factor"
    return None


def _shrink_normal_fused(dds, contrast, res, lfc_threshold):
    """Device route for type='normal' contrast-mode shrinkage (JAX
    shrink.py:_shrink_normal_fused): the beta prior variance from the
    STORED MLE coefficients (host quantile matching over (G,p) scalars),
    then ONE expanded-matrix ridge refit through K1 on the ORIGINAL counts
    at the STORED (post-replacement) dispersions, in the fit's dtype, and
    the contrast sandwich at its final mu (float64), then the zero-zero
    and replaced-row rules.  Where the JAX package falls back to its host
    path (a prior that does not cover the expanded columns, a level the
    expanded names lack) this returns None, and the caller runs the host
    arm."""
    from .engine import device_counts, fit_device, resolve_dtype
    from .expanded import make_expanded_model_matrix
    from .formula import make_names
    from .ops.cuda_irls import fit_beta
    from .parallel.fused import contrast_sandwich
    from .wald import estimate_beta_prior_var

    factor_name, num_level, den_level = contrast
    fac = dds.col_data[factor_name]

    # ---- prior variance from the stored MLEs (host, (G,p) scalars) ----
    # dds2: the fit's columns on the nonzero rows (all the estimator
    # reads), sharing the counts; no (G,S) copy or gather
    dds2 = dds.copy(share_counts=True)
    dds2.assays = {}
    dds2.attrs["modelMatrixType"] = "expanded"
    beta_cols = [n for n, (t, d) in dds2.row_meta.items()
                 if "log2 fold change (MLE)" in d]
    if not any(n.startswith("MLE_") for n in beta_cols):
        for n in beta_cols:
            dds2.row_data[f"MLE_{n}"] = dds2.row_data.pop(n)
            dds2.row_meta[f"MLE_{n}"] = dds2.row_meta.pop(n)
    nz = np.asarray(~dds2.row_data["allZero"])
    dds2.row_data = {k: np.asarray(v)[nz] for k, v in dds2.row_data.items()}
    prior_var, _ = estimate_beta_prior_var(dds2)
    x_e, names_e = make_expanded_model_matrix(dds2)
    names_e = make_names(["Intercept" if n == "(Intercept)" else n
                          for n in names_e])
    num_col = make_names([f"{factor_name}{num_level}"])[0]
    den_col = make_names([f"{factor_name}{den_level}"])[0]
    if len(prior_var) != x_e.shape[1] or np.any(prior_var == 0) \
            or num_col not in names_e or den_col not in names_e:
        return None
    cvec = np.zeros(len(names_e))
    cvec[names_e.index(num_col)] = 1.0
    cvec[names_e.index(den_col)] = -1.0

    # ---- one expanded ridge refit on the device ----
    dev = fit_device(dds)
    dtype = resolve_dtype(dds.config)
    nz_idx = torch.as_tensor(np.where(nz)[0], device=dev)
    counts = device_counts(dds, dev)
    y = counts[nz_idx].to(dtype)
    if dds.normalization_factors is not None:
        nf64 = torch.as_tensor(np.asarray(dds.normalization_factors,
                                          np.float64), device=dev)[nz_idx]
    else:
        nf64 = torch.as_tensor(np.asarray(dds.size_factors, np.float64),
                               device=dev)
    alpha = torch.as_tensor(np.asarray(dds2.row_data["dispersion"],
                                       np.float64), device=dev)
    # expanded matrices are rank-deficient: the init is zeros with the
    # intercept at log(mean(normalized counts)), the mean taken in float32
    # as the JAX package takes it
    mean_q = (y.float() / nf64.float()).mean(dim=1).double()
    p_e = x_e.shape[1]
    beta_init = torch.zeros((y.shape[0], p_e), dtype=torch.float64,
                            device=dev)
    beta_init[:, names_e.index("Intercept")] = torch.log(mean_q)
    lam = torch.as_tensor((1.0 / np.asarray(prior_var, np.float64))
                          / LN2 ** 2, device=dev)
    x = torch.as_tensor(np.asarray(x_e, np.float64), device=dev)
    fit = fit_beta(y, x.to(dtype), nf64.to(dtype), alpha.to(dtype),
                   beta_init.to(dtype), lam.to(dtype), tol=1e-8, maxit=100,
                   min_mu=0.5)
    num, den, _ = contrast_sandwich(fit["beta"], fit["mu"],
                                    alpha.to(dtype), x, lam, cvec)
    lfc = np.full(dds.n_genes, np.nan)
    se = np.full(dds.n_genes, np.nan)
    lfc[nz] = LOG2E * num.double().cpu().numpy()
    se[nz] = LOG2E * den.double().cpu().numpy()

    # zero-zero rule (both involved levels all zero, R/results.R:1237-43)
    sel = torch.as_tensor(np.where(np.isin(
        np.asarray(fac.codes), [fac.levels.index(num_level),
                                fac.levels.index(den_level)]))[0],
        device=dev)
    grp_sum = counts[:, sel].sum(dim=1).cpu().numpy()
    zz = (grp_sum == 0) & nz
    lfc[zz] = 0.0
    # replaced-to-zero rows (R/results.R:567-575)
    replace = dds.row_data.get("replace")
    if replace is not None and np.nansum(replace) > 0:
        now_zero = np.asarray(replace, bool) & \
            (np.asarray(dds.row_data["baseMean"]) == 0)
        lfc[now_zero] = 0.0
        se[now_zero] = 0.0

    out = DESeqResults(base_mean=res.base_mean, log2_fold_change=lfc,
                       lfc_se=se, stat=res.stat, pvalue=res.pvalue,
                       padj=res.padj, row_names=res.row_names)
    out.descriptions["log2FoldChange"] = \
        f"log2 fold change (MAP): {factor_name} {num_level} vs {den_level}"
    out.metadata["lfcThreshold"] = lfc_threshold
    out.prior_info = dict(type="normal", package="deseq2_tpu",
                          betaPriorVar=prior_var)
    return out


# ---------------------------------------------------------------------------
# apeglm-style
# ---------------------------------------------------------------------------

def _apeglm_fit(y, x, nf_log, alpha, weights, coef_num, prior_scale,
                no_shrink_scale=15.0, beta_init=None, n_iter=50,
                prior_df=1.0):
    """Batched posterior mode for apeglm's adaptive Student-t prior on
    column `coef_num` and wide normal priors on the rest, by a damped
    Newton with backtracking, float64 on y's device (the JAX package's
    _apeglm_fit).

    log p(b) = -((df+1)/2) log(1 + b^2/(df S^2)) for the shrunk
    coefficient (apeglm's defaults: df = 1, the Cauchy), N(0,
    no_shrink_scale) for the rest.  Betas on the natural-log scale.  Each
    step runs on the genes still iterating only (torch.nonzero), which
    equals a lockstep loop over all genes.  Returns (map, sd) from the
    observed information at the mode (Laplace approximation), as numpy."""
    from .ops.linalg import chol_solve
    from .ops.nb import nb_logpmf

    f = torch.float64
    dev = y.device
    y = y.to(f)
    G, S = y.shape
    x = torch.as_tensor(x, dtype=f, device=dev)
    p = x.shape[1]
    nf_log = torch.as_tensor(nf_log, dtype=f, device=dev)
    nf_row = nf_log.dim() == 1
    alpha = torch.as_tensor(alpha, dtype=f, device=dev)
    w_obs = None if weights is None else torch.as_tensor(
        np.asarray(weights), dtype=f, device=dev)
    is_coef = torch.arange(p, device=dev) == coef_num
    xx = (x[:, :, None] * x[:, None, :]).reshape(S, p * p)
    eye = torch.eye(p, dtype=f, device=dev)
    ds2 = prior_df * prior_scale ** 2

    def rows(idx):
        return (y[idx], alpha[idx], nf_log if nf_row else nf_log[idx],
                None if w_obs is None else w_obs[idx])

    def grad_hess(beta, d):
        d_y, d_alpha, d_nfl, d_w = d
        mu = torch.exp(beta @ x.T + d_nfl)
        size = 1.0 / d_alpha[:, None]
        # NB log-lik derivative wrt eta: y - mu (y + size)/(mu + size)
        frac = (d_y + size) / (mu + size)
        dl_deta = d_y - mu * frac
        winfo = mu * frac * (size / (mu + size))
        if d_w is not None:
            dl_deta = d_w * dl_deta
            winfo = d_w * winfo
        grad_ll = dl_deta @ x
        hess_ll = (winfo @ xx).reshape(beta.shape[0], p, p)
        # prior: Student-t(df, 0, prior_scale) on the coefficient,
        # normal(0, no_shrink_scale) on the others
        b = beta
        t_grad = -(prior_df + 1.0) * b / (ds2 + b ** 2)
        t_hess = (prior_df + 1.0) * (b ** 2 - ds2) / (ds2 + b ** 2) ** 2
        norm_grad = -b / no_shrink_scale ** 2
        norm_hess = torch.full_like(b, -1.0 / no_shrink_scale ** 2)
        pg = torch.where(is_coef[None, :], t_grad, norm_grad)
        ph = torch.where(is_coef[None, :], t_hess, norm_hess)
        return grad_ll + pg, hess_ll - torch.diag_embed(ph)

    def log_post(beta, d):
        d_y, d_alpha, d_nfl, d_w = d
        mu = torch.exp(beta @ x.T + d_nfl)
        ll_mat = nb_logpmf(d_y, mu, d_alpha[:, None])
        if d_w is not None:
            ll_mat = d_w * ll_mat
        ll = ll_mat.sum(dim=-1)
        b = beta
        lp_c = -0.5 * (prior_df + 1.0) * torch.log1p(
            b ** 2 / (prior_df * prior_scale ** 2))
        lp_n = -0.5 * b ** 2 / no_shrink_scale ** 2
        return ll + torch.where(is_coef[None, :], lp_c, lp_n).sum(dim=-1)

    beta = torch.zeros((G, p), dtype=f, device=dev) if beta_init is None \
        else torch.as_tensor(beta_init, dtype=f, device=dev).clone()
    all_rows = torch.arange(G, device=dev)
    lp0 = log_post(beta, rows(all_rows))
    step = torch.ones(G, dtype=f, device=dev)
    active = torch.ones(G, dtype=torch.bool, device=dev)
    eps = torch.finfo(f).eps
    for _ in range(n_iter):
        idx = torch.nonzero(active).squeeze(1)
        if idx.numel() == 0:
            break
        d = rows(idx)
        b, st, lp = beta[idx], step[idx], lp0[idx]
        g, h = grad_hess(b, d)
        delta = chol_solve(h + eye * 1e-8, g[..., None])[..., 0]
        # backtracking: the step, its half and its quarter (vectorized);
        # lp0 carried from the previous accept
        cands = [b + (st * s)[:, None] * delta for s in (1.0, 0.5, 0.25)]
        lps = [log_post(c, d) for c in cands]
        oks = [lp_k >= lp for lp_k in lps]
        new_b = torch.where(oks[0][:, None], cands[0], torch.where(
            oks[1][:, None], cands[1], torch.where(oks[2][:, None],
                                                   cands[2], b)))
        new_lp = torch.where(oks[0], lps[0], torch.where(
            oks[1], lps[1], torch.where(oks[2], lps[2], lp)))
        new_st = torch.where(oks[0], torch.clamp(st * 1.5, max=1.0),
                             torch.where(oks[1] | oks[2], st * 0.5,
                                         st * 0.25))
        # converged once an ACCEPTED step stops moving the mode (a full
        # reject only shrinks the step and stays active)
        dmax = (new_b - b).abs().amax(dim=-1)
        scale = 1.0 + new_b.abs().amax(dim=-1)
        accepted = oks[0] | oks[1] | oks[2]
        converged = accepted & ((dmax <= 8.0 * eps * scale) | (dmax <= 1e-8))
        beta[idx], step[idx], lp0[idx] = new_b, new_st, new_lp
        active[idx] = ~converged
    _, hess = grad_hess(beta, rows(all_rows))
    cov = torch.linalg.inv(hess + eye * 1e-10)
    sd = torch.sqrt(torch.clamp(torch.diagonal(cov, dim1=-2, dim2=-1),
                                min=0.0))
    return beta.cpu().numpy(), sd.cpu().numpy()


def apeglm_svalue(lfsr):
    """Cumulative mean of sorted local FSR (reference apeglm_svalue,
    R/lfcShrink.R:523-528)."""
    lfsr = np.asarray(lfsr, dtype=np.float64)
    order = np.argsort(np.where(np.isnan(lfsr), np.inf, lfsr), kind="stable")
    sorted_l = lfsr[order]
    cum = np.nancumsum(sorted_l) / np.arange(1, len(lfsr) + 1)
    out = np.empty_like(cum)
    out[order] = cum
    out[np.isnan(lfsr)] = np.nan
    return out


def _shrink_apeglm(dds, coef_num, coef_alpha, res, lfc_threshold, svalue,
                   return_fit, prior_df=1.0):
    from .engine import device_counts, fit_device

    nz = ~dds.row_data["allZero"]
    y = device_counts(dds, fit_device(dds))
    if isinstance(dds.design, np.ndarray):
        x = dds.design
    elif dds.attrs.get("modelMatrixType") == "user-supplied":
        x = dds.attrs["modelMatrix"]
    else:
        x, _ = dds.renamed_model_matrix()
    disps = np.asarray(dds.row_data["dispersion"]).copy()
    disps = np.where(np.isnan(disps), 1.0, disps)
    # shared per-sample factors ride as an (S,) row; (G,S) only for gene x
    # sample normalization factors
    nf = (dds.normalization_factors if dds.normalization_factors
          is not None else np.asarray(dds.size_factors))
    weights = dds.assays.get("weights")
    # The JAX package's prior scale (shrink.py:489-509): E[betahat^2] =
    # E[beta^2] + E[se^2], so the positive excess betahat^2 - se^2
    # estimates the per-gene signal variance; the scale is the RMS of the
    # positive excesses, capped at 1 (natural log).  Same prior family as
    # apeglm (Cauchy, no-shrink normals at scale 15), not apeglm's own
    # priorVar() estimator.
    mle = LN2 * np.column_stack([res.log2_fold_change, res.lfc_se])
    fin = np.isfinite(mle[:, 0]) & np.isfinite(mle[:, 1])
    var_est = mle[fin, 0] ** 2 - mle[fin, 1] ** 2
    pos = var_est > 0
    if pos.sum() == 0:
        prior_scale = 1.0
    else:
        prior_scale = float(np.sqrt(np.mean(var_est[pos])))
    prior_scale = min(prior_scale, 1.0)

    beta_init = None
    # initialize at the MLE fit (natural log scale) when available
    coef_cols = dds.results_names()
    if all(c in dds.row_data for c in coef_cols):
        beta_init = LN2 * np.column_stack(
            [np.nan_to_num(dds.row_data[c], nan=0.0) for c in coef_cols])

    bmap, bsd = _apeglm_fit(y, x, np.log(nf), disps, weights, coef_num,
                            prior_scale, beta_init=beta_init,
                            prior_df=prior_df)
    lfc = LOG2E * bmap[:, coef_num]
    se = LOG2E * bsd[:, coef_num]
    lfc[~nz] = np.nan
    se[~nz] = np.nan

    out = DESeqResults(base_mean=res.base_mean,
                       log2_fold_change=lfc, lfc_se=se,
                       stat=res.stat, pvalue=res.pvalue, padj=res.padj,
                       row_names=res.row_names)
    out.descriptions["log2FoldChange"] = \
        f"log2 fold change (MAP): {coef_alpha.replace('_', ' ')}"
    out.descriptions["lfcSE"] = \
        f"posterior SD: {coef_alpha.replace('_', ' ')}"
    # local false-sign rate via the Laplace approximation
    if lfc_threshold > 0:
        T = lfc_threshold
        fsos = (norm.cdf((T - lfc) / se) - norm.cdf((-T - lfc) / se))
        lfsr = np.clip(fsos, 0.0, 1.0)
        out.svalue = apeglm_svalue(lfsr)
        out.stat = out.pvalue = out.padj = None
    elif svalue:
        lfsr = norm.cdf(-np.abs(lfc) / se)
        out.svalue = apeglm_svalue(lfsr)
        out.stat = out.pvalue = out.padj = None
    out.metadata["lfcThreshold"] = lfc_threshold
    out.prior_info = dict(type="apeglm", package="deseq2_tpu",
                          prior_scale=prior_scale,
                          prior_control=dict(prior_scale=prior_scale,
                                             prior_df=prior_df,
                                             prior_no_shrink_scale=15))
    if return_fit:
        return out, dict(map=bmap, sd=bsd, prior_scale=prior_scale)
    return out


# ---------------------------------------------------------------------------
# ashr-style
# ---------------------------------------------------------------------------

def _ash_normal_mix(betahat, sebetahat, device, npoint=None, max_iter=2000,
                    tol=1e-7):
    """Fit pi over a zero-centred normal mixture by EM (ashr
    method='shrink', mixcompdist='normal'; Stephens 2016); the EM runs on
    `device` in float64, one step at a time until max |pi_new - pi| <
    tol."""
    ok = np.isfinite(betahat) & np.isfinite(sebetahat) & (sebetahat > 0)
    b, s = betahat[ok], sebetahat[ok]
    # autoselect.mixsd grid
    smin = np.min(s) / 10.0
    excess = b ** 2 - s ** 2
    if np.any(excess > 0):
        smax = 2.0 * np.sqrt(np.max(excess[excess > 0]))
    else:
        smax = 8.0 * smin
    grid = [0.0]
    v = smin
    while v < smax:
        grid.append(v)
        v *= np.sqrt(2.0)
    grid.append(v)
    sigmas = np.asarray(grid)
    K = len(sigmas)
    # marginal likelihood of each observation under each component
    tot_var = sigmas[None, :] ** 2 + s[:, None] ** 2
    loglik = (-0.5 * np.log(2 * np.pi * tot_var)
              - 0.5 * b[:, None] ** 2 / tot_var)
    lmax = loglik.max(axis=1, keepdims=True)
    lik = torch.as_tensor(np.exp(loglik - lmax), device=device)
    pi = torch.full((K,), 1.0 / K, dtype=torch.float64, device=device)
    for _ in range(max_iter):
        w = lik * pi[None, :]
        w = w / w.sum(dim=1, keepdim=True)
        pi_new = w.mean(dim=0)
        done = bool((pi_new - pi).abs().max() < tol)
        pi = pi_new
        if done:
            break
    return sigmas, pi.cpu().numpy(), ok


def _ash_posterior(betahat, sebetahat, sigmas, pi):
    """Posterior mean/SD and lfsr under the fitted mixture."""
    b, s = betahat, sebetahat
    tot_var = sigmas[None, :] ** 2 + s[:, None] ** 2
    loglik = (-0.5 * np.log(2 * np.pi * tot_var)
              - 0.5 * b[:, None] ** 2 / tot_var)
    lmax = loglik.max(axis=1, keepdims=True)
    resp = np.exp(loglik - lmax) * pi[None, :]
    resp /= resp.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        post_var_k = 1.0 / (1.0 / np.maximum(sigmas[None, :] ** 2, 1e-300)
                            + 1.0 / s[:, None] ** 2)
        post_mean_k = post_var_k * b[:, None] / s[:, None] ** 2
    # sigma=0 component: point mass at 0
    zero_comp = sigmas == 0
    post_var_k[:, zero_comp] = 0.0
    post_mean_k[:, zero_comp] = 0.0
    mean = np.sum(resp * post_mean_k, axis=1)
    second = np.sum(resp * (post_var_k + post_mean_k ** 2), axis=1)
    sd = np.sqrt(np.maximum(second - mean ** 2, 0.0))
    # probability of positive / negative sign
    with np.errstate(divide="ignore", invalid="ignore"):
        z = post_mean_k / np.sqrt(post_var_k)
    p_pos = np.where(post_var_k > 0, norm.sf(-z), 0.0)
    p_neg = np.where(post_var_k > 0, norm.cdf(-z), 0.0)
    prob_pos = np.sum(resp * p_pos, axis=1)
    prob_neg = np.sum(resp * p_neg, axis=1)
    lfsr = np.minimum(prob_pos, prob_neg) + resp[:, zero_comp].sum(axis=1)
    lfsr = np.minimum(lfsr, 1.0)
    return mean, sd, lfsr


def cdf_post_mixture(betahat, sebetahat, sigmas, pi, x):
    """P(beta <= x | data) under the fitted mixture (ashr cdf_post)."""
    b, s = betahat, sebetahat
    tot_var = sigmas[None, :] ** 2 + s[:, None] ** 2
    loglik = (-0.5 * np.log(2 * np.pi * tot_var)
              - 0.5 * b[:, None] ** 2 / tot_var)
    lmax = loglik.max(axis=1, keepdims=True)
    resp = np.exp(loglik - lmax) * pi[None, :]
    resp /= resp.sum(axis=1, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        post_var_k = 1.0 / (1.0 / np.maximum(sigmas[None, :] ** 2, 1e-300)
                            + 1.0 / s[:, None] ** 2)
        post_mean_k = post_var_k * b[:, None] / s[:, None] ** 2
    zero_comp = sigmas == 0
    cdf_k = np.where(post_var_k > 0,
                     norm.cdf((x - post_mean_k)
                              / np.sqrt(np.maximum(post_var_k, 1e-300))),
                     float(x >= 0))
    cdf_k[:, zero_comp] = float(x >= 0)
    return np.sum(resp * cdf_k, axis=1)


def _shrink_ashr(dds, res, lfc_threshold, svalue, return_fit):
    from .engine import fit_device

    betahat = res.log2_fold_change
    sebetahat = res.lfc_se
    sigmas, pi, ok = _ash_normal_mix(betahat, sebetahat, fit_device(dds))
    mean = np.full_like(betahat, np.nan)
    sd = np.full_like(betahat, np.nan)
    lfsr = np.full_like(betahat, np.nan)
    mean[ok], sd[ok], lfsr[ok] = _ash_posterior(betahat[ok], sebetahat[ok],
                                                sigmas, pi)
    out = DESeqResults(base_mean=res.base_mean, log2_fold_change=mean,
                       lfc_se=sd, stat=res.stat, pvalue=res.pvalue,
                       padj=res.padj, row_names=res.row_names)
    out.descriptions["log2FoldChange"] = "log2 fold change (MMSE)"
    out.descriptions["lfcSE"] = "posterior SD"
    if lfc_threshold > 0:
        cdf_pos = np.full_like(betahat, np.nan)
        cdf_neg = np.full_like(betahat, np.nan)
        cdf_pos[ok] = cdf_post_mixture(betahat[ok], sebetahat[ok], sigmas,
                                       pi, lfc_threshold)
        cdf_neg[ok] = cdf_post_mixture(betahat[ok], sebetahat[ok], sigmas,
                                       pi, -lfc_threshold)
        lfsr_t = np.where(mean > 0, cdf_pos, 1.0 - cdf_neg)
        out.svalue = apeglm_svalue(lfsr_t)
        out.stat = out.pvalue = out.padj = None
    elif svalue:
        out.svalue = apeglm_svalue(lfsr)
        out.stat = out.pvalue = out.padj = None
    out.metadata["lfcThreshold"] = lfc_threshold
    out.prior_info = dict(type="ashr", package="deseq2_tpu",
                          fitted_g=dict(sd=sigmas, pi=pi))
    if return_fit:
        return out, dict(sigmas=sigmas, pi=pi, lfsr=lfsr)
    return out
