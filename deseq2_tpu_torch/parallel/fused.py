"""The fused bulk pipeline on one device: gene-wise dispersion MLE ->
dispersion trend -> MAP shrinkage -> ridge IRLS -> Wald statistics or the
LRT, plus the results tail (Cook's distances, count-outlier replacement and
refit, Cook's p-value masking, filtered BH).

The per-gene solvers go through the kernel wrappers (ops/cuda_*.py): on a
CUDA device the hand-written kernels K1-K3 (past 8 columns K1's P = 16
build and the plain K2/K3 on the card), on the CPU their plain versions.
The cross-gene reductions (trend fits, MAD, prior variance, BH and the
filtering quantiles) are ordinary tensor reductions.  Every gene
is independent, so the grid fallback and the outlier refit run on the
selected rows only (gathered with torch.nonzero), which equals running
them on every row and keeping the selected ones.

Variants: observation weights (raw for the base statistics, max-1
normalized for the mu fit, MAP, IRLS and log-likelihood, additionally
floored at 1e-6 for the gene-wise search), gene x sample normalization
factors, the LRT against an intercept or a reduced model matrix, t
p-values (`use_t`), the parametric, local and mean trends, a numeric
contrast over the model-matrix columns (getContrast's sandwich at the
final fit), and betaPrior: the prior variance from the MLE betas on the
device, then the ridge refit on the expanded model matrix (intercept plus
one indicator per level) through K1 at p = levels + 1, with its default
or a user contrast.  A gene mesh (parallel/sharding.py) runs the per-gene
chains block by block on its devices and the cross-gene reductions on the
gathered vectors (fused_wald_pipeline's `mesh`, run_fused_sharded).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import profiling
from ..ops.cuda_grid import fit_disp_grid
from ..ops.cuda_irls import fit_beta
from ..ops.cuda_ls import fit_disp_line_search
from ..ops.disp import CR_WEIGHT_THRESHOLD
from ..ops.irls import xx_flat
from ..ops.linalg import chol_solve
from ..ops.nb import lgamma_diff_centered, trigamma
from .cooksdev import cooks_distance_dev, max_cooks_dev, trimmed_mean_dev
from .filterdev import bh_adjust, filtered_bh_dev, theta_grid_dev

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# On the card the per-gene products are row reductions and elementwise
# passes, not matrix products: a product's summation order there follows
# its row count (cuBLAS picks its kernel from the shape; rows of a (1,024,
# 1,024) x (1,024, 4) float64 product differ in the last bits from the same
# rows of the (2,048, 1,024) product), while a row reduction's does not
# from MIN_ROWS rows on (`python -m deseq2_tpu_torch.ops.studies
# batch_rows`).  So a gene's values do not depend on the other genes of its
# block, and a gene mesh's blocks give the whole's bits.  On the CPU they
# stay products, whose rounding the tests hold to the JAX package's dots
# (an iteration count that rounding decides follows it).
MIN_ROWS = 16


def rowdot(a, x):
    """a @ x for (G,S) rows and an (S,k) matrix: on the card k row
    reductions."""
    if not a.is_cuda:
        return a @ x
    return torch.stack([(a * x[:, j]).sum(dim=1) for j in range(x.shape[1])],
                       dim=1)


def rowcomb(coef, x):
    """coef @ x.T for (G,k) coefficients and an (S,k) matrix: on the card
    k elementwise passes, summed in column order."""
    if not coef.is_cuda:
        return coef @ x.T
    out = coef[:, :1] * x[:, 0]
    for j in range(1, coef.shape[1]):
        out = out + coef[:, j:j + 1] * x[:, j]
    return out


def _bmm(a, b):
    """Batched (G,p,p) products a @ b: on the card p elementwise passes."""
    if not a.is_cuda:
        return a @ b
    out = a[:, :, :1] * b[:, :1, :]
    for k in range(1, a.shape[2]):
        out = out + a[:, :, k:k + 1] * b[:, k:k + 1, :]
    return out


def contrast_sandwich(beta, mu_cl, alpha, x, ridge, c, w=None):
    """getContrast's post-fit quantities at a fit's final clamped mu
    (src/DESeq2.cpp:429-455; R/results.R:760-827): num = c'beta and
    den = sqrt(c' Sigma c) with Sigma = A^-1 X'WX A^-1, A = X'WX +
    diag(ridge), W = mu / (1 + alpha mu) (times the max-1 observation
    weights), and Sigma's diagonal.  Batched over genes, in float64
    whatever the fit's dtype (an expanded design's A is singular but for
    its ridge, so a float32 inverse would carry that direction's rounding
    into the sandwich); num, den and the diagonal come back in beta's
    dtype."""
    f = torch.float64
    x64 = x.to(f)
    p = x64.shape[1]
    mu = mu_cl.to(f)
    wc = mu / (1.0 + alpha.to(f)[:, None] * mu)
    if w is not None:
        wc = w.to(f) * wc
    xtwx = rowdot(wc, xx_flat(x64)).reshape(-1, p, p)
    ainv = torch.linalg.inv(xtwx + torch.diag(ridge.to(f)))
    sigma = _bmm(_bmm(ainv, xtwx), ainv)
    cv = torch.as_tensor(c, dtype=f, device=x.device)
    num = rowcomb(beta.to(f), cv[None, :])[:, 0]
    den = torch.sqrt(rowcomb(rowcomb(sigma.reshape(-1, p), cv[None, :])
                             .reshape(-1, p), cv[None, :])[:, 0])
    var = torch.diagonal(sigma, dim1=-2, dim2=-1)
    return num.to(beta.dtype), den.to(beta.dtype), var.to(beta.dtype)


def _ls_fitted(y, x):
    """Least-squares fitted values y X (X'X)^-1 X' (the reference's QR
    rewrite, R/core.R:2454-2463, as a p x p SPD solve)."""
    coef = chol_solve(x.T @ x, rowdot(y, x).T).T
    return rowcomb(coef, x)


def nanmedian(v, dim=0):
    """Median over the non-NaN entries, averaging the two middle values
    for an even count (jnp.nanmedian; torch.nanmedian takes the lower
    one).  NaN where every entry is NaN."""
    vs = torch.sort(v, dim=dim).values          # NaN sorts last
    n = (~torch.isnan(v)).sum(dim=dim, keepdim=True)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, min=0)
    m = 0.5 * torch.gather(vs, dim, lo) + 0.5 * torch.gather(vs, dim, hi)
    m = torch.where(n > 0, m, torch.full_like(m, float("nan")))
    return m.squeeze(dim)


def _masked_median(v, mask):
    return nanmedian(torch.where(mask, v, torch.full_like(v, float("nan"))))


def log_ratios(y):
    """Each count's log ratio to its gene's log geometric mean, NaN where
    the count or the mean is zero: the per-gene half of the median of
    ratios."""
    logy = torch.log(y)
    lg = logy.mean(dim=1)
    return torch.where(torch.isfinite(lg)[:, None] & (y > 0),
                       logy - lg[:, None], torch.full_like(logy, float("nan")))


def size_factors_dev(y, mesh=None):
    """Median-of-ratios size factors on the device (estimateSizeFactors
    ForMatrix type='ratio', R/core.R:535-578): per-sample median of the
    finite log ratios to the log geometric mean, over genes with a
    positive count.  Under `mesh` (a GeneMesh) each row block's log ratios
    are taken on its shard's device and gathered for the median."""
    if mesh is None:
        return torch.exp(nanmedian(log_ratios(y), dim=0))
    return torch.exp(nanmedian(mesh.gather(
        [log_ratios(b) for b in mesh.split(y)], y.shape[0]), dim=0))


def gamma_trend_fit(means, disps, use_mask):
    """Parametric dispersion trend (reference parametricDispersionFit,
    R/core.R:2166-2189): gamma GLM with identity link disp ~ a + b/mean
    and iterative outlier masking.  Inner IRLS with weights 1/mu^2 and
    deviance-relative convergence (1e-8, 25 steps); outer loop re-masks
    residuals in (1e-4, 15) and stops when sum(log(coefs/old)^2) < 1e-6
    with the inner fit converged, or after 10 rounds.  Returns
    ((a, b), valid): valid is False where the host path would raise
    (non-positive coefficients, or no settling in 10 rounds).

    The fit runs in float64 whatever the pipeline's dtype: a float32
    deviance cannot resolve the 1e-8 relative convergence test, so a
    float32 fit settles only when two sweeps happen to round to the same
    deviance (on the card they did not: the trend came back invalid)."""
    dtype = means.dtype
    means, disps = means.double(), disps.double()
    X1 = torch.where(use_mask, 1.0 / means, torch.zeros_like(means))
    yv = torch.where(use_mask, disps, torch.ones_like(disps))

    def gamma_dev(a, b, good):
        mu = a + b * X1
        t = torch.where(good, (yv - mu) / mu - torch.log(yv / mu.abs()),
                        torch.zeros_like(mu))
        return 2.0 * t.sum()

    def inner_glm(a, b, good):
        dev_old = gamma_dev(a, b, good)
        conv = False
        for _ in range(25):
            mu = a + b * X1
            w = torch.where(good, 1.0 / mu ** 2, torch.zeros_like(mu))
            s00, s01, s11 = w.sum(), (w * X1).sum(), (w * X1 * X1).sum()
            r0, r1 = (w * yv).sum(), (w * X1 * yv).sum()
            det = s00 * s11 - s01 * s01
            a, b = (s11 * r0 - s01 * r1) / det, (s00 * r1 - s01 * r0) / det
            dev = gamma_dev(a, b, good)
            conv = bool((dev - dev_old).abs() / (dev.abs() + 0.1) < 1e-8)
            dev_old = dev
            if conv:
                break
        return a, b, conv

    a = torch.tensor(0.1, dtype=torch.float64, device=means.device)
    b = torch.tensor(1.0, dtype=torch.float64, device=means.device)
    it = 0
    while True:
        mu = a + b * X1
        resid = torch.where(use_mask, disps / mu, torch.zeros_like(mu))
        good = use_mask & (resid > 1e-4) & (resid < 15.0)
        a_new, b_new, conv = inner_glm(a, b, good)
        delta = (torch.log((a_new / a).abs()) ** 2
                 + torch.log((b_new / b).abs()) ** 2)
        ok = bool((a_new > 0) & (b_new > 0))
        settled = bool(delta < 1e-6) and conv
        valid = ok and (settled or it < 10)
        a, b, it = a_new, b_new, it + 1
        if settled or it > 10 or not ok:
            return torch.stack([a, b]).to(dtype), valid


def trimmed_mean_masked(v, mask, trim):
    """R mean(x, trim=) over the masked entries (the fitType='mean'
    trend, R/core.R:900-905)."""
    vals = torch.sort(torch.where(mask, v, torch.full_like(v, math.inf)))
    vals = vals.values
    n = int(mask.sum())
    kcut = math.floor(n * trim)
    r = torch.arange(v.shape[0], device=v.device)
    take = (r >= kcut) & (r < n - kcut)
    return torch.where(take, vals, torch.zeros_like(vals)).sum() \
        / max(n - 2 * kcut, 1)


def local_trend_state(base_mean, disps, use_mask):
    """State of the tricube local-quadratic trend (fitType='local', the
    JAX package's locfit stand-in): fit points sorted by log mean, unused
    rows at the end with prior weight 0 and a finite sentinel x."""
    dtype = base_mean.dtype
    one = torch.ones_like(base_mean)
    lx = torch.where(use_mask, torch.log(torch.where(use_mask, base_mean,
                                                     one)),
                     torch.full_like(base_mean, math.inf))
    order = torch.argsort(lx, stable=True)
    lxs = lx[order]
    lys = torch.where(use_mask, torch.log(torch.where(use_mask, disps, one)),
                      torch.zeros_like(disps))[order]
    pws = torch.where(use_mask, base_mean, torch.zeros_like(base_mean))[order]
    lxs = torch.where(torch.isfinite(lxs), lxs,
                      torch.full_like(lxs, 1e30, dtype=dtype))
    return dict(lxs=lxs, lys=lys, pws=pws, nfit=int(use_mask.sum()))


def local_trend_eval(ts, x0, tile_bytes=2 ** 27):
    """The tricube local-quadratic regression at log-mean points x0.
    Window: the k = max(ceil(0.7 n), 3) nearest fit points, h = the k-th
    smallest distance in closed form from the sorted points (the k nearest
    points of a point on a line are a contiguous run).  Every fit point
    enters a weighted quadratic with weight tricube(d/h) * prior weight,
    zero at and beyond h.  The (E,K) products run in row tiles of at most
    `tile_bytes` per temporary (about a dozen are live at once)."""
    lxs, lys, pws, n = ts["lxs"], ts["lys"], ts["pws"], ts["nfit"]
    dtype = lxs.dtype
    K = lxs.shape[0]
    k = min(max(math.ceil(0.7 * n), 3), n)
    idx = torch.arange(K, device=lxs.device)
    xk = lxs[torch.clamp(idx + k - 1, 0, K - 1)]
    lo_max = max(n - k, 0)
    mid = torch.where(idx <= lo_max, (lxs + xk) / 2.0,
                      torch.full_like(lxs, math.inf))
    lo = torch.searchsorted(mid, x0.contiguous())
    cand = torch.stack([torch.clamp(lo - 1, 0, lo_max),
                        torch.clamp(lo, 0, lo_max)], dim=-1)      # (E,2)
    lo_x = lxs[cand]
    hi_x = lxs[torch.clamp(cand + k - 1, 0, K - 1)]
    h = torch.maximum(x0[:, None] - lo_x, hi_x - x0[:, None]).min(dim=1)
    h = torch.where(h.values > 0, h.values, torch.ones_like(x0))

    def tile_fit(x0c, hc):
        dx = lxs[None, :] - x0c[:, None]                          # (e,K)
        w = (1.0 - torch.clamp(dx.abs() / hc[:, None], max=1.0) ** 3) ** 3 \
            * pws[None, :]
        dxm = torch.where(w > 0, dx, torch.zeros_like(dx))
        wd = w * dxm
        wd2 = wd * dxm
        s0, s1, s2 = w.sum(1), wd.sum(1), wd2.sum(1)
        s3, s4 = (wd2 * dxm).sum(1), (wd2 * dxm * dxm).sum(1)
        # row reductions, not gemv: BLAS sums a product in an order that
        # depends on the tile's row count, which would break the tiles'
        # bit-for-bit independence
        t0, t1, t2 = ((w * lys).sum(1), (wd * lys).sum(1),
                      (wd2 * lys).sum(1))
        A = torch.stack([torch.stack([s0, s1, s2], -1),
                         torch.stack([s1, s2, s3], -1),
                         torch.stack([s2, s3, s4], -1)], -2)       # (e,3,3)
        b = torch.stack([t0, t1, t2], -1)[..., None]
        sol, info = torch.linalg.solve_ex(A, b)
        beta0 = sol[..., 0, 0]
        # singular fallback: the weighted mean (the host's LinAlgError arm)
        return torch.where(torch.isfinite(beta0) & (info == 0), beta0,
                           t0 / torch.where(s0 > 0, s0, torch.ones_like(s0)))

    E = x0.shape[0]
    ch = max(1, min(E, tile_bytes // max(1, K * lxs.element_size())))
    fitted = torch.cat([tile_fit(x0[i:i + ch], h[i:i + ch])
                        for i in range(0, E, ch)]) if E else x0
    return torch.exp(fitted.to(dtype))


def trend_eval(fit_type, ts, bm_safe):
    """The trend at (safe) base means: parametric a + b/mean (ts the
    (2,) coefficients), the trimmed-mean constant (ts a scalar tensor) or
    the local regression (ts local_trend_state's dict) (R/core.R:884-905).
    Trend state is float64; the values come back in bm_safe's dtype."""
    if fit_type == "parametric":
        return ts[0] + ts[1] / bm_safe
    if fit_type == "mean":
        return ts.to(bm_safe.dtype).expand(bm_safe.shape)
    return local_trend_eval(ts, torch.log(bm_safe.double())).to(
        bm_safe.dtype)


def nb_loglik(y, mu, alpha, w=None):
    """Row NB log-likelihood at (unclamped) mu (nbinomLogLike,
    R/core.R:2208-2230) in the stable difference form; observation
    weights multiply the per-sample terms."""
    size = 1.0 / alpha[:, None]
    t = torch.where(y > 0.0, y * torch.log(mu), torch.zeros_like(y))
    terms = (lgamma_diff_centered(y, size) - torch.lgamma(y + 1.0) + t
             - (y + size) * torch.log1p(mu * alpha[:, None]))
    if w is not None:
        terms = w * terms
    return terms.sum(dim=1)


def t_two_sided_p(stat, df):
    """Two-sided t p-values I_{d/(d+t^2)}(d/2, 1/2) (R/core.R:1478-1508).
    PyTorch has no regularized incomplete beta, so the (G,) or (G,p)
    statistics go to the host for scipy's and the p-values come back.
    `df`: a float, or a (G,) tensor of per-gene degrees of freedom."""
    from scipy.special import betainc
    s = stat.detach().double().cpu().numpy()
    d = df if isinstance(df, float) else df.double().cpu().numpy()
    if not isinstance(d, float) and s.ndim == 2:
        d = d[:, None]
    with np.errstate(invalid="ignore"):
        p = betainc(d / 2.0, 0.5, d / (d + s * s))
    return torch.as_tensor(p, dtype=stat.dtype, device=stat.device)


def _max1(w):
    return w / w.max(dim=1, keepdim=True).values


class Stages:
    """The per-gene chains of the pipeline for one design, size-factor row
    and dtype: the gene-wise estimate (R/core.R:657-860) and, given a
    frozen trend and prior, MAP shrinkage + ridge IRLS (R/core.R:1016-1115,
    1400-1463), with the reduced fit of the LRT (R/core.R:1787-1897).
    Both act on any subset of genes; a block's raw observation weights and
    (G,S) normalization factors travel with it."""

    def __init__(self, x, sf, grid, maxit=100, min_disp=1e-8,
                 linear_mu=True, min_mu=0.5, fit_type="parametric",
                 xim=None, x_reduced=None, reduced_intercept=False,
                 contrast=None, x_exp=None, contrast_exp=None):
        self.x = x
        # a numeric contrast over x's columns (post_trend adds its num/den)
        # and, under betaPrior, the expanded design with its contrast
        self.contrast = contrast
        self.x_exp = x_exp
        self.contrast_exp = contrast_exp
        self.sf = sf
        self.grid = grid
        self.maxit = maxit
        self.min_disp = min_disp
        self.linear_mu = linear_mu
        self.min_mu = min_mu
        self.fit_type = fit_type
        self.x_reduced = x_reduced
        self.reduced_intercept = reduced_intercept
        self.lrt = reduced_intercept or x_reduced is not None
        S, p = x.shape
        self.S, self.p = S, p
        self.max_disp = max(10.0, float(S))
        self.min_la = math.log(min_disp / 10.0)
        self.lam_nat = torch.full((p,), 1e-6 / LN2 ** 2, dtype=x.dtype,
                                  device=x.device)
        # momentsDispEstimate's xim (R/core.R:2440-2444)
        self.xim = (1.0 / sf).mean() if xim is None else xim

    def grid_fallback(self, disp_cur, need, prior_mean, prior_var,
                      use_prior, y_safe, mu_safe, w=None):
        """fitDispGrid on the `need` genes only (exact: genes are
        independent)."""
        idx = torch.nonzero(need).squeeze(1)
        if idx.numel() == 0:
            return disp_cur
        la = fit_disp_grid(y_safe[idx], self.x, mu_safe[idx], self.grid,
                           prior_mean[idx], float(prior_var),
                           use_prior=use_prior,
                           weights=None if w is None else w[idx])
        out = disp_cur.clone()
        out[idx] = torch.exp(la)
        return out

    def dispersion_init(self, y, w=None, nf=None):
        """Base stats, the rough/moments initial dispersion and the mu the
        gene-wise line search runs at (R/core.R:657-764).  `w`: the block's
        raw weights; `nf`: its (G,S) normalization factors."""
        x, S, p = self.x, self.S, self.p
        nf_b = self.sf[None, :] if nf is None else nf
        min_disp, max_disp = self.min_disp, self.max_disp
        norm_c = y / nf_b
        # base stats of weights * normalized counts (getBaseMeansAndVariances)
        wted = norm_c if w is None else w * norm_c
        base_mean = wted.mean(dim=1)
        base_var = wted.var(dim=1, correction=1)
        all_zero = y.sum(dim=1) == 0

        # dispersion init (R/core.R:709-728)
        mu_ls = torch.clamp(_ls_fitted(norm_c, x), min=1.0)
        rough = torch.clamp(((norm_c - mu_ls) ** 2 - mu_ls).div(mu_ls ** 2)
                            .sum(dim=1) / (S - p), min=0.0)
        moments = (base_var - self.xim * base_mean) / base_mean ** 2
        alpha_init = torch.minimum(rough, torch.where(all_zero, rough,
                                                      moments))
        alpha_init = torch.where(torch.isnan(alpha_init),
                                 torch.full_like(alpha_init, min_disp),
                                 alpha_init)
        alpha_init = torch.clamp(alpha_init, min_disp, max_disp)

        # mu for dispersion fitting (R/core.R:753-764): the linearMu LS
        # projection when #design-cells == #coefficients (never with
        # weights), else a GLM fit at the initial dispersions, clamped at
        # min_mu
        y_safe = torch.where(all_zero[:, None], torch.ones_like(y), y)
        if self.linear_mu:
            mu_disp = torch.clamp(_ls_fitted(norm_c, x) * nf_b,
                                  min=self.min_mu)
        else:
            # QR init as the host does (fitNbinomGLMs.R:139-155): the
            # lp-change stopping rule of the line search turns 1e-15
            # differences in mu into ~1e-3 differences in log alpha
            q_m, r_m = torch.linalg.qr(x)
            b0 = torch.linalg.solve(r_m, rowdot(torch.log(norm_c + 0.1),
                                                q_m).T).T
            f0 = fit_beta(y_safe, x, self.sf if nf is None else nf,
                          alpha_init, b0, self.lam_nat, maxit=self.maxit,
                          min_mu=self.min_mu,
                          weights=None if w is None else _max1(w))
            mu_disp = torch.clamp(nf_b * torch.exp(rowcomb(f0["beta"], x)),
                                  min=self.min_mu)
        mu_safe = torch.where(all_zero[:, None], torch.ones_like(mu_disp),
                              mu_disp)
        return dict(base_mean=base_mean, base_var=base_var,
                    all_zero=all_zero, alpha_init=alpha_init, y_safe=y_safe,
                    mu_safe=mu_safe, norm_c=norm_c, w=w, nf=nf)

    def gene_est(self, y, w=None, nf=None):
        """Base stats + gene-wise dispersion MLE for a block of genes
        (R/core.R:657-860).  The search and its grid fallback run at the
        max-1 weights floored at 1e-6 (the gene-wise stage's floor)."""
        est = self.dispersion_init(y, w, nf)
        x, min_disp, max_disp = self.x, self.min_disp, self.max_disp
        y_safe, mu_safe = est["y_safe"], est["mu_safe"]
        alpha_init = est.pop("alpha_init")
        w_ge = None if w is None else torch.clamp(_max1(w), min=1e-6)
        la0 = torch.log(alpha_init)
        mle = fit_disp_line_search(y_safe, x, mu_safe, la0, la0, 1.0,
                                   self.min_la, maxit=self.maxit,
                                   use_prior=False, weights=w_ge)
        alpha_mle = torch.clamp(torch.exp(mle["log_alpha"]), max=max_disp)
        no_increase = mle["last_lp"] < (mle["initial_lp"]
                                        + mle["initial_lp"].abs() / 1e6)
        dge = torch.where(no_increase, alpha_init, alpha_mle)
        conv = (mle["iter"] < self.maxit) & (mle["iter"] != 1)
        need_grid = ~conv & (dge > min_disp * 10)
        dge = self.grid_fallback(dge, need_grid, torch.zeros_like(dge), 1.0,
                                 False, y_safe, mu_safe, w_ge)
        est.update(disp_gene_est=torch.clamp(dge, min_disp, max_disp),
                   disp_gene_iter=mle["iter"])
        return est

    def _fit(self, y_safe, x, nf, alpha, beta_init, ridge, w):
        return fit_beta(y_safe, x, self.sf if nf is None else nf, alpha,
                        beta_init, ridge, maxit=self.maxit,
                        min_mu=self.min_mu, weights=w)

    def post_trend(self, est, ts, disp_prior_var, var_log_disp,
                   disp_fit=None):
        """MAP shrinkage + ridge IRLS given the frozen trend state `ts`
        (see trend_eval), the prior variance and varLogDispEsts; the
        reduced fit and both log-likelihoods under the LRT.  `disp_fit`:
        the trend at the block's base means when the caller has it."""
        x = self.x
        y_safe, mu_safe = est["y_safe"], est["mu_safe"]
        all_zero, dge = est["all_zero"], est["disp_gene_est"]
        nf = est.get("nf")
        nf_b = self.sf[None, :] if nf is None else nf
        w = None if est.get("w") is None else _max1(est["w"])
        if disp_fit is None:
            bm_safe = torch.where(all_zero,
                                  torch.ones_like(est["base_mean"]),
                                  est["base_mean"])
            disp_fit = trend_eval(self.fit_type, ts, bm_safe)

        disp_init = torch.where(dge > 0.1 * disp_fit, dge, disp_fit)
        map_res = fit_disp_line_search(
            y_safe, x, mu_safe, torch.log(disp_init), torch.log(disp_fit),
            float(disp_prior_var), self.min_la, maxit=self.maxit,
            use_prior=True, weights=w)
        disp_map = torch.exp(map_res["log_alpha"])
        need_grid = map_res["iter"] >= self.maxit
        disp_map = self.grid_fallback(disp_map, need_grid,
                                      torch.log(disp_fit), disp_prior_var,
                                      True, y_safe, mu_safe, w)
        disp_map = torch.clamp(disp_map, self.min_disp, self.max_disp)
        disp_outlier = torch.log(dge) > (torch.log(disp_fit)
                                         + 2.0 * torch.sqrt(var_log_disp))
        dispersion = torch.where(disp_outlier, dge, disp_map)

        log_nc = torch.log(est["norm_c"] + 0.1)
        beta_init = chol_solve(x.T @ x, rowdot(log_nc, x).T).T
        fit = self._fit(y_safe, x, nf, dispersion, beta_init, self.lam_nat,
                        w)
        # mu and the deviance are recomputed UNclamped from the final betas
        # (R/fitNbinomGLMs.R:180, nbinomLogLike R/core.R:2208-2230); the
        # kernel's clamped mu is internal to the fit and the hat diagonal
        mu_out = nf_b * torch.exp(rowcomb(fit["beta"], x))
        ll_out = nb_loglik(y_safe, mu_out, dispersion, w)
        out = dict(disp_fit=disp_fit, disp_map=disp_map,
                   disp_iter=map_res["iter"], disp_outlier=disp_outlier,
                   dispersion=dispersion, beta=fit["beta"],
                   beta_var=fit["beta_var"], beta_iter=fit["iter"],
                   mu=mu_out, hat=fit["hat_diag"], deviance=-2.0 * ll_out)
        if self.contrast is not None:
            # getContrast's maxit=0 re-entry: mu recomputed from the final
            # betas and clamped, as the host does (also on diverged rows,
            # where the kernel's own mu kept the pre-divergence value)
            out["num"], out["den"], _ = contrast_sandwich(
                fit["beta"], torch.clamp(mu_out, min=self.min_mu),
                dispersion, x, self.lam_nat, self.contrast, w)
        if self.lrt:
            if self.reduced_intercept:
                # intercept-only closed form (R/fitNbinomGLMs.R:99-137; the
                # weighted mean with observation weights)
                if w is None:
                    q_int = est["norm_c"].mean(dim=1)
                else:
                    q_int = (w * est["norm_c"]).sum(dim=1) / w.sum(dim=1)
                mu_red = torch.where(all_zero[:, None],
                                     torch.ones_like(mu_out),
                                     q_int[:, None] * nf_b)
                out["beta_iter_reduced"] = torch.zeros_like(fit["iter"])
            else:
                xr = self.x_reduced
                b0_red = chol_solve(xr.T @ xr, rowdot(log_nc, xr).T).T
                lam_red = torch.full((xr.shape[1],), 1e-6 / LN2 ** 2,
                                     dtype=xr.dtype, device=xr.device)
                fit_red = self._fit(y_safe, xr, nf, dispersion, b0_red,
                                    lam_red, w)
                mu_red = nf_b * torch.exp(rowcomb(fit_red["beta"], xr))
                out["beta_iter_reduced"] = fit_red["iter"]
            out["ll_full"] = ll_out
            out["ll_reduced"] = nb_loglik(y_safe, mu_red, dispersion, w)
        return out

    def prior_fit(self, y_safe, norm_c, all_zero, disp, prior_v, w=None,
                  nf=None):
        """The ridge refit on the expanded model matrix with the beta prior
        (fitGLMsWithPrior, R/fitNbinomGLMs.R:292-332): K1 at p = levels + 1
        with ridge [1e-6, 1/v, ..., 1/v] / ln2^2 from the intercept-only
        start (the expanded design is rank-deficient), then the contrast's
        num/den and the betas' variances from the sandwich at the kernel's
        final clamped mu (float64), and the deviance at the unclamped mu.
        `w`: the raw weights (max-1 normalized here); `prior_v`: the prior
        variance (log2 scale).

        The design's null direction n = (1, -1, ..., -1) (X n = 0) is
        fixed by the ridge alone: every IRLS step solves (X'WX + R) b =
        X'Wz, so n'R b = 0 exactly, and the fit's b is projected onto that
        plane.  In float32 this removes the rounding of the ill-conditioned
        system along n (at S = 1,024 the float32 fits sit up to 0.016 (the
        H100) to 0.07 (a CPU) natural-log units from the float64 fit along
        n, the kernel and the plain version differently, while off n they
        agree to 1e-4); mu, the contrasts (c'n = 0) and a float64 fit do
        not move."""
        x_e = self.x_exp
        pe = x_e.shape[1]
        dtype = x_e.dtype
        G = y_safe.shape[0]
        w_n = None if w is None else _max1(w)
        lam_e = torch.cat([
            torch.full((1,), 1e-6, dtype=dtype, device=x_e.device),
            (1.0 / torch.as_tensor(prior_v)).to(
                dtype=dtype, device=x_e.device).expand(pe - 1)]) / LN2 ** 2
        b0c = torch.where(all_zero, torch.zeros_like(norm_c[:, 0]),
                          torch.log(torch.clamp(norm_c.mean(dim=1),
                                                min=1e-300)))
        binit = torch.cat([b0c[:, None],
                           torch.zeros((G, pe - 1), dtype=dtype,
                                       device=x_e.device)], dim=1)
        fit = self._fit(y_safe, x_e, nf, disp, binit, lam_e, w_n)
        n = torch.full((pe,), -1.0, dtype=torch.float64, device=x_e.device)
        n[0] = 1.0
        lam64 = lam_e.double()
        b64 = fit["beta"].double()
        beta = (b64 - (rowcomb(b64 * lam64, n[None, :])
                       / (n * lam64 * n).sum()) * n).to(dtype)
        num, den, var = contrast_sandwich(beta, fit["mu"], disp, x_e, lam_e,
                                          self.contrast_exp, w_n)
        nf_b = self.sf[None, :] if nf is None else nf
        mu_e = nf_b * torch.exp(rowcomb(beta, x_e))
        ll_e = nb_loglik(y_safe, mu_e, disp, w_n)
        return dict(beta_e=beta, beta_var_e=var, iter_e=fit["iter"],
                    num=num, den=den, deviance_e=-2.0 * ll_e)


def _refit_rows(st, y_new, idx, cols, ts, disp_prior_var, var_log_disp,
                cells, w=None, nf=None, prior_v=None):
    """Refit dispersions and the GLM on the replaced rows `idx` with the
    frozen trend and prior (refitWithoutOutliers, R/core.R:2497-2560) and
    splice the new values into copies of the per-gene columns.  The LRT's
    Cook's distances use the gene-wise mu (nbinomLRT does not refresh
    it, R/core.R:1888).  On the card a block of fewer than MIN_ROWS rows
    runs with its first row repeated up to MIN_ROWS, so that its row
    reductions sum in the order they do for any larger block."""
    n = idx.numel()
    idx_run = idx if n >= MIN_ROWS or not y_new.is_cuda else torch.cat(
        [idx, idx[:1].expand(MIN_ROWS - n)])
    y_blk = y_new[idx_run]
    est2 = st.gene_est(y_blk, None if w is None else w[idx_run],
                       None if nf is None else nf[idx_run])
    post2 = st.post_trend(est2, ts, disp_prior_var, var_log_disp)
    cooks2 = cooks_distance_dev(y_blk, est2["norm_c"],
                                est2["mu_safe"] if st.lrt else post2["mu"],
                                post2["hat"], cells, st.p)
    cooks2 = torch.where(est2["all_zero"][:, None],
                         torch.full_like(cooks2, float("nan")), cooks2)
    new = dict(post2, disp_gene_est=est2["disp_gene_est"],
               disp_gene_iter=est2["disp_gene_iter"], cooks=cooks2)
    if st.x_exp is not None:
        # the refit reuses the SAVED prior variance (refitWithoutOutliers
        # passes betaPriorVar, R/core.R:2523-2531)
        new.update(st.prior_fit(est2["y_safe"], est2["norm_c"],
                                est2["all_zero"], post2["dispersion"],
                                prior_v, est2.get("w"), est2.get("nf")))
    cols = {k: v.clone() for k, v in cols.items()}
    for k in cols:
        cols[k][idx] = new[k][:n].to(cols[k].dtype)
    return cols


def _fit_trend(fit_type, base_mean, disp_gene_est, all_zero, min_disp):
    """The dispersion trend's state (R/core.R:884-905) in float64, and the
    outputs it adds: parametric gamma GLM (trendCoefs, trendValid),
    trimmed mean (meanDisp) or the local regression (nothing)."""
    use_for_fit = (disp_gene_est > 100 * min_disp) & ~all_zero
    use_mean = (disp_gene_est > 10 * min_disp) & ~all_zero
    bm, dge = base_mean.double(), disp_gene_est.double()
    if fit_type == "parametric":
        coefs, valid = gamma_trend_fit(base_mean, disp_gene_est, use_for_fit)
        return coefs, dict(trendCoefs=coefs, trendValid=valid)
    if fit_type == "mean":
        md = trimmed_mean_masked(dge, use_mean, 0.001)
        return md, dict(meanDisp=md.to(base_mean.dtype))
    if fit_type == "local":
        return local_trend_state(bm, dge, use_for_fit), {}
    raise ValueError("fused fit_type must be parametric/local/mean")


def _on(v, dev):
    """A trend state (a tensor, or local_trend_state's dict) on `dev`."""
    if isinstance(v, dict):
        return {k: _on(u, dev) for k, u in v.items()}
    return v.to(dev) if torch.is_tensor(v) else v


def fused_wald_pipeline(counts, x, size_factors, grid, maxit=100,
                        min_disp=1e-8, cells=None, two_group=False,
                        min_replicates=7, alpha=0.1, linear_mu=True,
                        dtype=torch.float64, x_reduced=None,
                        reduced_intercept=False, use_t=False, weights=None,
                        norm_factors=None, fit_type="parametric",
                        beta_prior=False, contrast=None, mesh=None):
    """counts: (G,S) integer tensor; x: (S,p); size_factors: (S,) or None to
    estimate median-of-ratios factors on the device (ignored with
    `norm_factors`); grid: (20,) log-alpha grid.  Everything runs on
    counts' device in `dtype`.  Returns the per-gene results dict of the
    JAX pipeline (log2 scale LFC/SE/stat/p, dispersions, diagnostics and
    the filtering tail).

    `weights`: raw (G,S) observation weights, validated by the caller
    (validated_weights); `norm_factors`: (G,S) gene x sample normalization
    factors, which replace the size factors everywhere
    (src/DESeq2.cpp:324-327); `x_reduced` / `reduced_intercept`: the LRT
    against a reduced model matrix or the intercept (R/core.R:1787-1897);
    `use_t`: t p-values with df = S - p, or sum(max-1 weights) - p per
    gene; `fit_type`: parametric, local or mean trend.

    `contrast`: a numeric contrast over x's columns; the results tail then
    takes its LFC and SE from the contrast sandwich at the final fit
    (getContrast, R/results.R:760-827), with the numeric zero-zero rule
    (under the LRT only the LFC is taken from it).  `beta_prior`: the Wald
    test with the LFC prior (needs `cells`, the per-sample factor level
    codes of a single-factor design): the prior variance from the MLE
    betas, the ridge refit on the expanded design [intercept, one column
    per level] and its contrast, `contrast` over the expanded columns or by
    default the last level against the first (R/results.R:389-398).

    With `cells` (per-sample design-cell codes) the pipeline also computes
    Cook's distances, maxCooks, the count-outlier replacement + refit
    (refitWithoutOutliers, R/core.R:2484-2563) when some cell has
    >= min_replicates replicates, Cook's p-value masking with the two-group
    heuristic (R/results.R:520-565) and the independent-filtering theta
    grid (R/results.R:638-718).

    `mesh` (parallel.sharding.GeneMesh): the genes axis is split into the
    mesh's row blocks, and the per-gene chains (the gene-wise estimate and
    its grid fallback, MAP and IRLS, the expanded refit, Cook's distances
    and the outlier refit) run block by block, each on its shard's device,
    as the JAX package's run under shard_map (fused.py:329-337); each
    block compacts its own grid-fallback and refit rows.  The cross-gene
    reductions (size factors, trend, MAD, prior variances, the beta
    prior's quantile, BH, the filtering quantiles) and the results tail
    run once on the gathered vectors on the mesh's first device, where
    every output lands.  Without a mesh the counts' device is the one
    block."""
    from .sharding import GeneMesh, as_mesh
    mesh = as_mesh(mesh) or GeneMesh([counts.device])
    dev = mesh.first_device
    G, S = counts.shape
    blocks = mesh.shards(G)
    if not blocks:
        raise ValueError(f"no genes of {G} fall to this process's shards "
                         f"of {mesh}")

    def gat(parts):
        return mesh.gather(parts, G)

    x = torch.as_tensor(x).to(device=dev, dtype=dtype)
    p = x.shape[1]
    ys = [c.to(dtype) for c in mesh.split(counts)]
    out = {}
    nfm = None
    if norm_factors is not None:
        nfm = torch.as_tensor(norm_factors).to(device=dev, dtype=dtype)
        sf = torch.ones(S, dtype=dtype, device=dev)
        xim = (1.0 / nfm.mean(dim=0)).mean()
    elif size_factors is None:
        with profiling.stage("fused.sizeFactors", genes=G):
            sf = torch.exp(nanmedian(gat([log_ratios(y) for y in ys]),
                                     dim=0))
        out["sizeFactors"] = sf
        xim = None
    else:
        sf = torch.as_tensor(size_factors).to(device=dev, dtype=dtype)
        xim = None
    w_raw = None
    if weights is not None:
        w_raw = torch.as_tensor(weights).to(device=dev, dtype=dtype)
        linear_mu = False          # weights disable linearMu (host rule)
    nfs, ws = mesh.split(nfm, G), mesh.split(w_raw, G)
    lrt = reduced_intercept or x_reduced is not None
    if x_reduced is not None:
        x_reduced = torch.as_tensor(x_reduced).to(device=dev, dtype=dtype)
    if beta_prior and (lrt or cells is None):
        raise ValueError("fused beta_prior requires cells (a single-factor "
                         "group design) and test='Wald'")
    if contrast is not None:
        contrast = tuple(float(c) for c in contrast)
    x_exp = cvec_e = None
    if beta_prior:
        # expanded model matrix: intercept + one indicator per level
        # (makeExpandedModelMatrix, R/expanded.R:1-18)
        cells_arr = np.asarray(cells)
        n_lvls = int(cells_arr.max()) + 1
        pe = n_lvls + 1
        x_exp = torch.as_tensor(np.column_stack(
            [np.ones(S)] + [(cells_arr == lv).astype(float)
                            for lv in range(n_lvls)]), dtype=dtype,
            device=dev)
        if contrast is not None:
            if len(contrast) != pe:
                raise ValueError(f"beta_prior contrast must have {pe} "
                                 "entries (expanded model matrix columns)")
            cvec_e = contrast
        else:
            cvec_e = tuple([0.0, -1.0] + [0.0] * (pe - 3) + [1.0])
    grid = torch.as_tensor(grid).to(device=dev, dtype=dtype)

    def stages_on(d):
        return Stages(x.to(d), sf.to(d), grid.to(d), maxit=maxit,
                      min_disp=min_disp, linear_mu=linear_mu,
                      fit_type=fit_type, xim=_on(xim, d),
                      x_reduced=_on(x_reduced, d),
                      reduced_intercept=reduced_intercept,
                      contrast=None if beta_prior else contrast,
                      x_exp=_on(x_exp, d), contrast_exp=cvec_e)

    sts = [stages_on(d) for _, _, d in blocks]

    # Wald p-values: normal, or t with df = S - p; with weights the
    # per-gene df = sum(max-1 weights) - p (R/core.R:1478-1508)
    if use_t and w_raw is not None:
        dfw = _max1(w_raw).sum(dim=1) - p
        t_df = torch.where(dfw > 0, dfw, torch.full_like(dfw, math.nan))
    else:
        t_df = float(S - p)

    def two_sided_p(stat):
        if use_t:
            return t_two_sided_p(stat, t_df)
        sqrt2 = torch.sqrt(torch.tensor(2.0, dtype=dtype, device=dev))
        return torch.special.erfc(stat.abs() / sqrt2)

    with profiling.stage("fused.geneEst", genes=G):
        ests = [s_.gene_est(y, w, nf) for s_, y, w, nf
                in zip(sts, ys, ws, nfs)]
    base_mean, base_var, all_zero, disp_gene_est = (
        gat([e[k] for e in ests]) for k in ("base_mean", "base_var",
                                           "all_zero", "disp_gene_est"))

    # dispersion trend, MAD and prior variance (cross-gene reductions)
    with profiling.stage("fused.trend", genes=G):
        ts, trend_out = _fit_trend(fit_type, base_mean, disp_gene_est,
                                   all_zero, min_disp)
        out.update(trend_out)
        bm_safe = torch.where(all_zero, torch.ones_like(base_mean),
                              base_mean)
        disp_fit_full = trend_eval(fit_type, ts, bm_safe)
    # varLogDispEsts: MAD^2 over non-zero genes (R/methods.R:172-184)
    resid = torch.log(disp_gene_est) - torch.log(disp_fit_full)
    med = _masked_median(resid, ~all_zero)
    var_log_disp = (1.4826 * _masked_median((resid - med).abs(),
                                            ~all_zero)) ** 2
    exp_var = trigamma(torch.tensor((S - p) / 2.0, dtype=torch.float64))
    disp_prior_var = torch.clamp(var_log_disp - exp_var.to(dev, dtype),
                                 min=0.25)
    out.update(dispPriorVar=disp_prior_var, varLogDispEsts=var_log_disp)
    # the frozen trend and prior on each block's device
    frozen = [(_on(ts, d), disp_prior_var.to(d), var_log_disp.to(d))
              for _, _, d in blocks]

    with profiling.stage("fused.mapIrls", genes=G):
        posts = [s_.post_trend(e, ts_, dpv, vld, dfit) for s_, e,
                 (ts_, dpv, vld), dfit
                 in zip(sts, ests, frozen, mesh.split(disp_fit_full))]
    keep = ["disp_fit", "disp_map", "disp_iter", "disp_outlier",
            "dispersion", "beta", "beta_var", "beta_iter", "mu", "hat",
            "deviance"]
    if lrt:
        keep += ["ll_full", "ll_reduced", "beta_iter_reduced"]
    if contrast is not None and not beta_prior:
        keep += ["num", "den"]
    cols_b = [dict({k: post[k] for k in keep},
                   disp_gene_est=e["disp_gene_est"],
                   disp_gene_iter=e["disp_gene_iter"])
              for e, post in zip(ests, posts)]

    # ---- beta prior variance + expanded refit ----
    priors = [None] * len(blocks)
    if beta_prior:
        from .priordev import match_weighted_upper_quantile_var_dev
        with profiling.stage("fused.betaPrior", genes=G):
            mle_log2 = LOG2E * gat([c["beta"] for c in cols_b])
            # weights 1/(1/baseMean + dispFit), nonzero genes only
            # (R/core.R:1637-1646)
            wq = torch.where(all_zero, torch.zeros_like(base_mean),
                             1.0 / (1.0 / torch.where(
                                 all_zero, torch.ones_like(base_mean),
                                 base_mean) + disp_fit_full))
            qcols = [mle_log2[:, j] for j in range(1, p)]
            for j in range(1, p):     # addAllContrasts (R/expanded.R:76-98)
                for i in range(j + 1, p):
                    qcols.append(mle_log2[:, i] - mle_log2[:, j])
            vs_ = [match_weighted_upper_quantile_var_dev(c_, wq)
                   for c_ in qcols]
            prior_v = sum(vs_) / len(vs_)   # averagePriorsOverLevels' mean
            out["betaPriorVar"] = prior_v.to(dtype)
            # MLE betas on the standard matrix (the MLE_ results columns,
            # R/fitNbinomGLMs.R:272-278)
            out["mleBeta"] = torch.where(all_zero[:, None],
                                         torch.full_like(mle_log2, math.nan),
                                         mle_log2)
            priors = [prior_v.to(d) for _, _, d in blocks]
            for s_, e, c, w, nf, pv in zip(sts, ests, cols_b, ws, nfs,
                                           priors):
                c.update(s_.prior_fit(e["y_safe"], e["norm_c"],
                                      e["all_zero"], c["dispersion"], pv, w,
                                      nf))

    # ---- Cook's distances + outlier replacement / refit, per block ----
    blk = [dict(replace=torch.zeros(hi - lo, dtype=torch.bool, device=d),
                base_mean=e["base_mean"], base_var=e["base_var"],
                all_zero=e["all_zero"])
           for (lo, hi, d), e in zip(blocks, ests)]
    stage = profiling.stage("fused.cooksRefit", genes=G)
    with_cooks = cells is not None and S > p
    if with_cooks:
        from scipy.stats import f as f_dist
        cutoff99 = float(f_dist.ppf(0.99, p, S - p))
        cells_np = np.asarray(cells)
        replaceable_np = np.bincount(cells_np)[cells_np] >= min_replicates
        for s_, e, c, b, y, nf in zip(sts, ests, cols_b, blk, ys, nfs):
            b["nf_b"] = s_.sf[None, :] if nf is None else nf
            b["norm_counts"] = y / b["nf_b"]
            # nbinomWaldTest refreshes mu before Cook's; nbinomLRT does
            # not, so LRT Cook's sees the gene-wise mu (R/core.R:1436 vs
            # 1888/1959)
            cooks = cooks_distance_dev(y, b["norm_counts"],
                                       e["mu_safe"] if lrt else c["mu"],
                                       c["hat"], cells, p)
            b["cooks"] = torch.where(e["all_zero"][:, None],
                                     torch.full_like(cooks, float("nan")),
                                     cooks)
            b["max_cooks"] = max_cooks_dev(b["cooks"], cells, p)
    if with_cooks and replaceable_np.any():
        with stage:
            for b, y, w in zip(blk, ys, ws):
                # replaceOutliers (R/core.R:2069-2115)
                with_outlier = b["cooks"] > cutoff99          # NaN -> False
                replace = with_outlier.any(dim=1) & ~b["all_zero"]
                trim_base = trimmed_mean_dev(b["norm_counts"], 0.2)
                replacement = torch.trunc(trim_base[:, None] * b["nf_b"])
                b["repl_cols"] = torch.as_tensor(
                    replaceable_np, device=y.device)[None, :]
                y_new = torch.where(with_outlier & b["repl_cols"],
                                    replacement, y)
                new_all_zero = y_new.sum(dim=1) == 0
                b["need"] = replace & ~new_all_zero
                # base stats of the replaced rows on the replaced counts
                # (R/core.R:2508), weighted with observation weights
                norm_new = y_new / b["nf_b"]
                if w is not None:
                    norm_new = w * norm_new
                b["base_mean"] = torch.where(replace, norm_new.mean(dim=1),
                                             b["base_mean"])
                b["base_var"] = torch.where(
                    replace, norm_new.var(dim=1, correction=1),
                    b["base_var"])
                b["all_zero"] = torch.where(replace, new_all_zero,
                                            b["all_zero"])
                b["replace"], b["y_new"] = replace, y_new
            # maxCooks is recomputed when a refit ran anywhere
            refit_any = bool(gat([b["need"] for b in blk]).any())
            for s_, c, b, w, nf, (ts_, dpv, vld), pv in zip(
                    sts, cols_b, blk, ws, nfs, frozen, priors):
                c["cooks"] = b["cooks"]
                idx = torch.nonzero(b["need"]).squeeze(1)
                if idx.numel():
                    c.update(_refit_rows(s_, b["y_new"], idx, c, ts_, dpv,
                                         vld, cells, w, nf, pv))
                b["replaceCounts"] = b["y_new"]
                b["replaceCooks"] = c.pop("cooks")
                # maxCooks after the refit (R/core.R:2540-2551), only when
                # a refit ran
                if refit_any:
                    if replaceable_np.all():
                        b["max_cooks"] = torch.full_like(b["max_cooks"],
                                                         float("nan"))
                    else:
                        b["max_cooks"] = max_cooks_dev(
                            torch.where(b["repl_cols"],
                                        torch.zeros_like(b["cooks"]),
                                        b["replaceCooks"]), cells, p)

    # per-gene flags of the tail that read the (G,S) counts
    zz_mode = None
    if lrt and contrast is not None:
        zz_mode = "numeric"
    elif not lrt and (beta_prior or contrast is not None):
        zz_mode = "levels" if beta_prior and contrast is None else "numeric"

    def numeric_zero_zero(y, cvals, xmat):
        """contrastAllZeroNumeric (R/results.R:1245-1270): rows whose counts
        are all zero over the samples the contrast involves (mixed-sign
        contrasts only)."""
        ca = np.asarray(cvals)
        if (ca >= 0).all() or (ca <= 0).all():
            return torch.zeros(y.shape[0], dtype=torch.bool, device=y.device)
        cbin = torch.as_tensor((ca != 0).astype(float), dtype=dtype,
                               device=y.device)
        which = (xmat.to(y.device) @ cbin) != 0
        return (y * which[None, :].to(dtype)).sum(dim=1) == 0

    for b, y in zip(blk, ys):
        if zz_mode == "numeric":
            b["zz"] = numeric_zero_zero(
                y, contrast, x_exp if beta_prior and not lrt else x)
        elif zz_mode == "levels":
            # the default betaPrior contrast's character rule: both
            # involved levels all zero (R/results.R:956-959, 1237-1243)
            carr = np.asarray(cells)
            first = torch.as_tensor(np.where(carr == 0)[0], device=y.device)
            last = torch.as_tensor(np.where(carr == carr.max())[0],
                                   device=y.device)
            b["zz"] = (y[:, first].sum(dim=1) == 0) \
                & (y[:, last].sum(dim=1) == 0)
        if with_cooks and two_group:
            # no masking when >= 3 counts exceed the outlier's count
            # (R/results.R:538-562)
            cmax = torch.where(torch.isnan(b["cooks"]),
                               torch.full_like(b["cooks"], float("-inf")),
                               b["cooks"])
            iarg = torch.argmax(cmax, dim=1)
            out_count = torch.gather(y, 1, iarg[:, None])
            b["unmask"] = (y > out_count).sum(dim=1) >= 3

    # ---- onto the first device: the results tail ----
    cols = {k: gat([c[k] for c in cols_b]) for k in cols_b[0]}
    # (max_cooks is None where no cell has 3 replicates, max_cooks_dev)
    tail = {k: gat([b[k] for b in blk]) for k in (
        "replace", "base_mean", "base_var", "all_zero", "cooks",
        "max_cooks", "replaceCounts", "replaceCooks", "zz", "unmask")
        if blk[0].get(k) is not None}
    replace, base_mean, base_var, all_zero = (
        tail[k] for k in ("replace", "base_mean", "base_var", "all_zero"))
    cooks, max_cooks = tail.get("cooks"), tail.get("max_cooks")
    for k in ("replaceCounts", "replaceCooks"):
        if k in tail:
            out[k] = tail[k]

    # ---- Wald statistics (R/core.R:1471-1508) ----
    beta_log2 = LOG2E * cols["beta"]
    se_log2 = LOG2E * torch.sqrt(torch.clamp(cols["beta_var"], min=0.0))
    wald_stat = beta_log2 / se_log2
    wald_p = two_sided_p(wald_stat)

    nan = float("nan")
    beta_iter, deviance = cols["beta_iter"], cols["deviance"]

    def nanmask(v):
        return torch.where(all_zero, torch.full_like(v, nan), v)

    lfc_last = nanmask(beta_log2[:, -1])
    se_last = nanmask(se_log2[:, -1])
    if lrt:
        # the LRT tail (R/core.R:1787-1897); R's pchisq gives p = 1 for a
        # statistic <= 0, which a ridge-penalized full fit can reach
        df = p - (1 if reduced_intercept else x_reduced.shape[1])
        lrt_stat = 2.0 * (cols["ll_full"] - cols["ll_reduced"])
        lrt_p = torch.special.gammaincc(
            torch.full_like(lrt_stat, df / 2.0),
            torch.clamp(lrt_stat, min=0.0) / 2.0)
        stat_last = nanmask(lrt_stat)
        p_last = nanmask(lrt_p)
        out["LRTStatistic"] = stat_last
        out["LRTPvalue"] = p_last
        out["betaIterReduced"] = cols["beta_iter_reduced"]
        if contrast is not None:
            # LFC and SE from the contrast sandwich; the zero-zero rule
            # zeroes only the LFC here, the LRT's statistic and p-value
            # stand (R/results.R:1021-1037)
            lfc_last = nanmask(LOG2E * cols["num"])
            se_last = nanmask(LOG2E * cols["den"])
            zz = tail["zz"] & ~all_zero
            lfc_last = torch.where(zz, torch.zeros_like(lfc_last), lfc_last)
    elif beta_prior or contrast is not None:
        # the contrast (under betaPrior by default the last level against
        # the first) from the sandwich: stat = c'beta / sqrt(c' Sigma c)
        # (R/results.R:797-818)
        lfc_last = nanmask(LOG2E * cols["num"])
        se_last = nanmask(LOG2E * cols["den"])
        stat_last = nanmask(cols["num"] / cols["den"])
        p_last = nanmask(two_sided_p(stat_last))
        # zero-zero rule, LFC = 0, stat = 0, p = 1: the default betaPrior
        # contrast takes the character rule, a user contrast the numeric
        # one (R/results.R:1245-1270)
        zz = tail["zz"] & ~all_zero
        zero = torch.zeros_like(p_last)
        lfc_last = torch.where(zz, zero, lfc_last)
        stat_last = torch.where(zz, zero, stat_last)
        p_last = torch.where(zz, torch.ones_like(p_last), p_last)
        if beta_prior:
            # the expanded MAP betas replace the MLE ones in the outputs
            beta_log2 = LOG2E * cols["beta_e"]
            se_log2 = LOG2E * torch.sqrt(torch.clamp(cols["beta_var_e"],
                                                     min=0.0))
            wald_stat = beta_log2 / se_log2
            wald_p = two_sided_p(wald_stat)
            beta_iter, deviance = cols["iter_e"], cols["deviance_e"]
    else:
        p_last = nanmask(wald_p[:, -1])
        stat_last = nanmask(wald_stat[:, -1])

    if max_cooks is not None:
        cooks_outlier = torch.where(torch.isnan(max_cooks),
                                    torch.zeros_like(replace),
                                    max_cooks > cutoff99)
        if two_group:
            cooks_outlier = cooks_outlier & ~tail["unmask"]
        p_last = torch.where(cooks_outlier, torch.full_like(p_last, nan),
                             p_last)

    # replaced-to-zero rows: LFC=0, SE=0, stat=0, p=1 (R/results.R:567-575)
    now_zero = replace & (base_mean == 0)
    zero, one = torch.zeros_like(p_last), torch.ones_like(p_last)
    lfc_last = torch.where(now_zero, zero, lfc_last)
    se_last = torch.where(now_zero, zero, se_last)
    stat_last = torch.where(now_zero, zero, stat_last)
    p_last = torch.where(now_zero, one, p_last)

    padj_last = bh_adjust(p_last, ~torch.isnan(p_last))
    theta = theta_grid_dev(base_mean)
    filter_padj, num_rej, cutoffs = filtered_bh_dev(p_last, base_mean, theta,
                                                    alpha)

    def rowmask(v):
        return torch.where(all_zero[:, None], torch.full_like(v, nan), v)

    out.update(
        baseMean=base_mean, baseVar=base_var, allZero=all_zero,
        dispGeneEst=nanmask(cols["disp_gene_est"]),
        dispFit=nanmask(cols["disp_fit"]),
        dispGeneIter=cols["disp_gene_iter"], dispIter=cols["disp_iter"],
        dispersion=nanmask(cols["dispersion"]),
        dispMAP=nanmask(cols["disp_map"]),
        dispOutlier=cols["disp_outlier"] & ~all_zero,
        beta=rowmask(beta_log2), betaSE=rowmask(se_log2),
        stat=rowmask(wald_stat), pvalue=rowmask(wald_p),
        betaIter=beta_iter, betaConv=beta_iter < maxit,
        mu=cols["mu"], hatDiag=cols["hat"], deviance=nanmask(deviance),
        lfcLast=lfc_last, seLast=se_last, statLast=stat_last,
        pvalueLast=p_last, padjLast=padj_last, replace=replace,
        filterTheta=theta, filterPadj=filter_padj, filterNumRej=num_rej,
        filterCutoffs=cutoffs)
    if cooks is not None:
        out["cooks"] = cooks
        out["maxCooks"] = (torch.full((G,), nan, dtype=dtype, device=dev)
                           if max_cooks is None else nanmask(max_cooks))
    return out


def design_cells(x):
    """Per-sample design-cell codes from a model matrix (host)."""
    rows = [tuple(r) for r in np.asarray(x)]
    seen = {}
    return tuple(seen.setdefault(r, len(seen)) for r in rows)


def default_grid(n_samples, min_disp=1e-8, n=20):
    """fitDispGrid's shared log-alpha grid, [log(min_disp), log(max(10, m))]
    (R/wrappers.R:70-72)."""
    return np.linspace(np.log(min_disp), np.log(max(10.0, n_samples)), n)


def reduced_args(reduced):
    """A `reduced` spec as (x_reduced array or None, intercept flag): '~ 1'
    or a 1-column all-ones matrix takes the intercept closed form
    (R/fitNbinomGLMs.R:99-104)."""
    if reduced is None:
        return None, False
    if isinstance(reduced, str):
        if reduced.replace(" ", "") not in ("~1", "1", "intercept"):
            raise ValueError("fused LRT accepts reduced='~ 1' or a model "
                             "matrix")
        return None, True
    reduced = np.asarray(reduced, dtype=np.float64)
    if reduced.shape[1] == 1 and np.all(reduced == 1.0):
        return None, True
    return reduced, False


# torch.linalg.eigvalsh on the card (cusolverDnXsyevBatched) refuses a
# batch of more than about 30,000 matrices, whatever their values
# (CUSOLVER_STATUS_INVALID_VALUE from its workspace query above 32,016
# matrices at p = 2 and 29,915 at p = 8), and its workspace takes about
# 0.5 MiB per matrix whatever p (1 GiB at 2,048, 8.2 GiB at 16,384);
# torch 2.11.0+cu128, `python -m deseq2_tpu_torch.ops.studies eigvalsh`.
# The rank tests take their eigenvalues in chunks of this many: 3.7-4.0 ms
# for 60,000 grams at p = 2-3 on an H100
EIGH_CHUNK = 2048


def weights_ok_dev(w, x, threshold=CR_WEIGHT_THRESHOLD):
    """Per-gene estimability tests of getAndCheckWeights
    (R/core.R:2697-2752) on w's device: full rank of X'W^2X and of the
    gram of the rows with weight above the Cox-Reid threshold (dropped
    columns embedded as identity), by the smallest eigenvalue against the
    largest times p eps; plus the negative / no-positive checks.  In
    float64 whatever the pipeline's dtype, so a row float64 accepts is
    never refused for float32 rounding of the eigenvalues."""
    w = w.double()
    x = x.double()
    m = x.shape[1]
    mx = w.max(dim=1, keepdim=True).values
    wn = w / mx
    eps = torch.finfo(torch.float64).eps

    def full_rank(gram):
        ev = torch.cat([torch.linalg.eigvalsh(g)
                        for g in gram.split(EIGH_CHUNK)])
        return ev[:, 0] > ev[:, -1] * m * eps

    xx = (x[:, :, None] * x[:, None, :]).reshape(x.shape[0], m * m)
    gram1 = ((wn * wn) @ xx).reshape(-1, m, m)
    sub = (wn > threshold).double()
    cm = ((sub @ x.abs()) > 0.0).double()
    gram2 = (sub @ xx).reshape(-1, m, m)
    gram2 = gram2 * (cm[:, :, None] * cm[:, None, :]) \
        + torch.diag_embed(1.0 - cm)
    neg = (w < 0).any(dim=1)
    nopos = mx[:, 0] <= 0
    return full_rank(gram1) & full_rank(gram2) & ~neg & ~nopos, \
        bool(neg.any()), bool(nopos.any())


def validated_weights(weights, x_np, device, dtype, refuse=True):
    """Upload the raw observation weights to `device` in `dtype` and
    validate them there (getAndCheckWeights' rank tests).  Rows that fail
    raise ValueError (the fused pipeline does not do the weightsFail/
    allZero bookkeeping), or with refuse=False give None: deseq() then
    runs the host engine, which does."""
    w = torch.as_tensor(np.asarray(weights)).to(device=device, dtype=dtype)
    x = torch.as_tensor(np.asarray(x_np, np.float64), device=device)
    ok, neg, nopos = weights_ok_dev(w, x)
    if neg:
        raise ValueError("weights must be non-negative")
    if nopos:
        raise ValueError("each gene needs at least one positive weight")
    bad = ~ok.cpu().numpy()
    if bad.any():
        if not refuse:
            return None
        raise ValueError(
            f"{int(bad.sum())} row(s) have weights that do not allow "
            "parameter estimation (rank-deficient weighted design); the "
            "fused pipeline refuses them, and deseq() runs such rows on "
            "its host engine with the weightsFail/allZero bookkeeping "
            f"(first rows: {np.where(bad)[0][:5].tolist()})")
    return w


def run_fused_sharded(counts, x, size_factors, mesh, maxit=100,
                      min_disp=1e-8, cells=None, two_group=False,
                      alpha=0.1, reduced=None, beta_prior=False,
                      contrast=None, use_t=False, weights=None,
                      norm_factors=None, min_replicates=7,
                      fit_type="parametric", dtype=torch.float64):
    """The fused pipeline with the genes axis sharded over `mesh` (a
    GeneMesh; the JAX package's run_fused_sharded): the host counts and
    (G,S) inputs go block by block to the shards' devices, and every
    output comes back as a host numpy array.  `size_factors=None`
    estimates median-of-ratios factors, the blocks' log ratios gathered
    for the per-sample median."""
    from .sharding import as_mesh
    if as_mesh(mesh) is None:
        raise TypeError("run_fused_sharded needs a GeneMesh")
    x_np = np.asarray(x, dtype=np.float64)
    out = _run_pipeline(counts, x_np, size_factors, mesh.first_device,
                        dtype, mesh, maxit=maxit, min_disp=min_disp,
                        cells=cells, two_group=two_group, alpha=alpha,
                        reduced=reduced, beta_prior=beta_prior,
                        contrast=contrast, use_t=use_t, weights=weights,
                        norm_factors=norm_factors,
                        min_replicates=min_replicates, fit_type=fit_type)
    return {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
            for k, v in out.items()}


def _run_pipeline(counts, x_np, size_factors, dev, dtype, mesh, min_disp,
                  reduced, weights, norm_factors, contrast, **kw):
    """fused_wald_pipeline from host arrays: the counts on `dev`, or under
    `mesh` left on the host for its blocks to go to their devices."""
    if contrast is not None:
        contrast = tuple(float(c) for c in np.asarray(contrast).ravel())
    if norm_factors is not None:
        if np.shape(norm_factors) != np.shape(counts):
            raise ValueError("norm_factors must match the counts shape "
                             "(genes x samples)")
        norm_factors = torch.as_tensor(np.asarray(norm_factors, np.float64))
    x_red, red_int = reduced_args(reduced)
    counts_t = torch.as_tensor(np.asarray(counts))
    if mesh is None:
        counts_t = counts_t.to(dev)
    return fused_wald_pipeline(
        counts_t, torch.as_tensor(x_np), None if size_factors is None
        else torch.as_tensor(np.asarray(size_factors, np.float64)),
        torch.as_tensor(default_grid(x_np.shape[0], min_disp)),
        min_disp=min_disp,
        linear_mu=len(set(design_cells(x_np))) == x_np.shape[1],
        dtype=dtype, x_reduced=None if x_red is None
        else torch.as_tensor(x_red), reduced_intercept=red_int,
        weights=weights, norm_factors=norm_factors, contrast=contrast,
        mesh=mesh, **kw)


def fused_results(counts, x, size_factors=None, maxit=100, min_disp=1e-8,
                  alpha=0.1, independent_filtering=True, two_group=False,
                  min_replicates=7, device=None, dtype=torch.float64,
                  reduced=None, use_t=False, weights=None,
                  norm_factors=None, fit_type="parametric",
                  beta_prior=False, contrast=None, mesh=None):
    """deseq() + results() through the fused pipeline: runs it on `device`
    (default "cuda"), then picks the independent-filtering cutoff on the
    host (R/results.R:661-698) and returns the results-table columns as
    numpy arrays.  `size_factors=None` estimates median-of-ratios factors
    on the device; `reduced` ('~ 1' or a matrix) runs the LRT; `weights`
    (raw, validated here), `norm_factors`, `use_t`, `fit_type`,
    `beta_prior` and `contrast` (a numeric vector over x's columns, or
    the expanded columns under beta_prior) as in fused_wald_pipeline.
    `mesh` (a GeneMesh) shards the genes axis over its devices, the
    cross-gene steps on its first device, which `device` may only name."""
    from ..results import choose_filter_theta
    from ..engine import resolve_device

    dev = resolve_device(device, mesh)
    x_np = np.asarray(x, dtype=np.float64)
    cells = design_cells(x_np)
    if weights is not None:
        weights = validated_weights(weights, x_np, dev, dtype)
    out = _run_pipeline(counts, x_np, size_factors, dev, dtype, mesh,
                        maxit=maxit, min_disp=min_disp, cells=cells,
                        two_group=two_group, min_replicates=min_replicates,
                        alpha=alpha, reduced=reduced, use_t=use_t,
                        weights=weights, norm_factors=norm_factors,
                        fit_type=fit_type, beta_prior=beta_prior,
                        contrast=contrast)

    def host(v):
        return v.cpu().numpy() if torch.is_tensor(v) else v

    res = dict(baseMean=out["baseMean"], log2FoldChange=out["lfcLast"],
               lfcSE=out["seLast"], stat=out["statLast"],
               pvalue=out["pvalueLast"])
    for k in ("dispGeneEst", "dispFit", "dispersion", "maxCooks", "replace",
              "betaConv", "allZero", "sizeFactors"):
        if k in out:
            res[k] = out[k]
    if independent_filtering:
        num_rej, theta = host(out["filterNumRej"]), host(out["filterTheta"])
        j, _, _ = choose_filter_theta(theta, num_rej)
        res["padj"] = out["filterPadj"][j]
        res = {k: host(v) for k, v in res.items()}
        res["filterThreshold"] = float(host(out["filterCutoffs"])[j])
        res["filterTheta"] = float(theta[j])
        res["filterNumRej"] = num_rej
    else:
        res["padj"] = out["padjLast"]
        res = {k: host(v) for k, v in res.items()}
    return res
