"""Readings and limits for holding the CUDA kernels (K1 irls.cu, K2
disp_ls.cu, K3 disp_grid.cu) against their plain PyTorch versions on the
same inputs.  chip_smoke.py and tests/test_torch_gpu.py both use them.

float64: the kernel follows the plain version's trajectory (the same steps,
summed in another order), so its solution equals the plain one to
rounding: beta to 1e-8 relative, the log posterior at the solution to 1e-9
relative, and at least 98% of the genes land on the same log alpha.

float32: the two trajectories part on rounding, and the float32 posterior
cannot order grid points closer than its rounding.  The kernel and the
plain version are then both held against the reference, the plain version
run in float64 on the same inputs, with the log posterior evaluated in
float64 at each solution:

- K2: the shortfall below the reference's solution, over the genes the
  pipeline takes as converged (iter < maxit and iter != 1, in all three).
  The float32 line search stops once an accepted step gains less than
  50 eps |lp0|, which a short step after backtracking does far from the
  optimum, so the plain float32 version itself stops up to a few lp units
  short.  The kernel's largest and mean shortfall may exceed the plain
  version's, measured in the same call, by the factors ls_max_x and
  ls_mean_x (plus eps times the mean |lp|);
- K3: the shortfall below the reference's pick in units of eps |lp|
  (float32's rounding of the gene's posterior), at most grid_short; and on
  the genes whose reference pick beats both fine-grid neighbours by more
  than SEPARATED such units (there must be some), the share that picks
  the reference's point;
- K1: beta against the plain float32 fit, |dbeta| / (1 + |beta|) over
  the genes converged in both (the IRLS fixpoint does not depend on the
  path).

The weighted modes are held by the same readings and limits, on inputs
with observation weights (`solver_inputs(..., weighted=True)`): max-1 rows
in [0.2, 1], and for p >= 2 the treated samples of the first ten genes
below the Cox-Reid threshold, so that their treatment column drops out of
the Cox-Reid term.  Every reading below takes d["w"] when it is there.

chip_smoke.py prints the kernel's and the plain version's readings side by
side; the limits leave a margin over both.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .disp import fit_disp_grid_plain, fit_disp_line_search_plain
from .disp import CR_WEIGHT_THRESHOLD, log_posterior, make_cr_masks
from .nb import nb_logpmf

MIN_LA = float(np.log(1e-9))
# log alpha below which (1/alpha > 1e8) the posterior is flat to within
# lgamma's rounding
FLAT_LA = float(np.log(1e-8))
PRIOR_VAR = 1.3
SEPARATED = 16.0
# (S, G) of the kernel checks: few and many samples, ragged gene counts
SHAPES = ((24, 333), (3000, 301))
# (S, G, p) of the kernel checks at the edges of the kernels' warp layout:
# sample counts at which a warp's lanes wrap, and the widest designs, where
# every lane runs the largest p x p algebra.
EDGES = ((31, 97, 2), (33, 97, 2), (65, 97, 3), (24, 120, 5), (65, 120, 8))
# (S, G, levels) of the K1 checks at the betaPrior refit's expanded design
# [intercept, one indicator per level] (p = levels + 1, rank-deficient but
# for its ridge): p = 3 and 4 at the main path's S, and p = 4 at few samples
EXPANDED = ((1024, 301, 2), (1024, 301, 3), (24, 333, 3))
# The float32 readings at EDGES that the plain float32 version fails
# against itself when only its summation order changes (the samples
# permuted), in any of 5 permutations on the CPU (`python -m
# deseq2_tpu_torch.ops.studies edges`, which gives the same answer on any
# machine), as (kernel, S, p, weighted, prior; None for K1).  There
# rounding alone fails TOL: K1 is held instead to the float64 fit
# (check_irls_f64), K2's readings are printed, not gated.  No K3 reading
# is rounding-bound there.
ROUNDING_BOUND = {("irls", 24, 5, False, None), ("irls", 24, 5, True, None),
                  ("irls", 65, 8, False, None), ("disp_ls", 33, 2, True, True),
                  ("disp_ls", 65, 3, False, True),
                  ("disp_ls", 65, 8, True, True)}

# the design widths of the wide kernels' checks (8 < p <= 16), and their
# modes as (weighted, MODES key): the default unweighted and weighted, and
# K2's and K3's other modes
WIDE_P = (9, 10, 12, 16)
WIDE_MODES = ((False, None), (True, None), (False, "nocr"), (True, "nocr"),
              (True, "thr"))

# The wide kernels' float32 K2 and K3 readings that fail TOL are held
# instead to the plain float32 version's own spread (within_plain_spread):
# the plain version rerun on SPREAD_PERMS permutations of the samples and
# of the design's columns, where only rounding changes.  A K2 kernel's
# log alpha agreement with the plain version may fall SPREAD_AGREE_MARGIN
# below the lowest of the permutations' (one draw more of the same spread:
# on the CPU the card's kernel readings sat 0 to 0.057 above the lowest
# of five permutations in all 24 Cox-Reid cases at S = 24).
SPREAD_PERMS = 5
SPREAD_AGREE_MARGIN = 0.05

TOL = {
    "float32": dict(beta=5e-3, same_conv=0.95, ls_agree=0.9, ls_max_x=4.0,
                    ls_mean_x=1.5, grid_short=16.0, grid_sep_same=0.99),
    "float64": dict(beta=1e-8, same_conv=0.98, ls_agree=0.98, lp_rel=1e-9,
                    grid_same=0.98),
}


def seed_of(p, S, mode=None):
    """The seed of a kernel check's inputs at (p, S): 10 p + S, and 7 more
    in K2's and K3's other modes (chip_smoke.py phase 3)."""
    return 10 * p + S + (7 if mode else 0)


def solver_inputs(G, S, p, seed, weighted=False):
    """NB counts, a design with p columns, a positive mean and start values
    for a kernel check (the fixtures of the JAX package's kernel tests), as
    numpy arrays; with `weighted`, observation weights "w" too."""
    rng = np.random.default_rng(seed)
    x = np.column_stack([np.ones(S)]
                        + [rng.permutation(np.arange(S) % 2).astype(float)
                           for _ in range(p - 1)])
    beta = np.column_stack([rng.normal(3.0, 1.0, G)]
                           + [rng.normal(0.0, 1.0, G) for _ in range(p - 1)])
    mu = np.exp(beta @ x.T)
    alpha = np.clip(4.0 / mu[:, 0] + 0.1, 0.05, 5.0)
    size = 1.0 / alpha[:, None]
    y = rng.negative_binomial(size, size / (size + mu)).astype(np.float64)
    la0 = np.log(np.clip(alpha * np.exp(rng.normal(0, 0.5, G)), 1e-8, 10.0))
    b0 = np.zeros((G, p))
    b0[:, 0] = np.log(np.maximum(y.mean(axis=1), 0.5))
    out = dict(y=y, x=x, mu=np.maximum(mu, 0.5), alpha=alpha, la0=la0,
               b0=b0, pm=np.log(np.full(G, 0.5)),
               grid=np.linspace(np.log(1e-8), np.log(max(10.0, S)), 20))
    if weighted:
        w = np.clip(rng.random((G, S)) + 0.2, 0.0, 1.0)
        w /= w.max(axis=1, keepdims=True)
        if p >= 2:
            w[:10][:, x[:, 1] > 0] = 1e-3      # below the 1e-2 threshold
        out["w"] = w
    return out


def expanded_inputs(G, S, levels, seed, weighted=False, prior_var=1.0):
    """K1's inputs at the betaPrior refit, as numpy arrays: NB counts of a
    `levels`-level factor (level l on samples s with s % levels == l), the
    expanded design [intercept, one indicator per level], whose intercept
    is the sum of the level columns, its ridge [1e-6, 1/v, ..., 1/v] /
    ln2^2 (the pipeline's, prior variance v on the log2 scale), the
    intercept-only start log(mean count) and the dispersions; with
    `weighted`, max-1 observation weights in [0.2, 1]."""
    rng = np.random.default_rng(seed)
    codes = np.arange(S) % levels
    x = np.column_stack([np.ones(S)] + [(codes == lv).astype(float)
                                        for lv in range(levels)])
    eff = rng.normal(0.0, 1.0, (G, levels))
    mu = np.exp(rng.normal(3.0, 1.0, G)[:, None] + eff[:, codes])
    alpha = np.clip(4.0 / mu.mean(axis=1) + 0.1, 0.05, 5.0)
    size = 1.0 / alpha[:, None]
    y = rng.negative_binomial(size, size / (size + mu)).astype(np.float64)
    b0 = np.zeros((G, levels + 1))
    b0[:, 0] = np.log(np.maximum(y.mean(axis=1), 0.5))
    ridge = np.array([1e-6] + [1.0 / prior_var] * levels) / np.log(2.0) ** 2
    out = dict(y=y, x=x, alpha=alpha, b0=b0, ridge=ridge)
    if weighted:
        w = np.clip(rng.random((G, S)) + 0.2, 0.0, 1.0)
        out["w"] = w / w.max(axis=1, keepdims=True)
    return out


def bench_counts(G, S, seed=0):
    """bench.py's make_inputs: NB counts (G,S) int32 with dispersion
    4/mu + 0.1 around 2^N(4, 2), and the ~ condition design (S,2)."""
    rng = np.random.default_rng(seed)
    S2 = S // 2
    x = np.column_stack([np.ones(S), np.repeat([0.0, 1.0], [S2, S - S2])])
    intercept = rng.normal(4.0, 2.0, G)
    mu0 = 2.0 ** intercept
    disp = 4.0 / mu0 + 0.1
    mu = mu0[:, None] * np.ones((1, S))
    size = 1.0 / disp[:, None]
    counts = rng.negative_binomial(size, size / (size + mu)).astype(np.int32)
    return counts, x


def gate_counts(G, S, seed=0):
    """bench.py's gate generator (_gate_inputs): bench_counts' NB counts
    with a log2 fold change N(0, 1) on half the genes between the two
    halves of the samples; returns (counts (G,S) int32, the design)."""
    rng = np.random.default_rng(seed)
    s2 = S // 2
    x = np.column_stack([np.ones(S), np.repeat([0.0, 1.0], [s2, S - s2])])
    intercept = rng.normal(4.0, 2.0, G)
    mu0 = 2.0 ** intercept
    disp = 4.0 / mu0 + 0.1
    lfc = np.where(rng.random(G) < 0.5, rng.normal(0.0, 1.0, G), 0.0)
    mu = mu0[:, None] * 2.0 ** (lfc[:, None] * x[:, 1][None, :])
    size = 1.0 / disp[:, None]
    counts = rng.negative_binomial(size, size / (size + mu)).astype(np.int32)
    return counts, x


def paired_design(S, subjects):
    """The paired design ~ subject + condition (p = subjects + 1): sample
    j belongs to subject j % subjects, and the condition alternates within
    each subject (A on its first sample, B on its second, ...).  Returns
    the subject and condition labels."""
    j = np.arange(S)
    return (np.array([f"s{v}" for v in j % subjects]),
            np.where((j // subjects) % 2 == 0, "A", "B"))


def paired_gate_counts(G, S, subjects, seed=0):
    """bench.py's gate generator (gate_counts) on the paired design: NB
    counts with a subject effect N(0, 0.5) per gene and subject (log2
    scale) and a log2 fold change N(0, 1) on half the genes between the
    conditions of paired_design; returns (counts (G,S) int32, subject
    labels, condition labels)."""
    rng = np.random.default_rng(seed)
    subj, cond = paired_design(S, subjects)
    codes = np.arange(S) % subjects
    intercept = rng.normal(4.0, 2.0, G)
    mu0 = 2.0 ** intercept
    disp = 4.0 / mu0 + 0.1
    lfc = np.where(rng.random(G) < 0.5, rng.normal(0.0, 1.0, G), 0.0)
    eff = rng.normal(0.0, 0.5, (G, subjects))
    mu = mu0[:, None] * 2.0 ** (eff[:, codes]
                                + lfc[:, None] * (cond == "B")[None, :])
    size = 1.0 / disp[:, None]
    counts = rng.negative_binomial(size, size / (size + mu)).astype(np.int32)
    return counts, subj, cond


def variant_inputs(counts, seed=0):
    """The weights assay and the (G,S) normalization factors of the
    variant paths, from `seed`: weights uniform(0.3, 1) with 5% of the
    zero-count entries at 1e-3 (below the Cox-Reid threshold, as zinbwave
    down-weights zeros); factors exp(N(0, 0.2)), row-centred."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.3, 1.0, counts.shape)
    w[(counts == 0) & (rng.random(counts.shape) < 0.05)] = 1e-3
    nf = np.exp(rng.normal(0.0, 0.2, counts.shape))
    nf /= np.exp(np.log(nf).mean(axis=1))[:, None]
    return w, nf


def pipeline_inputs(counts, x_np, dtype, device, weights=None):
    """The inputs the pipeline's own stages hand the gene-wise line search
    (K2) at these counts, unit size factors: y, mu, x, la0 (also the prior
    mean), min_la, and with `weights` (numpy, (G,S)) the max-1 weights
    floored at 1e-6 (w_ge, K2's) and unfloored (w_n, K1's); plus what K1
    needs around them (sf, ridge, norm_c, grid)."""
    from ..parallel.fused import Stages, default_grid
    S = counts.shape[1]
    y = torch.as_tensor(counts, device=device).to(dtype)
    x = torch.as_tensor(x_np, dtype=dtype, device=device)
    sf = torch.ones(S, dtype=dtype, device=device)
    grid = torch.as_tensor(default_grid(S), dtype=dtype, device=device)
    st = Stages(x, sf, grid, linear_mu=weights is None)
    out = dict(x=x, sf=sf, grid=grid, min_la=st.min_la, ridge=st.lam_nat,
               w_ge=None, w_n=None)
    if weights is not None:
        w = torch.as_tensor(weights, device=device).to(dtype)
        out["w_n"] = w / w.max(dim=1, keepdim=True).values
        out["w_ge"] = torch.clamp(out["w_n"], min=1e-6)
        init = st.dispersion_init(y, w)
    else:
        init = st.dispersion_init(y)
    out.update(y=init["y_safe"], mu=init["mu_safe"],
               la0=torch.log(init["alpha_init"]), norm_c=init["norm_c"])
    return out


def irls_start(d, log_alpha):
    """K1's inputs after the line search on pipeline_inputs' d: alpha
    clamped to [1e-8, S] and the least-squares start on log(counts + 0.1)
    (the pipeline's own)."""
    S = d["x"].shape[0]
    alpha = torch.exp(log_alpha).clamp(1e-8, S)
    x = d["x"]
    beta0 = torch.linalg.solve(x.T @ x, (torch.log(d["norm_c"] + 0.1)
                                         @ x).T).T
    return (d["y"], x, d["sf"], alpha, beta0, d["ridge"])


def as_tensors(raw, dtype, device):
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in raw.items()}


def ridge_for(p, dtype, device):
    return torch.full((p,), 1e-6 / np.log(2.0) ** 2, dtype=dtype,
                      device=device)


# the transforms' payload on the card against the port in float64 on the
# CPU, max |difference| in log2 units: float64 VST, vst and normTransform
# to rounding; float64 rlog to its IRLS's stopping rule (a relative
# deviance change of 1e-4); a float32 payload to bench.py's |dLFC| limit
TRANSFORM_TOL = {"float64": 1e-6, "rlog_float64": 1e-4, "float32": 0.01}


# K2's and K3's modes besides the default (the Cox-Reid term at the 1e-2
# weight threshold), as the entries of a check's inputs d that select them:
# without the Cox-Reid term, and (weighted) the row cut at 0.5
MODES = {"nocr": dict(use_cr=False), "thr": dict(weight_threshold=0.5)}


def with_mode(d, mode):
    """d with the entries of MODES[mode] (None: d itself)."""
    return d if mode is None else dict(d, **MODES[mode])


def mode_kw(d):
    """The mode arguments of K2 and K3 that d selects."""
    return dict(use_cr=d.get("use_cr", True),
                weight_threshold=d.get("weight_threshold",
                                       CR_WEIGHT_THRESHOLD))


def _f64(d):
    return {k: v.double() if torch.is_tensor(v) and v.is_floating_point()
            else v for k, v in d.items()}


def cr_singular(d):
    """(G,) bool: the genes whose Cox-Reid matrix X'WX is singular by
    construction, its kept rows (make_cr_masks: weight above the
    threshold) not spanning its kept columns; none without the Cox-Reid
    term.  There the plain version's Cholesky gives NaN or a log
    determinant at rounding level, and the kernels floor the pivot at
    1e-30 (as the TPU kernels do): the two compute different things."""
    dev = d["y"].device
    x = d["x"].double().cpu()
    G, p = d["y"].shape[0], x.shape[1]
    kw = mode_kw(d)
    if not kw["use_cr"]:
        return torch.zeros(G, dtype=torch.bool, device=dev)
    w = d.get("w")
    if w is None:
        full = int(torch.linalg.matrix_rank(x)) == p
        return torch.full((G,), not full, dtype=torch.bool, device=dev)
    # on the host: the card's batched eigensolver refuses large batches
    # (`python -m deseq2_tpu_torch.ops.studies eigvalsh`)
    rm, cm = make_cr_masks(x, w.double().cpu(), kw["weight_threshold"])
    cmd = cm.double()
    b = (rm.double() @ (x[:, :, None] * x[:, None, :]).reshape(-1, p * p)
         ).reshape(G, p, p) * (cmd[:, :, None] * cmd[:, None, :])
    rank = torch.linalg.matrix_rank(b, hermitian=True)
    return (rank < cm.sum(dim=1)).to(dev)


def lp_at(la, d, use_prior, prior_var=PRIOR_VAR):
    """float64 log posterior at log alpha `la` (the quantity K2 and K3
    maximize), evaluated by the plain code.  d holds y, mu, x, pm and
    optionally w and the mode entries (with_mode)."""
    f = torch.float64
    x = d["x"].to(f)
    w = d.get("w")
    w = None if w is None else w.to(f)
    kw = mode_kw(d)
    rm, cm = make_cr_masks(x, w, kw["weight_threshold"])
    return log_posterior(la.to(f), d["y"].to(f), d["mu"].to(f), x,
                         d["pm"].to(f), prior_var, use_prior, w, rm, cm,
                         kw["use_cr"])


def run_irls(fn, d, maxit=100, min_mu=0.5):
    """fn (the kernel wrapper or the plain version) on d's K1 inputs, with
    unit normalization factors and d's weights, if any."""
    dt, dev = d["y"].dtype, d["y"].device
    S, p = d["x"].shape
    ridge = d["ridge"] if "ridge" in d else ridge_for(p, dt, dev)
    return fn(d["y"], d["x"], torch.ones(S, dtype=dt, device=dev),
              d["alpha"], d["b0"], ridge, maxit=maxit, min_mu=min_mu,
              weights=d.get("w"))


def run_ls(fn, d, use_prior, prior_var=PRIOR_VAR, min_log_alpha=MIN_LA):
    """fn (the K2 wrapper or its plain version) on d's inputs."""
    return fn(d["y"], d["x"], d["mu"], d["la0"], d["pm"], prior_var,
              min_log_alpha, use_prior=use_prior, weights=d.get("w"),
              **mode_kw(d))


def run_grid(fn, d, use_prior, prior_var=PRIOR_VAR):
    """fn (the K3 wrapper or its plain version) on d's inputs."""
    return fn(d["y"], d["x"], d["mu"], d["grid"], d["pm"], prior_var,
              use_prior=use_prior, weights=d.get("w"), **mode_kw(d))


def _is_f32(t):
    return t.dtype == torch.float32


def _bits(t):
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def differing_outputs(a, b):
    """The outputs of two kernel runs on the same inputs that are not the
    same bit for bit (NaNs included)."""
    return [k for k in a if not torch.equal(_bits(a[k]), _bits(b[k]))]


def check_irls(k, pl, maxit=100):
    """K1 readings: kernel fit k against the plain fit pl (same dtype)."""
    tol = TOL["float32" if _is_f32(pl["beta"]) else "float64"]
    kc, pc = k["iter"] < maxit, pl["iter"] < maxit
    conv = kc & pc
    same_conv = (kc == pc).double().mean().item()
    diff = (k["beta"] - pl["beta"]).abs()[conv]
    rel = diff / (1.0 + pl["beta"].abs()[conv])
    beta_rel = rel.max().item() if rel.numel() else 0.0
    r = dict(beta_rel=beta_rel, same_conv=same_conv,
             max_abs_err=diff.max().item() if diff.numel() else 0.0)
    r["ok"] = beta_rel <= tol["beta"] and same_conv >= tol["same_conv"]
    return r


def check_irls_f64(k, pl, ref, maxit=100):
    """K1 readings in float32 where rounding alone moves beta past TOL's
    beta (ROUNDING_BOUND): the kernel's fit k and the plain float32 fit pl
    against the float64 fit ref, |dbeta| / (1 + |beta|) over the genes
    converged in all three.  The kernel may be no further from ref than the
    plain version plus TOL's beta."""
    tol = TOL["float32"]
    conv = (k["iter"] < maxit) & (pl["iter"] < maxit) & (ref["iter"] < maxit)
    rb = ref["beta"].double()[conv]

    def dist(res):
        d = (res["beta"].double()[conv] - rb).abs() / (1.0 + rb.abs())
        return d.max().item() if d.numel() else 0.0

    r = check_irls(k, pl, maxit)
    r.update(beta_rel_f64_kernel=dist(k), beta_rel_f64_plain=dist(pl))
    r["ok"] = (r["beta_rel_f64_kernel"]
               <= r["beta_rel_f64_plain"] + tol["beta"]
               and r["same_conv"] >= tol["same_conv"])
    return r


def check_irls_expanded(k, pl, ref, maxit=100):
    """K1 readings at an expanded design (expanded_inputs), whose betas
    are identified along the null direction n = (1, -1, ..., -1) (x n = 0)
    by the ridge alone.  float64: check_irls.  float32: the condition
    number of X'WX + ridge (~1e4-1e5 at S = 1,024) moves the betas along
    n by rounding (the plain float32 fit sits ~3% from the float64 fit
    there), and two summation orders move them differently; so beta is
    held to the float64 fit `ref` as in check_irls_f64 with its component
    along n removed (the kernel no further than the plain version plus
    TOL's beta), and the component along n is read, not gated, beside the
    share of genes at maxit."""
    if not _is_f32(pl["beta"]):
        r = check_irls(k, pl, maxit)
        r["maxit_share"] = (k["iter"] >= maxit).double().mean().item()
        return r
    tol = TOL["float32"]
    conv = (k["iter"] < maxit) & (pl["iter"] < maxit) & (ref["iter"] < maxit)
    p = ref["beta"].shape[1]
    n = torch.full((p,), -1.0, dtype=torch.float64, device=ref["beta"].device)
    n[0] = 1.0
    n = n / n.norm()
    rb = ref["beta"].double()[conv]

    def parts(res):
        db = res["beta"].double()[conv] - rb
        along = db @ n
        off = (db - along[:, None] * n).abs()
        if not off.numel():
            return 0.0, 0.0, 0.0
        return ((off / (1.0 + rb.abs())).max().item(), off.max().item(),
                along.abs().max().item())

    (off_k, abs_k, null_k), (off_p, _, null_p) = parts(k), parts(pl)
    kc, pc = k["iter"] < maxit, pl["iter"] < maxit
    r = dict(beta_rel_f64_kernel=off_k, beta_rel_f64_plain=off_p,
             null_f64_kernel=null_k, null_f64_plain=null_p,
             same_conv=(kc == pc).double().mean().item(),
             maxit_share=(k["iter"] >= maxit).double().mean().item(),
             max_abs_err=abs_k)
    r["ok"] = (off_k <= off_p + tol["beta"]
               and r["same_conv"] >= tol["same_conv"])
    return r


def line_search_reference(d, use_prior, prior_var=PRIOR_VAR,
                          min_log_alpha=MIN_LA):
    """The plain line search in float64 on d's inputs (d may be float32)."""
    return run_ls(fit_disp_line_search_plain, _f64(d), use_prior, prior_var,
                  min_log_alpha)


def check_ls(k, pl, d, use_prior, prior_var=PRIOR_VAR, ref=None, maxit=100):
    """K2 readings: kernel result k against the plain result pl on inputs d
    (y, mu, x, la0, pm).  float32 needs ref, the float64 reference.

    In float32 without the Cox-Reid term (d's mode "nocr") the share of
    genes whose log alpha agrees to 1e-3 is printed, not gated: without
    the term the posterior is flat enough near its maximum that the
    float32 stopping tolerance (an lp change below 50 eps |lp|) ends the
    search anywhere in a window up to ~0.1 wide in log alpha, so the
    plain version against itself in another summation order already
    reads 0.907-0.959 (5 sample permutations on the CPU) against the 0.9
    limit.  The kernel is held there by its lp shortfall below the
    float64 reference, as every float32 reading is.

    The readings leave out the genes whose Cox-Reid matrix is singular
    by construction (cr_singular, counted in n_singular).  Only wide
    designs on few samples have such genes among the checks' inputs (a
    16-column design with half of its 24 samples dropped)."""
    lk = lp_at(k["log_alpha"], d, use_prior, prior_var)
    lpl = lp_at(pl["log_alpha"], d, use_prior, prior_var)
    defined = ~cr_singular(d)
    agree = ((k["log_alpha"].double() - pl["log_alpha"].double()).abs()
             < 1e-3)[defined].double().mean().item()
    if not _is_f32(pl["log_alpha"]):
        t = TOL["float64"]
        gap = lpl - lk
        held = defined.clone()
        if not mode_kw(d)["use_cr"]:
            # without the Cox-Reid term an underdispersed gene's search
            # runs to alpha -> 0; past 1/alpha = 1e8 the lp is flat to
            # within lgamma's rounding (|lgamma(1/alpha)| > 1.7e9, ~1e-6
            # per term), so the lp there is read by agreement only
            held = (k["log_alpha"] > FLAT_LA) & (pl["log_alpha"] > FLAT_LA)
        rel = ((gap / lpl.abs().clamp(min=1.0))[held]).max().item() \
            if bool(held.any()) else 0.0
        r = dict(lp_rel=max(rel, 0.0), agree=agree,
                 max_abs_err=max(gap[held].max().item(), 0.0)
                 if bool(held.any()) else 0.0,
                 n_flat=int((~held & defined).sum()),
                 n_singular=int((~defined).sum()))
        r["ok"] = r["lp_rel"] <= t["lp_rel"] and agree >= t["ls_agree"]
        return r
    t = TOL["float32"]

    def conv_of(res):
        return (res["iter"] < maxit) & (res["iter"] != 1)

    kc, pc = conv_of(k), conv_of(pl)
    both = kc & pc & conv_of(ref) & defined
    same_conv = (kc == pc)[defined].double().mean().item()
    lref = lp_at(ref["log_alpha"], d, use_prior, prior_var)[both]
    sk = (lref - lk[both]).clamp(min=0.0)
    sp = (lref - lpl[both]).clamp(min=0.0)
    floor = torch.finfo(torch.float32).eps * lref.abs().mean().item()
    gap = (lpl - lk)[both]
    r = dict(short_kernel_max=sk.max().item() if sk.numel() else 0.0,
             short_plain_max=sp.max().item() if sp.numel() else 0.0,
             short_kernel_mean=sk.mean().item() if sk.numel() else 0.0,
             short_plain_mean=sp.mean().item() if sp.numel() else 0.0,
             same_conv=same_conv, agree=agree, n_conv=int(both.sum()),
             n_singular=int((~defined).sum()), lp_floor=floor,
             max_abs_err=max(gap.max().item(), 0.0) if gap.numel() else 0.0)
    agree_gated = mode_kw(d)["use_cr"]
    r["ok"] = (r["short_kernel_max"]
               <= t["ls_max_x"] * r["short_plain_max"] + floor
               and r["short_kernel_mean"]
               <= t["ls_mean_x"] * r["short_plain_mean"] + floor
               and same_conv >= t["same_conv"]
               and (agree >= t["ls_agree"] or not agree_gated))
    return r


def grid_reference(d, use_prior, prior_var=PRIOR_VAR):
    """The plain grid search in float64 on d's inputs (d may be float32)."""
    return run_grid(fit_disp_grid_plain, _f64(d), use_prior, prior_var)


def check_grid(k, pl, d, use_prior, prior_var=PRIOR_VAR, ref=None):
    """K3 readings: kernel picks k against plain picks pl, both (G,) log
    alpha, on inputs d (y, mu, x, grid, pm).  float32 needs ref, the
    float64 reference's picks."""
    lk = lp_at(k, d, use_prior, prior_var)
    lpl = lp_at(pl, d, use_prior, prior_var)
    # genes whose Cox-Reid matrix is singular by construction (check_ls)
    # are left out of every reading
    defined = ~cr_singular(d)
    n_singular = int((~defined).sum())
    k, pl, lk, lpl = k[defined], pl[defined], lk[defined], lpl[defined]
    d = {key: v[defined] if key in ("y", "mu", "w", "pm") else v
         for key, v in d.items()}
    grid = d["grid"].double()
    n = grid.shape[0]
    step = 2.0 * (grid[1] - grid[0]).item() / (n - 1)   # fine-grid spacing
    if not _is_f32(pl):
        t = TOL["float64"]
        rel = ((lpl - lk) / lpl.abs().clamp(min=1.0)).max().item()
        same64 = ((k - pl).abs() <= 1e-9).double().mean().item()
        r = dict(lp_rel=max(rel, 0.0), same=same64,
                 max_abs_err=max((lpl - lk).max().item(), 0.0),
                 n_singular=n_singular)
        r["ok"] = r["lp_rel"] <= t["lp_rel"] and same64 >= t["grid_same"]
        return r
    t = TOL["float32"]
    ref = ref[defined]
    lref = lp_at(ref, d, use_prior, prior_var)
    scale = torch.finfo(torch.float32).eps * lref.abs().clamp(min=1.0)
    rk = (lref - lk) / scale
    rp = (lref - lpl) / scale
    nb = torch.maximum(lp_at(ref - step, d, use_prior, prior_var),
                       lp_at(ref + step, d, use_prior, prior_var))
    sep = (lref - nb) > SEPARATED * scale
    on_ref_k = (k.double() - ref).abs() <= step / 4
    on_ref_p = (pl.double() - ref).abs() <= step / 4
    n_sep = int(sep.sum())
    same = ((k.double() - pl.double()).abs() <= step / 4).double().mean()
    r = dict(short_kernel=rk.max().item(), short_plain=rp.max().item(),
             same=same.item(), n_sep=n_sep,
             sep_same_kernel=(on_ref_k[sep].double().mean().item()
                              if n_sep else 1.0),
             sep_same_plain=(on_ref_p[sep].double().mean().item()
                             if n_sep else 1.0),
             max_abs_err=max((lpl - lk).max().item(), 0.0),
             n_singular=n_singular)
    r["ok"] = (r["short_kernel"] <= t["grid_short"] and n_sep > 0
               and r["sep_same_kernel"] >= t["grid_sep_same"])
    return r


def permuted(d, gen):
    """d with its samples (the columns of y, mu and w, the rows of x) and
    its design's columns in an order drawn from `gen`: the same problem,
    summed and eliminated in another order."""
    S, p = d["x"].shape
    dev = d["x"].device
    perm = torch.randperm(S, generator=gen).to(dev)
    cols = torch.randperm(p, generator=gen).to(dev)
    out = {k: v[:, perm] if k in ("y", "mu", "w") else v
           for k, v in d.items()}
    out["x"] = d["x"][perm][:, cols]
    return out


def within_plain_spread(kind, r, pl, d, use_prior, ref, prior_var=PRIOR_VAR,
                        n_perm=SPREAD_PERMS):
    """A float32 K2 ("ls", check_ls) or K3 ("grid", check_grid) reading r
    of a kernel against the plain result pl that failed TOL, held instead
    to the plain version's own spread: the plain version rerun on n_perm
    permutations of d (`permuted`, a fixed seed), each read against pl as
    the kernel was.  The kernel's log posterior shortfall below the
    float64 reference `ref` is then gated against the largest shortfall of
    the plain runs (pl and the permutations):

    - K2: its largest and mean shortfall within TOL's factors ls_max_x and
      ls_mean_x of the plain runs' largest ones, plus eps times the mean
      |lp| (check_ls's own limit, with the spread in place of pl alone),
      same_conv as TOL has it, and with the Cox-Reid term (where check_ls
      gates it) the share of genes whose log alpha agrees with pl to 1e-3
      at most SPREAD_AGREE_MARGIN below the permutations' lowest;
    - K3: its shortfall at most grid_short units above the plain runs'
      largest, and on the separated genes no fewer picks on the
      reference's point than TOL's grid_sep_same or the plain runs'
      lowest share.

    Returns r with the spread readings added and "ok" recomputed."""
    t = TOL["float32"]
    gen = torch.Generator().manual_seed(1)
    spread = []
    for _ in range(n_perm):
        dp = permuted(d, gen)
        if kind == "ls":
            v = run_ls(fit_disp_line_search_plain, dp, use_prior, prior_var)
            spread.append(check_ls(v, pl, d, use_prior, prior_var, ref=ref))
        else:
            v = run_grid(fit_disp_grid_plain, dp, use_prior, prior_var)
            spread.append(check_grid(v, pl, d, use_prior, prior_var,
                                     ref=ref))
    r = dict(r)
    if kind == "ls":
        r["spread_short_max"] = max([r["short_plain_max"]]
                                    + [s["short_kernel_max"] for s in spread])
        r["spread_short_mean"] = max([r["short_plain_mean"]]
                                     + [s["short_kernel_mean"]
                                        for s in spread])
        r["spread_agree_min"] = min(s["agree"] for s in spread)
        r["ok"] = (r["short_kernel_max"]
                   <= t["ls_max_x"] * r["spread_short_max"] + r["lp_floor"]
                   and r["short_kernel_mean"]
                   <= t["ls_mean_x"] * r["spread_short_mean"]
                   + r["lp_floor"]
                   and r["same_conv"] >= t["same_conv"]
                   and (r["agree"] >= r["spread_agree_min"]
                        - SPREAD_AGREE_MARGIN
                        or not mode_kw(d)["use_cr"]))
        return r
    r["spread_short"] = max([r["short_plain"]]
                            + [s["short_kernel"] for s in spread])
    r["spread_sep_same_min"] = min([r["sep_same_plain"]]
                                   + [s["sep_same_kernel"] for s in spread])
    r["ok"] = (r["short_kernel"] <= r["spread_short"] + t["grid_short"]
               and r["n_sep"] > 0
               and r["sep_same_kernel"] >= min(t["grid_sep_same"],
                                               r["spread_sep_same_min"]))
    return r


@contextlib.contextmanager
def recorded_disp_calls():
    """Within the block, every call of the K1, K2 and K3 wrappers
    (cuda_irls.fit_beta, cuda_ls.fit_disp_line_search,
    cuda_grid.fit_disp_grid) is recorded as (args, kwargs) in the yielded
    dict's "irls", "ls" and "grid" lists, then made as usual: the wrapper
    itself runs, so its launch counts move as they would without the
    recording."""
    from . import cuda_grid, cuda_irls, cuda_ls
    calls = {"irls": [], "ls": [], "grid": []}
    hooked = []

    def hook(mod, name, key):
        fn = getattr(mod, name)

        def recorder(*a, **k):
            calls[key].append((a, k))
            setattr(mod, name, fn)      # the wrapper counts on its own name
            try:
                return fn(*a, **k)
            finally:
                setattr(mod, name, recorder)

        recorder.__wrapped__ = fn      # where the launch counts live
        setattr(mod, name, recorder)
        hooked.append((mod, name, fn))

    hook(cuda_irls, "fit_beta", "irls")
    hook(cuda_ls, "fit_disp_line_search", "ls")
    hook(cuda_grid, "fit_disp_grid", "grid")
    try:
        yield calls
    finally:
        for mod, name, fn in hooked:
            setattr(mod, name, fn)


def recorded_case(kind, call):
    """A recorded K2 ("ls") or K3 ("grid") call as the readings' inputs:
    (d, use_prior, prior_var)."""
    a, kw = call
    d = dict(y=a[0], x=a[1], mu=a[2], pm=a[4])
    d["la0" if kind == "ls" else "grid"] = a[3]
    if kw.get("weights") is not None:
        d["w"] = kw["weights"]
    for k in ("use_cr", "weight_threshold"):
        if k in kw:
            d[k] = kw[k]
    return d, bool(kw.get("use_prior", False)), float(a[5])


# ---------------------------------------------------------------------------
# single-cell path: bench.py's fixtures and gate, and K1 at minmu = 1e-6
# ---------------------------------------------------------------------------

# minmu of the quasi-likelihood fits (the host glmGamPoi LRT); K1 is
# checked there at SHAPES on zero_group_inputs
MIN_MU_QL = 1e-6


ZERO_ROWS = 10


def check_irls_min_mu(k, pl, ref=None, d64=None):
    """K1 readings at minmu = 1e-6 on zero_group_inputs: float64 on every
    gene; float32 on the genes with counts in both groups, beside the
    reading over every gene (printed).  On a zero-group gene the group's
    beta is held by the ridge where the deviance is flat (mu at the
    clamp), and the float32 kernel and plain version stop up to 0.11
    apart relative there (measured on one H100), past TOL's 5e-3.

    With `ref` (the float64 plain fit on the float64 inputs `d64`) the
    zero-group genes are also read, not gated, against it: each float32
    fit's largest |dbeta| / (1 + |beta|) and its largest deviance excess
    over the float64 fit, the deviances taken in float64 at each fit's
    betas (a flat optimum: betas far apart, deviances equal)."""
    r = check_irls(k, pl)
    if not _is_f32(pl["beta"]):
        return r
    rows = check_irls({m: k[m][ZERO_ROWS:] for m in ("beta", "iter")},
                      {m: pl[m][ZERO_ROWS:] for m in ("beta", "iter")})
    rows["beta_rel_all_genes"] = r["beta_rel"]
    if ref is not None:
        rb = ref["beta"][:ZERO_ROWS]
        dev_ref = _deviance64(d64, rb)
        for name, res in (("kernel", k), ("plain", pl)):
            b = res["beta"][:ZERO_ROWS].double()
            rows[f"zero_rows_beta_rel_f64_{name}"] = (
                (b - rb).abs() / (1.0 + rb.abs())).max().item()
            rows[f"zero_rows_dev_excess_{name}"] = (
                _deviance64(d64, b) - dev_ref).max().item()
    return rows


def _deviance64(d64, beta):
    """Per-gene NB deviance (-2 log-likelihood) in float64 of the first
    beta.shape[0] genes of d64 at `beta`, mu clamped at MIN_MU_QL."""
    g = beta.shape[0]
    mu = torch.clamp(torch.exp(beta.double() @ d64["x"].double().T),
                     min=MIN_MU_QL)
    return -2.0 * nb_logpmf(d64["y"][:g].double(), mu,
                            d64["alpha"][:g].double()[:, None]).sum(dim=1)


def zero_group_inputs(G, S, p, seed, zero_rows=ZERO_ROWS):
    """solver_inputs with the counts of the first `zero_rows` genes set to
    0 on the samples where the design's second column is 1 (one group of a
    two-group design), so that mu falls to the 1e-6 clamp there, the IRLS
    weights mu/(1 + alpha mu) to ~0 and X'WX towards its ridge; alpha at
    its generating value (the fits of the QL test hold it at the trend)."""
    d = solver_inputs(G, S, p, seed)
    if p >= 2:
        d["y"][:zero_rows][:, d["x"][:, 1] > 0] = 0.0
    return d


def sc_gate_inputs(g, s, seed=0):
    """bench.py's _sc_gate_inputs: UMI-like counts (mu0 = max(2^N(-1, 2),
    0.01), dispersion min(4/mu0 + 0.3, 20)), two alternating groups, half
    the genes with a log2 fold change N(0, 1), unit size factors; returns
    (counts (g,s) int32, cells, size factors)."""
    rng = np.random.default_rng(seed)
    cells = (np.arange(s) % 2).astype(np.int32)
    mu0 = np.maximum(2.0 ** rng.normal(-1.0, 2.0, g), 0.01)
    disp = np.minimum(4.0 / mu0 + 0.3, 20.0)
    lfc = np.where(rng.random(g) < 0.5, rng.normal(0.0, 1.0, g), 0.0)
    mu = mu0[:, None] * 2.0 ** (lfc[:, None] * cells[None, :])
    size = 1.0 / disp[:, None]
    counts = rng.negative_binomial(size, size / (size + mu)).astype(
        np.int32)
    return counts, cells, np.ones(s)


def sc_cov_gate_inputs(g, s, seed=1):
    """bench.py's _sc_cov_gate_inputs: the ~ batch + condition fixture
    (batch alternating in pairs, a batch log2 effect N(0, 0.3)); returns
    (counts, design [1, batch, condition], reduced [1, batch], size
    factors)."""
    rng = np.random.default_rng(seed)
    cond = (np.arange(s) % 2).astype(np.float64)
    batch = ((np.arange(s) // 2) % 2).astype(np.float64)
    design = np.column_stack([np.ones(s), batch, cond])
    mu0 = np.maximum(2.0 ** rng.normal(-1.0, 2.0, g), 0.01)
    disp = np.minimum(4.0 / mu0 + 0.3, 20.0)
    lfc = np.where(rng.random(g) < 0.5, rng.normal(0.0, 1.0, g), 0.0)
    blfc = rng.normal(0.0, 0.3, g)
    mu = mu0[:, None] * 2.0 ** (lfc[:, None] * cond[None, :]
                                + blfc[:, None] * batch[None, :])
    size = 1.0 / disp[:, None]
    counts = rng.negative_binomial(size, size / (size + mu)).astype(
        np.int32)
    return counts, design, design[:, :2], np.ones(s)


# bench.py's single-cell gate limits (sc_accuracy_gate)
SC_GATE = dict(max_dlfc=0.02, logp_excess=1.0, flips=0, jaccard=0.94)


def sc_gate(res32, res64, alpha=0.1):
    """bench.py's single-cell gate readings of a float32 run against a
    float64 run (dicts with log2FoldChange, pvalue, padj): max |dLFC|, the
    log10 p excess over half of |log10 p|, the alpha rejection-set
    Jaccard and the confident flips (padj < 0.01 on one side, > 0.5 on
    the other); "ok" under SC_GATE."""
    lfc32 = np.asarray(res32["log2FoldChange"], np.float64)
    lfc64 = np.asarray(res64["log2FoldChange"], np.float64)
    both = np.isfinite(lfc32) & np.isfinite(lfc64)
    d_lfc = float(np.max(np.abs(lfc32[both] - lfc64[both])))
    p32 = np.asarray(res32["pvalue"], np.float64)
    p64 = np.asarray(res64["pvalue"], np.float64)
    pb = np.isfinite(p32) & np.isfinite(p64)
    l32 = np.log10(np.maximum(p32[pb], 1e-30))
    l64 = np.log10(np.maximum(p64[pb], 1e-30))
    excess = float(np.max(np.abs(l32 - l64) - 0.5 * np.abs(l64)))
    a32 = np.asarray(res32["padj"], np.float64)
    a64 = np.asarray(res64["padj"], np.float64)
    rej32 = np.isfinite(a32) & (a32 < alpha)
    rej64 = np.isfinite(a64) & (a64 < alpha)
    union = int((rej32 | rej64).sum())
    jacc = float((rej32 & rej64).sum() / union) if union else 1.0
    q32 = np.where(np.isfinite(a32), a32, 1.0)
    q64 = np.where(np.isfinite(a64), a64, 1.0)
    flips = int((((q32 < 0.01) & (q64 > 0.5))
                 | ((q64 < 0.01) & (q32 > 0.5))).sum())
    r = dict(max_dlfc=d_lfc, logp_excess=excess, jaccard=jacc, flips=flips,
             rejections=int(rej64.sum()))
    r["ok"] = (d_lfc < SC_GATE["max_dlfc"]
               and excess < SC_GATE["logp_excess"]
               and flips <= SC_GATE["flips"]
               and jacc >= SC_GATE["jaccard"])
    return r


def sc_bench_counts(G, S, device, seed=0, chunk=2500):
    """bench.py:main_sc's single-cell counts at (G, S), made on `device`:
    mu0 = max(2^N(-1, 2), 0.01) and dispersion min(4/mu0 + 0.3, 20) per
    gene from numpy's generator at `seed` (bench.py's), then a
    gamma-Poisson mixture drawn in sample chunks from the device's
    generator seeded with `seed` (numpy negative-binomial sampling of
    1.5e9 values takes minutes on the host).  Returns the (G,S) int32
    counts and the alternating two-group cell codes."""
    rng = np.random.default_rng(seed)
    cells = (np.arange(S) % 2).astype(np.int32)
    mu0 = np.maximum(2.0 ** rng.normal(-1.0, 2.0, G), 0.01)
    disp = np.minimum(4.0 / mu0 + 0.3, 20.0)
    dev = torch.device(device)
    shape = torch.as_tensor(1.0 / disp, dtype=torch.float32,
                            device=dev)[:, None]
    scale = torch.as_tensor(disp * mu0, dtype=torch.float32,
                            device=dev)[:, None]
    out = torch.empty((G, S), dtype=torch.int32, device=dev)
    with torch.random.fork_rng(devices=[dev] if dev.type == "cuda" else []):
        torch.manual_seed(seed)
        for s0 in range(0, S, chunk):
            w = min(chunk, S - s0)
            lam = torch._standard_gamma(shape.expand(G, w).contiguous()) \
                * scale
            out[:, s0:s0 + w] = torch.poisson(lam).to(torch.int32)
    return out, cells
