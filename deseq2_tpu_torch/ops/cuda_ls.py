"""K2 wrapper: dispersion line search on the card through csrc/disp_ls.cu.

Replaces deseq2_tpu/ops/pallas_ls.py:fit_disp_line_search_pallas, in all
its modes: `weights` selects the kernel's weighted instantiations,
`use_cr=False` the ones without the Cox-Reid term, and `weight_threshold`
is the weighted Cox-Reid term's row cut.  A CUDA tensor launches a
hand-written kernel (or raises): the templated one for 1 <= p <= 8, the
wide one (p a launch argument, disp_ls.cu's ls_wide_kernel) for 8 < p <=
16; p > 16 runs the plain version on the card, the counterpart of the XLA
core the JAX package runs for p > 8 outside any Pallas kernel (its
_use_pallas_* gates); a CPU tensor runs the plain version,
ops/disp.py:fit_disp_line_search_plain.  The route is chosen from the
tensor's device and p alone, before any launch.

Each launch adds one to exactly one count: ``launches`` (unweighted),
``launches_weighted`` (weighted, threshold 1e-2), ``launches_threshold``
(weighted, another threshold), ``launches_nocr`` and
``launches_weighted_nocr`` (without the Cox-Reid term), each with a
``_wide`` twin for the wide kernel, and ``launches_plain`` (p > 16 on the
card, the plain version); ``launches_by_device`` counts the kernels'
launches per device.  Under ops/placement.py:use_gene_mesh the call runs
shard by shard over the mesh.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .disp import CR_WEIGHT_THRESHOLD, fit_disp_line_search_plain
from .placement import active_gene_mesh, place_gene_axis

_P, _I = ctypes.c_void_p, ctypes.c_int
# the widest design the templated kernels take, and the wide kernels';
# wider ones run the plain version
P_MAX = 8
P_WIDE = 16


def mode_counter(weights, use_cr, weight_threshold, p=1):
    """The name of the count a launch in this mode, at design width p,
    adds to."""
    if not use_cr:
        name = "launches_nocr" if weights is None else \
            "launches_weighted_nocr"
    elif weights is None:
        name = "launches"
    else:
        name = "launches_weighted" \
            if weight_threshold == CR_WEIGHT_THRESHOLD \
            else "launches_threshold"
    return name + "_wide" if p > P_MAX else name


def fit_disp_line_search(y, x, mu, log_alpha_init, prior_mean, prior_var,
                         min_log_alpha, kappa_0=1.0, tol=1e-6, maxit=100,
                         use_prior=False, weights=None, use_cr=True,
                         weight_threshold=CR_WEIGHT_THRESHOLD):
    """Batched fitDisp: y, mu (G,S); x (S,p); log_alpha_init, prior_mean
    (G,); weights (G,S) or None.  Returns dict(log_alpha, iter,
    iter_accept, last_change, initial_lp, initial_dlp, last_lp, last_dlp)
    in mu's dtype."""
    if active_gene_mesh() is not None:
        return place_gene_axis(
            fit_disp_line_search,
            dict(y=y, mu=mu, log_alpha_init=log_alpha_init,
                 prior_mean=prior_mean, weights=weights),
            dict(x=x, prior_var=prior_var, min_log_alpha=min_log_alpha,
                 kappa_0=kappa_0, tol=tol, maxit=maxit, use_prior=use_prior,
                 use_cr=use_cr, weight_threshold=weight_threshold))
    kw = dict(kappa_0=kappa_0, tol=tol, maxit=maxit, use_prior=use_prior,
              weights=weights, use_cr=use_cr,
              weight_threshold=weight_threshold)
    if not mu.is_cuda:
        return fit_disp_line_search_plain(
            y, x, mu, log_alpha_init, prior_mean, prior_var, min_log_alpha,
            **kw)
    dtype = mu.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"line-search kernel takes float32/float64, not "
                        f"{dtype}")
    G, S = mu.shape
    p = x.shape[1]
    if p > P_WIDE:
        fit_disp_line_search.launches_plain += 1
        return fit_disp_line_search_plain(
            y, x.to(mu.device), mu, log_alpha_init, prior_mean, prior_var,
            min_log_alpha, **kw)
    if p < 1:
        raise ValueError(f"line-search kernel takes p >= 1, got {p}")
    if weights is not None and weights.shape != (G, S):
        raise ValueError("weights must be (G,S)")
    dev = mu.device

    def prep(t):
        return t.to(device=dev, dtype=dtype).contiguous()

    # the wide kernel reads the design transposed (p x S)
    y_, mu_, x_, la0_, pm_ = (prep(t) for t in (
        y, mu, x.t() if p > P_MAX else x, log_alpha_init, prior_mean))
    w_ = None if weights is None else prep(weights)
    names = ("log_alpha", "initial_lp", "initial_dlp", "last_lp",
             "last_dlp", "last_change")
    out = {k: torch.empty(G, dtype=dtype, device=dev) for k in names}
    out["iter"] = torch.empty(G, dtype=torch.int32, device=dev)
    out["iter_accept"] = torch.empty(G, dtype=torch.int32, device=dev)
    if G == 0:
        return out
    f64 = dtype == torch.float64
    scal = ctypes.c_double if f64 else ctypes.c_float
    lib = build.load("disp_ls")
    fn = build.bind(lib, "ls_launch_f64" if f64 else "ls_launch_f32",
                    [_P] * 6 + [_I, _I, _I] + [scal] * 4 + [_I, _I, _I,
                                                            scal]
                    + [_P] * 10)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(build.ptr(y_), build.ptr(mu_), build.ptr(w_),
                 build.ptr(x_), build.ptr(la0_), build.ptr(pm_), G, S, p,
                 float(prior_var), float(kappa_0), float(tol),
                 float(min_log_alpha), maxit,
                 int(bool(use_prior)), int(bool(use_cr)),
                 float(weight_threshold),
                 *(build.ptr(out[k]) for k in names),
                 build.ptr(out["iter"]), build.ptr(out["iter_accept"]),
                 build.ptr(counter), build.stream_of(mu_))
    build.check(err, "disp_ls")
    build.count_launch(fit_disp_line_search,
                       mode_counter(w_, use_cr, weight_threshold, p), dev)
    return out


MODES = ("launches", "launches_weighted", "launches_threshold",
         "launches_nocr", "launches_weighted_nocr")
COUNTERS = MODES + tuple(m + "_wide" for m in MODES) + ("launches_plain",)
for _c in COUNTERS:
    setattr(fit_disp_line_search, _c, 0)
fit_disp_line_search.launches_by_device = {}
