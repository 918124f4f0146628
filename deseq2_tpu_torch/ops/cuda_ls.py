"""K2 wrapper: dispersion line search on the card through csrc/disp_ls.cu.

Replaces deseq2_tpu/ops/pallas_ls.py:fit_disp_line_search_pallas, both
modes: `weights` selects the kernel's weighted instantiation.  A CUDA
tensor launches the hand-written kernel (or raises); a CPU tensor runs the
plain version, ops/disp.py:fit_disp_line_search_plain.
``fit_disp_line_search.launches`` counts the unweighted kernel's launches,
``fit_disp_line_search.launches_weighted`` the weighted one's.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .disp import fit_disp_line_search_plain

_P, _I = ctypes.c_void_p, ctypes.c_int


def fit_disp_line_search(y, x, mu, log_alpha_init, prior_mean, prior_var,
                         min_log_alpha, kappa_0=1.0, tol=1e-6, maxit=100,
                         use_prior=False, weights=None):
    """Batched fitDisp: y, mu (G,S); x (S,p); log_alpha_init, prior_mean
    (G,); weights (G,S) or None.  Returns dict(log_alpha, iter,
    iter_accept, last_change, initial_lp, initial_dlp, last_lp, last_dlp)
    in mu's dtype."""
    if not mu.is_cuda:
        return fit_disp_line_search_plain(
            y, x, mu, log_alpha_init, prior_mean, prior_var, min_log_alpha,
            kappa_0=kappa_0, tol=tol, maxit=maxit, use_prior=use_prior,
            weights=weights)
    dtype = mu.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"line-search kernel takes float32/float64, not "
                        f"{dtype}")
    G, S = mu.shape
    p = x.shape[1]
    if not 1 <= p <= 8:
        raise ValueError(f"line-search kernel takes 1 <= p <= 8, got {p}")
    if weights is not None and weights.shape != (G, S):
        raise ValueError("weights must be (G,S)")
    dev = mu.device

    def prep(t):
        return t.to(device=dev, dtype=dtype).contiguous()

    y_, mu_, x_, la0_, pm_ = (prep(t) for t in (y, mu, x, log_alpha_init,
                                               prior_mean))
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
                    [_P] * 6 + [_I, _I, _I] + [scal] * 4 + [_I, _I]
                    + [_P] * 10)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(build.ptr(y_), build.ptr(mu_), build.ptr(w_),
                 build.ptr(x_), build.ptr(la0_), build.ptr(pm_), G, S, p,
                 float(prior_var), float(kappa_0), float(tol),
                 float(min_log_alpha), maxit,
                 int(bool(use_prior)),
                 *(build.ptr(out[k]) for k in names),
                 build.ptr(out["iter"]), build.ptr(out["iter_accept"]),
                 build.ptr(counter), build.stream_of(mu_))
    build.check(err, "disp_ls")
    if w_ is None:
        fit_disp_line_search.launches += 1
    else:
        fit_disp_line_search.launches_weighted += 1
    return out


fit_disp_line_search.launches = 0
fit_disp_line_search.launches_weighted = 0
