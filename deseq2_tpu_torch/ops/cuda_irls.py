"""K1 wrapper: ridge NB IRLS on the card through csrc/irls.cu.

Replaces deseq2_tpu/ops/pallas_irls.py:fit_beta_pallas, both modes:
`weights` selects the kernel's weighted instantiation.  A CUDA tensor
launches the hand-written kernel (or raises); a CPU tensor runs the plain
version, ops/irls.py:fit_beta_plain.  ``fit_beta.launches`` counts the
unweighted kernel's launches, ``fit_beta.launches_weighted`` the weighted
one's.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .irls import fit_beta_plain

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def fit_beta(y, x, nf, alpha, beta_init, ridge, tol=1e-8, maxit=100,
             min_mu=0.5, weights=None):
    """Batched fitBeta: y (G,S); x (S,p); nf (S,) or (G,S); alpha (G,);
    beta_init (G,p); ridge (p,); weights (G,S), max-1 normalized, or None.
    Returns dict(beta, beta_var, iter, hat_diag, deviance, mu) in
    beta_init's dtype."""
    if not y.is_cuda:
        return fit_beta_plain(y, x, nf, alpha, beta_init, ridge, tol=tol,
                              maxit=maxit, min_mu=min_mu, weights=weights)
    dtype = beta_init.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fit_beta kernel takes float32/float64, not {dtype}")
    G, S = y.shape
    p = x.shape[1]
    if not 1 <= p <= 8:
        raise ValueError(f"fit_beta kernel takes 1 <= p <= 8 columns, got {p}")
    if nf.shape not in ((S,), (G, S)):
        raise ValueError("nf must be (S,) or (G,S)")
    if weights is not None and weights.shape != (G, S):
        raise ValueError("weights must be (G,S)")
    dev = y.device

    def prep(t):
        t = t.to(device=dev, dtype=dtype).contiguous()
        return t

    y_, x_, nf_, a_, b0_, r_ = (prep(t) for t in (y, x, nf, alpha,
                                                 beta_init, ridge))
    w_ = None if weights is None else prep(weights)
    out = dict(
        beta=torch.empty((G, p), dtype=dtype, device=dev),
        beta_var=torch.empty((G, p), dtype=dtype, device=dev),
        deviance=torch.empty(G, dtype=dtype, device=dev),
        iter=torch.empty(G, dtype=torch.int32, device=dev),
        mu=torch.empty((G, S), dtype=dtype, device=dev),
        hat_diag=torch.empty((G, S), dtype=dtype, device=dev))
    if G == 0:
        return out
    f64 = dtype == torch.float64
    scal = ctypes.c_double if f64 else ctypes.c_float
    lib = build.load("irls")
    fn = build.bind(lib, "irls_launch_f64" if f64 else "irls_launch_f32",
                    [_P, _P, _L, _P, _P, _P, _P, _P, _I, _I, _I, scal, _I,
                     scal] + [_P] * 8)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(build.ptr(y_), build.ptr(nf_), 0 if nf_.dim() == 1 else S,
                 build.ptr(w_), build.ptr(a_), build.ptr(b0_), build.ptr(r_),
                 build.ptr(x_),
                 G, S, p, tol, maxit, min_mu,
                 build.ptr(out["beta"]), build.ptr(out["beta_var"]),
                 build.ptr(out["deviance"]), build.ptr(out["iter"]),
                 build.ptr(out["mu"]), build.ptr(out["hat_diag"]),
                 build.ptr(counter), build.stream_of(y_))
    build.check(err, "irls")
    if w_ is None:
        fit_beta.launches += 1
    else:
        fit_beta.launches_weighted += 1
    return out


fit_beta.launches = 0
fit_beta.launches_weighted = 0
