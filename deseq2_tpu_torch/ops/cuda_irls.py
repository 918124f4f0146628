"""K1 wrapper: ridge NB IRLS on the card through csrc/irls.cu.

Replaces deseq2_tpu/ops/pallas_irls.py:fit_beta_pallas, both modes:
`weights` selects the kernel's weighted instantiation.  A CUDA tensor
launches a hand-written kernel (or raises): the P = p instantiation for 1
<= p <= 8, the wide kernel (p a launch argument, irls.cu's
irls_wide_kernel) for 8 < p <= 16, the block kernel (a thread block per
gene, irls_block.cu's irls_block_kernel) for 16 < p <= 64; these are the
counterparts of the XLA core the JAX package runs for p > 8
(pallas_irls.py:274).  p > 64 runs the plain version on the card.  A CPU
tensor runs the plain version, ops/irls.py:fit_beta_plain.  The route is chosen from the tensor's device
and p alone, before any launch.  ``fit_beta.launches`` counts the
unweighted P <= 8 kernels' launches, ``fit_beta.launches_weighted`` the
weighted ones', ``fit_beta.launches_wide`` the wide kernel's and
``fit_beta.launches_block`` the block kernel's (either mode), and
``fit_beta.launches_plain`` the p > 64 route's;
``fit_beta.launches_by_device`` counts the kernels' launches per device.
Under ops/placement.py:use_gene_mesh the call runs shard by shard over the
mesh (the gene-axis inputs split, the outputs gathered onto y's device).
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .cuda_ls import P_BLOCK, P_MAX, P_WIDE, width_suffix
from .irls import fit_beta_plain
from .placement import active_gene_mesh, place_gene_axis

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def fit_beta(y, x, nf, alpha, beta_init, ridge, tol=1e-8, maxit=100,
             min_mu=0.5, weights=None):
    """Batched fitBeta: y (G,S); x (S,p); nf (S,) or (G,S); alpha (G,);
    beta_init (G,p); ridge (p,); weights (G,S), max-1 normalized, or None.
    Returns dict(beta, beta_var, iter, hat_diag, deviance, mu) in
    beta_init's dtype."""
    if active_gene_mesh() is not None:
        gene = dict(y=y, alpha=alpha, beta_init=beta_init, weights=weights)
        shared = dict(x=x, ridge=ridge, tol=tol, maxit=maxit, min_mu=min_mu)
        (gene if nf.dim() == 2 else shared)["nf"] = nf
        return place_gene_axis(fit_beta, gene, shared)
    if not y.is_cuda:
        return fit_beta_plain(y, x, nf, alpha, beta_init, ridge, tol=tol,
                              maxit=maxit, min_mu=min_mu, weights=weights)
    dtype = beta_init.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fit_beta kernel takes float32/float64, not {dtype}")
    G, S = y.shape
    p = x.shape[1]
    if p > P_BLOCK:
        fit_beta.launches_plain += 1
        return fit_beta_plain(y, x.to(y.device), nf, alpha, beta_init, ridge,
                              tol=tol, maxit=maxit, min_mu=min_mu,
                              weights=weights)
    if p < 1:
        raise ValueError(f"fit_beta kernel takes p >= 1 columns, got {p}")
    if nf.shape not in ((S,), (G, S)):
        raise ValueError("nf must be (S,) or (G,S)")
    if weights is not None and weights.shape != (G, S):
        raise ValueError("weights must be (G,S)")
    dev = y.device

    def prep(t):
        t = t.to(device=dev, dtype=dtype).contiguous()
        return t

    # the wide and block kernels read the design transposed (p x S)
    y_, x_, nf_, a_, b0_, r_ = (prep(t) for t in (
        y, x.t() if p > P_MAX else x, nf, alpha, beta_init, ridge))
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
    # the block kernel lives in a library of its own (irls_block.cu)
    name = "irls_block" if p > P_WIDE else "irls"
    fn = build.bind(build.load(name),
                    f"{name}_launch_f64" if f64 else f"{name}_launch_f32",
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
    build.check(err, name)
    build.count_launch(fit_beta, "launches" + width_suffix(p) if p > P_MAX
                       else "launches" if w_ is None
                       else "launches_weighted", dev)
    return out


fit_beta.launches = 0
fit_beta.launches_weighted = 0
fit_beta.launches_wide = 0
fit_beta.launches_block = 0
fit_beta.launches_plain = 0
fit_beta.launches_by_device = {}
