"""K3 wrapper: two-stage dispersion grid search on the card through
csrc/disp_grid.cu.

Replaces deseq2_tpu/ops/pallas_disp.py:fit_disp_grid_pallas, in its modes
(`use_cr=False`: without the Cox-Reid term), and extends it with a weighted
mode (`weights`, with the Cox-Reid row cut `weight_threshold`; the JAX
pipeline runs its weighted grid on the XLA core).  A CUDA tensor launches
a hand-written kernel (or raises): the templated one for 1 <= p <= 8, the
wide one (disp_grid.cu's grid_wide_kernel) for 8 < p <= 16, the block one
(disp_grid_block.cu's grid_block_kernel) for 16 < p <= 64 (the JAX
package's XLA core for p > 8); p > 64 runs the plain version on the card;
a CPU tensor runs the plain version, ops/disp.py:fit_disp_grid_plain.  The
route is chosen from the tensor's device and p alone, before any launch.
The counts are cuda_ls.py's, one per mode and width (cuda_ls.COUNTERS),
and ``launches_by_device``.  The block kernel with the Cox-Reid term takes
global scratch, two rows of S weights for each resident block (a stage's
two grid points'), which the wrapper allocates as the library's
``grid_block_scratch_rows`` says, and a zeroed gene counter.  Under
ops/placement.py:use_gene_mesh the call runs shard by shard over the
mesh.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from .cuda_ls import COUNTERS, P_BLOCK, P_MAX, P_WIDE, mode_counter
from .disp import CR_WEIGHT_THRESHOLD, fit_disp_grid_plain
from .placement import active_gene_mesh, place_gene_axis

_P, _I = ctypes.c_void_p, ctypes.c_int


def fit_disp_grid(y, x, mu, disp_grid, prior_mean, prior_var,
                  use_prior=False, weights=None, use_cr=True,
                  weight_threshold=CR_WEIGHT_THRESHOLD):
    """Batched fitDispGrid: y, mu (G,S); x (S,p); disp_grid (n,) shared
    coarse log-alpha grid; prior_mean (G,); weights (G,S) or None.
    Returns (G,) log alpha."""
    if active_gene_mesh() is not None:
        return place_gene_axis(
            fit_disp_grid, dict(y=y, mu=mu, prior_mean=prior_mean,
                                weights=weights),
            dict(x=x, disp_grid=disp_grid, prior_var=prior_var,
                 use_prior=use_prior, use_cr=use_cr,
                 weight_threshold=weight_threshold))
    kw = dict(use_prior=use_prior, weights=weights, use_cr=use_cr,
              weight_threshold=weight_threshold)
    if not mu.is_cuda:
        return fit_disp_grid_plain(y, x, mu, disp_grid, prior_mean,
                                   prior_var, **kw)
    dtype = mu.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"grid kernel takes float32/float64, not {dtype}")
    G, S = mu.shape
    p = x.shape[1]
    n = disp_grid.shape[0]
    if p > P_BLOCK:
        fit_disp_grid.launches_plain += 1
        return fit_disp_grid_plain(y, x.to(mu.device), mu,
                                   disp_grid.to(mu.device), prior_mean,
                                   prior_var, **kw)
    if p < 1 or n < 2:
        raise ValueError(f"grid kernel takes p >= 1 and >= 2 grid "
                         f"points, got p={p}, n={n}")
    if weights is not None and weights.shape != (G, S):
        raise ValueError("weights must be (G,S)")
    dev = mu.device

    def prep(t):
        return t.to(device=dev, dtype=dtype).contiguous()

    # the wide and block kernels read the design transposed (p x S)
    y_, mu_, x_, grid_, pm_ = (prep(t) for t in (
        y, mu, x.t() if p > P_MAX else x, disp_grid, prior_mean))
    w_ = None if weights is None else prep(weights)
    out = torch.empty(G, dtype=dtype, device=dev)
    if G == 0:
        return out
    f64 = dtype == torch.float64
    scal = ctypes.c_double if f64 else ctypes.c_float
    # the block kernels live in a library of their own (disp_grid_block.cu),
    # and take a gene counter and global scratch (rows of S weights for
    # each resident block with the Cox-Reid term)
    block = p > P_WIDE
    lib, sym = ("disp_grid_block", "grid_block") if block \
        else ("disp_grid", "grid")
    fn = build.bind(build.load(lib),
                    f"{sym}_launch_f64" if f64 else f"{sym}_launch_f32",
                    [_P] * 6 + [_I] * 4 + [scal, _I, _I, scal, _P]
                    + ([_P, _P, _I] if block else []) + [_P])
    with torch.cuda.device(dev):
        extra = ()
        if block:
            rows = build.bind(build.load(lib), f"{sym}_scratch_rows",
                              [_I] * 5)(int(f64), int(w_ is not None), p,
                                        int(bool(use_cr)), G)
            if rows < 0:
                raise RuntimeError(f"{lib} kernel refused p = {p}")
            counter = torch.zeros(1, dtype=torch.int32, device=dev)
            buf = torch.empty((rows, S), dtype=dtype, device=dev) \
                if rows else None
            extra = (build.ptr(counter), build.ptr(buf), rows)
        err = fn(build.ptr(y_), build.ptr(mu_), build.ptr(w_),
                 build.ptr(x_), build.ptr(grid_), build.ptr(pm_), G, S, p, n,
                 float(prior_var), int(bool(use_prior)),
                 int(bool(use_cr)), float(weight_threshold),
                 build.ptr(out), *extra, build.stream_of(mu_))
    build.check(err, lib)
    build.count_launch(fit_disp_grid,
                       mode_counter(w_, use_cr, weight_threshold, p), dev)
    return out


for _c in COUNTERS:
    setattr(fit_disp_grid, _c, 0)
fit_disp_grid.launches_by_device = {}
