"""Cook's distance machinery for outlier detection (the JAX package's
numpy cooks.py, on the device of the (G,S) state: the sorts behind the
trimmed means run there).

Reference: robustMethodOfMomentsDisp / trimmedCellVariance / trimmedVariance
(R/core.R:2277-2331), calculateCooksDistance (R/core.R:2333-2340),
recordMaxCooks (R/core.R:2349-2359).
"""

from __future__ import annotations

import numpy as np
import torch

from .engine import resolve_device
from .hostdev import as_t, counts_t, factors_t, to_np


def model_matrix_groups(x):
    """Factor of distinct design-matrix rows (reference R/core.R:2450-2452):
    (codes, number of groups)."""
    from .parallel.fused import design_cells
    codes = np.asarray(design_cells(x), dtype=np.int64)
    return codes, int(codes.max()) + 1


def n_or_more_in_cell(model_matrix, n):
    """Per sample: does its design cell have >= n replicates
    (reference nOrMoreInCell, R/core.R:2366-2371)."""
    codes, _ = model_matrix_groups(model_matrix)
    counts = np.bincount(codes)
    return counts[codes] >= n


def r_trimmed_mean(x, trim):
    """R's mean(x, trim=t) over the last axis: drop floor(n*t) from each
    end of the sorted values."""
    n = x.shape[-1]
    k = int(np.floor(n * trim))
    if k > 0:
        x = torch.sort(x, dim=-1).values[..., k:n - k]
    return x.mean(dim=-1)


def trimmed_variance(x):
    """(reference trimmedVariance, R/core.R:2326-2331)"""
    rm = r_trimmed_mean(x, 1.0 / 8)
    sqerror = (x - rm[:, None]) ** 2
    return 1.51 * r_trimmed_mean(sqerror, 1.0 / 8)


def _trimfn(n):
    if n <= 3.5:
        return 0
    if n <= 23.5:
        return 1
    return 2


def trimmed_cell_variance(cnts, cells):
    """Per-cell trimmed variance, max across cells
    (reference trimmedCellVariance, R/core.R:2302-2324).

    cells: integer codes (S,) of design cells; only cells with >=3 samples
    are passed in by the caller."""
    trimratio = [1.0 / 3, 1.0 / 4, 1.0 / 8]
    scale_c = [2.04, 1.86, 1.51]
    levels = np.unique(cells)
    dev = cnts.device
    sels = [torch.as_tensor(np.where(cells == lvl)[0], device=dev)
            for lvl in levels]
    cell_means = torch.stack(
        [r_trimmed_mean(cnts[:, sel], trimratio[_trimfn(len(sel))])
         for sel in sels], dim=1)
    lvl_index = {lvl: i for i, lvl in enumerate(levels)}
    qmat = cell_means[:, torch.as_tensor([lvl_index[c] for c in cells],
                                         device=dev)]
    sqerror = (cnts - qmat) ** 2
    var_est = torch.stack(
        [scale_c[_trimfn(len(sel))] * r_trimmed_mean(
            sqerror[:, sel], trimratio[_trimfn(len(sel))]) for sel in sels],
        dim=1)
    return var_est.max(dim=1).values


def robust_method_of_moments_disp(dds, model_matrix, device=None):
    """(reference robustMethodOfMomentsDisp, R/core.R:2277-2300); a (G,)
    tensor."""
    dev = resolve_device(device)
    cnts = counts_t(dds, dev) / factors_t(dds, dev)
    three_or_more = n_or_more_in_cell(model_matrix, 3)
    if np.any(three_or_more):
        codes, _ = model_matrix_groups(model_matrix)
        cell_counts = np.bincount(codes)
        keep_cells = np.where(cell_counts >= 3)[0]
        idx = np.isin(codes, keep_cells)
        v = trimmed_cell_variance(
            cnts[:, torch.as_tensor(np.where(idx)[0], device=dev)],
            codes[idx])
    else:
        v = trimmed_variance(cnts)
    m = cnts.mean(dim=1)
    alpha = (v - m) / m ** 2
    # floor of 0.04, not the usual minDisp: avoids extreme Cook's distances
    # for counts in the outlier's own group (R/core.R:2296-2298)
    return torch.clamp(alpha, min=0.04)


def calculate_cooks_distance(dds, hat_diag, model_matrix, device=None):
    """(reference calculateCooksDistance, R/core.R:2333-2340): a (G,S)
    tensor from the dataset's mu assay and the hat diagonals."""
    dev = resolve_device(device)
    p = model_matrix.shape[1]
    dispersions = robust_method_of_moments_disp(dds, model_matrix, dev)
    mu = as_t(dds.assays["mu"], dev)
    h = as_t(hat_diag, dev)
    v = mu + dispersions[:, None] * mu ** 2
    pearson_res_sq = (counts_t(dds, dev) - mu) ** 2 / v
    return pearson_res_sq / p * h / (1.0 - h) ** 2


def record_max_cooks(model_matrix, cooks, num_rows):
    """Max Cook's only over samples in cells with >=3 replicates, NA when
    m <= p (reference recordMaxCooks, R/core.R:2349-2359); numpy (G,)."""
    samples_for_cooks = n_or_more_in_cell(model_matrix, 3)
    m, p = model_matrix.shape
    if m > p and np.any(samples_for_cooks):
        c = as_t(cooks, "cpu" if not torch.is_tensor(cooks)
                 else cooks.device)
        sel = torch.as_tensor(np.where(samples_for_cooks)[0],
                              device=c.device)
        return to_np(_nanless_max(c[:, sel]))
    return np.full(num_rows, np.nan)


def _nanless_max(c):
    """Row max that propagates NaN as numpy's max does."""
    mx = c.max(dim=1).values
    has_nan = torch.isnan(c).any(dim=1)
    return torch.where(has_nan, torch.full_like(mx, float("nan")), mx)
