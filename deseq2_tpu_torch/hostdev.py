"""Where the host-exact engine keeps its gene x sample state.

The host engine (sizefactors.py, glm.py, dispersions.py, cooks.py,
wald.py, lrt.py, outliers.py) runs the JAX package's host orchestration
with its batched per-gene work on a torch device: the card, or the CPU
when the caller asks for it.  Its (G,S) arrays (the counts, their float64
copy, mu, the hat diagonals, Cook's distances, the weights and
normalization factors) stay on that device from one stage to the next:
the dataset's counts through `engine.device_counts` (the copy the dataset
carries as `_counts_dev`), the assays as `engine.DeviceArray`s.  Per-gene
(G,) columns and scalar fits go to the host as numpy, as in the JAX
package.  Everything here is float64, as the JAX host path is.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def as_t(a, dev, dtype=F64):
    """A numpy array, DeviceArray or tensor as a tensor on `dev`."""
    from .engine import DeviceArray
    if isinstance(a, DeviceArray):
        a = a.tensor
    if not torch.is_tensor(a):
        a = torch.as_tensor(np.asarray(a))
    return a.to(device=dev, dtype=dtype)


def to_np(t):
    """A tensor (or array) as a host numpy array."""
    if torch.is_tensor(t):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def dev_array(t):
    """A (G,S) tensor wrapped as a dataset assay that stays on its device."""
    from .engine import DeviceArray
    return DeviceArray(t)


def counts_t(dds, dev):
    """The dataset's counts on `dev` in float64 (uploaded once, then the
    copy the dataset carries)."""
    from .engine import device_counts
    c = device_counts(dds, dev)
    dds._counts_dev = c
    return c.to(F64)


def factors_t(dds, dev):
    """The size factors as an (S,) row, or the normalization factors as a
    (G,S) matrix, on `dev` (getSizeOrNormFactors, R/core.R:2221-2228)."""
    nf = dds.assays.get("normalizationFactors")
    if nf is not None:
        return as_t(nf, dev)
    if dds.size_factors is None:
        raise ValueError("first call estimate_size_factors")
    return as_t(dds.size_factors, dev)


def full_factors(nf, G):
    """An (S,) size-factor row broadcast to (G,S); a (G,S) matrix as is."""
    return nf.expand(G, -1) if nf.dim() == 1 else nf


def rows(nf, idx):
    """Rows `idx` of the factors: the shared row itself, or a gather."""
    return nf if nf.dim() == 1 else nf[idx]


def na_pad(values, nz):
    """(G,) numpy with `values` at the nonzero rows and NaN elsewhere."""
    out = np.full(len(nz), np.nan)
    out[nz] = values
    return out


def na_pad_t(m, nz):
    """(G,S) tensor with `m` at the nonzero rows and NaN elsewhere."""
    nz_t = torch.as_tensor(np.asarray(nz), device=m.device)
    out = torch.full((len(nz), m.shape[1]), float("nan"), dtype=m.dtype,
                     device=m.device)
    out[nz_t] = m
    return out


def idx_t(idx, dev):
    """Row indices (a boolean mask or integers) as an int64 tensor."""
    idx = np.asarray(idx)
    if idx.dtype == bool:
        idx = np.where(idx)[0]
    return torch.as_tensor(idx, dtype=torch.int64, device=dev)

