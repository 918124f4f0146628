"""Straggler compaction for the streamed single-cell solvers.

The JAX package's ops/padding.py also pads the genes axis to canonical
bucket sizes so that XLA compiles one program per shape; eager PyTorch
compiles nothing per shape, so the port keeps only the compaction that
parallel/sc.py uses.
"""

from __future__ import annotations

import torch


def compact_live_indices(live, capacity):
    """Indices of the live genes first (stable), truncated to `capacity`.

    A stable argsort of the done flag puts live genes (False keys) ahead
    of done ones; slots past the live count hold done genes whose state
    the loop body leaves untouched, so gather -> iterate -> scatter is
    exact (deseq2_tpu/ops/padding.py:compact_live_indices)."""
    return torch.argsort((~live).to(torch.int8), stable=True)[:capacity]
