"""Gene-axis placement for the host-orchestrated engine (the JAX package's
deseq2_tpu/ops/placement.py).

Under `use_gene_mesh(mesh)` the kernel wrappers (ops/cuda_irls.py:fit_beta,
ops/cuda_ls.py:fit_disp_line_search, ops/cuda_grid.py:fit_disp_grid) split
their gene-axis inputs over the mesh, launch on each shard's device, and
gather the outputs onto the device of the input (place_gene_axis).  Every
fit is gene-parallel, and the host engine's cross-gene steps (trend, MAD,
prior variances, filtering) run in its orchestration on the gathered
vectors as in the single-device run, so the results are the same.

    from deseq2_tpu_torch.parallel import gene_mesh
    from deseq2_tpu_torch.ops.placement import use_gene_mesh
    with use_gene_mesh(gene_mesh(2)):
        dds = deseq(dds, engine="host")   # every batched fit sharded

(deseq(mesh=...) installs it for the host engine; the fused and streamed
pipelines split their chains themselves.)
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager

import torch

_ACTIVE = contextvars.ContextVar("gene_mesh", default=None)


def active_gene_mesh():
    """The mesh installed by use_gene_mesh, or None."""
    return _ACTIVE.get()


@contextmanager
def use_gene_mesh(mesh):
    """Within this context the kernel wrappers run sharded over `mesh` (a
    GeneMesh; None turns the placement off)."""
    from ..parallel.sharding import as_mesh
    token = _ACTIVE.set(as_mesh(mesh))
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def place_gene_axis(fn, gene, shared):
    """Run the wrapper `fn` shard by shard over the active mesh: `gene`
    holds its (G, ...) arguments (None entries stay None), split into the
    mesh's row blocks; `shared` the rest, tensors moved to each shard's
    device.  Each call runs outside the mesh; the outputs (a tensor or a
    dict of them) are gathered onto the gene arguments' device.  A process
    that holds no rows of a small call runs `fn` on zero rows, for the
    collective's shapes."""
    mesh = _ACTIVE.get()
    first = next(v for v in gene.values() if v is not None)
    G, home = first.shape[0], first.device
    token = _ACTIVE.set(None)
    try:
        blocks = mesh.shards(G) or [(0, 0, mesh.first_device)]
        outs = []
        for lo, hi, dev in blocks:
            kw = {k: None if v is None else v[lo:hi].to(dev)
                  for k, v in gene.items()}
            kw.update({k: v.to(dev) if torch.is_tensor(v) else v
                       for k, v in shared.items()})
            outs.append(fn(**kw))
    finally:
        _ACTIVE.reset(token)
    if torch.is_tensor(outs[0]):
        return mesh.gather(outs, G, home)
    return {k: mesh.gather([o[k] for o in outs], G, home) for k in outs[0]}
