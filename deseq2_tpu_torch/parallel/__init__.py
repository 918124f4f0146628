"""Device-wide pipeline stages of the port: the fused bulk pipeline
(fused.py) and the streamed single-cell pipeline (sc.py), and the gene mesh
that shards either over several devices (sharding.py; the JAX package's
genes-axis Mesh): its per-gene chains run on each shard's device, its
cross-gene reductions on the gathered vectors."""

from .sharding import gene_mesh, shard_genes
from .fused import fused_results, fused_wald_pipeline, run_fused_sharded
from .sc import fused_sc_pipeline, fused_sc_results

__all__ = ["gene_mesh", "shard_genes", "fused_wald_pipeline",
           "fused_results", "run_fused_sharded", "fused_sc_pipeline",
           "fused_sc_results"]
