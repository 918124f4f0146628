"""Device-wide pipeline stages of the port: the fused bulk pipeline
(fused.py) and the streamed single-cell pipeline (sc.py)."""

from .fused import fused_results, fused_wald_pipeline
from .sc import fused_sc_pipeline, fused_sc_results

__all__ = ["fused_wald_pipeline", "fused_results", "fused_sc_pipeline",
           "fused_sc_results"]
