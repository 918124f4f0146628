"""Stage timers: per-stage wall clock and genes/s.

Every orchestration stage records into a registry when profiling is on
(``enable()`` or the environment variable DESEQ2_TPU_PROFILE=1).  CUDA
work is asynchronous, so a stage synchronizes the cards before it reads
the clock at either end (every card the process holds memory on: a gene
mesh's too): the time it records is the stage's device work, not the time
to enqueue it.

Usage::

    import deseq2_tpu_torch as dt
    dt.profiling.enable()
    dds = dt.deseq(dt.make_example_dataset(n=60000, m=128))
    print(dt.profiling.report())
"""

from __future__ import annotations

import contextlib
import os
import time

__all__ = ["enable", "disable", "enabled", "stage", "records", "report",
           "reset"]

_records: list = []
_enabled = os.environ.get("DESEQ2_TPU_PROFILE", "0") not in ("0", "", "false")
_depth = 0


def enable():
    """Turn on stage timing (also: env DESEQ2_TPU_PROFILE=1)."""
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def enabled():
    return _enabled


def reset():
    _records.clear()


def records():
    """List of dicts: stage, seconds, genes, genes_per_sec, depth, t_start."""
    return list(_records)


def _sync():
    """Wait for every card this process holds memory on, so that a stage
    of a gene-mesh run ends when its last device does."""
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        cur = torch.cuda.current_device()
        for i in range(torch.cuda.device_count()):
            if i == cur or torch.cuda.memory_reserved(i):
                torch.cuda.synchronize(i)


@contextlib.contextmanager
def stage(name, genes=None):
    """Time a pipeline stage; no-op when profiling is disabled."""
    global _depth
    if not _enabled:
        yield
        return
    _depth += 1
    _sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync()
        dt = time.perf_counter() - t0
        _depth -= 1
        _records.append({
            "stage": name,
            "seconds": dt,
            "genes": genes,
            "genes_per_sec": (genes / dt) if genes and dt > 0 else None,
            "depth": _depth,
            "t_start": t0,
        })


def report():
    """Human-readable per-stage timing table, stages in start order and
    indented by nesting."""
    if not _records:
        return "(no profiling records; call profiling.enable())"
    lines = [f"{'stage':<42} {'seconds':>9} {'genes/s':>12}"]
    for r in sorted(_records, key=lambda r: r["t_start"]):
        gps = f"{r['genes_per_sec']:,.0f}" if r["genes_per_sec"] else ""
        lines.append(f"{'  ' * r['depth']}{r['stage']:<42} "
                     f"{r['seconds']:>9.3f} {gps:>12}")
    return "\n".join(lines)
