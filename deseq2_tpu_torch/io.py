"""Checkpoint / resume: serialize any prefix of the pipeline (the JAX
package's io.py, in the same file format: files move between the two
packages both ways).

The reference gets checkpoint/resume for free from its
everything-in-the-object state model (each stage reads/writes
mcols/assays/attrs of the S4 object, so ``saveRDS(dds)`` at any point is
a resumable checkpoint; SURVEY.md section 5, R/core.R:667-671,959-963).
We keep the same property: a DESeqDataSet is a container of arrays
plus small metadata, serialized
here to a single ``.npz`` file (arrays) with an embedded JSON header
(names, design formula, factor levels, attrs, dispersion-function
parameters).  ``load_dataset(save_dataset(dds))`` resumes mid-pipeline:
stages detect pre-existing result columns exactly as the reference does.

Frozen re-application is preserved across the checkpoint boundary: the
dispersion function is stored as (fitType, parameters) for the exact
closed forms (parametric, mean) and as a dense log-log sample grid for
the non-parametric fits (local, glmGamPoi), matching the reference's
frozen-VST contract (R/vst.R:69-77).

State a fit keeps on the device (DeviceArray assays, the fused engine's
lazily fetched row_data columns, tensors) is downloaded before writing;
the counts are written from the host array, which the counts' device copy
(`_counts_dev`) mirrors.  A loaded dataset carries no device state.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .config import DESeqConfig
from .dataset import DESeqDataSet, DispersionFunction
from .formula import Factor, parse_formula

__all__ = ["save_dataset", "load_dataset", "save_results", "load_results"]

_FORMAT_VERSION = 1


def _host(v):
    """A tensor or DeviceArray as host numpy; anything else as is."""
    if torch.is_tensor(v):
        return v.detach().cpu().numpy()
    from .engine import DeviceArray
    if isinstance(v, DeviceArray):
        return np.asarray(v)
    return v


def _jsonable(v):
    """Best-effort conversion of attr values to JSON-safe values."""
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    return v


def _split_attrs(attrs):
    """Partition a dict into (ndarray entries, JSON-able entries)."""
    arrs, meta = {}, {}
    for k, v in attrs.items():
        v = _host(v)
        if isinstance(v, np.ndarray):
            arrs[k] = v
        else:
            try:
                json.dumps(_jsonable(v))
                meta[k] = _jsonable(v)
            except (TypeError, ValueError):
                # non-serializable attr (e.g. a closure): dropped with a
                # marker so load_dataset can warn
                meta.setdefault("__dropped__", []).append(k)
    return arrs, meta


def _dispfn_payload(disp_fn, base_means):
    """Serialize a DispersionFunction: exact params when closed-form,
    dense log-log samples otherwise (local/glmGamPoi closures)."""
    if disp_fn is None:
        return None, {}
    meta = {
        "fit_type": disp_fn.fit_type,
        "mean": _jsonable(disp_fn.mean),
        "disp_prior_var": _jsonable(disp_fn.disp_prior_var),
        "var_log_disp_ests": _jsonable(disp_fn.var_log_disp_ests),
        "coefficients": None if disp_fn.coefficients is None
        else [float(c) for c in np.asarray(disp_fn.coefficients).ravel()],
    }
    arrays = {}
    if disp_fn.fit_type not in ("parametric", "mean"):
        bm = np.asarray(base_means, dtype=np.float64)
        bm = bm[np.isfinite(bm) & (bm > 0)]
        lo = max(bm.min() / 10.0, 1e-8) if bm.size else 1e-8
        hi = bm.max() * 10.0 if bm.size else 1e6
        grid = np.exp(np.linspace(np.log(lo), np.log(hi), 2048))
        arrays["dispfn_grid_x"] = grid
        arrays["dispfn_grid_y"] = np.asarray(disp_fn(grid), dtype=np.float64)
    return meta, arrays


def _dispfn_restore(meta, arrays):
    if meta is None:
        return None
    fit_type = meta["fit_type"]
    coefs = meta.get("coefficients")
    if fit_type == "parametric" and coefs is not None:
        a, b = float(coefs[0]), float(coefs[1])
        fn = lambda m: a + b / np.asarray(m, dtype=np.float64)  # noqa: E731
        disp_fn = DispersionFunction(fn, "parametric", coefficients=(a, b))
    elif fit_type == "mean":
        mean = float(meta["mean"])
        fn = lambda m: (np.full(np.shape(m), mean)  # noqa: E731
                        if np.ndim(m) else mean)
        disp_fn = DispersionFunction(fn, "mean", mean=mean)
    else:
        gx = np.log(arrays["dispfn_grid_x"])
        gy = np.log(np.maximum(arrays["dispfn_grid_y"], 1e-300))

        def fn(m, gx=gx, gy=gy):
            lm = np.log(np.maximum(np.asarray(m, dtype=np.float64), 1e-300))
            return np.exp(np.interp(lm, gx, gy))

        disp_fn = DispersionFunction(fn, fit_type)
    disp_fn.disp_prior_var = meta.get("disp_prior_var")
    disp_fn.var_log_disp_ests = meta.get("var_log_disp_ests")
    return disp_fn


def save_dataset(dds: DESeqDataSet, path):
    """Serialize a dataset (at any pipeline stage) to a single .npz."""
    arrays = {"counts": np.asarray(dds.counts)}
    meta = {
        "format_version": _FORMAT_VERSION,
        "row_names": list(dds.row_names),
        "col_names": list(dds.col_names),
        "row_meta": {k: list(v) for k, v in dds.row_meta.items()},
        "metadata": _jsonable(dds.metadata) if dds.metadata else {},
        "config": dataclasses.asdict(dds.config),
        "col_factors": {},
        "col_factors_ordered": {},
        "col_numeric": [],
    }
    if isinstance(dds.design, np.ndarray):
        arrays["design_matrix"] = dds.design
        meta["design"] = None
    else:
        meta["design"] = str(dds.design)
    for k, v in dds.col_data.items():
        if isinstance(v, Factor):
            arrays[f"colf:{k}"] = v.codes
            meta["col_factors"][k] = list(v.levels)
            meta["col_factors_ordered"][k] = bool(v.ordered)
        else:
            arrays[f"coln:{k}"] = np.asarray(v)
            meta["col_numeric"].append(k)
    for k, v in dds.row_data.items():
        arrays[f"row:{k}"] = np.asarray(_host(v))
    for k, v in dds.assays.items():
        arrays[f"assay:{k}"] = np.asarray(_host(v))
    attr_arrs, attr_meta = _split_attrs(dds.attrs)
    for k, v in attr_arrs.items():
        arrays[f"attr:{k}"] = v
    meta["attrs"] = attr_meta

    base_means = dds.row_data.get("baseMean", np.ones(1))
    dfn_meta, dfn_arrays = _dispfn_payload(dds.dispersion_function,
                                           base_means)
    meta["dispersion_function"] = dfn_meta
    arrays.update(dfn_arrays)

    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    return path


def load_dataset(path) -> DESeqDataSet:
    """Reconstruct a dataset checkpoint written by :func:`save_dataset`."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("__meta__")).decode("utf-8"))
    if meta.get("format_version", 0) > _FORMAT_VERSION:
        raise ValueError("checkpoint written by a newer deseq2_tpu")

    col_data = {}
    ordered_flags = meta.get("col_factors_ordered", {})
    for k, levels in meta["col_factors"].items():
        codes = arrays.pop(f"colf:{k}")
        f = Factor.__new__(Factor)
        f.codes = codes
        f.levels = list(levels)
        f.ordered = bool(ordered_flags.get(k, False))
        col_data[k] = f
    for k in meta["col_numeric"]:
        col_data[k] = arrays.pop(f"coln:{k}")

    if meta["design"] is None:
        design = arrays.pop("design_matrix")
    else:
        design = parse_formula(meta["design"])

    cfg_fields = {f.name for f in dataclasses.fields(DESeqConfig)}
    config = DESeqConfig(**{k: v for k, v in meta["config"].items()
                            if k in cfg_fields})
    dds = DESeqDataSet(arrays.pop("counts"), col_data, design,
                       row_names=meta["row_names"],
                       col_names=meta["col_names"], config=config,
                       check_counts=False)
    dds.row_meta = {k: tuple(v) for k, v in meta["row_meta"].items()}
    dds.metadata = meta.get("metadata", {})
    for k in list(arrays):
        if k.startswith("row:"):
            dds.row_data[k[4:]] = arrays.pop(k)
        elif k.startswith("assay:"):
            dds.assays[k[6:]] = arrays.pop(k)
        elif k.startswith("attr:"):
            dds.attrs[k[5:]] = arrays.pop(k)
    for k, v in meta["attrs"].items():
        if k != "__dropped__":
            dds.attrs[k] = v
    dds.dispersion_function = _dispfn_restore(
        meta.get("dispersion_function"),
        {k: arrays[k] for k in ("dispfn_grid_x", "dispfn_grid_y")
         if k in arrays})
    return dds


def save_results(res, path):
    """Serialize a DESeqResults table to .npz (same scheme)."""
    arrays = {}
    meta = {
        "format_version": _FORMAT_VERSION,
        "row_names": None if res.row_names is None else list(res.row_names),
        "descriptions": _jsonable(res.descriptions),
        "prior_info": _jsonable(res.prior_info),
        "metadata": {},
        "columns": [],
        "extra_columns": list(res.extra_columns),
    }
    md_arrs, md_meta = _split_attrs(res.metadata or {})
    for k, v in md_arrs.items():
        arrays[f"md:{k}"] = v
    meta["metadata"] = md_meta
    for col in ("base_mean", "log2_fold_change", "lfc_se", "stat",
                "pvalue", "padj", "svalue"):
        v = getattr(res, col)
        if v is not None:
            arrays[f"col:{col}"] = np.asarray(v)
            meta["columns"].append(col)
    for k, v in res.extra_columns.items():
        arrays[f"extra:{k}"] = np.asarray(v)
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    return path


def load_results(path):
    from .results import DESeqResults

    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    meta = json.loads(bytes(arrays.pop("__meta__")).decode("utf-8"))
    kw = {c: arrays[f"col:{c}"] for c in meta["columns"]}
    res = DESeqResults(
        base_mean=kw.get("base_mean"),
        log2_fold_change=kw.get("log2_fold_change"),
        lfc_se=kw.get("lfc_se"), stat=kw.get("stat"),
        pvalue=kw.get("pvalue"), padj=kw.get("padj"),
        svalue=kw.get("svalue"), row_names=meta["row_names"],
        descriptions=meta["descriptions"], prior_info=meta["prior_info"],
        metadata=dict(meta["metadata"]),
        extra_columns={k: arrays[f"extra:{k}"]
                       for k in meta["extra_columns"]})
    for k, v in arrays.items():
        if k.startswith("md:"):
            res.metadata[k[3:]] = v
    return res
