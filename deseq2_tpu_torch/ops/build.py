"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into
``build/lib<name>-<hash>.so`` at the repository root (``.gitignore``
lists ``build/``), where the hash covers the source, the shared header and
the flags, so an edited source builds anew and an unchanged one is reused.
The libraries export plain ``extern "C"`` launch functions that take raw
device pointers and the CUDA stream and return ``cudaGetLastError()``.

Nothing here runs at import: the first launch of a kernel builds it, and
``build_all()`` starts one nvcc per source at once (the smoke script calls
it first so the three builds overlap).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
KERNELS = ("irls", "disp_ls", "disp_grid")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def _nvcc():
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit at first use")
    return path


def _digest(name):
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", CSRC / "common.cuh"):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def so_path(name):
    """The library of csrc/<name>.cu."""
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def log_path(name):
    """nvcc's output for the library (the -Xptxas -v resource report)."""
    return so_path(name).with_suffix(".log")


def ptxas_resources(name):
    """{kernel symbol: (registers, spill bytes)} of a kernel library, from
    nvcc's -Xptxas -v report (built first if needed)."""
    import re
    load(name)
    out = {}
    for part in log_path(name).read_text().split(
            "Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.findall(r"(\d+) bytes spill (?:stores|loads)", part)
        out[part.split("'", 1)[0]] = (int(regs.group(1)) if regs else -1,
                                      sum(int(v) for v in spill))
    return out


def _start(name):
    """Start nvcc for one source unless its library is already built.
    Returns (process, temporary output path) or None."""
    out = so_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    log = open(log_path(name), "w")
    try:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    finally:
        log.close()
    return proc, tmp


def _finish(name, started):
    if started is None:
        return
    proc, tmp = started
    rc = proc.wait()
    if rc != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {rc}):\n"
                           + log_path(name).read_text()[-4000:])
    os.replace(tmp, so_path(name))


def build_all(names=KERNELS):
    """Build every named kernel library, one nvcc process per library, all
    started together.  Returns {name: nvcc output}."""
    with _lock:
        started = {n: _start(n) for n in names}
        try:
            for n in names:
                _finish(n, started[n])
        finally:
            for s in started.values():
                if s is not None and s[0].poll() is None:
                    s[0].kill()
                    s[0].wait()
    return {n: log_path(n).read_text() if log_path(n).exists() else ""
            for n in names}


def load(name):
    """ctypes handle of a kernel library, built first if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        _finish(name, _start(name))
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(so_path(name)))
            _libs[name] = lib
    return lib


def bind(lib, fn_name, argtypes):
    """Declare a launch function's argument types (pointers and the stream
    as c_void_p, so ctypes never truncates them); returns it."""
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def ptr(t):
    """A tensor's device pointer; None gives NULL."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(t):
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def count_launch(fn, name, device):
    """One launch of the wrapper `fn`'s kernel: add one to its count
    `name` and to its count for `device` (``fn.launches_by_device``, keyed
    by the device's name, every mode together)."""
    setattr(fn, name, getattr(fn, name) + 1)
    key = str(device)
    fn.launches_by_device[key] = fn.launches_by_device.get(key, 0) + 1


def check(err, name):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
