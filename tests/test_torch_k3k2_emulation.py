"""The float64 block K3 on the FP64 tensor cores and the float32 wide K2's
one-shift digamma, on the CPU.

The CUDA sources of deseq2_tpu_torch/csrc (disp_grid_block.cu's
grid_block_kernel<double> with the Cox-Reid term, its gram as mma.sync
products; disp_ls.cu's ls_wide_kernel<float> with common.cuh's
lgamma_digamma's digamma) are built for the host by
tests/cuda_emulation/emulate.py (g++, an address sanitizer, a thread block
as its launch's fibers, mma.sync as a warp's exchange) and held to their
plain PyTorch versions (ops/disp.py):

- K3 in float64 at p = 17 on 300 samples, weighted (two tiles of samples,
  the last of 44; the Cox-Reid column mask drops a column of the first
  genes), at p = 40 without the Cox-Reid term and at p = 57, weighted (a
  one-column last 8-column tile), two genes each, with and without the
  prior: phase 3's reading (ops/checks.py:check_grid) and
  the same chosen point as the plain version, except where the log
  posterior at the kernel's point is within 1e-12 (relative) of the plain
  pick's, each launch twice and bit-identical;
- K2 in float32 at p = 10 (a last tile of 4 samples) and p = 16
  (weighted), six genes each, by phase 3's rules (check_ls against the
  plain version and the float64 reference, past checks.TOL the plain
  version's own spread over permutations, checks.within_plain_spread),
  each launch twice and bit-identical.  At so few genes the readings sit
  on float32 rounding: the share of genes whose log alpha agrees moves in
  steps of 1/G, and a stop on a flat posterior (lp within one float32
  step) may land elsewhere: this kernel, and the same kernel with
  digamma_pos in the routine's place, fail these rules at p = 16 weighted
  on eight or sixteen genes (and at p = 10 on sixteen), and pass on two to
  six.  The card's phase 3 holds both at full size;
- lgamma_digamma itself (its lgamma is the form the kernel does not take,
  PERF.md section 6) against scipy's gammaln and psi for z from 4.5e-5
  (the line search's smallest c = 1/alpha, e^-10) to 1e7: in float64
  within 1e-13 of the value (relative, the value floored at 1: near the
  roots of lgamma at 1 and 2 and of digamma at 1.4616 that is 1e-13
  absolute), and in float32 within 8 float32 epsilons of the float64
  routine's value, floored at 1 the same way (a dense sweep of the
  float32 arguments read at most 4.24 for lgamma and 4.32 for digamma:
  near the roots the float32 terms of about log Gamma(3) that the shift
  subtracts).
"""

import ctypes
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy import special

from torch_threads import one_torch_thread  # noqa: F401

EMU = Path(__file__).resolve().parent / "cuda_emulation"

# (kernel, p, S, G, weighted, dtype, mode)
CASES = [("grid", 17, 300, 2, True, "float64", ""),
         ("grid", 40, 120, 2, False, "float64", "nocr"),
         ("grid", 57, 171, 2, True, "float64", ""),
         ("ls", 10, 100, 6, False, "float32", ""),
         ("ls", 16, 100, 6, True, "float32", "")]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The K3 block and K2 libraries and lgamma_digamma built for the host,
    and the sanitizer's runtime to preload; skips where g++ or its
    sanitizer is missing."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the CUDA sources for the host")
    asan = subprocess.run(["g++", "-print-file-name=libasan.so"],
                          capture_output=True, text=True).stdout.strip()
    if not os.path.isabs(asan) or not os.path.exists(asan):
        pytest.skip("needs g++'s address sanitizer runtime")
    sys.path.insert(0, str(EMU))
    try:
        import emulate
    finally:
        sys.path.remove(str(EMU))
    out = tmp_path_factory.mktemp("k3k2_emulation")
    emulate.build(out, ("disp_grid_block", "disp_ls"))
    return out, asan, emulate.build_special(out)


@pytest.mark.parametrize("case", CASES, ids=[
    f"{k}-p{p}-S{S}-{'w' if w else 'u'}-{t}" + (f"-{m}" if m else "")
    for k, p, S, _, w, t, m in CASES])
def test_kernel_source_matches_plain(emulated, case):
    lib_dir, asan, _ = emulated
    kernel, p, S, G, weighted, dtype, mode = case
    env = dict(os.environ, LD_PRELOAD=asan,
               ASAN_OPTIONS="detect_leaks=0", OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, str(EMU / "emulate.py"), str(lib_dir), kernel,
         str(p), str(S), str(G), str(int(weighted)), dtype]
        + ([mode] if mode else []),
        capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    readings = json.loads(run.stdout.strip().splitlines()[-1])
    assert len(readings) == 2, readings   # without and with the prior
    for name, r in readings.items():
        assert r["ok"], (name, r)
        assert r["repeat_differs"] == [], (name, r)


def _arguments():
    z = np.concatenate([
        np.geomspace(4.5e-5, 1e7, 20001),
        np.linspace(0.5, 2.5, 4001),          # the roots of lgamma, digamma
        np.arange(1.0, 200.0), np.arange(1.0, 200.0) + 0.5,
        np.arange(0.0, 64.0) + 4.5e-5, np.arange(1.0, 64.0) - 1e-6])
    return np.unique(z)


def _lgdg(lib, z, name):
    lg, dg = np.empty_like(z), np.empty_like(z)
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    fn(*(a.ctypes.data_as(ctypes.c_void_p) for a in (z, lg, dg)), len(z))
    return lg, dg


def test_lgamma_digamma_float64(emulated):
    lib = ctypes.CDLL(str(emulated[2]))
    z = _arguments()
    lg, dg = _lgdg(lib, z, "lgdg_f64")
    for got, want in ((lg, special.gammaln(z)), (dg, special.psi(z))):
        err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        assert err.max() <= 1e-13, (err.max(), z[err.argmax()])


def test_lgamma_digamma_float32(emulated):
    lib = ctypes.CDLL(str(emulated[2]))
    z32 = _arguments().astype(np.float32)
    lg32, dg32 = _lgdg(lib, z32, "lgdg_f32")
    lg64, dg64 = _lgdg(lib, z32.astype(np.float64), "lgdg_f64")
    eps = float(np.finfo(np.float32).eps)
    for got, want in ((lg32, lg64), (dg32, dg64)):
        err = np.abs(got - want) / (eps * np.maximum(np.abs(want), 1.0))
        assert np.isfinite(got).all()
        assert err.max() <= 8, (err.max(), z32[err.argmax()])
