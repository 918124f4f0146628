"""The float64 narrow K2 and K1 (p <= 8), deseq()'s default dtype, on the
CPU.

The CUDA sources of deseq2_tpu_torch/csrc (disp_ls.cu's ls_kernel<double,
P>, with common.cuh's ls_point64 / ls_terms64; irls.cu's
irls_kernel<double, P>) are built for the host by
tests/cuda_emulation/emulate.py (g++, an address sanitizer, a warp's
lanes as fibers; of the templated instantiations P = 1 and 2 in float64)
and held to their plain PyTorch versions (ops/disp.py, ops/irls.py) by
phase 3's float64 readings (ops/checks.py: check_ls, lp_rel <= 1e-9 and
agree >= 0.98; check_irls, beta_rel <= 1e-8 and same_conv >= 0.98), each
launch twice and bit-identical:

- K2 at p = 2 on 24 samples, unweighted, weighted (the first genes'
  Cox-Reid column dropped) and without the Cox-Reid term, and at p = 1 on
  100 samples, each with and without the prior;
- K1 at p = 2 unweighted on 600 samples with an (S,) row of
  normalization factors (the row and its logs staged alone) and weighted
  on 24 with a (G,S) matrix of them (the design staged, log(nf) taken a
  sample), with each of
  its other outputs (deviance, beta_var, hat_diag, mu) within TOL's beta
  of the plain version's, relative, and every gene's sweep count the
  plain version's.

And ls_terms64 itself against float64 references: lgamma(y + c) -
lgamma(c) - y log c as sum_{j<y} log1p(j/c) and digamma(y + c) -
digamma(c) as sum_{j<y} 1/(c + j) (math.fsum) for counts y up to 10^4
and c = 1/alpha from e^-10 to e^30, the line search's range of log
alpha, within 1e-13 of the largest term the direct form would add
(lgamma(y + c), lgamma(c), y log c; digamma(y + c), digamma(c)), and
from c = 8 on (the difference form) within 1e-12 of the difference
itself or y: at c = e^30 the direct form's lgamma(c) ~ 3e14 alone rounds
by 0.03; and lgamma_digamma on the same arguments y + c against scipy.
"""

import ctypes
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from scipy import special

from deseq2_tpu_torch.ops.checks import TOL as _TOL
from torch_threads import one_torch_thread  # noqa: F401

TOL = _TOL["float64"]

EMU = Path(__file__).resolve().parent / "cuda_emulation"

# (kernel, p, S, G, weighted, mode)
CASES = [("ls", 2, 24, 40, False, ""),
         ("ls", 2, 24, 40, True, ""),
         ("ls", 2, 24, 40, False, "nocr"),
         ("ls", 1, 100, 20, False, ""),
         ("irls", 2, 600, 20, False, "sf"),
         ("irls", 2, 24, 40, True, "gsnf")]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """disp_ls.cu and irls.cu built for the host (P = 1 and 2 in float64)
    with ls_terms64 and lgamma_digamma, and the sanitizer's runtime to
    preload; skips where g++ or its sanitizer is missing."""
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
    out = tmp_path_factory.mktemp("narrow_emulation")
    emulate.build(out, ("disp_ls", "irls"))
    return out, asan, emulate.build_special(out)


@pytest.fixture(scope="module")
def readings(emulated):
    """Every case's readings (emulate.run), from one process under the
    sanitizer (its start and torch's import take most of a case's time)."""
    lib_dir, asan, _ = emulated
    env = dict(os.environ, LD_PRELOAD=asan,
               ASAN_OPTIONS="detect_leaks=0", OMP_NUM_THREADS="1")
    code = ("import json, sys\n"
            f"sys.path.insert(0, {str(EMU)!r})\n"
            "import emulate\n"
            f"for k, p, S, G, w, m in {CASES!r}:\n"
            f"    print(json.dumps(emulate.run({str(lib_dir)!r}, k, p, S, G, "
            "w, 'float64', m or None)), flush=True)\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    lines = run.stdout.strip().splitlines()[-len(CASES):]
    return dict(zip(CASES, (json.loads(v) for v in lines)))


@pytest.mark.parametrize("case", CASES, ids=[
    f"{k}-p{p}-S{S}-{'w' if w else 'u'}" + (f"-{m}" if m else "")
    for k, p, S, _, w, m in CASES])
def test_narrow_float64_kernel_matches_plain(readings, case):
    kernel = case[0]
    got = readings[case]
    # K2 without and with the prior, K1 once
    assert len(got) == (2 if kernel == "ls" else 1), got
    for name, r in got.items():
        assert r["ok"], (name, r)
        assert r["repeat_differs"] == [], (name, r)
        if kernel == "irls":
            assert max(r["rel"].values()) <= TOL["beta"], (name, r)
            assert r["same_iter"] >= TOL["same_conv"], (name, r)


def _grid():
    """(y, c) over counts 0-10^4 and c = 1/alpha from e^-10 to e^30."""
    ys = np.array([0, 1, 2, 3, 7, 8, 15, 50, 333, 1000, 10000], float)
    cs = np.exp(np.linspace(-10.0, 30.0, 81))
    y, c = np.meshgrid(ys, cs, indexing="ij")
    return y.ravel(), c.ravel()


def _terms(lib, y, alpha, mua):
    fn = lib.ls_terms_f64
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int]
    outs = [np.empty_like(y) for _ in range(4)]
    fn(*(a.ctypes.data_as(ctypes.c_void_p)
         for a in (y, alpha, mua, *outs)), len(y))
    return outs


def test_ls_terms64_against_sums(emulated):
    lib = ctypes.CDLL(str(emulated[2]))
    y, c = _grid()
    alpha = 1.0 / c
    mua = np.full_like(y, 0.37)
    l1p, r, lgd, dgd = _terms(lib, y, alpha, mua)
    assert np.allclose(l1p, np.log1p(mua), rtol=1e-15, atol=0)
    assert np.allclose(r, 1.0 / (1.0 + mua), rtol=1e-15, atol=0)
    for i in range(len(y)):
        js = np.arange(int(y[i]), dtype=float)
        want_lg = math.fsum(np.log1p(js / c[i]))
        want_dg = math.fsum(1.0 / (c[i] + js))
        scale_lg = max(abs(special.gammaln(y[i] + c[i])),
                       abs(special.gammaln(c[i])),
                       abs(y[i] * np.log(c[i])), 1.0)
        scale_dg = max(abs(special.psi(y[i] + c[i])),
                       abs(special.psi(c[i])), 1.0)
        assert abs(lgd[i] - want_lg) <= 1e-13 * scale_lg, (y[i], c[i])
        assert abs(dgd[i] - want_dg) <= 1e-13 * scale_dg, (y[i], c[i])


def test_ls_terms64_difference_does_not_cancel(emulated):
    # from c >= 8 on, the difference form: no error of the size of
    # lgamma(c)'s rounding, where the direct form (gammaln(y + c) -
    # gammaln(c) - y log c) is off by up to 0.06 at c = e^30
    lib = ctypes.CDLL(str(emulated[2]))
    y, c = _grid()
    big = c >= 8.0
    y, c = y[big], c[big]
    _, _, lgd, dgd = _terms(lib, y, 1.0 / c, np.full_like(y, 0.37))
    for i in range(len(y)):
        js = np.arange(int(y[i]), dtype=float)
        want = math.fsum(np.log1p(js / c[i]))
        assert abs(lgd[i] - want) <= 1e-12 * max(abs(want), y[i], 1.0), \
            (y[i], c[i], lgd[i], want)
        want_dg = math.fsum(1.0 / (c[i] + js))
        assert abs(dgd[i] - want_dg) <= 1e-13 * max(want_dg, c[i] ** -2), \
            (y[i], c[i])


def test_lgamma_digamma_float64_at_the_line_search_arguments(emulated):
    lib = ctypes.CDLL(str(emulated[2]))
    y, c = _grid()
    z = np.unique(np.concatenate([c, y + c]))
    fn = lib.lgdg_f64
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lg, dg = np.empty_like(z), np.empty_like(z)
    fn(*(a.ctypes.data_as(ctypes.c_void_p) for a in (z, lg, dg)), len(z))
    for got, want in ((lg, special.gammaln(z)), (dg, special.psi(z))):
        err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        assert err.max() <= 1e-13, (err.max(), z[err.argmax()])
