"""The float32 block K3 (16 < p <= 64), the wide K3 (8 < p <= 16) and the
narrow float64 K3 (p <= 8), on the CPU.

The CUDA sources of deseq2_tpu_torch/csrc (disp_grid_block.cu's
grid_block_kernel<float> with the Cox-Reid term: log_post_rows, two grid
points a pass on sample-major tiles, persistent blocks, the factor on
warp 0; disp_grid.cu's grid_wide_kernel, both dtypes: log_post_wide_pair,
two grid points a warp's pass over the block's staged design, float64 on
the tensor cores; disp_grid.cu's grid_kernel<double, P>) are built for
the host by
tests/cuda_emulation/emulate.py (g++, an address sanitizer, a thread
block as its launch's fibers, up to disp_grid.cu's 10 warps; of the
templated instantiations P = 1 and 2 in float64) and held to their plain
PyTorch versions (ops/disp.py) by phase 3's readings (ops/checks.py:
check_grid; in float32 against the float64 reference and, past
checks.TOL, the plain version's own spread over permutations,
checks.within_plain_spread; in float64 lp_rel <= 1e-9, the same pick on
98% of the genes, and every pick the plain version's or within 1e-12 of
its log posterior, relative), each with and without the prior, each
launch twice and bit-identical:

- the float32 block K3 at p = 25 on 300 samples, weighted (two tiles of
  256 and 44 samples: the tile is narrower than S; the Cox-Reid column
  mask drops a column of the first genes), and at p = 48 on 120 samples
  (one tile: the tile takes 192);
- the narrow float64 K3 at p = 2 on 24 samples: unweighted, weighted,
  without the Cox-Reid term and with the weighted row cut at 0.5; and at
  p = 1 on 100 samples;
- the wide K3 at p = 10 and 16 in both dtypes, each dtype unweighted,
  weighted, without the Cox-Reid term and with the row cut at 0.5: on 24
  samples (one partial tile), on 300 (tiles wrap) and past the design's
  staged chunk (disp_grid.cu kWideChunkF32 / kWideChunkF64: 1,100 samples
  in float32, 600 in float64, staged in two chunks every pass).
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from torch_threads import one_torch_thread  # noqa: F401

EMU = Path(__file__).resolve().parent / "cuda_emulation"

# (p, S, G, weighted, dtype, mode)
CASES = [(25, 300, 3, True, "float32", ""),
         (48, 120, 2, False, "float32", ""),
         (2, 24, 40, False, "float64", ""),
         (2, 24, 40, True, "float64", ""),
         (2, 24, 40, False, "float64", "nocr"),
         (2, 24, 40, True, "float64", "thr"),
         (1, 100, 20, False, "float64", ""),
         (10, 24, 8, False, "float32", ""),
         (10, 1100, 2, True, "float32", ""),
         (16, 24, 8, False, "float32", "nocr"),
         (16, 300, 3, True, "float32", "thr"),
         (10, 600, 2, False, "float64", ""),
         (10, 24, 8, True, "float64", ""),
         (16, 300, 3, True, "float64", "thr"),
         (16, 24, 8, False, "float64", "nocr")]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """disp_grid_block.cu and disp_grid.cu (its wide kernel, and P = 1 and
    2 in float64) built for the host, and the sanitizer's runtime to
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
    out = tmp_path_factory.mktemp("k3_emulation")
    emulate.build(out, ("disp_grid_block", "disp_grid"))
    return out, asan


@pytest.fixture(scope="module")
def readings(emulated):
    """Every case's readings (emulate.run), from one process under the
    sanitizer (its start and torch's import take most of a case's time)."""
    lib_dir, asan = emulated
    env = dict(os.environ, LD_PRELOAD=asan,
               ASAN_OPTIONS="detect_leaks=0", OMP_NUM_THREADS="1")
    code = ("import json, sys\n"
            f"sys.path.insert(0, {str(EMU)!r})\n"
            "import emulate\n"
            f"for p, S, G, w, t, m in {CASES!r}:\n"
            f"    print(json.dumps(emulate.run({str(lib_dir)!r}, 'grid', p, "
            "S, G, w, t, m or None)), flush=True)\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    lines = run.stdout.strip().splitlines()[-len(CASES):]
    return dict(zip(CASES, (json.loads(v) for v in lines)))


@pytest.mark.parametrize("case", CASES, ids=[
    f"p{p}-S{S}-{'w' if w else 'u'}-{t}" + (f"-{m}" if m else "")
    for p, S, _, w, t, m in CASES])
def test_k3_kernel_source_matches_plain(readings, case):
    got = readings[case]
    assert len(got) == 2, got   # without and with the prior
    for name, r in got.items():
        assert r["ok"], (name, r)
        assert r["repeat_differs"] == [], (name, r)

