"""The block kernels' and the wide K1's and K2's CUDA sources on the CPU:
the tensor-core K1 (irls_block_mma) and K2 (lp_dlp_mma, and the wide K2's
lp_dlp_wide_mma on one warp) of deseq2_tpu_torch/csrc, the float32 block
K2 (sample-major tiles, the algebra on one warp), and the float32 block
K1 (irls_block_rows) and wide K1 (irls_wide_kernel<float>), built for the
host by tests/cuda_emulation/emulate.py (g++, an address sanitizer, a thread
block emulated by its launch's threads as fibers, mma.sync by a warp's
exchange) and
held to their plain PyTorch versions with phase 3's readings
(ops/checks.py; in float32 K1 held to the fit in float64, a K2 reading
past TOL to the plain version's permutation spread), each launch twice
and bit-identical.  The cases cover the 8-column tiles' edges: a design
whose width is a multiple of 8 (K1's X'Wz then takes a column tile of its
own), a one-column last tile, a last tile of samples shorter than the
rest, weights, and warps left without a tile.  No card: the sources'
indexing, layouts and fixed order are what is checked; the card runs the
same checks in chip_smoke.py's phase 3.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from deseq2_tpu_torch.ops import checks
from torch_threads import one_torch_thread  # noqa: F401

EMU = Path(__file__).resolve().parent / "cuda_emulation"

# (kernel, p, S, G, weighted, dtype): K1 at p = 17 on 300 samples (two
# tiles of samples, the last of 44; runs of one tile) weighted, K1 at p =
# 40 (X'Wz's column tile), K2 at p = 24 (whole tiles), K2 at p = 57 (a
# one-column last tile) weighted; the wide K2 in float64 at p = 9 (a
# one-column last tile; a last tile of 4 samples) weighted and at p = 16;
# the float32 block K2 at p = 25 weighted and at p = 48 (tiles narrower
# than the samples: three tiles, the last of 22, and the per-sample terms
# on threads past the tile width); the float32 block K1 at p = 25
# weighted and at p = 48 on 340 samples (tiles of 160: three, the last of
# 20; the per-sample terms on threads past the tile width; the hat in
# rounds of 128 samples, two threads a sample), the float32 wide K1 at p
# = 10 (a last tile of 4 samples) and p = 16 weighted; two genes each (the
# emulation's barriers are slow)
CASES = [("irls", 17, 300, 2, True, "float64"),
         ("irls", 40, 120, 2, False, "float64"),
         ("ls", 24, 72, 2, False, "float64"),
         ("ls", 57, 171, 2, True, "float64"),
         ("ls", 9, 100, 2, True, "float64"),
         ("ls", 16, 72, 2, False, "float64"),
         ("ls", 25, 75, 2, True, "float32"),
         ("ls", 48, 150, 2, False, "float32"),
         ("irls", 25, 75, 2, True, "float32"),
         ("irls", 48, 340, 2, False, "float32"),
         ("irls", 10, 100, 2, False, "float32"),
         ("irls", 16, 100, 2, True, "float32")]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The two libraries built for the host, and the sanitizer's runtime
    to preload; skips where g++ or its sanitizer is missing."""
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
    out = tmp_path_factory.mktemp("block_emulation")
    emulate.build(out)
    return out, asan


@pytest.mark.parametrize("case", CASES, ids=[
    f"{k}-p{p}-S{S}-{'w' if w else 'u'}" + ("-f32" if t == "float32" else "")
    for k, p, S, _, w, t in CASES])
def test_block_kernel_source_matches_plain(emulated, case):
    lib_dir, asan = emulated
    kernel, p, S, G, weighted, dtype = case
    env = dict(os.environ, LD_PRELOAD=asan,
               ASAN_OPTIONS="detect_leaks=0", OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, str(EMU / "emulate.py"), str(lib_dir), kernel,
         str(p), str(S), str(G), str(int(weighted)), dtype],
        capture_output=True, text=True, env=env, timeout=600)
    assert run.returncode == 0, run.stderr[-4000:]
    readings = json.loads(run.stdout.strip().splitlines()[-1])
    for name, r in readings.items():
        assert r["ok"], (name, r)
        assert r["repeat_differs"] == [], (name, r)
        # K1's other outputs, on the genes the fits converged: in float64
        # against the plain version, in float32 against the fit in float64
        # no further than the plain float32 version plus TOL's beta
        for k, v in r.get("rel", {}).items():
            if "rel_plain" in r:
                limit = r["rel_plain"][k] + checks.TOL["float32"]["beta"]
                assert v <= limit, (name, k, v, limit)
            else:
                assert v < 1e-6, (name, k, v)
