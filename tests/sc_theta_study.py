"""Where the single-cell route's float32 and float64 calls pick another
filtering theta, on the CPU (a study, not a test: pytest does not collect
this file).

    python tests/sc_theta_study.py [null] [G S SEEDS ...]

For each (G, S) and seed, bench.py's single-cell gate counts
(ops/checks.py:sc_gate_inputs: two alternating groups, UMI-like, half the
genes with an effect), or with `null` bench.py:main_sc's counts
(ops/checks.py:sc_bench_counts on the CPU: no effects, the counts of
chip_smoke.py phases 10-11 at a smaller size) go through the port's
fused_sc_results (group QL, test="LRT", fit_type="glmGamPoi") in float32
and in float64, and the JAX package's
fused_sc_results on the same counts in float32 (jax x64 off) and in
float64.  The line says which thetas each package picked (to 6 digits),
the Jaccard index of each float32 rejection set against its float64 one
at alpha 0.1, and the rejection counts beside the threshold that decides
the pick (R/results.R:661-692: the first theta whose count exceeds the
lowess fit's maximum minus its RMSE).
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from deseq2_tpu.parallel import sc as jsc  # noqa: E402
from deseq2_tpu_torch.ops import checks  # noqa: E402
from deseq2_tpu_torch.parallel import sc as tsc  # noqa: E402
from deseq2_tpu_torch.results import choose_filter_theta  # noqa: E402

KW = dict(n_groups=2, test="LRT", fit_type="glmGamPoi")


def threshold(out):
    """The rejection counts per theta and the count a theta must exceed
    (choose_filter_theta's lowess maximum minus its RMSE)."""
    nr = np.asarray(out["filterNumRej"], float)
    bm = np.asarray(out["baseMean"], float)
    lower = float(np.mean(bm == 0))
    theta = np.linspace(lower, 0.95 if lower < 0.95 else 1.0, len(nr))
    _, _, fit = choose_filter_theta(theta, nr)
    res = nr[nr > 0] - fit[nr > 0]
    return nr, fit.max() - np.sqrt(np.mean(res ** 2))


def jaccard(a, b, alpha=0.1):
    ra = np.nan_to_num(np.asarray(a["padj"], float), nan=1.0) < alpha
    rb = np.nan_to_num(np.asarray(b["padj"], float), nan=1.0) < alpha
    return (ra & rb).sum() / max((ra | rb).sum(), 1)


def main(args):
    null = args[:1] == ["null"]
    args = args[1:] if null else args
    cases = [(2048, 4096, list(range(8)))]
    if args:
        cases = [(int(args[0]), int(args[1]), [int(v) for v in args[2:]])]
    for G, S, seeds in cases:
        for seed in seeds:
            if null:
                c, cells = checks.sc_bench_counts(G, S, "cpu", seed)
                counts, sf = c.numpy(), np.ones(S)
            else:
                counts, cells, sf = checks.sc_gate_inputs(G, S, seed)
            t0 = time.perf_counter()
            o32 = tsc.fused_sc_results(counts, cells, sf, dtype=torch.float32,
                                       device="cpu", **KW)
            o64 = tsc.fused_sc_results(counts, cells, sf, dtype=torch.float64,
                                       device="cpu", **KW)
            line = (f"G={G} S={S} seed={seed}: port theta float32 "
                    f"{o32['filterTheta']:.6f} float64 "
                    f"{o64['filterTheta']:.6f}, Jaccard {jaccard(o32, o64):.4f}"
                    f" ({time.perf_counter() - t0:.0f} s)")
            with jax.enable_x64(False):
                j32 = jsc.fused_sc_results(counts, cells, sf, **KW)
            j64 = jsc.fused_sc_results(counts, cells, sf, **KW)
            line += (f"; JAX theta float32 {j32['filterTheta']:.6f} "
                     f"float64 {j64['filterTheta']:.6f}, Jaccard "
                     f"{jaccard(j32, j64):.4f}")
            for name, o in (("port f32", o32), ("port f64", o64),
                            ("jax f32", j32), ("jax f64", j64)):
                nr, thr = threshold(o)
                j = int(np.where(nr > thr)[0][0]) if (nr > thr).any() \
                    else -1
                line += (f"\n    {name}: threshold {thr:.2f}, counts "
                         f"around the pick {nr[max(j - 2, 0):j + 3]}")
            print(line, flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
