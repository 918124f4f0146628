"""Smoke run of deseq2_tpu_torch on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases; any failure exits non-zero and no phase's failure is caught:

1. the card: nvidia-smi name and power limit, torch/CUDA versions, device
   count.  No card: exit 2 before anything else.
2. build the three CUDA kernels from deseq2_tpu_torch/csrc (one nvcc per
   source, started together) and print ptxas' registers / shared memory /
   spills per library, and for the p = 2 instantiations of K1, K2 and K3
   and their wide kernels (8 < p <= 16, one build) their registers,
   spills and resident warps per SM.
3. hold each kernel, unweighted and weighted, against its plain PyTorch
   version on the card, in float32 and float64, for p = 1, 2, 3, at S = 24
   and S = 3000 with a ragged gene count (weighted: forced Cox-Reid column
   drops); in float32 both are also held against the plain version run in
   float64 (readings and limits: deseq2_tpu_torch/ops/checks.py).  Also
   at checks.EDGES (S = 31, 33, 65; p = 5, 8; the float32 readings that
   rounding alone fails, checks.ROUNDING_BOUND, held to the float64 fit
   (K1) or printed (K2, K3)), and every launch twice, bit-identical.
   K1 also at the betaPrior refit's expanded design (checks.EXPANDED: p =
   3 and 4 at S = 1,024 and p = 4 at S = 24, the prior's ridge), float32
   held to the float64 fit off the design's null direction.  The wide
   kernels at p = 9, 10, 12, 16 (checks.WIDE_P), checks.SHAPES, every
   mode, both dtypes, every launch twice (float32: K1 held to the float64
   fit, a K2/K3 reading past TOL held to the plain version's spread over
   permutations, checks.within_plain_spread); no plain version may run on
   the card there.
4. the main path at full width: 60,000 genes x 1,024 samples, ~ condition,
   public deseq() + results() in float32 (a cold and a warm call; the
   launch counters are zeroed just before the warm call and read just
   after it), then the same in float64, then one more float32 call with
   the stage timers on under torch.profiler (stage table, kernels by
   device time, the device's busy share).  Then two variants at the same
   width in float32, cold and warm, each with its own counters:
   a. observation weights (uniform(0.3, 1), 5% of the zero counts at 1e-3,
      below the Cox-Reid threshold): needs weighted K1 and K2 launches;
   b. the LRT of ~ batch + condition against ~ batch with gene x sample
      normalization factors: needs >= 3 K1 launches and a K2 launch;
   each followed by a third call with the stage timers on.  And the local
   trend's state and evaluation at the main path's genes in float32
   against float64 (error, time and peak memory: the pipeline fits it in
   float64).
5. accuracy gates on a 2,048 x 1,024 slice with bench.py's generator and
   thresholds: the port in float32 on the card against the port in float64
   on the CPU (the plain versions), for the default Wald path, the
   weighted Wald path, the LRT with normalization factors and
   fit_type="local".
6. each kernel and mode at the main path's shapes, on the inputs the
   pipeline's own stages hand it (the weighted modes at the weighted
   path's inputs): held against its plain version and the float64
   reference with phase 3's limits, then timed beside its plain version
   and its bound.
7. betaPrior, contrasts and shrinkage at 60,000 x 1,024 in float32 on a
   three-level condition (A the first half of the samples, B and C the
   second half split evenly), each call cold then warm with the counters
   zeroed just before the warm call and read just after it:
   deseq(beta_prior=True) + results(); results(contrast=C vs B) on that
   fit; deseq() + results(contrast=C vs B); the list and numeric forms of
   that contrast; lfc_shrink of types apeglm (coef B_vs_A), normal
   (contrast C vs A) and ashr.  Fails if the betaPrior deseq() or the
   normal shrinkage launches no K1 or a table is malformed.  Then the
   prior variance's weighted quantile in float32 against float64, a stage
   table, the accuracy gates of these calls on the gate slice (betaPrior
   default table, C-vs-B contrast table, apeglm and normal LFCs) and K1 at
   the expanded shape (p = 4) checked and timed in float32 and float64.

8. the host-exact engine at 60,000 x 1,024 in float64 (deseq2_tpu_torch's
   host orchestration, its batched fits on the card), each call with its
   counters zeroed just before it and read just after and its stage
   table: the main path's ~ condition Wald through engine="host" (cold,
   then warm); ~ batch + condition with betaPrior and poscounts size
   factors through "auto" (the expanded p = 5, L-BFGS-B rows counted);
   the weighted path with 1% of the rows' weights rank-deficient through
   "auto" (weightsFail flagged); useCR = FALSE (K2 and K3 without the
   Cox-Reid term), unweighted and weighted; the weighted Cox-Reid row cut
   at 0.5 (K2w and K3w in that mode), these three with maxit_disp = 10,
   so that the grid fallback
   (K3) runs: in float64 the full line search converges on every gene;
   then the gates on the 2,048 x 1,024 gate slice (the host
   engine on the card against the fused engine on the card and against
   the host engine on the CPU: Jaccard >= 0.995, zero flips, |dLFC| <
   0.01), and K2 and K3 in the new modes checked and timed at the main
   path's shapes in float64 (rows of the JSON line).  Phase 3 also checks
   K2 and K3 in those modes against their plain versions, gated.  Then
   the paired designs ~ subject + condition (samples round-robin over the
   subjects, the condition alternating within each subject) at 60,000 x
   1,024: p = 10 (9 subjects) in float32 and float64 on the fused route
   and in float64 through engine="host", p = 16 (15 subjects) in float64,
   each cold, warm (counters zeroed just before it and read just after;
   seconds, genes/s, peak device memory) and once more with the stage
   timers on; fails if a plain version ran on the card or the wide K1 or
   K2 did not; lfc_shrink(type="normal") on the p = 10 float64 fit (wide
   K1).  Their gates on 2,048 x 1,024 paired slices: float32 card vs
   float64 CPU by bench.py's gates, and the float64 calls' columns on the
   card against the CPU at rtol 1e-6 (1e-4 on the genes whose dispersion
   search took another number of steps, at most 0.5% of them).  Then K1,
   K2 and K3 at p = 10 (the wide kernels) on the inputs the pipeline
   hands them at 60,000 x 1,024, float64 and float32, checked and timed
   (the kernels line's *_wide_f64 and *_wide_f32 rows, each with the
   launches of the p = 10 fused call of its dtype).
9. the transforms at 60,000 x 1,024 on the main path's counts, each
   public call warm (after a first call), timed once to its payload on the
   card (counters zeroed just before it and read just after; peak device
   memory) and once including DESeqTransform.matrix's download: vst
   (blind, nsub = 1000), varianceStabilizingTransformation (blind;
   parametric, mean, local), rlog (blind), normTransform, the parametric
   VST and rlog with a float32 payload, the VST of a float32 deseq() fit
   (blind=False; the fit made as phase 4 makes it), and plot_pca_data on
   the VST payload without its download; a stage table of one more VST
   and rlog call.  Fails unless every blind call
   with a dispersion step launches K2 and no K1 (the gene-wise estimate
   and the trend only); in float64 the full line search leaves no gene to
   the grid at this width, so one more blind VST with maxit_disp = 10
   must launch K3.  K2 and K3 at p = 1 are then held against their plain
   versions on the inputs those calls handed them (recorded) and timed
   beside them and their bound.  Gates on the 2,048 x 1,024 gate slice,
   the transforms on the card against the port in float64 on the CPU
   (limits ops/checks.py:TRANSFORM_TOL): float64 VST (three trends), vst
   and normTransform within 1e-6, rlog within 1e-4; float32 payloads
   within 0.01, and plot_pca_data's coordinates on the float32 VST within
   0.01 of their largest value, up to each component's sign.

10. the single-cell path (ROADMAP item 8) at 30,000 genes x 50,000 cells,
   bench.py:main_sc's configuration: UMI-like counts made on the card
   (ops/checks.py:sc_bench_counts, seed 0, int32), unit size factors.
   a. parallel.sc.fused_sc_results(test="LRT", fit_type="glmGamPoi") on
      the two alternating groups in float32, cold, warm (genes/s, peak
      device memory, the chunk, the histogram overflow count, the stage
      table) and once more under
      torch.profiler (the device's busy share);
   b. the covariate design [1, batch, condition] against [1, batch],
      warm (first call; its cold and profiled calls were cut for the
      script's time limit);
   c. the parametric Wald call (the MAP search), warm;
   d. the public route: dataset_from_matrix of those counts (timed apart),
      deseq(test="LRT", reduced="~ 1", fit_type="glmGamPoi") + results(),
      cold and warm; fails unless it took the streamed route ("fused-sc");
   e. the host engine's glmGamPoi at 60,000 x 1,024 in float64 on the main
      path's counts, counters zeroed just before each call and read just
      after: the LRT of ~ condition against ~ 1 (K1 >= 1: the full fit,
      the reduced model being the closed form; K2 >= 1), the LRT of ~
      batch + condition against ~ batch (K1 >= 2) and the Wald test
      through "auto" (K1, K2 >= 1); then K1 at minmu = 1e-6 held against
      its plain version at checks.SHAPES (p = 2, 3; ten genes
      counting zero in one group) in both dtypes, and on the inputs the
      first LRT handed it (recorded), checked and timed beside its plain
      version and its bound in float64 (the kernels line's
      irls_min_mu_f64 row) and float32 (logged);
   f. gates: bench.py's single-cell gates on its 2,048 x 4,096 group and
      covariate fixtures (float32 on the card against float64 on the CPU,
      histogram order matched: |dLFC| < 0.02, log10 p excess < 1.0, no
      confident flips, Jaccard >= 0.94), and the host glmGamPoi LRT on
      the 2,048 x 1,024 gate slice on the card against the CPU (Jaccard
      >= 0.995, no flips, |dLFC| < 0.01).
   The streamed path launches none of K1-K3 (the JAX package's runs no
   Pallas kernel either); its per-chunk passes are PyTorch.

11. the gene mesh at full width (ROADMAP item 11): the mesh is the visible
   cards, up to 4, or 4 shards on cuda:0 on a one-card machine (printed).
   a. the main path ~ condition at 60,000 x 1,024 through deseq(mesh=...)
      + results() in float32 and float64, the host engine
      (engine="host", float64), and the paired design at p = 10 (float64,
      the wide kernels), each against the single-device call on the
      same inputs: warm seconds of both, peak device memory per card,
      launches per kernel and per device (K1 and K2 on every mesh card,
      K3 in float32), each card's busy share in a profiled call; float64
      gated at rtol 1e-8 / atol 1e-10 on every row_data and results
      column and the cross-gene scalars (dispPriorVar, the trend
      coefficients, filterTheta), float32 by bench.py's gates;
   b. group QL at 30,000 x 50,000 (phase 10's counts) through
      fused_sc_results(mesh=...), float32, gated by bench.py's single-cell
      gates against the single-device float64 call (the single float32
      call's own reading printed beside it) and by the straggler test's
      rule for iteration counts against the single float32 call (each
      differing gene also moves with the chunk width, at most 0.1% of the
      genes, estimates within rtol 1e-6);
   c. two processes through torch.distributed (this script re-run with
      --mesh-rank; NCCL with a card per rank, gloo when both share one) on
      the 2,048 x 1,024 gate slice, the fused route and the host engine in
      float64, against this process's single-device calls at rtol 1e-8.
   With a second card phase 3 also holds K1-K3 against their plain
   versions on cuda:1.

Each phase prints its seconds.  The last two lines are the card's
nvidia-smi line and the JSON result line.
"""

import functools
import json
import subprocess
import sys
import time

import numpy as np

G_MAIN, S_MAIN = 60000, 1024
G_GATE = 2048
# the card's peak rates (NVIDIA data sheet, H100 SXM at 700 W): HBM bytes/s
# and non-tensor-core float32 / float64 operations/s
HBM_BPS = 3.35e12
PEAK_OPS = {"float32": 67e12, "float64": 34e12}


def log(*a):
    print(*a, flush=True)


def ptxas_summary(text):
    """Registers, static shared memory and spills over one library's
    kernel instantiations, from nvcc -Xptxas -v."""
    import re
    regs = [int(v) for v in re.findall(r"Used (\d+) registers", text)]
    smem = [int(v) for v in re.findall(r"(\d+) bytes smem", text)]
    spill = sum(int(v) for v in re.findall(r"(\d+) bytes spill", text))
    if not regs:
        return "no ptxas report"
    return (f"{len(regs)} instantiations, registers {min(regs)}-{max(regs)}"
            f", static smem <= {max(smem or [0])} B, spill bytes {spill}")


def kernel_resources():
    """Registers, spill bytes and resident warps per SM (the occupancy
    calculator at the main path's S) of the p = 2 instantiations of K1, K2
    and K3, and of their wide kernels (p = 10; 8 < p <= 16 share one
    build)."""
    import ctypes
    import re

    from deseq2_tpu_torch.ops import build
    out = {}
    # warps per block: kWarpBlock / 32 (common.cuh), kGridWarps (disp_grid.cu)
    # (the trailing query argument: K1's (S,) factor-row flag, K2's and
    # K3's use_cr = 1, the default instantiations)
    for name, sym, query, extra, warps in (
            ("disp_ls", "ls_kernel", "ls_blocks_per_sm", (1,), 4),
            ("irls", "irls_kernel", "irls_blocks_per_sm", (1,), 4),
            ("disp_grid", "grid_kernel", "grid_blocks_per_sm", (1,), 10)):
        funcs = build.ptxas_resources(name)
        fn = build.bind(build.load(name), query,
                        [ctypes.c_int] * (4 + len(extra)))
        wide_sym = sym.replace("_kernel", "_wide_kernel")
        for t, dname in (("f", "float32"), ("d", "float64")):
            for w in (0, 1):
                for p, pat, tag in (
                        (2, rf"{sym}I{t}Li2ELb{w}E(Lb1E)?E", ""),
                        (10, rf"{wide_sym}I{t}Lb{w}E(Lb1E)?E", "_wide")):
                    hit = [v for k, v in funcs.items() if re.search(pat, k)]
                    regs, spill = hit[0] if len(hit) == 1 else (-1, -1)
                    blocks = fn(int(t == "d"), w, p, S_MAIN, *extra)
                    key = f"{name}{'_w' if w else ''}{tag} {dname}"
                    out[key] = dict(registers=regs, spill_bytes=spill,
                                    warps_per_sm=warps * blocks)
                    log(f"  {key} p={p}: {regs} registers, {spill} spill "
                        f"bytes, {warps * blocks} resident warps per SM at "
                        f"S={S_MAIN}")
    return out


def smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs (copies of bench.py's generators: make_inputs, _gate_inputs)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=2)
def make_inputs(G, S, seed=0):
    """bench.py's make_inputs (deseq2_tpu_torch/ops/checks.py:bench_counts);
    cached, since every full-width phase uses the same seed-0 matrix
    (callers only read it)."""
    from deseq2_tpu_torch.ops import checks
    return checks.bench_counts(G, S, seed)


def gate_inputs(g, s, seed=0):
    """bench.py's _gate_inputs (deseq2_tpu_torch/ops/checks.py:gate_counts)."""
    from deseq2_tpu_torch.ops import checks
    return checks.gate_counts(g, s, seed)


# ---------------------------------------------------------------------------
# kernels vs plain versions (readings, limits: deseq2_tpu_torch/ops/checks.py)
# ---------------------------------------------------------------------------

def fmt(r):
    return " ".join(f"{k}={v:.3g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in r.items() if k != "ok")


def check_kernels(torch, dev, modes=(False, True)):
    """Each kernel, unweighted and weighted, against its plain version at
    checks.SHAPES for p = 1, 2, 3 and at checks.EDGES (sample counts where
    a warp's lanes wrap, p = 5 and 8).  Every reading is gated under
    checks.TOL but the float32 ones in checks.ROUNDING_BOUND, which
    rounding alone fails: there K1 is held to the float64 fit
    (checks.check_irls_f64) and K2's and K3's readings are printed.  Every
    kernel runs twice on every input and must give the same outputs bit
    for bit."""
    from deseq2_tpu_torch.ops import checks, disp, irls
    from deseq2_tpu_torch.ops.cuda_grid import fit_disp_grid
    from deseq2_tpu_torch.ops.cuda_irls import fit_beta
    from deseq2_tpu_torch.ops.cuda_ls import fit_disp_line_search

    worst = {k + sfx: 0.0 for k in ("irls", "disp_ls", "disp_grid",
                                    "irls_expanded")
             for sfx in ("", "_w")}
    failed = []
    log(f"  limits: {checks.TOL}; float32 rounding-bound readings: "
        f"{sorted(checks.ROUNDING_BOUND, key=str)}")
    cases = [(S, G, p) for S, G in checks.SHAPES for p in (1, 2, 3)]
    for weighted in modes:
        sfx = "_w" if weighted else ""
        for dname in ("float32", "float64"):
            dt = getattr(torch, dname)
            f32 = dname == "float32"
            for S, G, p in cases + list(checks.EDGES):
                def bound(kernel, prior=None):
                    return f32 and (kernel, S, p, weighted,
                                    prior) in checks.ROUNDING_BOUND

                raw = checks.solver_inputs(G, S, p, 10 * p + S,
                                           weighted=weighted)
                d = checks.as_tensors(raw, dt, dev)
                k1 = checks.run_irls(fit_beta, d)
                rep = checks.differing_outputs(k1, checks.run_irls(fit_beta,
                                                                   d))
                pl1 = checks.run_irls(irls.fit_beta_plain, d)
                if bound("irls"):
                    r1 = checks.check_irls_f64(
                        k1, pl1, checks.run_irls(irls.fit_beta_plain,
                                                 checks.as_tensors(
                                                     raw, torch.float64,
                                                     dev)))
                else:
                    r1 = checks.check_irls(k1, pl1)
                torch.cuda.synchronize()
                case = f"{dname} p={p} S={S} G={G} weighted={weighted}"
                log(f"  {case} irls: {fmt(r1)} repeat_differs={rep}"
                    + (" (rounding-bound: held to the float64 fit)"
                       if bound("irls") else ""))
                if not r1["ok"] or rep:
                    failed.append(f"{case} irls")
                worst["irls" + sfx] = max(worst["irls" + sfx],
                                          r1["max_abs_err"])
                for use_prior in (False, True):
                    k2 = checks.run_ls(fit_disp_line_search, d, use_prior)
                    rep = checks.differing_outputs(
                        k2, checks.run_ls(fit_disp_line_search, d, use_prior))
                    p2 = checks.run_ls(disp.fit_disp_line_search_plain,
                                       d, use_prior)
                    torch.cuda.synchronize()
                    r2 = checks.check_ls(
                        k2, p2, d, use_prior,
                        ref=checks.line_search_reference(d, use_prior)
                        if f32 else None)
                    k3 = checks.run_grid(fit_disp_grid, d, use_prior)
                    rep3 = checks.differing_outputs(
                        {"log_alpha": k3},
                        {"log_alpha": checks.run_grid(fit_disp_grid, d,
                                                      use_prior)})
                    p3 = checks.run_grid(disp.fit_disp_grid_plain, d,
                                         use_prior)
                    r3 = checks.check_grid(
                        k3, p3, d, use_prior,
                        ref=checks.grid_reference(d, use_prior)
                        if f32 else None)
                    for name, r, rp, tag in (("disp_ls", r2, rep, "ls"),
                                             ("disp_grid", r3, rep3, "grid")):
                        gated = not bound(name, use_prior)
                        log(f"  {case} prior={use_prior} {tag}: {fmt(r)} "
                            f"repeat_differs={rp}"
                            + ("" if gated else " (rounding-bound: not gated)"))
                        if (gated and not r["ok"]) or rp:
                            failed.append(f"{case} prior={use_prior} {name}")
                        if gated:
                            worst[name + sfx] = max(worst[name + sfx],
                                                    r["max_abs_err"])
    # K1 at the betaPrior refit's expanded design: p = levels + 1, the
    # intercept the sum of the level columns, held up by the prior's ridge
    for weighted in modes:
        sfx = "_w" if weighted else ""
        for dname in ("float32", "float64"):
            dt = getattr(torch, dname)
            for S, G, lv in checks.EXPANDED:
                raw = checks.expanded_inputs(G, S, lv, 7 + S + lv,
                                             weighted=weighted)
                d = checks.as_tensors(raw, dt, dev)
                k1 = checks.run_irls(fit_beta, d)
                rep = checks.differing_outputs(k1, checks.run_irls(fit_beta,
                                                                   d))
                pl1 = checks.run_irls(irls.fit_beta_plain, d)
                ref = checks.run_irls(irls.fit_beta_plain, checks.as_tensors(
                    raw, torch.float64, dev))
                r1 = checks.check_irls_expanded(k1, pl1, ref)
                torch.cuda.synchronize()
                case = (f"{dname} expanded p={lv + 1} S={S} G={G} "
                        f"weighted={weighted}")
                log(f"  {case} irls: {fmt(r1)} repeat_differs={rep}")
                if not r1["ok"] or rep:
                    failed.append(f"{case} irls")
                worst["irls_expanded" + sfx] = max(
                    worst["irls_expanded" + sfx], r1["max_abs_err"])
    check_wide_kernels(torch, dev, worst, failed)
    check_kernel_modes(torch, dev, worst, failed)
    if failed:
        raise SystemExit(f"kernel checks failed: {failed}")
    return worst


def check_wide_kernels(torch, dev, worst, failed):
    """The wide kernels (8 < p <= 16, csrc's *_wide_kernel) against their
    plain versions at checks.SHAPES for p in checks.WIDE_P, in every mode
    of checks.WIDE_MODES (K1 in the default two), float32 and float64,
    every launch twice and bit-identical.  float64 is gated under
    checks.TOL.  In float32, K1 is held to the float64 fit
    (checks.check_irls_f64), and a K2 or K3 reading that fails
    checks.TOL is held to the plain version's own spread over
    permutations of the samples and of the design's columns
    (checks.within_plain_spread), which rounding alone moves past TOL at
    S = 24 (`python -m deseq2_tpu_torch.ops.studies edges 20 wide`).
    Fills worst[<kernel>_wide_f32 / _f64] for the kernels line's wide
    rows."""
    from deseq2_tpu_torch.ops import checks, disp, irls
    from deseq2_tpu_torch.ops.cuda_grid import fit_disp_grid
    from deseq2_tpu_torch.ops.cuda_irls import fit_beta
    from deseq2_tpu_torch.ops.cuda_ls import fit_disp_line_search

    for k in ("irls_wide", "disp_ls_wide", "disp_grid_wide"):
        for dsfx in ("_f32", "_f64"):
            worst[k + dsfx] = 0.0
    n0 = {k: read_counts()[k] for k in ("irls_plain", "disp_ls_plain",
                                        "disp_grid_plain")}
    for weighted, mode in checks.WIDE_MODES:
        for dname in ("float32", "float64"):
            dt = getattr(torch, dname)
            f32 = dname == "float32"
            dsfx = "_f32" if f32 else "_f64"
            for (S, G), p in ((sg, pp) for sg in checks.SHAPES
                              for pp in checks.WIDE_P):
                raw = checks.solver_inputs(G, S, p,
                                           checks.seed_of(p, S, mode),
                                           weighted=weighted)
                d = checks.with_mode(checks.as_tensors(raw, dt, dev), mode)
                case = (f"{dname} wide p={p} S={S} G={G} weighted={weighted}"
                        + (f" {k_label(mode, weighted)}" if mode else ""))
                if mode is None:
                    k1 = checks.run_irls(fit_beta, d)
                    rep = checks.differing_outputs(
                        k1, checks.run_irls(fit_beta, d))
                    pl1 = checks.run_irls(irls.fit_beta_plain, d)
                    r1 = checks.check_irls_f64(k1, pl1, checks.run_irls(
                        irls.fit_beta_plain, checks.as_tensors(
                            raw, torch.float64, dev))) if f32 else \
                        checks.check_irls(k1, pl1)
                    torch.cuda.synchronize()
                    log(f"  {case} irls: {fmt(r1)} repeat_differs={rep}")
                    if not r1["ok"] or rep:
                        failed.append(f"{case} irls")
                    worst["irls_wide" + dsfx] = max(
                        worst["irls_wide" + dsfx], r1["max_abs_err"])
                for use_prior in (False, True):
                    k2 = checks.run_ls(fit_disp_line_search, d, use_prior)
                    rep2 = checks.differing_outputs(
                        k2, checks.run_ls(fit_disp_line_search, d, use_prior))
                    p2 = checks.run_ls(disp.fit_disp_line_search_plain, d,
                                       use_prior)
                    ref2 = checks.line_search_reference(d, use_prior) \
                        if f32 else None
                    r2 = checks.check_ls(k2, p2, d, use_prior, ref=ref2)
                    k3 = checks.run_grid(fit_disp_grid, d, use_prior)
                    rep3 = checks.differing_outputs(
                        {"log_alpha": k3},
                        {"log_alpha": checks.run_grid(fit_disp_grid, d,
                                                      use_prior)})
                    p3 = checks.run_grid(disp.fit_disp_grid_plain, d,
                                         use_prior)
                    ref3 = checks.grid_reference(d, use_prior) \
                        if f32 else None
                    r3 = checks.check_grid(k3, p3, d, use_prior, ref=ref3)
                    torch.cuda.synchronize()
                    for name, kind, r, pl, ref, rp in (
                            ("disp_ls", "ls", r2, p2, ref2, rep2),
                            ("disp_grid", "grid", r3, p3, ref3, rep3)):
                        spread = f32 and not r["ok"]
                        if spread:
                            r = checks.within_plain_spread(
                                kind, r, pl, d, use_prior, ref)
                        log(f"  {case} prior={use_prior} {name}: {fmt(r)} "
                            f"repeat_differs={rp}" + (
                                " (past TOL: held to the plain version's "
                                "permutation spread)" if spread else ""))
                        if not r["ok"] or rp:
                            failed.append(f"{case} prior={use_prior} {name}")
                        worst[name + "_wide" + dsfx] = max(
                            worst[name + "_wide" + dsfx], r["max_abs_err"])
    moved = {k: read_counts()[k] - v for k, v in n0.items()}
    log(f"  wide checks: plain-route launches {moved}")
    if any(moved.values()):
        failed.append(f"wide checks ran a plain version on the card: {moved}")


def check_second_card(torch):
    """With a second card: K1, K2 and K3 at checks.SHAPES (p = 2, both
    dtypes, unweighted) launched on cuda:1 and held against their plain
    versions there, as phase 3 does on cuda:0: a launch on a non-zero
    device is where a current-device fault of the ctypes path shows.
    Fails unless every launch landed on cuda:1."""
    from deseq2_tpu_torch.ops import checks, disp, irls
    from deseq2_tpu_torch.ops.cuda_grid import fit_disp_grid
    from deseq2_tpu_torch.ops.cuda_irls import fit_beta
    from deseq2_tpu_torch.ops.cuda_ls import fit_disp_line_search
    dev = torch.device("cuda", 1)
    zero_counts()
    failed = []
    for dname in ("float32", "float64"):
        dt = getattr(torch, dname)
        for S, G in checks.SHAPES:
            raw = checks.solver_inputs(G, S, 2, 20 + S)
            d = checks.as_tensors(raw, dt, dev)
            r1 = checks.check_irls(checks.run_irls(fit_beta, d),
                                   checks.run_irls(irls.fit_beta_plain, d))
            r2 = checks.check_ls(
                checks.run_ls(fit_disp_line_search, d, True),
                checks.run_ls(disp.fit_disp_line_search_plain, d, True), d,
                True, ref=checks.line_search_reference(d, True)
                if dname == "float32" else None)
            r3 = checks.check_grid(
                checks.run_grid(fit_disp_grid, d, True),
                checks.run_grid(disp.fit_disp_grid_plain, d, True), d, True,
                ref=checks.grid_reference(d, True)
                if dname == "float32" else None)
            torch.cuda.synchronize(dev)
            for name, r in (("irls", r1), ("disp_ls", r2), ("disp_grid", r3)):
                log(f"  cuda:1 {dname} p=2 S={S} G={G} {name}: {fmt(r)}")
                if not r["ok"]:
                    failed.append(f"cuda:1 {dname} S={S} {name}")
    by_dev = read_counts_by_device()
    log(f"  cuda:1 launches by device: {by_dev}")
    if any(set(v) != {"cuda:1"} for v in by_dev.values()):
        failed.append(f"launches off cuda:1: {by_dev}")
    if failed:
        raise SystemExit(f"second-card kernel checks failed: {failed}")


def check_kernel_modes(torch, dev, worst, failed):
    """K2 and K3 in their other modes (checks.MODES: without the Cox-Reid
    term, unweighted and weighted; the weighted Cox-Reid row cut at 0.5)
    against their plain versions on the card at checks.SHAPES for p = 1,
    2, 3 and at checks.EDGES, in float32 and float64, gated under
    checks.TOL as the default mode is (float32 also against the float64
    plain version); every launch twice, bit-identical.  Fills worst[name]
    for each mode's row."""
    from deseq2_tpu_torch.ops import checks, disp
    from deseq2_tpu_torch.ops.cuda_grid import fit_disp_grid
    from deseq2_tpu_torch.ops.cuda_ls import fit_disp_line_search

    cases = [(S, G, p) for S, G in checks.SHAPES for p in (1, 2, 3)]
    for mode, weighted in (("nocr", False), ("nocr", True), ("thr", True)):
        sfx = ("_w" if weighted else "") + "_" + mode
        for k in ("disp_ls", "disp_grid"):
            worst.setdefault(k + sfx, 0.0)
        for dname in ("float32", "float64"):
            dt = getattr(torch, dname)
            f32 = dname == "float32"
            for S, G, p in cases + list(checks.EDGES):
                raw = checks.solver_inputs(G, S, p, 10 * p + S + 7,
                                           weighted=weighted)
                d = checks.with_mode(checks.as_tensors(raw, dt, dev), mode)
                case = f"{dname} p={p} S={S} G={G} {k_label(mode, weighted)}"
                for use_prior in (False, True):
                    k2 = checks.run_ls(fit_disp_line_search, d, use_prior)
                    rep2 = checks.differing_outputs(
                        k2, checks.run_ls(fit_disp_line_search, d, use_prior))
                    p2 = checks.run_ls(disp.fit_disp_line_search_plain, d,
                                       use_prior)
                    r2 = checks.check_ls(
                        k2, p2, d, use_prior,
                        ref=checks.line_search_reference(d, use_prior)
                        if f32 else None)
                    k3 = checks.run_grid(fit_disp_grid, d, use_prior)
                    rep3 = checks.differing_outputs(
                        {"log_alpha": k3},
                        {"log_alpha": checks.run_grid(fit_disp_grid, d,
                                                      use_prior)})
                    p3 = checks.run_grid(disp.fit_disp_grid_plain, d,
                                         use_prior)
                    r3 = checks.check_grid(
                        k3, p3, d, use_prior,
                        ref=checks.grid_reference(d, use_prior)
                        if f32 else None)
                    torch.cuda.synchronize()
                    for name, r, rp in (("disp_ls", r2, rep2),
                                        ("disp_grid", r3, rep3)):
                        log(f"  {case} prior={use_prior} {name}: {fmt(r)} "
                            f"repeat_differs={rp}")
                        if not r["ok"] or rp:
                            failed.append(f"{case} prior={use_prior} {name}")
                        worst[name + sfx] = max(worst[name + sfx],
                                                r["max_abs_err"])


def k_label(mode, weighted):
    return {"nocr": "use_cr=False", "thr": "weight_threshold=0.5"}[mode] \
        + (" weighted" if weighted else "")


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------

# K2's and K3's counts per mode (ops/cuda_ls.py:mode_counter), each with
# a _wide twin for the wide kernels (8 < p <= 16)
_MODE_KEYS = {"": "launches", "_w": "launches_weighted",
              "_w_thr": "launches_threshold", "_nocr": "launches_nocr",
              "_w_nocr": "launches_weighted_nocr"}
COUNTERS = {"irls": ("fit_beta", "launches"),
            "irls_w": ("fit_beta", "launches_weighted"),
            "irls_wide": ("fit_beta", "launches_wide"),
            "irls_plain": ("fit_beta", "launches_plain")}
for _k, _fn in (("disp_ls", "fit_disp_line_search"),
                ("disp_grid", "fit_disp_grid")):
    for _sfx, _attr in _MODE_KEYS.items():
        COUNTERS[_k + _sfx] = (_fn, _attr)
        COUNTERS[_k + _sfx + "_wide"] = (_fn, _attr + "_wide")
    COUNTERS[_k + "_plain"] = (_fn, "launches_plain")


def _wrappers():
    """The kernel wrappers, whose attributes hold the launch counts (the
    wrappers themselves while checks.recorded_disp_calls records them)."""
    from deseq2_tpu_torch.ops import cuda_grid, cuda_irls, cuda_ls
    fns = {"fit_beta": cuda_irls.fit_beta,
           "fit_disp_line_search": cuda_ls.fit_disp_line_search,
           "fit_disp_grid": cuda_grid.fit_disp_grid}
    return {k: getattr(f, "__wrapped__", f) for k, f in fns.items()}


def zero_counts():
    fns = _wrappers()
    for fn, attr in COUNTERS.values():
        setattr(fns[fn], attr, 0)
    for f in fns.values():
        f.launches_by_device = {}


def read_counts_by_device():
    """Each wrapper's kernel launches per device since zero_counts()."""
    return {k: dict(f.launches_by_device) for k, f in _wrappers().items()}


def read_counts():
    fns = _wrappers()
    return {k: getattr(fns[fn], attr) for k, (fn, attr) in COUNTERS.items()}


def three_level_labels(s):
    """The betaPrior phase's condition: A on the first half of the
    samples, B and C splitting the second half evenly."""
    h = s // 2
    q = (s - h) // 2
    return np.array(["A"] * h + ["B"] * q + ["C"] * (s - h - q))


def public_run(torch, counts, dtype_name, sf=None, device="cuda",
               design="~ condition", weights=None, nf=None, labels=None,
               subjects=None, results_kw=None, **deseq_kw):
    """bench.py's _public_run through the port: build the dataset from
    the matrix, deseq(), results().  `design` "~ batch + condition" adds a
    two-level batch alternating over the samples; `weights` and `nf` are
    set as the weights assay and the normalization factors; `labels` the
    condition (default A on the first half, B on the second), `subjects`
    a subject column; `results_kw` goes to results().  The outer steps
    are profiling stages (no-ops unless profiling is on)."""
    import deseq2_tpu_torch as dt
    from deseq2_tpu_torch import profiling
    g, s = counts.shape
    col_data = {"condition": np.repeat(["A", "B"], [s // 2, s - s // 2])
                if labels is None else labels}
    if "batch" in design:
        col_data["batch"] = np.tile(["1", "2"], s // 2 + 1)[:s]
    if subjects is not None:
        col_data["subject"] = subjects
    with profiling.stage("smoke.datasetFromMatrix", genes=g):
        dds = dt.dataset_from_matrix(
            counts, col_data, design,
            config=dt.DESeqConfig(dtype=dtype_name))
    if sf is not None:
        dds.size_factors = sf
    if weights is not None:
        dds.assays["weights"] = weights
    if nf is not None:
        dds.normalization_factors = nf
    fit = dt.deseq(dds, device=device, **deseq_kw)
    with profiling.stage("smoke.results", genes=g):
        res = dt.results(fit, **(results_kw or {}))
    if device != "cpu":
        torch.cuda.synchronize()
    return res, fit


@functools.lru_cache(maxsize=1)
def _main_variant_inputs():
    return variant_inputs(make_inputs(G_MAIN, S_MAIN)[0])


def variant_inputs(counts, seed=0):
    """The variant paths' weights assay and (G,S) normalization factors
    (deseq2_tpu_torch/ops/checks.py:variant_inputs)."""
    from deseq2_tpu_torch.ops import checks
    return checks.variant_inputs(counts, seed)


def main_path(torch):
    counts, _ = make_inputs(G_MAIN, S_MAIN)
    out = {}
    for dname in ("float32", "float64"):
        t0 = time.perf_counter()
        public_run(torch, counts, dname)
        cold = time.perf_counter() - t0
        if dname == "float32":
            zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res, _ = public_run(torch, counts, dname)
        warm = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        stat, padj = np.asarray(res["stat"]), np.asarray(res["padj"])
        log(f"  {dname}: cold {cold:.3f} s, warm {warm:.3f} s = "
            f"{G_MAIN / warm:,.0f} genes/s, peak device memory {peak:.2f} GiB,"
            f" finite stat {np.isfinite(stat).mean():.4f}, finite padj "
            f"{np.isfinite(padj).mean():.4f}, rejections "
            f"{int(np.sum(padj < 0.1))}")
        if stat.shape != (G_MAIN,) or np.isfinite(stat).mean() <= 0.95 \
                or np.isfinite(padj).mean() <= 0.5:
            raise SystemExit(f"main path output malformed ({dname})")
        if dname == "float32":
            launches = read_counts()
            log(f"  float32 warm-call kernel launches: {launches}")
            missing = [k for k in ("irls", "disp_ls", "disp_grid")
                       if launches[k] == 0]
            if missing:
                raise SystemExit(f"main path never launched {missing}")
            out["launches"] = launches
        out[dname] = dict(cold_s=cold, warm_s=warm,
                          genes_per_s=G_MAIN / warm, peak_gib=peak)
    return out


def device_busy(prof):
    """The device's kernel seconds in a torch.profiler run, and its
    kernels as (microseconds, count, name), longest first."""
    rows = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows) / 1e6, rows


def stage_breakdown(torch):
    """One more float32 main-path call with the port's stage timers on
    (each stage synchronizes the card at both ends) under torch.profiler:
    the stage table, the kernels by device time, and the share of the
    call's wall time in which the card ran a kernel."""
    from torch.profiler import ProfilerActivity, profile

    from deseq2_tpu_torch import profiling

    counts, _ = make_inputs(G_MAIN, S_MAIN)
    profiling.reset()
    profiling.enable()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        public_run(torch, counts, "float32")
        wall = time.perf_counter() - t0
    profiling.disable()
    log("  float32 stage timings (profiled call, timers synchronize):")
    for line in profiling.report().splitlines():
        log(f"    {line}")
    busy_s, rows = device_busy(prof)
    log(f"  profiled call: wall {wall:.3f} s, device kernel time "
        f"{busy_s:.3f} s ({len(rows)} kernels), busy share "
        f"{busy_s / wall:.3f}" if rows else
        f"  profiled call: wall {wall:.3f} s, device time not measured "
        f"(the profiler recorded no device kernels)")
    for us, n, key in rows[:15]:
        log(f"    {us / 1e3:9.2f} ms  x{n:<5d} {key[:90]}")
    return dict(profiled_wall_s=wall,
                device_busy_s=busy_s if rows else None,
                busy_share=busy_s / wall if rows else None)


def variant_path(torch, name):
    """A variant of the main path at full width, float32, cold and warm:
    "weights" (the weighted Wald path) or "lrt_nf" (the LRT of ~ batch +
    condition against ~ batch with normalization factors).  The counters
    are zeroed just before the warm call and read just after it."""
    counts, _ = make_inputs(G_MAIN, S_MAIN)
    w, nf = _main_variant_inputs()
    if name == "weights":
        kw = dict(weights=w)
    else:
        kw = dict(nf=nf, design="~ batch + condition", test="LRT",
                  reduced="~ batch")
    t0 = time.perf_counter()
    public_run(torch, counts, "float32", **kw)
    cold = time.perf_counter() - t0
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, _ = public_run(torch, counts, "float32", **kw)
    warm = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stat, padj = np.asarray(res["stat"]), np.asarray(res["padj"])
    log(f"  {name}: cold {cold:.3f} s, warm {warm:.3f} s = "
        f"{G_MAIN / warm:,.0f} genes/s, peak device memory {peak:.2f} GiB, "
        f"finite stat {np.isfinite(stat).mean():.4f}, finite padj "
        f"{np.isfinite(padj).mean():.4f}, rejections "
        f"{int(np.sum(padj < 0.1))}")
    log(f"  {name} warm-call kernel launches: {launches}")
    if stat.shape != (G_MAIN,) or np.isfinite(stat).mean() <= 0.95 \
            or np.isfinite(padj).mean() <= 0.5:
        raise SystemExit(f"{name} path output malformed")
    if name == "weights":
        missing = [k for k in ("irls_w", "disp_ls_w") if launches[k] == 0]
    else:
        missing = ([] if launches["irls"] >= 3 else ["irls x3"]) + \
            ([] if launches["disp_ls"] > 0 else ["disp_ls"])
    if missing:
        raise SystemExit(f"{name} path never launched {missing}")
    # a third call with the stage timers on (they synchronize the card)
    from deseq2_tpu_torch import profiling
    profiling.reset()
    profiling.enable()
    public_run(torch, counts, "float32", **kw)
    profiling.disable()
    log(f"  {name} stage timings (third call, timers synchronize):")
    for line in profiling.report().splitlines():
        log(f"    {line}")
    return dict(cold_s=cold, warm_s=warm, genes_per_s=G_MAIN / warm,
                peak_gib=peak, launches=launches)


def local_trend_dtype(torch, dev):
    """The local trend's state and evaluation at the main path's genes in
    float32 and in float64 on the card: the float32 version's largest
    relative difference from the float64 one, and each one's time."""
    from deseq2_tpu_torch.parallel.fused import (Stages, default_grid,
                                                 local_trend_eval,
                                                 local_trend_state)
    counts, x_np = make_inputs(G_MAIN, S_MAIN)
    dt = torch.float32
    x = torch.as_tensor(x_np, dtype=dt, device=dev)
    st = Stages(x, torch.ones(S_MAIN, dtype=dt, device=dev),
                torch.as_tensor(default_grid(S_MAIN), dtype=dt, device=dev))
    est = st.gene_est(torch.as_tensor(counts, device=dev).to(dt))
    bm, dge, az = est["base_mean"], est["disp_gene_est"], est["all_zero"]
    use = (dge > 1e-6) & ~az
    bm_safe = torch.where(az, torch.ones_like(bm), bm)
    fits, ms, peak = {}, {}, {}
    for dname in ("float32", "float64"):
        d = getattr(torch, dname)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        ts = local_trend_state(bm.to(d), dge.to(d), use)
        fits[dname] = local_trend_eval(ts, torch.log(bm_safe.to(d)))
        torch.cuda.synchronize()
        ms[dname] = (time.perf_counter() - t0) * 1e3
        peak[dname] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    rel = ((fits["float32"].double() - fits["float64"]).abs()
           / fits["float64"]).max().item()
    log(f"  local trend at {G_MAIN} genes ({int(use.sum())} fit points): "
        f"float32 {ms['float32']:.1f} ms, float64 {ms['float64']:.1f} ms, "
        f"peak memory over the inputs {peak['float32']:.2f} / "
        f"{peak['float64']:.2f} GiB, float32 largest relative difference "
        f"from float64 {rel:.3g}")
    return dict(local_trend_f32_ms=ms["float32"],
                local_trend_f64_ms=ms["float64"],
                local_trend_f32_peak_gib=peak["float32"],
                local_trend_f64_peak_gib=peak["float64"],
                local_trend_f32_max_rel=rel)


def gate_compare(res32, res64):
    """bench.py's gate readings and thresholds (bench.py:240-245) on a
    float32 card run against a float64 CPU run."""
    lfc32 = np.asarray(res32["log2FoldChange"], float)
    lfc64 = np.asarray(res64["log2FoldChange"], float)
    p32, p64 = np.asarray(res32["pvalue"]), np.asarray(res64["pvalue"])
    padj32, padj64 = np.asarray(res32["padj"]), np.asarray(res64["padj"])
    both = np.isfinite(lfc32) & np.isfinite(lfc64)
    finite_match = float(np.mean(np.isfinite(lfc32) == np.isfinite(lfc64)))
    d_lfc = float(np.max(np.abs(lfc32[both] - lfc64[both])))
    pb = np.isfinite(p32) & np.isfinite(p64)
    lp32 = np.log10(np.maximum(p32[pb], 1e-30))
    lp64 = np.log10(np.maximum(p64[pb], 1e-30))
    excess = float(np.max(np.abs(lp32 - lp64) - 0.15 * np.abs(lp64)))
    rej32 = np.isfinite(padj32) & (padj32 < 0.1)
    rej64 = np.isfinite(padj64) & (padj64 < 0.1)
    union = (rej32 | rej64).sum()
    jacc = float((rej32 & rej64).sum() / union) if union else 1.0
    p64a = np.where(np.isfinite(padj64), padj64, 1.0)
    p32a = np.where(np.isfinite(padj32), padj32, 1.0)
    flips = int((((p32a < 0.05) & (p64a > 0.2))
                 | ((p64a < 0.05) & (p32a > 0.2))).sum())
    gate = dict(gate_genes=G_GATE, gate_max_dlfc=d_lfc,
                gate_logp_excess=excess, gate_rejection_jaccard=jacc,
                gate_confident_flips=flips, gate_finite_match=finite_match,
                gate_rejections=int(rej64.sum()))
    checks = dict(finite=finite_match >= 0.999, lfc=d_lfc < 0.01,
                  logp=excess < 0.5, jaccard=jacc >= 0.995, flips=flips == 0)
    return gate, checks


def accuracy_gate(torch):
    """bench.py's accuracy gate with its thresholds (bench.py:240-245)."""
    sub, _ = gate_inputs(G_GATE, S_MAIN)
    ones = np.ones(S_MAIN)
    est32, fit32 = public_run(torch, sub, "float32")
    res32, _ = public_run(torch, sub, "float32", sf=ones)
    t0 = time.perf_counter()
    res64, _ = public_run(torch, sub, "float64", sf=ones, device="cpu")
    log(f"  float64 CPU reference run: {time.perf_counter() - t0:.1f} s")

    logc = np.log(np.asarray(sub, np.float64))
    with np.errstate(divide="ignore"):
        lg = logc.mean(axis=1)
    sf_host = np.array([np.exp(np.median(
        (logc[:, j] - lg)[np.isfinite(lg) & (sub[:, j] > 0)]))
        for j in range(sub.shape[1])])
    sf_err = float(np.max(np.abs(fit32.size_factors / sf_host - 1.0)))
    gate, checks = gate_compare(res32, res64)
    gate.update(gate_sf_max_rel_err=sf_err, gate_est_sf_finite=float(
        np.isfinite(np.asarray(est32["stat"])).mean()))
    checks["sf"] = sf_err < 1e-5
    log(f"  gate: {json.dumps(gate)}")
    failed = [k for k, v in checks.items() if not v]
    if failed:
        raise SystemExit(f"accuracy gate failed: {failed}")
    return gate


def variant_gates(torch):
    """The gate for the variants: the weighted Wald path, the LRT of
    ~ batch + condition against ~ batch with normalization factors, and
    fit_type="local", each in float32 on the card against float64 on the
    CPU, on the gate slice with the variant inputs of that slice."""
    sub, _ = gate_inputs(G_GATE, S_MAIN)
    w, nf = variant_inputs(sub)
    ones = np.ones(S_MAIN)
    cases = {"weights": dict(sf=ones, weights=w),
             "lrt_nf": dict(nf=nf, design="~ batch + condition",
                            test="LRT", reduced="~ batch"),
             "local": dict(sf=ones, fit_type="local")}
    out, failed = {}, []
    for name, kw in cases.items():
        res32, _ = public_run(torch, sub, "float32", **kw)
        t0 = time.perf_counter()
        res64, _ = public_run(torch, sub, "float64", device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        gate, checks = gate_compare(res32, res64)
        log(f"  gate {name} (float64 CPU reference {cpu_s:.1f} s): "
            f"{json.dumps(gate)}")
        failed += [f"{name}:{k}" for k, v in checks.items() if not v]
        out[name] = gate
    if failed:
        raise SystemExit(f"variant accuracy gates failed: {failed}")
    return out


# ---------------------------------------------------------------------------
# betaPrior, contrasts and shrinkage
# ---------------------------------------------------------------------------

CB = ("condition", "C", "B")


def _table_ok(tab):
    """A results table has G_MAIN rows, finite LFC, SE and stat on > 95% of
    them and finite padj on > 50% (variant_path's shares)."""
    shares = {}
    for c in ("log2FoldChange", "lfcSE", "stat", "padj"):
        v = np.asarray(tab[c], float)
        if v.shape != (G_MAIN,):
            return False, {c: f"shape {v.shape}"}
        shares[c] = float(np.isfinite(v).mean())
    ok = all(shares[c] > (0.5 if c == "padj" else 0.95) for c in shares)
    return ok, shares


def prior_quantile_dtype(torch, fit):
    """The beta prior variance's weighted quantile from the fit's stored MLE
    columns, its cumsum in float32 against float64 on the fit's device: the
    prior variances and their relative difference (the pipeline takes it
    in float64)."""
    from deseq2_tpu_torch.engine import fit_device
    from deseq2_tpu_torch.parallel.priordev import wtd_quantile_dev
    from scipy.stats import norm
    dev = fit_device(fit)
    az = np.asarray(fit.row_data["allZero"], bool)
    bm = np.asarray(fit.row_data["baseMean"], float)
    wq = np.where(az, 0.0, 1.0 / (1.0 / np.where(az, 1.0, bm)
                                  + np.asarray(fit.row_data["dispFit"],
                                               float)))
    cols = [np.asarray(fit.row_data[c], float) for c in
            ("MLE_condition_B_vs_A", "MLE_condition_C_vs_A")]
    cols.append(cols[1] - cols[0])
    z = float(norm.ppf(0.975))
    out = {}
    for dname in ("float32", "float64"):
        dt = getattr(torch, dname)
        vs = []
        for c in cols:
            fin = np.isfinite(c) & (np.abs(c) < 10.0)
            b = torch.as_tensor(np.where(fin, np.abs(c), 0.0), dtype=dt,
                                device=dev)
            w = torch.as_tensor(np.where(fin, wq, 0.0), dtype=dt,
                                device=dev)
            vs.append((wtd_quantile_dev(b, w, 0.95).double().item() / z) ** 2)
        out[dname] = float(np.mean(vs))
    rel = abs(out["float32"] - out["float64"]) / out["float64"]
    log(f"  prior variance's weighted quantile, float32 cumsum "
        f"{out['float32']:.9g} against float64 {out['float64']:.9g} "
        f"(relative {rel:.3g}; stored betaPriorVar "
        f"{fit.attrs['betaPriorVar'][1]:.9g})")
    return dict(prior_var_f32=out["float32"], prior_var_f64=out["float64"],
                prior_var_rel=rel)


def prior_phase(torch):
    """betaPrior, contrasts and shrinkage at 60,000 x 1,024 in float32 on
    the three-level design (three_level_labels): each call cold, then warm
    with the launch counters zeroed just before it and read just after it.
    Fails if the betaPrior deseq() or the normal shrinkage launches no K1,
    or a table is malformed.  Then one call each of the betaPrior deseq() +
    results() and the C-vs-B contrast with the stage timers on."""
    import deseq2_tpu_torch as dt
    from deseq2_tpu_torch import profiling

    counts, _ = make_inputs(G_MAIN, S_MAIN)
    labels = three_level_labels(S_MAIN)
    fits = {}

    def run(key, **kw):
        res, fits[key] = public_run(torch, counts, "float32", labels=labels,
                                    **kw)
        return res

    def sync(v):
        torch.cuda.synchronize()
        return v

    calls = [
        ("deseq(beta_prior=True) + results()",
         lambda: run("bp", beta_prior=True), True),
        ("results(contrast=C vs B), betaPrior fit",
         lambda: sync(dt.results(fits["bp"], contrast=CB)), False),
        ("deseq() + results(contrast=C vs B)",
         lambda: run("plain", results_kw=dict(contrast=CB)), False),
        ("results(contrast=[[C_vs_A], [B_vs_A]])",
         lambda: sync(dt.results(fits["plain"], contrast=[
             ["condition_C_vs_A"], ["condition_B_vs_A"]])), False),
        ("results(contrast=[0, -1, 1])",
         lambda: sync(dt.results(fits["plain"],
                                 contrast=np.array([0.0, -1.0, 1.0]))),
         False),
        ("lfc_shrink(coef=B_vs_A, apeglm)",
         lambda: sync(dt.lfc_shrink(fits["plain"], coef="condition_B_vs_A",
                                    type="apeglm")), False),
        ("lfc_shrink(contrast=C vs A, normal)",
         lambda: sync(dt.lfc_shrink(fits["plain"],
                                    contrast=("condition", "C", "A"),
                                    type="normal")), True),
        ("lfc_shrink(coef=B_vs_A, ashr)",
         lambda: sync(dt.lfc_shrink(fits["plain"], coef="condition_B_vs_A",
                                    type="ashr")), False),
    ]
    out, failed = {}, []
    for name, fn, needs_k1 in calls:
        t0 = time.perf_counter()
        fn()
        cold = time.perf_counter() - t0
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tab = fn()
        warm = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        k1 = launches["irls"] + launches["irls_w"]
        ok, shares = _table_ok(tab)
        log(f"  {name}: cold {cold:.3f} s, warm {warm:.3f} s = "
            f"{G_MAIN / warm:,.0f} genes/s, peak device memory {peak:.2f} "
            f"GiB, K1 launches {k1}, finite shares {shares}")
        if not ok:
            failed.append(f"{name}: table malformed")
        if needs_k1 and k1 == 0:
            failed.append(f"{name}: no K1 launch")
        out[name] = dict(cold_s=cold, warm_s=warm,
                         genes_per_s=G_MAIN / warm, peak_gib=peak,
                         k1_launches=k1, launches=launches)
    if failed:
        raise SystemExit(f"betaPrior/contrast/shrinkage phase failed: "
                         f"{failed}")
    out["prior_quantile"] = prior_quantile_dtype(torch, fits["bp"])
    profiling.reset()
    profiling.enable()
    run("bp", beta_prior=True)
    with profiling.stage("smoke.resultsContrast", genes=G_MAIN):
        sync(dt.results(fits["bp"], contrast=CB))
    profiling.disable()
    log("  betaPrior deseq() + results() and the C-vs-B contrast, stage "
        "timings (timers synchronize):")
    for line in profiling.report().splitlines():
        log(f"    {line}")
    return out, fits["bp"]


def prior_gates(torch):
    """Accuracy gates of the betaPrior phase on the gate slice with the
    second half split into B and C: the betaPrior default table, the
    C-vs-B contrast table (deseq() without the prior), and the shrunken
    LFCs of apeglm (coef B_vs_A) and normal (contrast C vs A), each the
    port in float32 on the card against float64 on the CPU; the tables
    under gate_compare's thresholds, the shrunken LFCs under its |dLFC|
    and finite-pattern ones."""
    import deseq2_tpu_torch as dt
    sub, _ = gate_inputs(G_GATE, S_MAIN)
    labels = three_level_labels(S_MAIN)
    kw = dict(sf=np.ones(S_MAIN), labels=labels)
    out, failed = {}, []
    fits = {}
    for name, extra in (("beta_prior", dict(beta_prior=True)),
                        ("contrast_CB", dict(results_kw=dict(contrast=CB)))):
        res32, fit32 = public_run(torch, sub, "float32", **kw, **extra)
        t0 = time.perf_counter()
        res64, fit64 = public_run(torch, sub, "float64", device="cpu", **kw,
                                  **extra)
        cpu_s = time.perf_counter() - t0
        gate, checks = gate_compare(res32, res64)
        log(f"  gate {name} (float64 CPU reference {cpu_s:.1f} s): "
            f"{json.dumps(gate)}")
        failed += [f"{name}:{k}" for k, v in checks.items() if not v]
        out[name] = gate
        fits[name] = (fit32, fit64)
    fit32, fit64 = fits["contrast_CB"]
    for name, skw in (("apeglm", dict(coef="condition_B_vs_A",
                                      type="apeglm")),
                      ("normal", dict(contrast=("condition", "C", "A"),
                                      type="normal"))):
        l32 = np.asarray(dt.lfc_shrink(fit32, **skw)["log2FoldChange"], float)
        l64 = np.asarray(dt.lfc_shrink(fit64, **skw)["log2FoldChange"], float)
        both = np.isfinite(l32) & np.isfinite(l64)
        finite = float(np.mean(np.isfinite(l32) == np.isfinite(l64)))
        d_lfc = float(np.max(np.abs(l32[both] - l64[both])))
        gate = dict(gate_genes=G_GATE, gate_max_dlfc=d_lfc,
                    gate_finite_match=finite)
        log(f"  gate shrink_{name}: {json.dumps(gate)}")
        failed += [f"shrink_{name}:{k}" for k, v in
                   dict(finite=finite >= 0.999, lfc=d_lfc < 0.01).items()
                   if not v]
        out["shrink_" + name] = gate
    if failed:
        raise SystemExit(f"betaPrior/contrast/shrinkage gates failed: "
                         f"{failed}")
    return out


# ---------------------------------------------------------------------------
# kernel timing at the main path's shapes
# ---------------------------------------------------------------------------

def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# operations per sample counted for the bounds: arithmetic operations and
# special-function calls each counted once (so the bound is a lower bound).
def ops_irls(P):
    nt = P * (P + 1) // 2
    return dict(init=7 + 2 * P, sweep=(9 + 3 * nt + 3 * P) + (11 + 2 * P),
                post=(3 + 3 * nt) + (3 + 3 * P * P))


def ops_ls(P, shared_constants=True):
    """Per sample and trial point: the lgamma difference 5 (lgamma(y+c),
    y+c, y log c, two subtractions), digamma(y+c) 8 shifts x 3 + series 12
    and the subtraction of digamma(c), log1p/reciprocal/remaining terms 12,
    w 1, two packed outer products.  shared_constants=False gives the
    earlier count, which charged lgamma(c), log(c) and digamma(c) to every
    sample (7 + 72 + 12 + 3 + outer products)."""
    outer = 6 * (P * (P + 1) // 2)
    return (5 + 37 + 12 + 1 if shared_constants else 7 + 72 + 12 + 3) + outer


def ops_ls_point(P):
    # per trial point and gene: exp, 1/alpha, 1/c, lgamma(c), log(c),
    # digamma(c) (8 shifts x 3 + series 12), the Cholesky, inverse and
    # trace (~P^3) and the step control (~20)
    return 5 + 36 + P ** 3 + 20


def ops_grid(P, shared_constants=True):
    """Per sample and grid point: the lgamma difference 5 (lgamma(y+c),
    y+c, y log c, two subtractions), the log1p term 4, the Cox-Reid weight
    3 (1 + mu alpha, its reciprocal, mu r), a packed outer product.
    shared_constants=False gives the earlier count, which charged lgamma(c)
    and log(c) to every sample (7 + 4 + 3 + outer product)."""
    return (5 if shared_constants else 7) + 4 + 3 + 3 * (P * (P + 1) // 2)


def ops_grid_point(P):
    # per grid point and gene: exp, 1/alpha, 1/c, lgamma(c), log(c), the
    # Cholesky and log determinant (~P^2) and the prior (4)
    return 5 + P * P + 4


def bound(bytes_, ops, dname):
    t_bytes = bytes_ / HBM_BPS * 1e3
    t_ops = ops / PEAK_OPS[dname] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_timings(torch, dev, launches, worst, weighted=False,
                   dname="float32", x_np=None):
    """Each kernel at the main path's shapes (float32, 60,000 x 1,024,
    ~ condition), on the inputs the pipeline hands it, built by the
    pipeline's own stages: held against its plain version and the float64
    reference with the limits of phase 3 (a failure exits), then timed.
    `weighted`: the weighted modes at the weighted path's inputs (the
    gene-wise search and grid at the max-1 weights floored at 1e-6, the
    IRLS at the max-1 weights), `launches` that path's counters.  With a
    design `x_np` of more than 8 columns (phase 8's paired design) the
    wide kernels in `dname`, rows named <kernel>_wide_f64 / _f32: K1 held
    to the float64 fit in float32, as phase 3 holds it."""
    from deseq2_tpu_torch.ops import checks, disp, irls
    from deseq2_tpu_torch.ops.cuda_grid import fit_disp_grid
    from deseq2_tpu_torch.ops.cuda_irls import fit_beta
    from deseq2_tpu_torch.ops.cuda_ls import fit_disp_line_search

    dt = getattr(torch, dname)
    counts, x_main = make_inputs(G_MAIN, S_MAIN)
    x_np = x_main if x_np is None else x_np
    pin = checks.pipeline_inputs(
        counts, x_np, dt, dev,
        weights=_main_variant_inputs()[0] if weighted else None)
    y_s, mu_s, x, la0 = pin["y"], pin["mu"], pin["x"], pin["la0"]
    w_ge, w_n, grid = pin["w_ge"], pin["w_n"], pin["grid"]
    G, S, P = G_MAIN, S_MAIN, x_np.shape[1]
    it = 4 if dname == "float32" else 8   # itemsize
    f32 = dname == "float32"
    nw = int(weighted)   # weight rows read
    wide = P > 8
    # launch and worst-reading keys, and the row names' suffix
    sfx = "_wide" if wide else "_w" if weighted else ""
    rsfx = sfx + ("_f32" if f32 else "_f64") if wide else sfx
    rows, failed = [], []

    # K2: the gene-wise line search
    ls_args = (y_s, x, mu_s, la0, la0, 1.0, pin["min_la"])
    k2 = fit_disp_line_search(*ls_args, weights=w_ge)
    p2 = disp.fit_disp_line_search_plain(*ls_args, weights=w_ge)
    d2 = dict(y=y_s, mu=mu_s, x=x, la0=la0, pm=la0)
    if weighted:
        d2["w"] = w_ge
    ref2 = checks.line_search_reference(d2, False, prior_var=1.0,
                                        min_log_alpha=pin["min_la"]) \
        if f32 else p2
    r2 = checks.check_ls(k2, p2, d2, False, prior_var=1.0,
                         ref=ref2 if f32 else None)
    log(f"  disp_ls{rsfx}: {fmt(r2)}")
    lk = checks.lp_at(k2["log_alpha"], d2, False, 1.0)
    lpl = checks.lp_at(p2["log_alpha"], d2, False, 1.0)
    rel = (lpl - lk) / lpl.abs().clamp(min=1.0)
    i = int(rel.argmax())
    log(f"  disp_ls{rsfx}: over all genes the largest shortfall below the "
        f"plain solution is {rel[i].item():.3g} of |lp| (gene {i}: |lp| "
        f"{lpl[i].abs().item():.4g}, iter kernel {int(k2['iter'][i])} / "
        f"plain {int(p2['iter'][i])} / reference {int(ref2['iter'][i])}, "
        f"log alpha {k2['log_alpha'][i].item():.4f} / "
        f"{p2['log_alpha'][i].item():.4f} / "
        f"{ref2['log_alpha'][i].item():.4f})")
    if not r2["ok"]:
        failed.append("disp_ls" + rsfx)
    ms2 = time_ms(torch, lambda: fit_disp_line_search(*ls_args,
                                                      weights=w_ge), 3)
    pms2 = time_ms(torch, lambda: disp.fit_disp_line_search_plain(
        *ls_args, weights=w_ge), 1)
    evals = float((k2["iter"].double() + 1).sum())
    ls_bytes = it * ((2 + nw) * G * S + S * P + 2 * G + 8 * G)
    b2, by2 = bound(ls_bytes, evals * (S * (ops_ls(P) + 2 * nw)
                                       + ops_ls_point(P)), dname)
    b2_old, _ = bound(ls_bytes, evals * S * (ops_ls(P, False) + 2 * nw),
                      dname)
    rows.append(dict(name="disp_ls" + rsfx, route="cuda",
                     source="deseq2_tpu_torch/csrc/disp_ls.cu",
                     replaces="deseq2_tpu/ops/pallas_ls.py:409",
                     launches=launches["disp_ls" + sfx],
                     max_abs_err=max(worst["disp_ls" + rsfx],
                                     r2["max_abs_err"]),
                     ms=ms2, plain_ms=pms2, bound_ms=b2, bound_by=by2,
                     library_ms=None))
    log(f"  disp_ls{rsfx}: {evals / G:.1f} evaluations/gene; bound "
        f"{b2:.3f} ms ({b2_old:.3f} ms by the earlier count, which "
        f"charged the trial point's constants to every sample)")

    # K3: the grid fallback on the genes whose line search did not converge
    conv = (k2["iter"] < 100) & (k2["iter"] != 1)
    need = torch.nonzero(~conv).squeeze(1)
    n_need = int(need.numel())
    if n_need == 0:
        need = torch.arange(4096, device=dev)
    gy, gm, gpm = y_s[need], mu_s[need], torch.zeros(len(need), dtype=dt,
                                                      device=dev)
    gw = None if w_ge is None else w_ge[need]
    g_args = (gy, x, gm, grid, gpm, 1.0)
    k3 = fit_disp_grid(*g_args, weights=gw)
    p3 = disp.fit_disp_grid_plain(*g_args, weights=gw)
    d3 = dict(y=gy, mu=gm, x=x, grid=grid, pm=gpm)
    if weighted:
        d3["w"] = gw
    r3 = checks.check_grid(k3, p3, d3, False, prior_var=1.0,
                           ref=checks.grid_reference(d3, False, 1.0)
                           if f32 else None)
    log(f"  disp_grid{rsfx}: {fmt(r3)}")
    if not r3["ok"]:
        failed.append("disp_grid" + rsfx)
    ms3 = time_ms(torch, lambda: fit_disp_grid(*g_args, weights=gw), 3)
    pms3 = time_ms(torch, lambda: disp.fit_disp_grid_plain(
        *g_args, weights=gw), 1)
    Gn, evals = len(need), 2.0 * len(need) * len(grid)
    g_bytes = it * ((2 + nw) * Gn * S + S * P + 2 * Gn + len(grid))
    b3, by3 = bound(g_bytes, evals * (S * (ops_grid(P) + nw)
                                      + ops_grid_point(P)), dname)
    b3_old, _ = bound(g_bytes, evals * S * (ops_grid(P, False) + nw), dname)
    grid_row = dict(name="disp_grid" + rsfx, route="cuda",
                    source="deseq2_tpu_torch/csrc/disp_grid.cu",
                    replaces="deseq2_tpu/ops/pallas_disp.py:244",
                    launches=launches["disp_grid" + sfx],
                    max_abs_err=max(worst["disp_grid" + rsfx],
                                    r3["max_abs_err"]),
                    ms=ms3, plain_ms=pms3, bound_ms=b3, bound_by=by3,
                    library_ms=None)
    # a wide row only where the paired path launched the kernel (in float64
    # the line search converges on every gene at this width)
    if not wide or grid_row["launches"]:
        rows.append(grid_row)
    log(f"  disp_grid{rsfx}: {n_need} genes need the grid at this shape "
        f"(timed on {Gn}); bound {b3:.4f} ms ({b3_old:.4f} ms by the earlier "
        f"count, which charged the point's constants to every sample)")

    # K1: the final ridge IRLS at the gene-wise dispersions
    i_args = checks.irls_start(pin, k2["log_alpha"])
    k1 = fit_beta(*i_args, weights=w_n)
    pl1 = irls.fit_beta_plain(*i_args, weights=w_n)
    if wide and f32:
        r1 = checks.check_irls_f64(k1, pl1, irls.fit_beta_plain(
            *(a.double() for a in i_args),
            weights=None if w_n is None else w_n.double()))
    else:
        r1 = checks.check_irls(k1, pl1)
    log(f"  irls{rsfx}: {fmt(r1)}")
    if not r1["ok"]:
        failed.append("irls" + rsfx)
    ms1 = time_ms(torch, lambda: fit_beta(*i_args, weights=w_n), 3)
    pms1 = time_ms(torch, lambda: irls.fit_beta_plain(*i_args, weights=w_n),
                   1)
    sweeps = float(k1["iter"].double().sum())
    o = ops_irls(P)
    b1, by1 = bound(it * ((3 + nw) * G * S + S + S * P + G * (1 + 3 * P)
                          + 2 * G),
                    S * (G * (o["init"] + o["post"] + 2 * nw)
                         + sweeps * (o["sweep"] + 2 * nw)), dname)
    rows.append(dict(name="irls" + rsfx, route="cuda",
                     source="deseq2_tpu_torch/csrc/irls.cu",
                     replaces="deseq2_tpu/ops/pallas_irls.py:360",
                     launches=launches["irls" + sfx],
                     max_abs_err=max(worst["irls" + rsfx],
                                     r1["max_abs_err"]),
                     ms=ms1, plain_ms=pms1, bound_ms=b1, bound_by=by1,
                     library_ms=None))
    log(f"  irls{rsfx}: {sweeps / G:.1f} sweeps/gene")
    for r in rows:
        log(f"  {r['name']}: {r['ms']:.3f} ms (plain {r['plain_ms']:.1f} ms, "
            f"bound {r['bound_ms']:.3f} ms by {r['bound_by']}), "
            f"max_abs_err {r['max_abs_err']:.2e}, launches {r['launches']}")
    if failed:
        raise SystemExit(f"kernel checks at the main path's shapes failed: "
                         f"{failed}")
    return rows


def expanded_k1_timing(torch, dev, fit, launches, worst):
    """K1 at the betaPrior refit's shape: 60,000 x 1,024, the expanded
    design [intercept, A, B, C] (p = 4) of the betaPrior phase's fit, its
    ridge from the fit's betaPriorVar, the intercept-only start, the fit's
    size factors and dispersions (1 on all-zero rows): held against its
    plain version and the float64 fit (check_irls_expanded, a failure
    exits), then timed beside the plain version and its bound, in float32
    (the returned kernels row, with the betaPrior warm call's K1 launches)
    and float64 (logged)."""
    from deseq2_tpu_torch.ops import checks, irls
    from deseq2_tpu_torch.ops.cuda_irls import fit_beta

    counts, _ = make_inputs(G_MAIN, S_MAIN)
    codes = np.searchsorted(np.array(["A", "B", "C"]),
                            three_level_labels(S_MAIN))
    x_e = np.column_stack([np.ones(S_MAIN)] + [(codes == lv).astype(float)
                                               for lv in range(3)])
    az = np.asarray(fit.row_data["allZero"], bool)
    sf = np.asarray(fit.size_factors, float)
    disp = np.asarray(fit.row_data["dispersion"], float)
    disp = np.where(np.isfinite(disp), disp, 1.0)
    pv = float(fit.attrs["betaPriorVar"][1])
    lam = np.array([1e-6, 1.0 / pv, 1.0 / pv, 1.0 / pv]) / np.log(2.0) ** 2
    y_safe = np.where(az[:, None], 1, counts)
    b0 = np.zeros((G_MAIN, 4))
    b0[:, 0] = np.where(az, 0.0, np.log(np.maximum(
        (counts / sf).mean(axis=1), 1e-300)))
    G, S, P = G_MAIN, S_MAIN, 4
    rows, failed = [], []
    ref = None
    for dname in ("float64", "float32"):
        dt = getattr(torch, dname)

        def t(a):
            return torch.as_tensor(a, device=dev).to(dt)

        args = (t(y_safe), t(x_e), t(sf), t(disp), t(b0), t(lam))
        k1 = fit_beta(*args)
        pl = irls.fit_beta_plain(*args)
        if ref is None:
            ref = pl
        r = checks.check_irls_expanded(k1, pl, ref)
        log(f"  irls expanded p=4 {dname}: {fmt(r)}")
        if not r["ok"]:
            failed.append(f"irls expanded {dname}")
        ms = time_ms(torch, lambda: fit_beta(*args), 3)
        pms = time_ms(torch, lambda: irls.fit_beta_plain(*args), 1)
        sweeps = float(k1["iter"].double().sum())
        o = ops_irls(P)
        it = 4 if dname == "float32" else 8
        b1, by1 = bound(it * (3 * G * S + S + S * P + G * (1 + 3 * P)
                              + 2 * G),
                        S * (G * (o["init"] + o["post"])
                             + sweeps * o["sweep"]), dname)
        log(f"  irls expanded p=4 {dname}: {ms:.3f} ms (plain {pms:.1f} ms, "
            f"bound {b1:.3f} ms by {by1}, {100 * b1 / ms:.1f}% of it), "
            f"{sweeps / G:.2f} sweeps/gene, betaPrior warm-call launches "
            f"{launches}")
        if dname == "float32":
            rows.append(dict(
                name="irls_expanded", route="cuda",
                source="deseq2_tpu_torch/csrc/irls.cu",
                replaces="deseq2_tpu/ops/pallas_irls.py:360",
                launches=launches,
                max_abs_err=max(worst["irls_expanded"], r["max_abs_err"]),
                ms=ms, plain_ms=pms, bound_ms=b1, bound_by=by1,
                library_ms=None))
        else:
            f64_row = dict(ms=ms, plain_ms=pms, bound_ms=b1, bound_by=by1,
                           max_abs_err=r["max_abs_err"])
    if failed:
        raise SystemExit(f"expanded K1 checks failed: {failed}")
    return rows, f64_row


# ---------------------------------------------------------------------------
# phase 8: the host-exact engine
# ---------------------------------------------------------------------------

def host_call(torch, name, counts, need, device="cuda", **kw):
    """One float64 deseq() + results() call through the host engine (or
    "auto"), with the launch counters zeroed just before it and read just
    after, and the stage timers on (they synchronize the card at each
    stage's ends): wall seconds, the stage table, the counters; fails if
    a kernel in `need` was not launched or the table is malformed."""
    from deseq2_tpu_torch import glm, profiling
    zero_counts()
    glm.fit_glm_tensors.optim_rows = 0
    profiling.reset()
    profiling.enable()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, fit = public_run(torch, counts, "float64", device=device, **kw)
    wall = time.perf_counter() - t0
    profiling.disable()
    launches = {k: v for k, v in read_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    g = counts.shape[0]
    stat, padj = np.asarray(res["stat"]), np.asarray(res["padj"])
    log(f"  {name}: {wall:.3f} s = {g / wall:,.0f} genes/s (stage timers "
        f"on), engine {fit.attrs.get('engine')}, peak device memory "
        f"{peak:.2f} GiB, finite stat {np.isfinite(stat).mean():.4f}, "
        f"rejections {int(np.sum(padj < 0.1))}, L-BFGS-B rows "
        f"{glm.fit_glm_tensors.optim_rows}, launches {launches}")
    log(f"  {name} stage timings:")
    for line in profiling.report().splitlines():
        log(f"    {line}")
    missing = [k for k in need if not launches.get(k)]
    if missing:
        raise SystemExit(f"host engine call {name} never launched {missing}")
    if stat.shape != (g,) or np.isfinite(stat).mean() <= 0.95 \
            or np.isfinite(padj).mean() <= 0.5:
        raise SystemExit(f"host engine call {name}: output malformed")
    return dict(wall_s=wall, genes_per_s=g / wall, peak_gib=peak,
                launches=launches, engine=fit.attrs.get("engine"),
                optim_rows=glm.fit_glm_tensors.optim_rows), res, fit


def host_phase(torch):
    """The host engine at 60,000 x 1,024 in float64: the main path's
    ~ condition Wald through engine="host" (cold, then warm); ~ batch +
    condition with betaPrior and poscounts size factors through "auto";
    the weighted path with 1% of the rows' weights rank-deficient through
    "auto" (weightsFail); the configuration's useCR = FALSE (unweighted
    and weighted), and the weighted Cox-Reid row cut at 0.5, all with
    maxit_disp = 10 (so the grid fallback runs).  Each call's counters and
    stage table; the modes' kernel launches gated."""
    import deseq2_tpu_torch as dt
    counts, _ = make_inputs(G_MAIN, S_MAIN)
    w, _ = _main_variant_inputs()
    out = {}
    t0 = time.perf_counter()
    public_run(torch, counts, "float64", engine="host")
    out["wald_cold_s"] = time.perf_counter() - t0
    log(f"  ~ condition, engine='host': cold {out['wald_cold_s']:.3f} s")
    # in float64 the line search converges on every gene here, so K3 runs
    # in the two mode calls below, whose shortened search (maxit_disp =
    # 10) leaves genes to the grid
    out["wald"], _, _ = host_call(torch, "~ condition, engine='host'",
                                  counts, ("irls", "disp_ls"),
                                  engine="host")
    out["betaprior_poscounts"], _, bp = host_call(
        torch, "~ batch + condition, beta_prior, poscounts, 'auto'", counts,
        ("irls",), design="~ batch + condition", beta_prior=True,
        sf_type="poscounts")
    if bp.attrs.get("engine") != "host" or len(bp.attrs["modelMatrixNames"]) \
            != 5:
        raise SystemExit("betaPrior on ~ batch + condition did not run the "
                         "host engine's expanded p = 5 fit")
    wf = w.copy()
    bad = np.arange(0, G_MAIN, 100)
    wf[bad, S_MAIN // 2:] = 0.0      # no weight on condition B
    import warnings
    with warnings.catch_warnings():     # the weightsFail warning
        warnings.simplefilter("ignore")
        out["weights_fail"], _, wfit = host_call(
            torch, "weights, 1% rows rank-deficient, 'auto'", counts,
            ("irls_w", "disp_ls_w"), weights=wf)
    flagged = np.where(np.asarray(wfit.row_data["weightsFail"], bool))[0]
    out["weights_fail"]["flagged"] = int(flagged.size)
    if wfit.attrs.get("engine") != "host" \
            or not np.array_equal(flagged, bad):
        raise SystemExit(f"weightsFail rows: {flagged.size} flagged, "
                         f"{bad.size} made rank-deficient")
    out["no_cr"], _, _ = host_call(
        torch, "useCR=FALSE, maxit_disp=10, engine='host'", counts,
        ("disp_ls_nocr", "disp_grid_nocr", "disp_grid"), engine="host",
        config=dt.DESeqConfig(use_cr=False, maxit_disp=10))
    out["no_cr_weighted"], _, _ = host_call(
        torch, "weights, useCR=FALSE, maxit_disp=10, engine='host'", counts,
        ("disp_ls_w_nocr", "disp_grid_w_nocr"), engine="host", weights=w,
        config=dt.DESeqConfig(use_cr=False, maxit_disp=10))
    out["threshold"], _, _ = host_call(
        torch, "weights, weightThreshold=0.5, maxit_disp=10, engine='host'",
        counts, ("disp_ls_w_thr", "disp_grid_w_thr", "irls_w"),
        engine="host", weights=w,
        config=dt.DESeqConfig(weight_threshold=0.5, maxit_disp=10))
    return out


def host_gates(torch):
    """On the 2,048 x 1,024 gate slice, float64: the host engine on the
    card against the fused engine on the card and against the host engine
    on the CPU (bench.py's thresholds)."""
    sub, _ = gate_inputs(G_GATE, S_MAIN)
    host_card, _ = public_run(torch, sub, "float64", engine="host")
    fused_card, _ = public_run(torch, sub, "float64", engine="fused")
    t0 = time.perf_counter()
    host_cpu, _ = public_run(torch, sub, "float64", engine="host",
                             device="cpu")
    log(f"  host engine on the CPU: {time.perf_counter() - t0:.1f} s")
    out, failed = {}, []
    for name, ref in (("vs fused on the card", fused_card),
                      ("vs host on the CPU", host_cpu)):
        gate, checks = gate_compare(host_card, ref)
        out[name] = gate
        log(f"  host engine on the card {name}: {json.dumps(gate)}")
        failed += [f"{name}: {k}" for k in ("jaccard", "flips", "lfc")
                   if not checks[k]]
    if failed:
        raise SystemExit(f"host engine gates failed: {failed}")
    return out


def mode_timings(torch, dev, launches, worst):
    """K2 and K3 in the host engine's other modes at the main path's
    shapes in float64 (the host engine's dtype), on the inputs the
    pipeline's stages hand them: without the Cox-Reid term (unweighted
    and weighted), and with the weighted Cox-Reid row cut at 0.5 (the
    weighted path's weights floored at 1e-6); each held against its plain
    version with phase 3's float64 limits, then timed beside it and its
    bound.
    `launches`: phase 8's counters per mode."""
    from deseq2_tpu_torch.ops import checks, disp
    from deseq2_tpu_torch.ops.cuda_grid import fit_disp_grid
    from deseq2_tpu_torch.ops.cuda_ls import fit_disp_line_search

    dname, dt = "float64", torch.float64
    counts, x_np = make_inputs(G_MAIN, S_MAIN)
    G, S, P, it = G_MAIN, S_MAIN, 2, 8
    rows, failed = [], []
    for mode, weighted in (("nocr", False), ("nocr", True), ("thr", True)):
        sfx = ("_w" if weighted else "") + "_" + mode
        nw = int(weighted)
        pin = checks.pipeline_inputs(
            counts, x_np, dt, dev,
            weights=_main_variant_inputs()[0] if weighted else None)
        kw = checks.MODES[mode]
        cr = kw.get("use_cr", True)
        y_s, mu_s, x, la0 = pin["y"], pin["mu"], pin["x"], pin["la0"]
        w_ge, grid = pin["w_ge"], pin["grid"]
        ls_args = (y_s, x, mu_s, la0, la0, 1.0, pin["min_la"])
        k2 = fit_disp_line_search(*ls_args, weights=w_ge, **kw)
        p2 = disp.fit_disp_line_search_plain(*ls_args, weights=w_ge, **kw)
        d2 = checks.with_mode(dict(y=y_s, mu=mu_s, x=x, la0=la0, pm=la0),
                              mode)
        if weighted:
            d2["w"] = w_ge
        r2 = checks.check_ls(k2, p2, d2, False, prior_var=1.0)
        ms2 = time_ms(torch, lambda: fit_disp_line_search(
            *ls_args, weights=w_ge, **kw), 3)
        pms2 = time_ms(torch, lambda: disp.fit_disp_line_search_plain(
            *ls_args, weights=w_ge, **kw), 1)
        evals = float((k2["iter"].double() + 1).sum())
        per_s = ops_ls(P) - (0 if cr else 6 * (P * (P + 1) // 2) + 1)
        per_pt = ops_ls_point(P) - (0 if cr else P ** 3)
        b2, by2 = bound(it * ((2 + nw) * G * S + S * P + 2 * G + 8 * G),
                        evals * (S * (per_s + 2 * nw) + per_pt), dname)
        conv = (k2["iter"] < 100) & (k2["iter"] != 1)
        need = torch.nonzero(~conv).squeeze(1)
        if need.numel() == 0:
            need = torch.arange(4096, device=dev)
        gy, gm = y_s[need], mu_s[need]
        gpm = torch.zeros(len(need), dtype=dt, device=dev)
        gw = None if w_ge is None else w_ge[need]
        g_args = (gy, x, gm, grid, gpm, 1.0)
        k3 = fit_disp_grid(*g_args, weights=gw, **kw)
        p3 = disp.fit_disp_grid_plain(*g_args, weights=gw, **kw)
        d3 = checks.with_mode(dict(y=gy, mu=gm, x=x, grid=grid, pm=gpm),
                              mode)
        if weighted:
            d3["w"] = gw
        r3 = checks.check_grid(k3, p3, d3, False, prior_var=1.0)
        ms3 = time_ms(torch, lambda: fit_disp_grid(*g_args, weights=gw,
                                                   **kw), 3)
        pms3 = time_ms(torch, lambda: disp.fit_disp_grid_plain(
            *g_args, weights=gw, **kw), 1)
        Gn = len(need)
        per_s3 = ops_grid(P) - (0 if cr else 3 + 3 * (P * (P + 1) // 2))
        per_pt3 = ops_grid_point(P) - (0 if cr else P * P)
        b3, by3 = bound(it * ((2 + nw) * Gn * S + S * P + 2 * Gn
                              + len(grid)),
                        2.0 * Gn * len(grid) * (S * (per_s3 + nw)
                                                + per_pt3), dname)
        for name, r, ms, pms, b, by, src, rep in (
                ("disp_ls", r2, ms2, pms2, b2, by2, "disp_ls.cu",
                 "deseq2_tpu/ops/pallas_ls.py:409"),
                ("disp_grid", r3, ms3, pms3, b3, by3, "disp_grid.cu",
                 "deseq2_tpu/ops/pallas_disp.py:244")):
            log(f"  {name}{sfx} float64: {fmt(r)}; {ms:.3f} ms (plain "
                f"{pms:.1f} ms, bound {b:.3f} ms by {by}), launches "
                f"{launches.get(name + sfx, 0)}")
            if not r["ok"]:
                failed.append(name + sfx)
            rows.append(dict(
                name=name + sfx, route="cuda",
                source=f"deseq2_tpu_torch/csrc/{src}", replaces=rep,
                launches=launches.get(name + sfx, 0),
                max_abs_err=max(worst.get(name + sfx, 0.0),
                                r["max_abs_err"]),
                ms=ms, plain_ms=pms, bound_ms=b, bound_by=by,
                library_ms=None))
        log(f"  {mode}: {evals / G:.1f} line-search evaluations/gene, "
            f"{int((~conv).sum())} genes need the grid")
    if failed:
        raise SystemExit(f"mode checks at the main path's shapes failed: "
                         f"{failed}")
    return rows


# ---------------------------------------------------------------------------
# phase 8: paired designs ~ subject + condition (8 < p <= 16)
# ---------------------------------------------------------------------------

# design width -> subjects of the paired design (checks.paired_design)
PAIRED = {10: 9, 16: 15}
# the paired gates' float64 columns, card against CPU (rtol, atol of the
# CPU tests)
PAIRED_COLUMNS = ("baseMean", "log2FoldChange", "lfcSE", "stat", "pvalue",
                  "padj", "dispGeneEst", "dispFit", "dispersion")
PAIRED_RTOL, PAIRED_ATOL = 1e-6, 1e-9
# the genes whose dispersion search ended at another step
# (paired_columns_close), and the largest share of the genes that may be
# among them (10 of the gates' 2,048)
PAIRED_STEP_RTOL = 1e-4
PAIRED_STEP_SHARE = 0.005


def paired_run(torch, counts, dname, p, **kw):
    """public_run on the paired design with p columns."""
    from deseq2_tpu_torch.ops import checks
    subj, cond = checks.paired_design(counts.shape[1], PAIRED[p])
    return public_run(torch, counts, dname, design="~ subject + condition",
                      labels=cond, subjects=subj, **kw)


def paired_x(S, p):
    """The paired design's model matrix [1, subject 1.., condition B]."""
    from deseq2_tpu_torch.ops import checks
    _, cond = checks.paired_design(S, PAIRED[p])
    codes = np.arange(S) % PAIRED[p]
    return np.column_stack([np.ones(S)]
                           + [(codes == k).astype(float)
                              for k in range(1, PAIRED[p])]
                           + [(cond == "B").astype(float)])


def paired_call(torch, name, dname, p, **kw):
    """One paired-design deseq() + results() at 60,000 x 1,024: cold, warm
    with the counters zeroed just before it and read just after (seconds,
    genes/s, peak device memory, launches), then once more with the stage
    timers on (they synchronize the card at each stage's ends) for the
    stage table.  Fails if a plain version ran on the card, if the wide
    K1 or K2 did not, or if the output is malformed.  Returns the record
    and the warm call's fit."""
    from deseq2_tpu_torch import profiling
    counts, _ = make_inputs(G_MAIN, S_MAIN)
    t0 = time.perf_counter()
    paired_run(torch, counts, dname, p, **kw)
    cold = time.perf_counter() - t0
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, fit = paired_run(torch, counts, dname, p, **kw)
    warm = time.perf_counter() - t0
    counts_all = read_counts()
    launches = {k: v for k, v in counts_all.items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    profiling.reset()
    profiling.enable()
    paired_run(torch, counts, dname, p, **kw)
    profiling.disable()
    stat, padj = np.asarray(res["stat"]), np.asarray(res["padj"])
    width = len(fit.attrs["modelMatrixNames"])
    log(f"  {name}: cold {cold:.3f} s, warm {warm:.3f} s = "
        f"{G_MAIN / warm:,.0f} genes/s, engine {fit.attrs.get('engine')}, "
        f"p = {width}, peak device memory {peak:.2f} GiB, finite stat "
        f"{np.isfinite(stat).mean():.4f}, launches {launches}")
    log(f"  {name} stage timings (a third call, timers on):")
    for line in profiling.report().splitlines():
        log(f"    {line}")
    plain = [k for k in launches if k.endswith("_plain")]
    missing = [k for k in ("irls_wide", "disp_ls_wide") if not launches.get(k)]
    if plain or missing:
        raise SystemExit(f"{name}: plain versions on the card {plain}, wide "
                         f"kernels never launched {missing}")
    if width != p or stat.shape != (G_MAIN,) \
            or np.isfinite(stat).mean() <= 0.95 \
            or np.isfinite(padj).mean() <= 0.5:
        raise SystemExit(f"{name}: output malformed")
    return dict(cold_s=cold, warm_s=warm, genes_per_s=G_MAIN / warm,
                peak_gib=peak, launches=counts_all,
                engine=fit.attrs.get("engine")), fit


def paired_phase(torch):
    """The paired designs ~ subject + condition at 60,000 x 1,024
    (bench.py's counts, seed 0): p = 10 in float32 and float64 on the
    fused route and in float64 through engine="host", p = 16 in float64 on
    the fused route (paired_call); then lfc_shrink(type="normal") on the p
    = 10 float64 fit, which refits on the wide K1."""
    import deseq2_tpu_torch as dt
    out, fits = {}, {}
    for key, dname, p, kw in (
            ("p10 float32", "float32", 10, {}),
            ("p10 float64", "float64", 10, {}),
            ("p10 float64 host", "float64", 10, dict(engine="host")),
            ("p16 float64", "float64", 16, {})):
        out[key], fits[key] = paired_call(
            torch, f"~ subject + condition, {key}", dname, p, **kw)
    zero_counts()
    t0 = time.perf_counter()
    shr = dt.lfc_shrink(fits["p10 float64"], type="normal",
                        contrast=("condition", "B", "A"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in read_counts().items() if v}
    lfc = np.asarray(shr["log2FoldChange"])
    out["p10 normal shrinkage"] = dict(wall_s=wall, launches=launches)
    log(f"  p = 10 lfc_shrink(normal): {wall:.3f} s, launches {launches}, "
        f"finite {np.isfinite(lfc).mean():.4f}")
    if not launches.get("irls_wide") or np.isfinite(lfc).mean() <= 0.95 \
            or any(k.endswith("_plain") for k in launches):
        raise SystemExit("p = 10 normal shrinkage did not run its wide fit")
    return out


def paired_columns_close(card, cpu):
    """A float64 paired call on the card against the same call on the CPU
    (public_run's (results, fit) pairs), on the genes whose betaConv is
    true on both: PAIRED_COLUMNS at PAIRED_RTOL / PAIRED_ATOL where the
    gene-wise and MAP dispersion searches took the same number of steps on
    both, and at PAIRED_STEP_RTOL where one stopped at another step.  The
    line search stops on an lp change below its tolerance, and the
    kernels' sums differ from the plain version's in the last bits (phase
    3 holds K2 to the plain log posterior at 1e-9, not to its step count),
    so a decision at that threshold can flip and end a search one step
    away (a few genes in 2,048; PERF.md section 6); more than
    PAIRED_STEP_SHARE of the genes there is a failure (paired_gates).
    Returns the largest relative difference, the columns off, the genes
    left out (betaConv false), the genes held at the step tolerance and,
    for each group, the largest |difference| / (atol + rtol |CPU value|)
    over the columns (at most 1 passes)."""
    (cr, cf), (pr, pf) = card, cpu
    keep = np.asarray(cf.row_data["betaConv"], bool) \
        & np.asarray(pf.row_data["betaConv"], bool)
    same = np.ones_like(keep)
    for c in ("dispGeneIter", "dispIter"):
        a, b = (np.asarray(f.row_data[c], float) for f in (cf, pf))
        same &= (a == b) | (np.isnan(a) & np.isnan(b))
    worst, bad, ratio = 0.0, [], {"same_steps": 0.0, "other_steps": 0.0}
    for c in PAIRED_COLUMNS:
        src = (cr, pr) if c in cr.column_names else (cf.row_data, pf.row_data)
        g, w = (np.asarray(v[c], float) for v in src)
        fin = keep & np.isfinite(g) & np.isfinite(w)
        if fin.any():
            worst = max(worst, float(np.max(np.abs(g[fin] - w[fin])
                                            / np.maximum(np.abs(w[fin]),
                                                         1e-300))))
        for rows, rtol, grp in ((keep & same, PAIRED_RTOL, "same_steps"),
                                (keep & ~same, PAIRED_STEP_RTOL,
                                 "other_steps")):
            if not np.allclose(g[rows], w[rows], rtol=rtol, atol=PAIRED_ATOL,
                               equal_nan=True):
                bad.append(c)
            both = rows & np.isfinite(g) & np.isfinite(w)
            if both.any():
                ratio[grp] = max(ratio[grp], float(np.max(
                    np.abs(g[both] - w[both])
                    / (PAIRED_ATOL + rtol * np.abs(w[both])))))
    return (worst, bad, int((~keep).sum()), int((keep & ~same).sum()),
            ratio)


def paired_gates(torch):
    """On 2,048 x 1,024 slices of the paired designs
    (checks.paired_gate_counts, seed 0): the p = 10 fused call in float32
    on the card against float64 on the CPU by bench.py's gates (Jaccard >=
    0.995, zero confident flips, |dLFC| < 0.01), and the float64 calls on
    the card (p = 10 fused and host engine, p = 16 fused) against the same
    calls on the CPU (paired_columns_close; at most PAIRED_STEP_SHARE of
    the genes may have taken another number of dispersion steps)."""
    from deseq2_tpu_torch.ops import checks
    out, failed = {}, []
    for p, engines in ((10, (None, "host")), (16, (None,))):
        sub, subj, cond = checks.paired_gate_counts(G_GATE, S_MAIN,
                                                    PAIRED[p], 0)

        def run(dname, **kw):
            return public_run(torch, sub, dname,
                              design="~ subject + condition", labels=cond,
                              subjects=subj, **kw)

        for engine in engines:
            kw = {} if engine is None else dict(engine=engine)
            key = f"p{p} {engine or 'fused'}"
            t0 = time.perf_counter()
            cpu = run("float64", device="cpu", **kw)
            cpu_s = time.perf_counter() - t0
            card = run("float64", **kw)
            worst, bad, left, step, ratio = paired_columns_close(card, cpu)
            step_limit = int(PAIRED_STEP_SHARE * G_GATE)
            out[key] = dict(max_rel=worst, off=bad, betaconv_false=left,
                            other_step=step, other_step_limit=step_limit,
                            limit_ratio=ratio)
            log(f"  {key} float64, card vs CPU ({cpu_s:.1f} s): largest "
                f"relative difference {worst:.3g}, off: {bad}, genes with "
                f"betaConv false {left}, genes whose dispersion search "
                f"took another number of steps {step} of at most "
                f"{step_limit} (held at rtol {PAIRED_STEP_RTOL:g}, the rest "
                f"at {PAIRED_RTOL:g}); largest difference over its limit "
                f"{json.dumps(ratio)}")
            failed += [f"{key} {c}" for c in bad]
            if step > step_limit:
                failed.append(f"{key}: {step} genes took another number of "
                              f"dispersion steps, more than {step_limit}")
            if p == 10 and engine is None:
                r32, _ = run("float32")
                gate, ok = gate_compare(r32, cpu[0])
                out[key]["gate_f32"] = gate
                log(f"  {key} float32 card vs float64 CPU, bench.py's "
                    f"gates: {json.dumps(gate)}")
                failed += [f"{key} float32 {k}" for k in
                           ("jaccard", "flips", "lfc") if not ok[k]]
    if failed:
        raise SystemExit(f"paired-design gates failed: {failed}")
    return out


# ---------------------------------------------------------------------------
# phase 9: the transforms
# ---------------------------------------------------------------------------

def transform_dataset(counts, dtype_name="float64", **cfg):
    """The main path's ~ condition dataset over `counts`, with
    DESeqConfig(dtype=dtype_name, **cfg)."""
    import deseq2_tpu_torch as dt
    s = counts.shape[1]
    return dt.dataset_from_matrix(
        counts, {"condition": np.repeat(["A", "B"], [s // 2, s - s // 2])},
        "~ condition", config=dt.DESeqConfig(dtype=dtype_name, **cfg))


# the public transform calls of phase 9 and its gates: name -> (call on a
# dataset and a device, blind: it runs the dispersion step)
TRANSFORMS = {
    "vst": (lambda dt, d, dev: dt.vst(d, nsub=1000, device=dev), True),
    "VST parametric": (lambda dt, d, dev:
                       dt.variance_stabilizing_transformation(
                           d, device=dev), True),
    "VST mean": (lambda dt, d, dev: dt.variance_stabilizing_transformation(
        d, fit_type="mean", device=dev), True),
    "VST local": (lambda dt, d, dev: dt.variance_stabilizing_transformation(
        d, fit_type="local", device=dev), True),
    "rlog": (lambda dt, d, dev: dt.rlog(d, device=dev), True),
    "normTransform": (lambda dt, d, dev: dt.norm_transform(d, device=dev),
                      False),
}


def _k_launches(launches):
    """K1, K2 and K3 launches of a call, over every mode and route."""
    return tuple(sum(v for k, v in launches.items() if k.startswith(pre))
                 for pre in ("irls", "disp_ls", "disp_grid"))


def transform_call(torch, name, fn, blind, g):
    """One public transform call, warm (after a first call): timed to its
    payload on the card with the counters zeroed just before and read just
    after, the K2/K3 calls recorded and the peak device memory read; then
    timed again including .matrix's download.  Fails if the output is
    malformed or a blind call launched K1 or no K2."""
    from deseq2_tpu_torch.ops import checks
    fn()
    torch.cuda.synchronize()
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with checks.recorded_disp_calls() as calls:
        t = fn()
        torch.cuda.synchronize()
    dev_s = time.perf_counter() - t0
    launches = {k: v for k, v in read_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if not torch.is_tensor(t.matrix_device) or not t.matrix_device.is_cuda:
        raise SystemExit(f"transform {name}: the payload is not on the card")
    dtype = str(t.matrix_device.dtype).replace("torch.", "")
    del t
    t0 = time.perf_counter()
    m = fn().matrix
    host_s = time.perf_counter() - t0
    k1, k2, k3 = _k_launches(launches)
    log(f"  {name}: {dev_s:.3f} s to the payload ({dtype}), {host_s:.3f} s "
        f"with the download, peak device memory {peak:.2f} GiB, launches "
        f"K1 {k1} K2 {k2} K3 {k3}, finite {np.isfinite(m).mean():.4f}")
    if m.shape != (g, S_MAIN) or not np.isfinite(m).all():
        raise SystemExit(f"transform {name}: output malformed")
    if blind and (k1 or not k2):
        raise SystemExit(f"blind transform {name} launched K1 {k1} and K2 "
                         f"{k2} times: its dispersion step must run K2 and "
                         f"no GLM fit")
    return dict(device_s=dev_s, with_download_s=host_s, peak_gib=peak,
                dtype=dtype, launches=launches), calls


def transform_phase(torch):
    """Phase 9's timed calls at 60,000 x 1,024 (module docstring); returns
    the summary and the recorded K2 and K3 calls at p = 1."""
    import deseq2_tpu_torch as dt
    from deseq2_tpu_torch.plots import plot_pca_data
    counts, _ = make_inputs(G_MAIN, S_MAIN)
    out, rec = {}, {}
    dds = transform_dataset(counts)
    for name, (fn, blind) in TRANSFORMS.items():
        out[name], calls = transform_call(
            torch, name, functools.partial(fn, dt, dds, None), blind, G_MAIN)
        if name == "VST parametric":
            rec["ls"] = calls["ls"][0]
        if calls["grid"]:
            rec.setdefault("grid", (calls["grid"][0], name))
    for name in ("VST parametric", "rlog"):
        fn, blind = TRANSFORMS[name]
        out[name + ", float32"], _ = transform_call(
            torch, name + ", float32", functools.partial(
                fn, dt, transform_dataset(counts, "float32"), None), blind,
            G_MAIN)
    if "grid" not in rec:
        name = "VST parametric, maxit_disp = 10"
        out[name], calls = transform_call(
            torch, name, functools.partial(
                TRANSFORMS["VST parametric"][0], dt,
                transform_dataset(counts, maxit_disp=10), None), True,
            G_MAIN)
        if not calls["grid"]:
            raise SystemExit("no transform call launched K3")
        rec["grid"] = (calls["grid"][0], name)
    from deseq2_tpu_torch import profiling
    for name in ("VST parametric", "rlog"):
        profiling.reset()
        profiling.enable()
        TRANSFORMS[name][0](dt, dds, None).matrix
        profiling.disable()
        log(f"  {name} stage timings (one more call, timers synchronize):")
        for line in profiling.report().splitlines():
            log(f"    {line}")
    _, fit = public_run(torch, counts, "float32")
    out["VST of a float32 fit, blind=False"], _ = transform_call(
        torch, "VST of a float32 fit, blind=False",
        lambda: dt.variance_stabilizing_transformation(fit, blind=False),
        False, G_MAIN)
    del fit
    vsd = TRANSFORMS["VST parametric"][0](dt, dds, None)
    plot_pca_data(vsd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pca = plot_pca_data(vsd)
    pca_s = time.perf_counter() - t0
    if not torch.is_tensor(vsd.matrix_device) or pca["x"].shape != (S_MAIN,):
        raise SystemExit("plot_pca_data downloaded the payload or failed")
    out["plot_pca_data"] = dict(host_s=pca_s)
    log(f"  plot_pca_data on the VST payload: {pca_s:.3f} s (the payload "
        f"stays on the card; PC1 {pca['percent_var'][0]:.4f} of the "
        f"variance)")
    return out, rec


def p1_timings(torch, rec, out):
    """K2 and K3 at p = 1 in float64 on the inputs the transforms' blind
    dispersion step handed them (recorded in phase 9): held against their
    plain versions with phase 3's float64 readings, then timed beside them
    and their bound.  `launches`: the recording call's count."""
    from deseq2_tpu_torch.ops import checks, disp
    from deseq2_tpu_torch.ops.cuda_grid import fit_disp_grid
    from deseq2_tpu_torch.ops.cuda_ls import fit_disp_line_search
    P, it, dname = 1, 8, "float64"
    rows, failed = [], []
    for kind, call, src_name in (("ls", rec["ls"], "VST parametric"),
                                 ("grid",) + rec["grid"]):
        a, kw = call
        Gn, S = a[2].shape
        if kind == "ls":
            kern, plain = fit_disp_line_search, \
                disp.fit_disp_line_search_plain
            name, src, rep = ("disp_ls_p1_f64", "disp_ls.cu",
                              "deseq2_tpu/ops/pallas_ls.py:409")
        else:
            kern, plain = fit_disp_grid, disp.fit_disp_grid_plain
            name, src, rep = ("disp_grid_p1_f64", "disp_grid.cu",
                              "deseq2_tpu/ops/pallas_disp.py:244")
        k, pl = kern(*a, **kw), plain(*a, **kw)
        d, use_prior, prior_var = checks.recorded_case(kind, call)
        r = (checks.check_ls if kind == "ls" else checks.check_grid)(
            k, pl, d, use_prior, prior_var=prior_var)
        ms = time_ms(torch, lambda: kern(*a, **kw), 3)
        pms = time_ms(torch, lambda: plain(*a, **kw), 1)
        if kind == "ls":
            evals = float((k["iter"].double() + 1).sum())
            b, by = bound(it * (2 * Gn * S + S * P + 2 * Gn + 8 * Gn),
                          evals * (S * ops_ls(P) + ops_ls_point(P)), dname)
            note = f"{evals / Gn:.1f} line-search evaluations/gene"
        else:
            n_grid = a[3].numel()
            b, by = bound(it * (2 * Gn * S + S * P + 2 * Gn + n_grid),
                          2.0 * Gn * n_grid * (S * ops_grid(P)
                                               + ops_grid_point(P)), dname)
            note = f"{Gn} genes on the grid"
        launches = _k_launches(out[src_name]["launches"])[
            1 if kind == "ls" else 2]
        log(f"  {name} ({src_name}'s call, {note}): {fmt(r)}; {ms:.3f} ms "
            f"(plain {pms:.1f} ms, bound {b:.3f} ms by {by}), launches "
            f"{launches}")
        if not r["ok"]:
            failed.append(name)
        rows.append(dict(name=name, route="cuda",
                         source=f"deseq2_tpu_torch/csrc/{src}", replaces=rep,
                         launches=launches, max_abs_err=r["max_abs_err"],
                         ms=ms, plain_ms=pms, bound_ms=b, bound_by=by,
                         library_ms=None))
    if failed:
        raise SystemExit(f"p = 1 kernel checks failed: {failed}")
    return rows


def transform_gates(torch):
    """Phase 9's gates on the 2,048 x 1,024 gate slice: each transform on
    the card (float64, then a float32 payload) against the port in float64
    on the CPU, limits ops/checks.py:TRANSFORM_TOL; and plot_pca_data's
    coordinates on the float32 VST payload against those of the CPU's."""
    import deseq2_tpu_torch as dt
    from deseq2_tpu_torch.ops import checks
    from deseq2_tpu_torch.plots import plot_pca_data
    sub, _ = gate_inputs(G_GATE, S_MAIN)
    t0 = time.perf_counter()
    cpu = {name: fn(dt, transform_dataset(sub), "cpu")
           for name, (fn, _) in TRANSFORMS.items()}
    log(f"  the transforms on the CPU: {time.perf_counter() - t0:.1f} s")
    out, failed = {}, []
    for dname in ("float64", "float32"):
        for name, (fn, _) in TRANSFORMS.items():
            card = fn(dt, transform_dataset(sub, dname), None)
            err = float(np.max(np.abs(card.matrix - cpu[name].matrix)))
            tol = checks.TRANSFORM_TOL[
                "rlog_float64" if name == "rlog" and dname == "float64"
                else dname]
            out[f"{name}, {dname}"] = err
            log(f"  {name} {dname} on the card vs float64 on the CPU: max "
                f"|diff| {err:.3g} (limit {tol:g})")
            if not err <= tol:
                failed.append(f"{name} {dname}")
    vsd32 = TRANSFORMS["VST parametric"][0](
        dt, transform_dataset(sub, "float32"), None)
    want = plot_pca_data(dt.DESeqTransform(
        cpu["VST parametric"].matrix, vsd32.col_data, vsd32.row_names,
        vsd32.col_names))
    got = plot_pca_data(vsd32)
    pca = max(min(np.max(np.abs(got[k] - want[k])),
                  np.max(np.abs(got[k] + want[k]))) / np.max(np.abs(want[k]))
              for k in ("x", "y"))
    out["plot_pca_data, float32, relative"] = float(pca)
    log(f"  plot_pca_data on the float32 VST payload vs the CPU's: largest "
        f"coordinate difference up to sign {pca:.3g} of the largest "
        f"coordinate (limit {checks.TRANSFORM_TOL['float32']:g})")
    if not pca <= checks.TRANSFORM_TOL["float32"]:
        failed.append("plot_pca_data float32")
    if failed:
        raise SystemExit(f"transform gates failed: {failed}")
    return out


# ---------------------------------------------------------------------------
# phase 10: the single-cell path
# ---------------------------------------------------------------------------

G_SC, S_SC = 30000, 50000       # bench.py:main_sc's configuration
G_SC_GATE, S_SC_GATE = 2048, 4096


def sc_counts(torch):
    """bench.py:main_sc's counts at 30,000 x 50,000, made on the card
    (deseq2_tpu_torch/ops/checks.py:sc_bench_counts, seed 0)."""
    from deseq2_tpu_torch.ops import checks
    t0 = time.perf_counter()
    counts, cells = checks.sc_bench_counts(G_SC, S_SC, "cuda")
    torch.cuda.synchronize()
    log(f"  counts made on the card in {time.perf_counter() - t0:.2f} s: "
        f"{G_SC} x {S_SC} int32 ({counts.numel() * 4 / 1e9:.2f} GB), "
        f"largest count {int(counts.max())}")
    return counts, cells


def sc_call(torch, name, counts, profiled=False, **kw):
    """One float32 fused_sc_results call at full width with the stage
    timers on (they synchronize the card at each stage's ends; off under
    the profiler): wall seconds, genes/s, peak device memory, the chunk,
    the histogram overflow count, the stage table; with `profiled`, under torch.profiler for the device's busy
    share.  Fails on a malformed result."""
    from torch.profiler import ProfilerActivity, profile

    from deseq2_tpu_torch import profiling
    from deseq2_tpu_torch.parallel.sc import fused_sc_results
    info = {}
    profiling.reset()
    if not profiled:
        profiling.enable()
    torch.cuda.reset_peak_memory_stats()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
        if profiled else None
    if prof is not None:
        prof.__enter__()
    t0 = time.perf_counter()
    out = fused_sc_results(counts, size_factors=np.ones(S_SC), device="cuda",
                           dtype=torch.float32, info=info, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    profiling.disable()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    stat, padj = np.asarray(out["stat"]), np.asarray(out["padj"])
    r = dict(wall_s=wall, genes_per_s=G_SC / wall, peak_gib=peak,
             chunk=info["chunk"], n_chunks=info["n_chunks"],
             hist=info["use_hist"],
             hist_overflow_genes=info["hist_overflow_genes"],
             rejections=int(np.sum(padj < 0.1)))
    if profiled:
        busy_s, rows = device_busy(prof)
        r.update(device_busy_s=busy_s if rows else None,
                 busy_share=busy_s / wall if rows else None)
        log(f"  {name}, profiled: wall {wall:.3f} s, device kernel time "
            f"{busy_s:.3f} s, busy share {busy_s / wall:.3f}" if rows else
            f"  {name}, profiled: wall {wall:.3f} s, device time not "
            f"measured (the profiler recorded no device kernels)")
        for us, n, key in rows[:8]:
            log(f"    {us / 1e3:9.2f} ms  x{n:<6d} {key[:80]}")
    else:
        log(f"  {name}: {wall:.3f} s = {G_SC / wall:,.0f} genes/s, peak "
            f"device memory {peak:.2f} GiB, chunk {info['chunk']} "
            f"({info['n_chunks']} chunks), histogram {info['use_hist']} "
            f"(overflow genes {info['hist_overflow_genes']}), finite stat "
            f"{np.isfinite(stat).mean():.4f}, rejections {r['rejections']}")
        r["stages"] = {x["stage"]: x["seconds"] for x in profiling.records()}
        for line in profiling.report().splitlines():
            log(f"    {line}")
    if stat.shape != (G_SC,) or np.isfinite(stat).mean() <= 0.9 \
            or not np.isfinite(padj).any():
        raise SystemExit(f"single-cell call {name}: output malformed")
    return r


def sc_phase(torch):
    """Phase 10a-d: the group QL call (cold, warm, profiled), the
    covariate QL call ~ batch + condition against ~ batch (warm), the
    parametric Wald call (warm), and the public route: a dataset of the
    same counts, deseq(test="LRT", reduced="~ 1", fit_type="glmGamPoi") +
    results(), which must take the streamed route (engine "fused-sc")."""
    import deseq2_tpu_torch as dt
    counts, cells = sc_counts(torch)
    out = {}
    batch = ((np.arange(S_SC) // 2) % 2).astype(np.float64)
    design = np.column_stack([np.ones(S_SC), batch, cells.astype(float)])
    calls = {"group_ql": dict(cells=cells, n_groups=2, test="LRT",
                              fit_type="glmGamPoi"),
             "covariate_ql": dict(design=design, reduced_design=design[:, :2],
                                  test="LRT", fit_type="glmGamPoi")}
    for key, kw in calls.items():
        if key == "covariate_ql":
            # warm only: the script's time limit (the group call reads
            # the cold call and the busy share)
            out[key] = sc_call(torch, f"{key} warm", counts, **kw)
            continue
        t0 = time.perf_counter()
        sc_call(torch, f"{key} cold", counts, **kw)
        cold = time.perf_counter() - t0
        out[key] = sc_call(torch, f"{key} warm", counts, **kw)
        out[key]["cold_s"] = cold
        out[key].update({k: v for k, v in sc_call(
            torch, key, counts, profiled=True, **kw).items()
            if k in ("device_busy_s", "busy_share")})
    out["wald"] = sc_call(torch, "group Wald (parametric) warm", counts,
                          cells=cells, n_groups=2, test="Wald",
                          fit_type="parametric")
    # the public route
    t0 = time.perf_counter()
    host = counts.cpu().numpy()
    fetch = time.perf_counter() - t0
    labels = np.where(cells == 0, "A", "B")
    del counts
    t0 = time.perf_counter()
    dds = dt.dataset_from_matrix(host, {"condition": labels}, "~ condition",
                                 config=dt.DESeqConfig(dtype="float32"))
    dds.size_factors = np.ones(S_SC)
    build = time.perf_counter() - t0
    runs = []
    for _ in range(2):      # deseq() copies the dataset: cold, then warm
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        fit = dt.deseq(dds, test="LRT", reduced="~ 1", fit_type="glmGamPoi")
        res = dt.results(fit)
        padj = np.asarray(res["padj"])
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0,
                     torch.cuda.max_memory_allocated() / 2 ** 30))
        if fit.attrs.get("engine") != "fused-sc":
            raise SystemExit("the public glmGamPoi LRT did not take the "
                             f"streamed route: {fit.attrs.get('engine')}")
        del fit
    del dds
    warm, peak = runs[-1]
    out["public"] = dict(fetch_counts_s=fetch, dataset_s=build,
                         deseq_results_s=warm, cold_s=runs[0][0],
                         genes_per_s=G_SC / warm, peak_gib=peak,
                         engine="fused-sc",
                         rejections=int(np.nansum(padj < 0.1)))
    log(f"  public deseq(fit_type='glmGamPoi', test='LRT') + results(): "
        f"engine fused-sc, counts to the host {fetch:.2f} s, "
        f"dataset_from_matrix {build:.2f} s, deseq() + results() cold "
        f"{runs[0][0]:.3f} s, warm {warm:.3f} s = {G_SC / warm:,.0f} "
        f"genes/s, peak device memory {peak:.2f} GiB, rejections "
        f"{out['public']['rejections']}")
    if padj.shape != (G_SC,) or not np.isfinite(padj).any():
        raise SystemExit("public glmGamPoi results malformed")
    return out


def sc_host_phase(torch):
    """Phase 10e: the host engine's glmGamPoi at 60,000 x 1,024 in float64
    on the main path's counts: the LRT of ~ condition against ~ 1 (K1 for
    the full fit at minmu = 1e-6, the reduced model in closed form, K2
    for the gene-wise estimate), the LRT of ~ batch + condition against
    ~ batch (K1 for the gene-wise estimate's mu and both fits), and the
    Wald test through "auto" (the host engine, the JAX package's route).
    Returns the phase's numbers and the K1 calls the first LRT made."""
    from deseq2_tpu_torch.ops import checks
    counts, _ = make_inputs(G_MAIN, S_MAIN)
    out = {}
    with checks.recorded_disp_calls() as rec:
        out["lrt"], _, _ = host_call(
            torch, "glmGamPoi LRT ~ condition vs ~ 1, engine='host'",
            counts, ("irls", "disp_ls"), engine="host", test="LRT",
            reduced="~ 1", fit_type="glmGamPoi")
    irls_calls = list(rec["irls"])
    del rec
    out["lrt_batch"], _, _ = host_call(
        torch, "glmGamPoi LRT ~ batch + condition vs ~ batch, engine='host'",
        counts, ("irls", "disp_ls"), engine="host", test="LRT",
        reduced="~ batch", fit_type="glmGamPoi", design="~ batch + condition")
    out["wald"], _, wfit = host_call(
        torch, "glmGamPoi Wald, 'auto'", counts, ("irls", "disp_ls"),
        fit_type="glmGamPoi")
    if wfit.attrs.get("engine") != "host":
        raise SystemExit("glmGamPoi Wald through 'auto' did not run the "
                         "host engine")
    if out["lrt"]["launches"]["irls"] < 1 \
            or out["lrt_batch"]["launches"]["irls"] < 2:
        raise SystemExit(f"host glmGamPoi LRT K1 launches: "
                         f"{out['lrt']['launches']}, "
                         f"{out['lrt_batch']['launches']}")
    return out, irls_calls


def min_mu_k1_timing(torch, dev, calls, launches, worst):
    """K1 at minmu = 1e-6 on the inputs the host glmGamPoi LRT handed it
    (its full fit, 60,000 x 1,024, p = 2, alpha at the trend): held
    against its plain version (phase 3's readings and limits), then timed
    beside it and its bound, in float64 (the host engine's dtype) and in
    float32 (the same inputs cast).  And K1 at minmu = 1e-6 at
    checks.SHAPES, p = 2 and 3, both dtypes, on inputs whose first
    ten genes count zero in one group (checks.check_irls_min_mu: float32
    gated off those ten genes, where it misses TOL; there both float32
    fits are read against the float64 plain fit)."""
    from deseq2_tpu_torch.ops import checks, irls
    from deseq2_tpu_torch.ops.cuda_irls import fit_beta
    failed = []
    for dname in ("float64", "float32"):
        dt = getattr(torch, dname)
        for p in (2, 3):
            for S, G in checks.SHAPES:
                inputs = checks.zero_group_inputs(G, S, p, 7 * p + S)
                d = checks.as_tensors(inputs, dt, dev)
                k = checks.run_irls(fit_beta, d, min_mu=checks.MIN_MU_QL)
                pl = checks.run_irls(irls.fit_beta_plain, d,
                                     min_mu=checks.MIN_MU_QL)
                d64 = checks.as_tensors(inputs, torch.float64, dev)
                ref = None if dname == "float64" else checks.run_irls(
                    irls.fit_beta_plain, d64, min_mu=checks.MIN_MU_QL)
                r = checks.check_irls_min_mu(k, pl, ref, d64)
                key = f"irls_min_mu_{dname}"
                worst[key] = max(worst.get(key, 0.0), r["max_abs_err"])
                log(f"  irls minmu=1e-6 {dname} p={p} S={S} G={G}: "
                    f"{fmt(r)}")
                if not r["ok"]:
                    failed.append(f"{dname} p={p} S={S}")
    if len(calls) != 1:
        raise SystemExit(f"the host QL LRT made {len(calls)} K1 calls, "
                         "expected its full fit's one")
    a, kw = calls[0]
    G, S = a[0].shape
    P = a[1].shape[1]
    rows, f64_pl, f32 = [], None, None
    for dname in ("float64", "float32"):
        dt = getattr(torch, dname)
        args = tuple(t.to(dt) for t in a)
        k1 = fit_beta(*args, **kw)
        pl = irls.fit_beta_plain(*args, **kw)
        r = checks.check_irls(k1, pl)
        if dname == "float32":
            # printed beside the gated reading: both float32 fits held to
            # the float64 plain fit
            r64 = checks.check_irls_f64(k1, pl, f64_pl)
            log(f"  irls minmu=1e-6 float32 against the float64 fit: "
                f"{fmt(r64)}")
        f64_pl = pl
        log(f"  irls minmu=1e-6 {dname} at the host QL LRT's full fit "
            f"({G} x {S}, p = {P}): {fmt(r)}")
        if not r["ok"]:
            failed.append(f"{dname} main shape")
        ms = time_ms(torch, lambda: fit_beta(*args, **kw), 3)
        pms = time_ms(torch, lambda: irls.fit_beta_plain(*args, **kw), 1)
        sweeps = float(k1["iter"].double().sum())
        o = ops_irls(P)
        it = 4 if dname == "float32" else 8
        nf_el = a[2].numel()
        b1, by1 = bound(it * (3 * G * S + nf_el + S * P + G * (1 + 3 * P)
                              + 2 * G),
                        S * (G * (o["init"] + o["post"])
                             + sweeps * o["sweep"]), dname)
        log(f"  irls minmu=1e-6 {dname}: {ms:.3f} ms (plain {pms:.1f} ms, "
            f"bound {b1:.3f} ms by {by1}, {100 * b1 / ms:.1f}% of it), "
            f"{sweeps / G:.2f} sweeps/gene, the LRT's launches {launches}")
        row = dict(name="irls_min_mu_f64", route="cuda",
                   source="deseq2_tpu_torch/csrc/irls.cu",
                   replaces="deseq2_tpu/ops/pallas_irls.py:360",
                   launches=launches,
                   max_abs_err=max(worst[f"irls_min_mu_{dname}"],
                                   r["max_abs_err"]),
                   ms=ms, plain_ms=pms, bound_ms=b1, bound_by=by1,
                   library_ms=None)
        if dname == "float64":
            rows.append(row)
        else:
            # the float32 instantiation on the same inputs: no path of
            # this run launches it at minmu = 1e-6 (the host engine fits
            # in float64), so it is logged, not a row of the kernels line
            f32 = {k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by")}
    if failed:
        raise SystemExit(f"K1 at minmu = 1e-6 failed: {failed}")
    return rows, f32


def sc_gates(torch):
    """Phase 10f: bench.py's single-cell gates (sc_accuracy_gate,
    sc_covariate_accuracy_gate) on their 2,048 x 4,096 fixtures: the port
    in float32 on the card against the port in float64 on the CPU, the
    histogram order matched (checks.sc_gate, bench.py's limits); and the
    host glmGamPoi LRT on the 2,048 x 1,024 gate slice on the card
    against the CPU (Jaccard >= 0.995, zero flips, |dLFC| < 0.01)."""
    from deseq2_tpu_torch.ops import checks
    from deseq2_tpu_torch.parallel.sc import fused_sc_results
    out, failed = {}, []
    for name in ("group", "covariate"):
        if name == "group":
            c, cells, sf = checks.sc_gate_inputs(G_SC_GATE, S_SC_GATE)
            kw = dict(cells=cells, n_groups=2)
        else:
            c, x, red, sf = checks.sc_cov_gate_inputs(G_SC_GATE, S_SC_GATE)
            kw = dict(design=x, reduced_design=red)
        run = dict(size_factors=sf, test="LRT", fit_type="glmGamPoi", **kw)
        card = fused_sc_results(c, device="cuda", dtype=torch.float32, **run)
        t0 = time.perf_counter()
        cpu = fused_sc_results(c, device="cpu", dtype=torch.float64,
                               use_hist=True, **run)
        r = checks.sc_gate(card, cpu)
        out[name] = r
        log(f"  {name} QL gate (float32 card vs float64 CPU, CPU "
            f"{time.perf_counter() - t0:.1f} s): {json.dumps(r)}")
        if not r["ok"]:
            failed.append(name)
    sub, _ = gate_inputs(G_GATE, S_MAIN)
    kw = dict(engine="host", test="LRT", reduced="~ 1",
              fit_type="glmGamPoi")
    card, _ = public_run(torch, sub, "float64", **kw)
    cpu, _ = public_run(torch, sub, "float64", device="cpu", **kw)
    gate, ok = gate_compare(card, cpu)
    out["host_ql"] = gate
    log(f"  host glmGamPoi LRT, card vs CPU: {json.dumps(gate)}")
    failed += [f"host_ql {k}" for k in ("jaccard", "flips", "lfc")
               if not ok[k]]
    if failed:
        raise SystemExit(f"single-cell gates failed: {failed}")
    return out


# ---------------------------------------------------------------------------
# phase 11: the gene mesh
# ---------------------------------------------------------------------------

# the per-gene columns of a fit and its results table held against the
# single-device run in float64 (tests/test_sharding.py's limits)
MESH_RTOL, MESH_ATOL = 1e-8, 1e-10


def mesh_devices(torch):
    """The phase's mesh: the visible cards, up to 4, or on a one-card
    machine 4 shards on cuda:0 (the shards then split the work without
    adding a device)."""
    n = torch.cuda.device_count()
    if n >= 2:
        devs = [torch.device("cuda", i) for i in range(min(n, 4))]
        return devs, f"{len(devs)} cards"
    return [torch.device("cuda", 0)] * 4, "4 shards on cuda:0 (one card)"


def busy_by_device(prof):
    """Kernel seconds per card index in a torch.profiler run."""
    busy = {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            i = getattr(e, "device_index", 0)
            busy[i] = busy.get(i, 0.0) + e.time_range.elapsed_us() / 1e6
    return busy


def mesh_timed(torch, name, devs, fn, warm_up=True, profiled=True):
    """fn() once, warm (after a first call unless `warm_up` is False: the
    earlier phases warmed its path), with the counters zeroed just before
    it and read just after: wall seconds, peak device memory per card,
    launches per kernel and per device; with `profiled` once more under
    torch.profiler for each card's busy share.  Returns the record and the
    warm call's result."""
    from torch.profiler import ProfilerActivity, profile
    cards = sorted({d.index for d in devs})
    if warm_up:
        fn()
    zero_counts()
    for i in cards:
        torch.cuda.reset_peak_memory_stats(i)
    t0 = time.perf_counter()
    result = fn()
    for i in cards:
        torch.cuda.synchronize(i)
    wall = time.perf_counter() - t0
    r = dict(wall_s=wall, peak_gib={
        f"cuda:{i}": torch.cuda.max_memory_allocated(i) / 2 ** 30
        for i in cards},
        launches={k: v for k, v in read_counts().items() if v},
        launches_by_device=read_counts_by_device())
    busy = None
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            for i in cards:
                torch.cuda.synchronize(i)
            pwall = time.perf_counter() - t0
        busy = busy_by_device(prof)
        r["profiled_wall_s"] = pwall
        r["busy_share"] = {f"cuda:{i}": busy.get(i, 0.0) / pwall
                           for i in cards} if busy else None
    log(f"  {name}: warm {wall:.3f} s, peak device memory "
        f"{', '.join(f'{k} {v:.2f} GiB' for k, v in r['peak_gib'].items())}"
        f", launches {r['launches']}, by device {r['launches_by_device']}"
        + (f", busy share {r['busy_share']} of a {pwall:.3f} s profiled "
           "call" if busy else ", busy share not measured" if profiled
           else ""))
    return r, result


def need_launches(r, devs, kernels, name):
    """Fails unless every mesh card launched each of `kernels`."""
    missing = [(k, str(d)) for k in kernels for d in devs
               if not r["launches_by_device"][k].get(str(d))]
    if missing:
        raise SystemExit(f"{name}: no launches of {missing}")


def fit_columns(fit, res):
    """A public fit's per-gene columns (row_data, results) and cross-gene
    scalars, as float64 arrays."""
    cols = {}
    for k in list(fit.row_data):
        v = np.asarray(fit.row_data[k])
        if v.dtype != object and v.ndim == 1:
            cols[f"row_data {k}"] = v.astype(float)
    for c in res.column_names:
        cols[f"results {c}"] = np.asarray(res[c], float)
    fn = fit.dispersion_function
    cols["dispPriorVar"] = np.atleast_1d(float(fn.disp_prior_var))
    if fn.coefficients is not None:
        cols["trendCoefs"] = np.asarray(fn.coefficients, float)
    if "filterTheta" in res.metadata:
        cols["filterTheta"] = np.atleast_1d(float(res.metadata["filterTheta"]))
    return cols


def same_as_single(got, want, name):
    """float64 gate: every column at MESH_RTOL / MESH_ATOL, equal NaN
    patterns; returns the largest relative difference and the columns
    that failed."""
    worst, bad = 0.0, []
    for k, w in want.items():
        g = got[k]
        fin = np.isfinite(w) & np.isfinite(g)
        if fin.any():
            worst = max(worst, float(np.max(np.abs(g[fin] - w[fin])
                                            / np.maximum(np.abs(w[fin]),
                                                         1e-300))))
        if not np.allclose(g, w, rtol=MESH_RTOL, atol=MESH_ATOL,
                           equal_nan=True):
            bad.append(k)
    log(f"  {name}: largest relative difference from the single-device "
        f"run {worst:.3g} over {len(want)} columns; off at rtol "
        f"{MESH_RTOL:g}: {bad}")
    return worst, bad


def mesh_phase(torch):
    """Phase 11a-c: the main path ~ condition at 60,000 x 1,024 through
    deseq(mesh=...) + results() in float32 and float64, the host engine in
    float64, the paired p = 10 design in float64, and group QL at 30,000 x
    50,000 through fused_sc_results(mesh=...), each against the
    single-device call on the same inputs."""
    from deseq2_tpu_torch.ops import checks
    from deseq2_tpu_torch.parallel import gene_mesh
    from deseq2_tpu_torch.parallel.sc import fused_sc_results
    devs, what = mesh_devices(torch)
    mesh = gene_mesh(devices=devs)
    log(f"  the mesh: {what}, {mesh}")
    counts, _ = make_inputs(G_MAIN, S_MAIN)
    out = dict(mesh=what, shards=len(devs))
    failed = []
    for dname, engine, paired in (("float32", None, False),
                                  ("float64", None, False),
                                  ("float64", "host", False),
                                  ("float64", None, True)):
        key = (f"{dname}{'' if engine is None else ' host engine'}"
               + (" paired p = 10" if paired else ""))
        kw = {} if engine is None else dict(engine=engine)

        def run(**more):
            if paired:
                return paired_run(torch, counts, dname, 10, **kw, **more)
            return public_run(torch, counts, dname, **kw, **more)

        res1, fit1 = run()
        t0 = time.perf_counter()
        run()
        single_s = time.perf_counter() - t0
        r, (res, fit) = mesh_timed(
            torch, f"deseq(mesh) + results() {key}", devs,
            lambda: run(mesh=mesh))
        r["single_wall_s"] = single_s
        log(f"  single-device call {key}: warm {single_s:.3f} s")
        need_launches(r, devs, ("fit_beta", "fit_disp_line_search"), key)
        if dname == "float32" and not r["launches"].get("disp_grid"):
            raise SystemExit(f"{key}: the mesh run launched no K3")
        want, got = fit_columns(fit1, res1), fit_columns(fit, res)
        if dname == "float64":
            r["max_rel"], bad = same_as_single(got, want, key)
            failed += [f"{key} {k}" for k in bad]
        else:
            gate, ok = gate_compare(res, res1)
            r["max_rel"], _ = same_as_single(got, want, key)
            r["gate"] = gate
            log(f"  {key} mesh vs single, bench.py's gates: "
                f"{json.dumps(gate)}")
            failed += [f"{key} {k}" for k in ("jaccard", "flips", "lfc")
                       if not ok[k]]
        out[key] = r
        del fit, fit1, res, res1
    # group QL on the streamed route, phase 10's counts: the single-device
    # float32 and float64 calls, then the mesh's float32 call
    sc, cells = sc_counts(torch)
    kw = dict(cells=cells, n_groups=2, size_factors=np.ones(S_SC),
              test="LRT", fit_type="glmGamPoi", device="cuda")
    t0 = time.perf_counter()
    one = fused_sc_results(sc, dtype=torch.float32, **kw)
    single_s = time.perf_counter() - t0
    one64 = fused_sc_results(sc, dtype=torch.float64, **kw)
    r, got = mesh_timed(
        torch, f"group QL fused_sc_results(mesh) at {G_SC} x {S_SC}, "
        "float32", devs, lambda: fused_sc_results(
            sc, mesh=mesh, dtype=torch.float32, **kw), warm_up=False,
        # the profiler's events of a streamed call take minutes to read
        # (a profiled 4-shard call on one H100: busy share 0.595, PERF.md)
        profiled=False)
    wall = r["wall_s"]
    r.update(single_wall_s=single_s, genes_per_s=G_SC / wall)
    # bench.py's single-cell gates hold a float32 run to a float64 one:
    # the mesh's float32 call to the single-device float64 call, beside
    # the single-device float32 call's own reading
    gate = checks.sc_gate(got, one64)
    base = checks.sc_gate(one, one64)

    def iters_differ(a, b):
        return (a["dispGeneIter"] != b["dispGeneIter"]) \
            & ~(np.isnan(a["dispGeneIter"]) & np.isnan(b["dispGeneIter"]))

    off = np.where(iters_differ(got, one))[0]
    rule = dict(differing_genes=int(off.size))
    if off.size:
        # the iteration-count rule of tests/test_torch_sc.py's straggler
        # test: each differing gene's count also moves with the chunk
        moved = np.zeros(G_SC, bool)
        for m, ref in ((None, one), (mesh, got)):
            moved |= iters_differ(fused_sc_results(
                sc, mesh=m, chunk=4096, dtype=torch.float32, **kw), ref)
        dge, dge1 = got["dispGeneEst"][off], one["dispGeneEst"][off]
        rule.update(moved=int(moved[off].sum()),
                    est_max_rel=float(np.max(np.abs(dge - dge1) / dge1)))
        rule["ok"] = bool(moved[off].all() and off.size <= G_SC // 1000
                          and np.allclose(dge, dge1, rtol=1e-6, atol=0.0))
    else:
        rule["ok"] = True
    r.update(gate=gate, single_gate=base, iteration_rule=rule,
             vs_single_f32=checks.sc_gate(got, one),
             filter_theta=dict(mesh=got["filterTheta"],
                               single_f32=one["filterTheta"],
                               single_f64=one64["filterTheta"]))
    log(f"  group QL: the mesh {G_SC / wall:,.0f} genes/s, the "
        f"single-device call {single_s:.3f} s")
    log(f"  bench.py's single-cell gates, the mesh's float32 call against "
        f"the single-device float64 call: {json.dumps(gate)}; the "
        f"single-device float32 call against it: {json.dumps(base)}; "
        f"the mesh against the single-device float32 call: "
        f"{json.dumps(r['vs_single_f32'])}; filter theta "
        f"{r['filter_theta']}; iteration counts: {rule}")
    if not gate["ok"]:
        failed.append("sc gates")
    if not rule["ok"]:
        failed.append("sc iteration counts")
    out["group_ql"] = r
    del sc
    if failed:
        raise SystemExit(f"gene mesh gates failed: {failed}")
    return out


def mesh_worker(rank, world, port, out_dir, backend):
    """One rank of the multi-process phase (chip_smoke.py --mesh-rank):
    the gate slice through deseq(mesh=...) + results() on the fused route
    and the host engine, float64, over a mesh of one card per rank joined
    by torch.distributed; rank 0 saves the results tables and seconds."""
    import torch
    import torch.distributed as dist

    from deseq2_tpu_torch.parallel import gene_mesh
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = gene_mesh(devices=[dev], process_group=dist.group.WORLD)
        sub, _ = gate_inputs(G_GATE, S_MAIN)
        out = {}
        for engine in ("fused", "host"):
            public_run(torch, sub, "float64", engine=engine, mesh=mesh)
            t0 = time.perf_counter()
            res, _ = public_run(torch, sub, "float64", engine=engine,
                                mesh=mesh)
            out[f"{engine} seconds"] = np.array(time.perf_counter() - t0)
            for c in res.column_names:
                out[f"{engine} {c}"] = np.asarray(res[c], float)
        if rank == 0:
            np.savez(f"{out_dir}/result.npz", **out)
    finally:
        dist.destroy_process_group()


def multiprocess_phase(torch):
    """Phase 11d: two processes through torch.distributed on the 2,048 x
    1,024 gate slice (NCCL with a card per rank, gloo through host memory
    when both share one card, which NCCL refuses), against this process's
    single-device runs at MESH_RTOL."""
    import socket
    import tempfile

    from deseq2_tpu_torch.ops import build
    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out_dir = tempfile.mkdtemp(prefix="mesh_mp_", dir=build.BUILD_DIR)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--mesh-rank", str(rank), "2", str(port),
         out_dir, backend], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise SystemExit(f"multi-process rank {rank} failed "
                             f"({p.returncode}): {text[-3000:]}")
    got = dict(np.load(f"{out_dir}/result.npz"))
    sub, _ = gate_inputs(G_GATE, S_MAIN)
    want = {}
    for engine in ("fused", "host"):
        res, _ = public_run(torch, sub, "float64", engine=engine)
        for c in res.column_names:
            want[f"{engine} {c}"] = np.asarray(res[c], float)
    worst, bad = same_as_single({k: got[k] for k in want}, want,
                                f"two processes over {backend}")
    r = dict(backend=backend, processes_wall_s=wall,
             fused_s=float(got["fused seconds"]),
             host_s=float(got["host seconds"]), max_rel=worst)
    log(f"  two processes ({backend}, {G_GATE} x {S_MAIN}, float64): "
        f"processes {wall:.1f} s in all, warm fused call "
        f"{r['fused_s']:.3f} s, host engine {r['host_s']:.3f} s")
    if bad:
        raise SystemExit(f"multi-process mesh differs: {bad}")
    return r


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    smi = smi_line()
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s), "
        f"Python {sys.version.split()[0]}")
    dev = torch.device("cuda", 0)
    seconds = {}

    def phase(key, title):
        log(title)
        seconds[key] = time.perf_counter()

    def done(key):
        seconds[key] = time.perf_counter() - seconds[key]
        log(f"  phase {key}: {seconds[key]:.1f} s")

    from deseq2_tpu_torch.ops import build
    phase("2", "[2] build the kernels")
    logs = build.build_all()
    log(f"  built {list(logs)}")
    for name, text in logs.items():
        log(f"  {name}: {ptxas_summary(text)}")
    resources = kernel_resources()
    done("2")

    phase("3", "[3] kernels vs plain versions on the card")
    worst = check_kernels(torch, dev)
    if torch.cuda.device_count() >= 2:
        check_second_card(torch)
    done("3")

    phase("4", f"[4] main path: deseq() + results() at {G_MAIN} x {S_MAIN}")
    main_out = main_path(torch)
    main_out["float32"].update(stage_breakdown(torch))
    for name in ("weights", "lrt_nf"):
        main_out[name] = variant_path(torch, name)
    main_out["local_trend"] = local_trend_dtype(torch, dev)
    done("4")

    phase("5", f"[5] accuracy gates at {G_GATE} x {S_MAIN}")
    gate = accuracy_gate(torch)
    gates = variant_gates(torch)
    done("5")

    phase("6", "[6] kernel timings at the main path's shapes (float32)")
    rows = kernel_timings(torch, dev, main_out["launches"], worst)
    rows += kernel_timings(torch, dev, main_out["weights"]["launches"],
                           worst, weighted=True)
    done("6")

    phase("7", f"[7] betaPrior, contrasts and shrinkage at {G_MAIN} x "
          f"{S_MAIN}")
    prior_out, bp_fit = prior_phase(torch)
    prior_out["gates"] = prior_gates(torch)
    exp_rows, prior_out["irls_expanded_f64"] = expanded_k1_timing(
        torch, dev, bp_fit,
        prior_out["deseq(beta_prior=True) + results()"]["k1_launches"], worst)
    rows += exp_rows
    done("7")

    phase("8", f"[8] host engine at {G_MAIN} x {S_MAIN}")
    host_out = host_phase(torch)
    host_out["gates"] = host_gates(torch)
    mode_launches = {}
    for key in ("no_cr", "no_cr_weighted", "threshold"):
        mode_launches.update(host_out[key]["launches"])
    rows += mode_timings(torch, dev, mode_launches, worst)
    host_out["paired"] = paired_phase(torch)
    host_out["paired"]["gates"] = paired_gates(torch)
    for dname in ("float64", "float32"):
        # the wide rows stand for the p = 10 fused call of their dtype and
        # carry its warm call's launches (the other paired calls' launches
        # are on their own log lines)
        rows += kernel_timings(torch, dev,
                               host_out["paired"][f"p10 {dname}"]["launches"],
                               worst, dname=dname, x_np=paired_x(S_MAIN, 10))
    done("8")

    phase("9", f"[9] transforms at {G_MAIN} x {S_MAIN}")
    transform_out, rec = transform_phase(torch)
    rows += p1_timings(torch, rec, transform_out)
    del rec
    transform_out["gates"] = transform_gates(torch)
    done("9")

    phase("10", f"[10] the single-cell path at {G_SC} x {S_SC}")
    sc_out = sc_phase(torch)
    sc_out["host"], irls_calls = sc_host_phase(torch)
    mm_rows, sc_out["irls_min_mu_f32"] = min_mu_k1_timing(
        torch, dev, irls_calls, sc_out["host"]["lrt"]["launches"]["irls"],
        worst)
    rows += mm_rows
    del irls_calls
    sc_out["gates"] = sc_gates(torch)
    done("10")

    phase("11", "[11] gene mesh at full width")
    mesh_out = mesh_phase(torch)
    mesh_out["two_processes"] = multiprocess_phase(torch)
    done("11")

    log(json.dumps({"main_path": {k: v for k, v in main_out.items()},
                    "gate": gate, "variant_gates": gates,
                    "prior_phase": prior_out, "host_phase": host_out,
                    "transform_phase": transform_out, "sc_phase": sc_out,
                    "mesh_phase": mesh_out,
                    "kernel_resources": resources, "phase_seconds": seconds}))
    print(json.dumps({"kernels": rows}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        mesh_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                    sys.argv[5], sys.argv[6])
    else:
        main()
