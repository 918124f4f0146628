"""Measurements on the card behind choices recorded in PERF.md and
ROADMAP.md:

    python -m deseq2_tpu_torch.ops.studies eigvalsh
    python -m deseq2_tpu_torch.ops.studies ls [N_SEEDS]
    python -m deseq2_tpu_torch.ops.studies kernels PARENT_ROOT [REPS]
    python -m deseq2_tpu_torch.ops.studies k2 PARENT_ROOT[,ROOT...] [REPS [P:DTYPE ...]]
    python -m deseq2_tpu_torch.ops.studies k1 PARENT_ROOT[,ROOT...] [REPS [P:DTYPE ...]]
    python -m deseq2_tpu_torch.ops.studies k3 PARENT_ROOT[,ROOT...] [REPS [P:DTYPE[:w|nocr] ...]]
    python -m deseq2_tpu_torch.ops.studies edges [N_PERM [wide]]
    python -m deseq2_tpu_torch.ops.studies expanded
    python -m deseq2_tpu_torch.ops.studies mainpath PARENT_ROOT [CALLS]
    python -m deseq2_tpu_torch.ops.studies wide [REPS]
    python -m deseq2_tpu_torch.ops.studies block [REPS]
    python -m deseq2_tpu_torch.ops.studies crossover [REPS]
    python -m deseq2_tpu_torch.ops.studies variant smem|minp [REPS]
    python -m deseq2_tpu_torch.ops.studies phases [k1|k3 [ROOT]]
    python -m deseq2_tpu_torch.ops.studies paired PARENT_ROOT [P [CALLS [DTYPE [ENGINE]]]]
    python -m deseq2_tpu_torch.ops.studies rlog [N_SEEDS]
    python -m deseq2_tpu_torch.ops.studies sc [G S]
    python -m deseq2_tpu_torch.ops.studies batch_rows

`eigvalsh`: the largest batch of symmetric n x n matrices that
torch.linalg.eigvalsh takes on the card, per dtype and n, found by
bisection on finite, well-conditioned matrices (so a refusal cannot come
from the data), and the time and peak memory of the (60,000, n, n) float64
eigenvalues in chunks of several sizes on the card, against LAPACK on the
host.

`ls`: the float32 line search (K2, csrc/disp_ls.cu) and its plain version,
both held against the plain version in float64, over N_SEEDS seeds of
ops/checks.py's inputs per shape, p, prior and mode (seed 0 is
chip_smoke.py's phase 3).  Per case it prints each one's mean and largest
shortfall below the reference on the genes all three take as converged,
how many genes end more than one lp unit below the other version (kernel
below plain, plain below kernel, and of the first within the first ten
genes, whose treated samples carry weights below the Cox-Reid threshold),
and the gene where the kernel ends furthest below the plain version.

`crossover`: K1, K2 (gene-wise) and K3 (4,096 genes) on the card against
their plain versions at 8,192 x 1,024 on ops/checks.py's inputs, p = 10
and 16 (the wide kernels) and 17 to 64 (the block kernels), float64 and
float32: the median of REPS launches each, the plain version's time over
the kernel's, and the p past which the plain version is faster.
`variant smem` builds the block kernels with one block an SM
(-DDK_BLOCK_SMEM_TARGET=232448: tiles up to 4x wider past 48 columns)
and times them at p = 48, 56, 64; `variant minp` builds them to take
designs past 8 columns (-DDK_BLOCK_MIN_P=8), routes p = 10 and 16 to them
and times them there (against `crossover`'s wide rows), each also read
against the plain version (largest |beta| and |log alpha| difference).
`phases` (its own process) builds a copy of csrc with clock64 marks in
the float64 block K1, K2 and K3 and prints each phase's clocks a gene (K1),
trial point (K2) or grid point (K3) and its share, on the paired p = 64
and 25 pipeline inputs at 60,000 x 1,024 (the per-sample terms, the
tiles' staging and tensor-core products, the Cholesky, the solve, the
inverse, the sandwich, the hat diagonal; K3 on the genes the line search
leaves, or the first 4,096: its terms, its tiles (the tensor-core
design's staging and products, or the 4 x 4 design's tile writes and gram
adds), the store, the Cholesky with its log determinant, the prior), then
the float32 block K3 at p = 25 a grid point (its terms, the tiles'
staging, both points' gram adds, each gram's reduction and store, the
Cholesky, the prior), the wide K2 at p = 10 in both dtypes and the float32
block K2 at p = 25 a trial point, with the float32 wide K2's samples
counted by the branch their special functions take (the large-c series;
a shift of z = y + c < 8, and the shifts a sample; none).  `phases k3
[ROOT]` builds the block and the wide K3 alone, marked, from ROOT's
checkout (default this one; an earlier checkout's designs, the block
K3's 4 x 4 float32 one and the wide K3's point a pass, take
_K3_EARLIER_MARKS) and prints their split at p = 25 (the block K3) and
p = 10 (the wide K3) in both dtypes.
`phases k1 [ROOT]` prints the float32 K1 kernels'
registers, spill bytes and resident warps an SM (of ROOT's checkout, by
default this one), then builds a copy of ROOT's csrc with clock64 marks
in them (_K1_MARKS: a checkout of this design) and prints, on the
paired pipeline inputs at p = 10 (the wide K1), 25 and 64 (the block K1),
sweeps a gene and each phase's clocks a gene and share (the per-sample
terms, the tile writes, the gram adds, the groups' reduction and the
store, the per-sweep Cholesky, solve and control, the post-fit factor
and inverse, the sandwich, the hat-diagonal pass).
`paired`: the public paired deseq() + results() (~ subject + condition,
p = P, default 64, in DTYPE, float64 by default or float32, 60,000 x 1,024
of the main path's counts, through ENGINE: auto, deseq()'s default, or
host)
timed in fresh processes in PARENT_ROOT's checkout and this one, in turns
parent, change, change, parent (a cold call, then CALLS warm ones), and
each checkout's median and quartiles over its warm calls.

`kernels`: K1 (csrc/irls.cu), K2 (csrc/disp_ls.cu) and K3
(csrc/disp_grid.cu, on the genes whose float32 line search did not
converge, in both dtypes: in float64 it converges on every gene), both
modes, against another checkout's kernels (PARENT_ROOT, e.g. a `git
archive` of the parent unpacked into the gitignored .scratch/), on the
same inputs: the main path's shapes (60,000 x 1,024, ~ condition, float32
and float64) and 60,000 x 24 (float32), the inputs the pipeline's own
stages hand the kernels, saved once to build/. Each turn is a fresh
process in one checkout that builds that checkout's kernels and times each
one: the median of REPS launches (default 7), each between its own CUDA
events, after at least 0.5 s of warm-up launches; the turns run parent,
change, change, parent. Per kernel it prints every turn's time, the
change's mean over the parent's, whether the two turns of each checkout
gave the same outputs bit for bit, and whether the two checkouts did.

`k2`: the gene-wise line search (K2) on the paired pipeline inputs at
60,000 x 1,024 (chip_smoke.py's ~ subject + condition; by default p = 10,
the wide kernel, and p = 25, the block kernel, float32 and float64; or
the cases P:DTYPE given, e.g. 16:float64 64:float32, P from 1 to 64: at
P <= 8 the templated kernels on the main path's counts with
study_matrix's design, an intercept at P = 1, ~ condition at P = 2, the
paired design past it), timed and printed as `kernels` times its cases
(REPS launches a turn, default 5).  Each
further ROOT (a study variant's checkout) is timed beside the change, in
turns parent, change, ROOT..., ROOT... reversed, change, parent.

`k1`: K1 (the IRLS) on the paired pipeline inputs at 60,000 x 1,024 (the
dispersions from this checkout's line search, the pipeline's start; by
default p = 10, the wide kernel, and p = 25, the block kernel, in float32
and float64; or the cases P:DTYPE given), timed and printed as `k2`
times its cases.

`k3`: the grid search (K3) on the paired pipeline inputs at 60,000 x
1,024 (by default the block kernel in float64 at p = 17, 24, 25, 32, 40,
48, 56, 64 and in float32 at p = 25, the wide kernel at p = 10 in both
dtypes, and the templated kernel in float64 at p = 2; or the cases
P:DTYPE[:MODE] given, MODE w (weighted) or nocr
(without the Cox-Reid term)), on the genes the line search (this
checkout's K2) leaves, or on the first 4,096 genes where it leaves none
(in float64 it converges everywhere: chip_smoke.py's kernel rows time the
same genes), timed and printed as `k2` times its cases.

`edges` (the card if there is one, else the CPU): the float32 readings of
ops/checks.py at checks.EDGES and SHAPES' S = 24 row, taken between the
plain version and the plain version on the same inputs with the samples
permuted (so only the summation order differs), N_PERM permutations
(default 5), K1, K2 and K3 both modes: how far the readings move when
nothing but rounding does.  A reading that fails in any permutation is
rounding-bound (checks.ROUNDING_BOUND).  `edges N_PERM wide`: the same at
the wide kernels' checks (SHAPES' S = 24 row, p in checks.WIDE_P, every
mode of checks.WIDE_MODES), each permutation also permuting the design's
columns, so that the p x p algebra's elimination order moves as the
kernels' own order moves it, and on a card one more run of the plain
version on the host against the card's (other special functions and
summation orders, as the kernels have their own): how far rounding alone
moves the readings that checks.within_plain_spread holds a wide kernel
to, where it fails checks.TOL (at S = 3,000 no reading failed in 5 sample
permutations, on the card or the CPU, PERF.md section 6).

`batch_rows` (the card, or the CPU): whether the first (and last) N rows
of a per-gene quantity come out bit for bit as the same rows of the whole
call, for N from 3 to half the rows, at (2,048 | 60,000) x 1,024 and
30,000 x 2,048 in both dtypes: a row sum, a (N,S) x (S,4) and a (N,4) x
(4,S) matrix product, and the pipeline's forms of the two products
(parallel/fused.py:rowdot, rowcomb); then the fused pipeline on the
2,048 x 1,024 gate slice in float64, a 2-block mesh on the same device
against one block: the genes that differ, per output.  What it reads
decides which forms a gene mesh's blocks compute their per-gene glue in
(fused.MIN_ROWS).

`sc`: the streamed single-cell path (parallel/sc.py) at G x S (default
30,000 x 50,000, bench.py:main_sc's counts made on the card), the group
QL call of fused_sc_results in float32, warm: its seconds, peak device
memory and stage table at sample chunks of 1,024, 2,048, 4,096 and 8,192
with the dispersion estimation in float64, and at 2,048 with it in
float32 (sc.SEARCH_DTYPE rebound); then bench.py's gate (checks.sc_gate:
the float32 call on the card against the float64 call on the CPU,
histogram order matched) with each search dtype, on the 2,048 x 4,096
gate fixtures, group seeds 0-6 and covariate seeds 1-3 (`sc G S SEEDS`:
SEEDS group seeds, at most 3 covariate ones; 0 skips the gates).  These
set sc.DEFAULT_CHUNK and sc.SEARCH_DTYPE.

`scpaths PARENT_ROOT [CALLS]`: the streamed single-cell path at 30,000 x
50,000 in float32 on the card (bench.py:main_sc's counts) in fresh
processes alternating between PARENT_ROOT and this checkout (parent,
change, change, parent): each turn times CALLS (default 2) warm calls of
group QL, covariate QL and covariate QL with (G,S) normalization
factors, and the study prints each case's median per checkout.

`expanded` (the card if there is one, else the CPU): the plain float32
IRLS at the betaPrior refit's expanded design (checks.EXPANDED, both
modes), held to the float64 fit by check_irls_expanded: how far the fit
sits from it along the design's null direction when the p x p system is
solved in float32 (as K1 and its plain version do) and when it is solved
in float64 from the same float32 sums, and after the projection onto
n'R b = 0 that parallel/fused.py:Stages.prior_fit applies.

`mainpath`: the public deseq() + results() at 60,000 x 1,024 float32 on
the card (chip_smoke.py's main path, counts from bench.py's generator
saved once to build/), in fresh processes alternating between PARENT_ROOT
and this checkout (parent, change, change, parent): each turn makes a
cold call, then CALLS warm calls (default 5), and the study prints every
warm call's genes/s and each checkout's median.

`wide`: the wide kernels (8 < p <= 16, csrc's *_wide_kernel): their
registers and spill bytes (ptxas), then K1 and K2 (with the prior) at p =
10 and 16, 60,000 x 1,024 (checks.solver_inputs, seed 11), float64 and
float32: the median of REPS launches (default 3) after a warm-up, beside
the plain version on the card, and K1's largest beta difference from the
plain version on the genes both take as converged.  (Before the wide
kernels this study timed builds of the templated K1 at P = 10 and 16, the
yardstick in PERF.md section 6.)

`block`: the block kernels (16 < p <= 64, csrc/*_block.cu): their
registers and spill bytes, then at p = 25 and 64, 16,384 x 1,024
(checks.solver_inputs, seed 11), float64 and float32, K2 (per trial point
and gene) and K3 (per grid point and gene, on 4,096 genes) with and
without the Cox-Reid term on the same inputs, the median of REPS launches
(default 3): the grams' and their algebra's share of a point's time, the
per-sample terms' the rest.

`rlog` (the card if there is one, else the CPU): rlog's arrow IRLS
(transforms.py:rlog_arrow_irls) on the inputs a blind rlog hands it
(gene-wise dispersions and trend fitted in float64, the prior variance),
run in float64 and in float32, on the main path's generator at 4,000 x
1,024 (seed 0) and on bench.py's 2,048 x 1,024 gate slice for N_SEEDS
seeds (default 4): the float64 fit's sweeps per gene (mean,
percentiles, share at maxit), how many genes stop after another number of
sweeps in float32, and the float32 fit's largest difference from the
float64 one in log2 units, with the genes past 1e-3 and 0.01.  Behind
rlog_data's float64 fit for a float32 payload.
"""

from __future__ import annotations

import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import checks


def _eig_ok(n, batch, dtype, dev, gen):
    a = torch.randn(batch, n, n + 2, dtype=dtype, device=dev, generator=gen)
    gram = a @ a.transpose(1, 2) + torch.eye(n, dtype=dtype, device=dev)
    try:
        torch.linalg.eigvalsh(gram)
        torch.cuda.synchronize()
        return True, ""
    except RuntimeError as e:      # the refusal is what is measured
        return False, str(e).split(", when calling")[0][:100]


def eigvalsh_study(dev):
    gen = torch.Generator(device=dev).manual_seed(0)
    for dtype in (torch.float64, torch.float32):
        for n in (2, 3, 4, 8):
            ok, _ = _eig_ok(n, 1 << 20, dtype, dev, gen)
            if ok:
                print(f"eigvalsh {dtype} n={n}: batch 1,048,576 accepted")
                continue
            lo, hi, msg = 1, 1 << 20, ""
            while hi - lo > 1:
                mid = (lo + hi) // 2
                good, why = _eig_ok(n, mid, dtype, dev, gen)
                if good:
                    lo = mid
                else:
                    hi, msg = mid, why
            print(f"eigvalsh {dtype} n={n}: largest batch accepted {lo:,}, "
                  f"refused from {hi:,} ({msg})")
    for n in (2, 3):
        a = torch.randn(60000, n, 1024, dtype=torch.float64, device=dev,
                        generator=gen)
        gram = a @ a.transpose(1, 2)
        for chunk in (1024, 2048, 4096, 8192, 12288, 16384, 24576):
            torch.linalg.eigvalsh(gram[:chunk])
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            torch.cat([torch.linalg.eigvalsh(g) for g in gram.split(chunk)])
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            extra = (torch.cuda.max_memory_allocated() - base) / 2 ** 20
            print(f"eigvalsh (60000,{n},{n}) float64 on the card in chunks "
                  f"of {chunk}: {ms:.2f} ms, peak {extra:.1f} MiB over the "
                  f"inputs")
        t0 = time.perf_counter()
        torch.linalg.eigvalsh(gram.cpu()).to(dev)
        torch.cuda.synchronize()
        print(f"eigvalsh (60000,{n},{n}) float64 copied to the host, LAPACK, "
              f"copied back: {1e3 * (time.perf_counter() - t0):.2f} ms")


def _ls_case(fit, d, use_prior, maxit=100):
    k = checks.run_ls(fit, d, use_prior)
    pl = checks.run_ls(checks.fit_disp_line_search_plain, d, use_prior)
    ref = checks.line_search_reference(d, use_prior)
    lk, lpl, lref = (checks.lp_at(r["log_alpha"], d, use_prior)
                     for r in (k, pl, ref))

    def conv(r):
        return (r["iter"] < maxit) & (r["iter"] != 1)

    both = conv(k) & conv(pl) & conv(ref)
    idx = torch.nonzero(both).squeeze(1)
    sk = (lref - lk)[idx].clamp(min=0.0)
    sp = (lref - lpl)[idx].clamp(min=0.0)
    gap = (lpl - lk)[idx]
    j = int(idx[gap.argmax()])
    lp0 = checks.lp_at(d["la0"], d, use_prior)[j].abs().item()
    return dict(
        k_mean=sk.mean().item(), p_mean=sp.mean().item(),
        k_max=sk.max().item(), p_max=sp.max().item(),
        k_below=int((gap > 1.0).sum()), p_below=int((gap < -1.0).sum()),
        k_below_first10=int(((gap > 1.0) & (idx < 10)).sum()),
        worst=(f"gene {j} gap {gap.max().item():.3g} (lp {lpl[j].item():.6g};"
               f" stop tolerance 50 eps |lp0| {50 * 1.1920929e-07 * lp0:.3g};"
               f" iter {int(k['iter'][j])}/{int(pl['iter'][j])}/"
               f"{int(ref['iter'][j])}; log alpha "
               f"{k['log_alpha'][j].item():.4f}/"
               f"{pl['log_alpha'][j].item():.4f}/"
               f"{ref['log_alpha'][j].item():.4f} kernel/plain/reference)"))


def ls_study(dev, n_seeds):
    from .cuda_ls import fit_disp_line_search
    tot = {}
    for weighted in (False, True):
        for S, G in checks.SHAPES:
            for p in (1, 2, 3):
                for use_prior in (False, True):
                    key = (weighted, S, p, use_prior)
                    for s in range(n_seeds):
                        raw = checks.solver_inputs(G, S, p,
                                                   10 * p + S + 1000 * s,
                                                   weighted=weighted)
                        d = checks.as_tensors(raw, torch.float32, dev)
                        r = _ls_case(fit_disp_line_search, d, use_prior)
                        t = tot.setdefault(key, dict(
                            k_below=0, p_below=0, k_below_first10=0,
                            ratio_max=0.0, n_over=0))
                        for c in ("k_below", "p_below", "k_below_first10"):
                            t[c] += r[c]
                        ratio = r["k_mean"] / max(r["p_mean"], 1e-12)
                        t["ratio_max"] = max(t["ratio_max"], ratio)
                        t["n_over"] += ratio > checks.TOL["float32"][
                            "ls_mean_x"]
                        if s == 0 or r["k_below"]:
                            print(f"weighted={weighted} S={S} p={p} "
                                  f"prior={use_prior} seed {s}: shortfall "
                                  f"mean {r['k_mean']:.3g}/{r['p_mean']:.3g} "
                                  f"max {r['k_max']:.3g}/{r['p_max']:.3g} "
                                  f"(kernel/plain); genes >1 below the other:"
                                  f" kernel {r['k_below']} (first ten "
                                  f"{r['k_below_first10']}), plain "
                                  f"{r['p_below']}; worst {r['worst']}")
    print(f"totals over {n_seeds} seeds per case:")
    for key, t in tot.items():
        print(f"  weighted={key[0]} S={key[1]} p={key[2]} prior={key[3]}: "
              f"genes >1 below the other: kernel {t['k_below']} (first ten "
              f"{t['k_below_first10']}), plain {t['p_below']}; largest mean "
              f"shortfall ratio kernel/plain {t['ratio_max']:.3g}, seeds over "
              f"{checks.TOL['float32']['ls_mean_x']}: {t['n_over']}")
    for weighted in (False, True):
        ks = sum(t["k_below"] for k, t in tot.items() if k[0] == weighted)
        ps = sum(t["p_below"] for k, t in tot.items() if k[0] == weighted)
        print(f"weighted={weighted}: genes >1 lp below the other version, "
              f"kernel {ks}, plain {ps}")


def edges_study(dev, n_perm, wide=False):
    from .disp import fit_disp_grid_plain, fit_disp_line_search_plain
    from .irls import fit_beta_plain
    perm_rng = torch.Generator().manual_seed(1)
    if wide:
        cases = [(S, G, p) for S, G in checks.SHAPES if S < 1000
                 for p in checks.WIDE_P]
        modes = checks.WIDE_MODES
    else:
        cases = [(S, G, p) for S, G in checks.SHAPES if S < 1000
                 for p in (2, 3)] + list(checks.EDGES)
        modes = ((False, None), (True, None))
    for S, G, p in cases:
        for weighted, mode in modes:
            raw = checks.solver_inputs(G, S, p, checks.seed_of(p, S, mode),
                                       weighted=weighted)
            d = checks.with_mode(checks.as_tensors(raw, torch.float32, dev),
                                 mode)
            base1 = checks.run_irls(fit_beta_plain, d)
            base2 = {u: checks.run_ls(fit_disp_line_search_plain, d, u)
                     for u in (False, True)}
            ref2 = {u: checks.line_search_reference(d, u)
                    for u in (False, True)}
            base3 = {u: checks.run_grid(fit_disp_grid_plain, d, u)
                     for u in (False, True)}
            ref3 = {u: checks.grid_reference(d, u) for u in (False, True)}
            fails = {"irls": 0, False: 0, True: 0, "grid": [0, 0]}
            line = f"S={S} G={G} p={p} weighted={weighted} mode={mode}:"

            def on(dev_, fn, dp, *a):
                # fn on device dev_, its outputs back on dev
                out = fn({k: v.to(dev_) if torch.is_tensor(v) else v
                          for k, v in dp.items()}, *a)
                if torch.is_tensor(out):
                    return out.to(dev)
                return {k: v.to(dev) for k, v in out.items()}

            # the variants: sample permutations (wide: and column
            # permutations) on this device, and for wide designs on a card
            # the plain version on the host too (its own special functions
            # and summation orders, as the kernels have theirs)
            variants = list(range(n_perm))
            if wide and dev.type == "cuda":
                variants.append("cpu")
            for i in variants:
                run_dev = torch.device("cpu") if i == "cpu" else dev
                dp, cols = dict(d), None
                if i != "cpu":
                    perm = torch.randperm(S, generator=perm_rng).to(dev)
                    dp = {k: v[:, perm] if k in ("y", "mu", "w") else v
                          for k, v in d.items()}
                    dp["x"] = d["x"][perm]
                    if wide:
                        # the columns too: the p x p algebra's elimination
                        # order changes, the posterior and the fit do not
                        cols = torch.randperm(p, generator=perm_rng).to(dev)
                        dp["x"], dp["b0"] = dp["x"][:, cols], d["b0"][:, cols]
                k1 = on(run_dev, lambda dd: checks.run_irls(fit_beta_plain,
                                                            dd), dp)
                if cols is not None:
                    k1["beta"] = k1["beta"][:, torch.argsort(cols)]
                r1 = checks.check_irls(k1, base1)
                fails["irls"] += not r1["ok"]
                line += f" [{i}] irls beta_rel {r1['beta_rel']:.3g}"
                for u in (False, True):
                    r2 = checks.check_ls(on(
                        run_dev, lambda dd: checks.run_ls(
                            fit_disp_line_search_plain, dd, u), dp),
                        base2[u], d, u, ref=ref2[u])
                    fails[u] += not r2["ok"]
                    line += (f"; ls prior={u} agree {r2['agree']:.3f} max "
                             f"{r2['short_kernel_max']:.3g}/"
                             f"{r2['short_plain_max']:.3g} mean "
                             f"{r2['short_kernel_mean']:.3g}/"
                             f"{r2['short_plain_mean']:.3g}")
                    r3 = checks.check_grid(on(
                        run_dev, lambda dd: checks.run_grid(
                            fit_disp_grid_plain, dd, u), dp),
                        base3[u], d, u, ref=ref3[u])
                    fails["grid"][u] += not r3["ok"]
                    line += (f"; grid prior={u} short "
                             f"{r3['short_kernel']:.3g}/"
                             f"{r3['short_plain']:.3g} sep_same "
                             f"{r3['sep_same_kernel']:.3f} of {r3['n_sep']}")
            print(f"{line}\n  failed in {len(variants)} variants: irls "
                  f"{fails['irls']}, ls prior=False {fails[False]}, "
                  f"ls prior=True {fails[True]}, grid prior=False "
                  f"{fails['grid'][0]}, grid prior=True {fails['grid'][1]}",
                  flush=True)


def expanded_study(dev):
    from unittest import mock

    from . import irls
    from .linalg import chol_solve

    def solve64(a, b):
        return chol_solve(a.double(), b.double()).to(a.dtype)

    for S, G, lv in checks.EXPANDED:
        for weighted in (False, True):
            raw = checks.expanded_inputs(G, S, lv, 7 + S + lv,
                                         weighted=weighted)
            d32 = checks.as_tensors(raw, torch.float32, dev)
            ref = checks.run_irls(irls.fit_beta_plain,
                                  checks.as_tensors(raw, torch.float64, dev))
            f32 = checks.run_irls(irls.fit_beta_plain, d32)
            with mock.patch.object(irls, "chol_solve", solve64):
                f64solve = checks.run_irls(irls.fit_beta_plain, d32)
            lam = d32["ridge"].double()
            n = torch.full((lv + 1,), -1.0, dtype=torch.float64, device=dev)
            n[0] = 1.0
            b = f32["beta"].double()
            proj = dict(f32, beta=(b - ((b * lam) @ n / (n * lam * n).sum())
                                   [:, None] * n).float())
            line = f"S={S} G={G} p={lv + 1} weighted={weighted}:"
            for name, fit in (("float32 solve", f32),
                              ("float64 solve", f64solve),
                              ("projected", proj)):
                r = checks.check_irls_expanded(fit, fit, ref)
                line += (f" {name} along n {r['null_f64_kernel']:.3g}, off "
                         f"n {r['beta_rel_f64_kernel']:.3g};")
            print(line, flush=True)


def _run_turn(fn, args, root):
    """fn(*args) in a fresh `python -c` process in checkout `root` (so that
    checkout's package is imported); returns the JSON its last line
    prints."""
    code = f"{inspect.getsource(fn)}\n{fn.__name__}(*{args!r})\n"
    run = subprocess.run([sys.executable, "-c", code], cwd=str(root),
                         capture_output=True, text=True)
    if run.returncode != 0:
        raise SystemExit(f"turn in {root} failed:\n{run.stderr[-4000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def _time_main_path(counts_path, calls):
    """One turn of the main-path study: a cold call, then `calls` warm
    calls of deseq() + results() on the saved counts; prints their wall
    seconds as one JSON line."""
    import json
    import time
    import numpy as np
    import torch
    import deseq2_tpu_torch as dt
    counts = np.load(counts_path)
    s = counts.shape[1]
    col_data = {"condition": np.repeat(["A", "B"], [s // 2, s - s // 2])}

    def call():
        dds = dt.dataset_from_matrix(counts, col_data, "~ condition",
                                     config=dt.DESeqConfig(dtype="float32"))
        dt.results(dt.deseq(dds))
        torch.cuda.synchronize()

    call()
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        call()
        out.append(time.perf_counter() - t0)
    print(json.dumps(out))


def mainpath_study(parent_root, calls):
    import statistics

    import numpy as np
    change_root = Path(__file__).resolve().parents[2]
    counts, _ = checks.bench_counts(60000, 1024)
    path = change_root / "build" / "study_main_counts.npy"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, counts)
    got = {}
    for tag, root in (("parent", parent_root), ("change", change_root),
                      ("change", change_root), ("parent", parent_root)):
        secs = _run_turn(_time_main_path, (str(path), calls), root)
        rates = [counts.shape[0] / t for t in secs]
        got.setdefault(tag, []).extend(rates)
        print(f"turn {tag}: warm genes/s "
              + ", ".join(f"{r:,.0f}" for r in rates), flush=True)
    for tag, rates in got.items():
        print(f"{tag}: median {statistics.median(rates):,.0f} genes/s over "
              f"{len(rates)} warm calls, range {min(rates):,.0f}-"
              f"{max(rates):,.0f}")


def _time_sc_paths(G, S, calls):
    """One turn of the scpaths study, run as `python -c` in the checkout
    being timed: bench.py:main_sc's counts made on the card, then per case
    (group QL; covariate QL [1, batch, condition] against [1, batch];
    the same with (G,S) float32 normalization factors exp(N(0, 0.2)) made
    on the card) a warm-up and `calls` warm float32 calls of
    fused_sc_results; prints {case: [wall seconds]} as one JSON line."""
    import json
    import time
    import numpy as np
    import torch
    from deseq2_tpu_torch.ops import checks
    from deseq2_tpu_torch.parallel.sc import fused_sc_results
    dev = torch.device("cuda", 0)
    counts, cells = checks.sc_bench_counts(G, S, dev)
    batch = ((np.arange(S) // 2) % 2).astype(np.float64)
    x = np.column_stack([np.ones(S), batch, cells.astype(float)])
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    nf = torch.exp(0.2 * torch.randn(G, S, generator=gen, device=dev))
    cov = dict(design=x, reduced_design=x[:, :2])
    cases = {"group_ql": dict(cells=cells, n_groups=2),
             "covariate_ql": cov,
             "covariate_ql_nf": dict(cov, norm_factors=nf)}
    out = {}
    for name, kw in cases.items():
        def call():
            fused_sc_results(counts, size_factors=np.ones(S), test="LRT",
                             fit_type="glmGamPoi", device=dev,
                             dtype=torch.float32, **kw)
            torch.cuda.synchronize()
        call()
        out[name] = []
        for _ in range(calls):
            t0 = time.perf_counter()
            call()
            out[name].append(time.perf_counter() - t0)
    print(json.dumps(out))


def scpaths_study(parent_root, calls):
    import statistics
    change_root = Path(__file__).resolve().parents[2]
    got = {}
    for tag, root in (("parent", parent_root), ("change", change_root),
                      ("change", change_root), ("parent", parent_root)):
        secs = _run_turn(_time_sc_paths, (30000, 50000, calls), root)
        print(f"turn {tag}: " + "; ".join(
            f"{k} " + ", ".join(f"{t:.3f}" for t in v)
            for k, v in secs.items()), flush=True)
        for k, v in secs.items():
            got.setdefault((tag, k), []).extend(v)
    for (tag, k), v in sorted(got.items(), key=lambda kv: kv[0][::-1]):
        print(f"{k}, {tag}: median {statistics.median(v):.3f} s over "
              f"{len(v)} warm calls, range {min(v):.3f}-{max(v):.3f}")


def _time_kernels(path, reps):
    """One turn of the kernels study, run as `python -c` in the checkout
    being timed (so its own package is imported): time K1, K2 and K3 on the
    saved inputs; print one JSON line {case: [median ms of `reps` launches
    each between its own CUDA events, after a warm-up of at least 0.5 s;
    digest of the outputs]}."""
    import hashlib
    import json
    import statistics
    import time
    import torch
    from deseq2_tpu_torch.ops import cuda_grid, cuda_irls, cuda_ls
    dev = torch.device("cuda", 0)
    out = {}
    for case, d in torch.load(path).items():
        t = {k: v.to(dev) if torch.is_tensor(v) else v for k, v in d.items()}
        ls_args = tuple(t.get(k) for k in ("y", "x", "mu", "la0", "la0")) \
            + (1.0, t.get("min_la"))
        irls_args = tuple(t.get(k) for k in ("y", "x", "sf", "alpha",
                                             "beta0", "ridge"))
        calls = {
            "disp_ls": lambda: cuda_ls.fit_disp_line_search(
                *ls_args, weights=t.get("w_ge")),
            "irls": lambda: cuda_irls.fit_beta(*irls_args,
                                               weights=t.get("w_n")),
            "disp_grid": lambda: {"log_alpha": cuda_grid.fit_disp_grid(
                t["gy"], t["x"], t["gmu"], t["grid"], t["gpm"], 1.0,
                weights=t.get("gw"), use_cr=t.get("use_cr", True))}}
        # a case without K1's or K3's inputs (the k2 study's) times K2
        # alone, one without K2's (the k1 study's) K1 alone, one with K3's
        # alone (the k3 study's) K3 alone
        if "y" not in t:
            calls = {"disp_grid": calls["disp_grid"]}
        elif "sf" not in t:
            calls = {"disp_ls": calls["disp_ls"]}
        elif "mu" not in t:
            calls = {"irls": calls["irls"]}
        for name, fn in calls.items():
            res = fn()
            h = hashlib.sha256()
            for k in sorted(res):
                h.update(res[k].cpu().numpy().tobytes())
            del res
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 0.5:   # clocks up, blocks cached
                fn()
                torch.cuda.synchronize()
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
            for start, end in ev:
                start.record()
                fn()
                end.record()
            torch.cuda.synchronize()
            out[f"{name} {case}"] = [
                statistics.median(a.elapsed_time(b) for a, b in ev),
                h.hexdigest()[:16]]
    print(json.dumps(out))


def _kernel_inputs(dev):
    """The inputs the pipeline's own stages hand K1, K2 and K3 at 60,000 x
    1,024 (float32 and float64) and 60,000 x 24 (float32), both modes, as
    CPU tensors by case name."""
    from .cuda_ls import fit_disp_line_search
    data, need_f32 = {}, {}
    for S, dnames in ((1024, ("float32", "float64")), (24, ("float32",))):
        counts, x_np = checks.bench_counts(60000, S)
        weights = checks.variant_inputs(counts)[0]
        for dname, w in ((d, w) for d in dnames for w in (None, weights)):
            dt = getattr(torch, dname)
            d = checks.pipeline_inputs(counts, x_np, dt, dev, weights=w)
            k2 = fit_disp_line_search(d["y"], d["x"], d["mu"], d["la0"],
                                      d["la0"], 1.0, d["min_la"],
                                      weights=d["w_ge"])
            _, _, _, d["alpha"], d["beta0"], _ = checks.irls_start(
                d, k2["log_alpha"])
            # K3's genes: those whose float32 line search did not converge,
            # as the pipeline (and chip_smoke.py's kernel timings) picks
            # them (in float64 the line search converges on every gene)
            if dname == "float32":
                need_f32[w is None] = torch.nonzero(
                    (k2["iter"] >= 100) | (k2["iter"] == 1)).squeeze(1)
            need = need_f32[w is None]
            d.update(gy=d["y"][need], gmu=d["mu"][need],
                     gpm=torch.zeros(len(need), dtype=dt, device=dev))
            own = int(((k2["iter"] >= 100) | (k2["iter"] == 1)).sum())
            print(f"{dname}{'' if w is None else ' weighted'} S={S}: "
                  f"{len(need)} genes need the grid in float32, {own} in "
                  f"{dname}", flush=True)
            keep = ("y", "x", "mu", "la0", "min_la", "sf", "ridge", "alpha",
                    "beta0", "grid", "gy", "gmu", "gpm")
            if w is not None:
                d["gw"] = d["w_ge"][need]
                keep += ("w_ge", "w_n", "gw")
            case = (dname + ("" if w is None else " weighted")
                    + ("" if S == 1024 else f" S={S}"))
            data[case] = {k: d[k].cpu() if torch.is_tensor(d[k]) else d[k]
                          for k in keep}
    return data


def _kernel_turns(data, name, parent_root, reps, others=()):
    """Save `data` (case -> inputs) to build/<name>.pt and time it in turns
    parent, change, change, parent (_time_kernels in fresh processes), or
    with `others` (further checkouts, tagged by their directory's name)
    parent, change, others..., others reversed, change, parent; print each
    case's times, each checkout's mean over the parent's, and whether each
    checkout's turns, and each checkout and the parent, gave the same
    bits."""
    change_root = Path(__file__).resolve().parents[2]
    path = change_root / "build" / f"{name}.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(data, path)
    torch.cuda.empty_cache()
    half = [("parent", parent_root), ("change", change_root)] \
        + [(Path(r).name, Path(r)) for r in others]
    got = []
    for tag, root in half + half[::-1]:
        t0 = time.perf_counter()
        got.append((tag, _run_turn(_time_kernels, (str(path), reps), root)))
        print(f"turn {tag} ({root}): {time.perf_counter() - t0:.1f} s",
              flush=True)
    print(f"ms per launch, median of {reps} launches; turns "
          f"{', '.join(t for t, _ in got)}")
    for case in got[0][1]:
        by = {}
        for tag, res in got:
            by.setdefault(tag, []).append(res[case])
        mean = {t: sum(v[0] for v in r) / len(r) for t, r in by.items()}
        same = {t: len({v[1] for v in r}) == 1 for t, r in by.items()}
        times = "; ".join(f"{t} " + "/".join(f"{v[0]:.3f}" for v in r)
                          for t, r in by.items())
        vs = "; ".join(f"{t}/parent {mean[t] / mean['parent']:.3f}, "
                       f"bit-identical to the parent "
                       f"{by['parent'][0][1] == by[t][0][1]}"
                       for t, _ in half[2:])
        print(f"{case}: {times}; change/parent "
              f"{mean['change'] / mean['parent']:.3f}; repeat-identical "
              f"{same}; the checkouts bit-identical "
              f"{by['parent'][0][1] == by['change'][0][1]}"
              + (f"; {vs}" if vs else ""), flush=True)


def kernels_study(dev, parent_root, reps):
    _kernel_turns(_kernel_inputs(dev), "study_kernels_inputs", parent_root,
                  reps)


# `k2`'s default cases: the paired design's width and dtype
K2_CASES = ((10, "float64"), (10, "float32"), (25, "float32"),
            (25, "float64"))


def _case_args(study, args, default, modes=()):
    """A kernel study's arguments PARENT_ROOT[,ROOT...] [REPS [P:DTYPE
    ...]]: (root, reps, ((p, dtype name), ...), further roots), `default`
    without cases.  With `modes`, a case may name one of them,
    P:DTYPE:MODE, and is then (p, dtype name, mode)."""
    cases = []
    for a in args[2:]:
        p, _, rest = a.partition(":")
        dtype, _, mode = rest.partition(":")
        if not p.isdigit() or not 1 <= int(p) <= 64 \
                or dtype not in ("float64", "float32") \
                or (mode and mode not in modes):
            raise SystemExit(f"{study}: a case is P:DTYPE"
                             + (f"[:{'|'.join(modes)}]" if modes else "")
                             + f", 1 <= P <= 64, DTYPE float64 or float32, "
                             f"not {a}")
        cases.append((int(p), dtype) + ((mode,) if mode else ()))
    roots = [Path(r).resolve() for r in args[0].split(",")]
    return (roots[0], int(args[1]) if len(args) > 1 else 5,
            tuple(cases) or default, tuple(roots[1:]))


def study_matrix(S, p):
    """The design of a kernel study's case of p columns: an intercept at p
    = 1, the main path's ~ condition (the samples' first half A, the
    second B) at p = 2, else the paired design ~ subject + condition of p
    - 1 subjects (checks.paired_matrix)."""
    if p == 1:
        return np.ones((S, 1))
    if p == 2:
        return np.column_stack([np.ones(S), np.repeat([0.0, 1.0],
                                                      [S // 2, S - S // 2])])
    return checks.paired_matrix(S, p - 1)


def k2_args(args):
    """`k2`'s arguments (_case_args), K2_CASES without cases."""
    return _case_args("k2", args, K2_CASES)


def k2_study(dev, parent_root, reps, cases=K2_CASES, others=()):
    """K2 on the paired pipeline inputs in both checkouts (see the
    module's docstring)."""
    import chip_smoke as cs
    counts, _ = cs.make_inputs(cs.G_MAIN, cs.S_MAIN)
    data = {}
    for p, dname in cases:
        d = checks.pipeline_inputs(counts, study_matrix(cs.S_MAIN, p),
                                   getattr(torch, dname), dev)
        data[f"p={p} {dname}"] = {k: d[k].cpu() if torch.is_tensor(d[k])
                                  else d[k] for k in
                                  ("y", "x", "mu", "la0", "min_la")}
        del d
    _kernel_turns(data, "study_k2_inputs", parent_root, reps, others)


# `k3`'s default cases: the block K3 in float64 from 17 to 64 columns, the
# float32 block K3 at the paired p = 25, the wide K3 at the paired p = 10
# in both dtypes and the narrow float64 K3 at the main path's p = 2
K3_CASES = tuple((p, "float64") for p in (17, 24, 25, 32, 40, 48, 56, 64)) \
    + ((25, "float32"), (10, "float32"), (10, "float64"), (2, "float64"))


# `k3`'s modes besides the default: weighted (the zinbwave-style weights
# of chip_smoke.py's weighted path, the Cox-Reid row cut at its default)
# and without the Cox-Reid term
K3_MODES = ("w", "nocr")


def k3_args(args):
    """`k3`'s arguments (_case_args: P:DTYPE[:MODE], MODE of K3_MODES),
    K3_CASES without cases."""
    return _case_args("k3", args, K3_CASES, K3_MODES)


def k3_study(dev, parent_root, reps, cases=K3_CASES, others=()):
    """K3 on the paired pipeline inputs in both checkouts (see the
    module's docstring): the genes this checkout's line search leaves, or
    the first 4,096 where it leaves none, as chip_smoke.py's kernel rows
    take them; a case's mode (K3_MODES) weights them or drops the
    Cox-Reid term."""
    import chip_smoke as cs
    from .cuda_ls import fit_disp_line_search
    counts, _ = cs.make_inputs(cs.G_MAIN, cs.S_MAIN)
    data = {}
    for p, dname, *mode in cases:
        dt = getattr(torch, dname)
        w = checks.variant_inputs(counts)[0] if mode == ["w"] else None
        d = checks.pipeline_inputs(counts, study_matrix(cs.S_MAIN, p),
                                   dt, dev, weights=w)
        k2 = fit_disp_line_search(d["y"], d["x"], d["mu"], d["la0"],
                                  d["la0"], 1.0, d["min_la"],
                                  weights=d.get("w_ge"))
        need = torch.nonzero((k2["iter"] >= 100)
                             | (k2["iter"] == 1)).squeeze(1)
        if need.numel() == 0:
            need = torch.arange(4096, device=dev)
        case = f"p={p} {dname}" + "".join(f" {m}" for m in mode)
        print(f"k3 {case}: {len(need)} genes", flush=True)
        data[case] = dict(
            x=d["x"].cpu(), grid=d["grid"].cpu(), gy=d["y"][need].cpu(),
            gmu=d["mu"][need].cpu(),
            gpm=torch.zeros(len(need), dtype=dt))
        if w is not None:
            data[case]["gw"] = d["w_ge"][need].cpu()
        if mode == ["nocr"]:
            data[case]["use_cr"] = False
        del d, k2
    _kernel_turns(data, "study_k3_inputs", parent_root, reps, others)


# `k1`'s default cases: the paired designs' widths, the wide K1 (p = 10)
# and the block K1 (p = 25), in the bench dtype and in float64
K1_CASES = ((10, "float32"), (25, "float32"), (10, "float64"),
            (25, "float64"))


def k1_args(args):
    """`k1`'s arguments (_case_args), K1_CASES without cases."""
    return _case_args("k1", args, K1_CASES)


def k1_study(dev, parent_root, reps, cases=K1_CASES, others=()):
    """K1 on the paired pipeline inputs in both checkouts (see the
    module's docstring): the line search's dispersions (this checkout's
    K2) and the pipeline's start, as chip_smoke.py's kernel rows take
    them."""
    import chip_smoke as cs
    from .cuda_ls import fit_disp_line_search
    counts, _ = cs.make_inputs(cs.G_MAIN, cs.S_MAIN)
    data = {}
    for p, dname in cases:
        d = checks.pipeline_inputs(counts, study_matrix(cs.S_MAIN, p),
                                   getattr(torch, dname), dev)
        k2 = fit_disp_line_search(d["y"], d["x"], d["mu"], d["la0"],
                                  d["la0"], 1.0, d["min_la"])
        i_args = checks.irls_start(d, k2["log_alpha"])
        data[f"p={p} {dname}"] = {
            k: v.cpu() for k, v in zip(("y", "x", "sf", "alpha", "beta0",
                                        "ridge"), i_args)}
        del d, k2, i_args
    _kernel_turns(data, "study_k1_inputs", parent_root, reps, others)


def wide_study(dev, reps):
    """The wide kernels (8 < p <= 16) against their plain versions."""
    import re

    from . import build
    from .cuda_irls import fit_beta
    from .cuda_ls import fit_disp_line_search
    from .disp import fit_disp_line_search_plain
    from .irls import fit_beta_plain

    for name in ("irls", "disp_ls", "disp_grid"):
        for sym, (regs, spill) in sorted(build.ptxas_resources(name).items()):
            m = re.search(r"([a-z]+_wide_kernel)I(\w)Lb(\d)E(Lb(\d)E)?E", sym)
            if m:
                t = "float" if m.group(2) == "f" else "double"
                print(f"{m.group(1)} {t} weighted={m.group(3)} use_cr="
                      f"{m.group(5) or '-'}: {regs} registers, {spill} spill "
                      f"bytes", flush=True)

    def median_ms(fn):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return sorted(ts)[len(ts) // 2]

    G, S = 60000, 1024
    for p in (10, 16):
        raw = checks.solver_inputs(G, S, p, 11)
        for dname in ("float64", "float32"):
            d = checks.as_tensors(raw, getattr(torch, dname), dev)
            k1 = checks.run_irls(fit_beta, d)
            ref = checks.run_irls(fit_beta_plain, d)
            conv = (k1["iter"] < 100) & (ref["iter"] < 100)
            diff = (k1["beta"] - ref["beta"]).abs()[conv].max().item()
            ms = median_ms(lambda: checks.run_irls(fit_beta, d))
            pms = median_ms(lambda: checks.run_irls(fit_beta_plain, d))
            print(f"{dname} p={p} K1: wide kernel {ms:.2f} ms, plain version "
                  f"on the card {pms:.2f} ms, sweeps/gene "
                  f"{k1['iter'].double().mean().item():.2f}, converged "
                  f"{int(conv.sum())}/{G}, max |beta - plain| {diff:.3g}",
                  flush=True)
            k2 = checks.run_ls(fit_disp_line_search, d, True)
            ms = median_ms(lambda: checks.run_ls(fit_disp_line_search, d,
                                                 True))
            pms = median_ms(lambda: checks.run_ls(fit_disp_line_search_plain,
                                                  d, True))
            evals = (k2["iter"].double() + 1).mean().item()
            print(f"{dname} p={p} K2 (prior): wide kernel {ms:.2f} ms, plain "
                  f"version on the card {pms:.2f} ms, {evals:.2f} "
                  f"evaluations/gene", flush=True)


def block_study(dev, reps):
    """The block kernels (16 < p <= 64): registers and spills, then at p =
    25 and 64, 16,384 x 1,024, float64 and float32, the time of one trial
    point a gene (K2) and of one grid point a gene (K3) with and without
    the Cox-Reid term on the same inputs.  Without the term a block sums
    only the per-sample likelihood terms; with it it also sums the grams
    and factors them, so the difference is their share (the per-sample
    versus gram split)."""
    import re

    from . import build
    from .cuda_grid import fit_disp_grid
    from .cuda_ls import fit_disp_line_search

    for name in ("irls_block", "disp_ls_block", "disp_grid_block"):
        for sym, (regs, spill) in sorted(build.ptxas_resources(name).items()):
            m = re.search(r"([a-z]+_block_kernel)I(\w)Lb(\d)E(Lb(\d)E)?E",
                          sym)
            if m:
                t = "float" if m.group(2) == "f" else "double"
                print(f"{m.group(1)} {t} weighted={m.group(3)} use_cr="
                      f"{m.group(5) or '-'}: {regs} registers, {spill} spill "
                      f"bytes", flush=True)

    def median_ms(fn):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return sorted(ts)[len(ts) // 2]

    G, S = 16384, 1024
    for p in (25, 64):
        raw = checks.solver_inputs(G, S, p, 11)
        for dname in ("float64", "float32"):
            d = checks.as_tensors(raw, getattr(torch, dname), dev)
            per = {}
            for use_cr in (True, False):
                dm = dict(d, use_cr=use_cr)
                k2 = checks.run_ls(fit_disp_line_search, dm, False)
                evals = float((k2["iter"].double() + 1).sum())
                ms2 = median_ms(lambda: checks.run_ls(fit_disp_line_search,
                                                      dm, False))
                g3 = {k: v[:4096] if k in ("y", "mu", "pm") else v
                      for k, v in dm.items()}
                ms3 = median_ms(lambda: checks.run_grid(fit_disp_grid, g3,
                                                        False))
                per[use_cr] = (ms2 / evals * 1e6, ms3 / (4096 * 40) * 1e6)
                print(f"{dname} p={p} use_cr={use_cr}: K2 {ms2:.2f} ms, "
                      f"{evals / G:.2f} trial points a gene, "
                      f"{per[use_cr][0]:.2f} ns a trial point and gene; K3 "
                      f"(4,096 genes) {ms3:.2f} ms, {per[use_cr][1]:.2f} ns a "
                      f"grid point and gene", flush=True)
            for i, k in ((0, "K2"), (1, "K3")):
                share = 1.0 - per[False][i] / per[True][i]
                print(f"{dname} p={p} {k}: the grams and their algebra take "
                      f"{share:.3f} of a point's time, the per-sample terms "
                      f"{1.0 - share:.3f}", flush=True)


def _median_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return sorted(ts)[len(ts) // 2]


def _width_times(dev, widths, reps, plain=True):
    """K1, K2 (gene-wise) and K3 at each p of `widths`, float64 and
    float32, 8,192 x 1,024 (K3 4,096 genes): {(dtype, p, kernel): (ms,
    plain ms or None)}, and each kernel's largest difference from the
    plain version printed beside it."""
    from .cuda_grid import fit_disp_grid
    from .cuda_irls import fit_beta
    from .cuda_ls import fit_disp_line_search
    from .disp import fit_disp_grid_plain, fit_disp_line_search_plain
    from .irls import fit_beta_plain

    G, S, out = 8192, 1024, {}
    for dname in ("float64", "float32"):
        for p in widths:
            d = checks.as_tensors(checks.solver_inputs(G, S, p, 11),
                                  getattr(torch, dname), dev)
            g3 = {k: v[:4096] if k in ("y", "mu", "pm") else v
                  for k, v in d.items()}
            for name, kern, ref, run, dd, key in (
                    ("K1", fit_beta, fit_beta_plain, checks.run_irls, d,
                     "beta"),
                    ("K2", fit_disp_line_search, fit_disp_line_search_plain,
                     lambda f, x: checks.run_ls(f, x, False), d,
                     "log_alpha"),
                    ("K3", fit_disp_grid, fit_disp_grid_plain,
                     lambda f, x: checks.run_grid(f, x, False), g3, None)):
                a, b = run(kern, dd), run(ref, dd)
                a, b = (a, b) if key is None else (a[key], b[key])
                diff = (a.double() - b.double()).abs().max().item()
                ms = _median_ms(lambda: run(kern, dd), reps)
                pms = _median_ms(lambda: run(ref, dd), reps) if plain \
                    else None
                out[(dname, p, name)] = (ms, pms)
                print(f"{dname} p={p} {name}: kernel {ms:.2f} ms"
                      + (f", plain {pms:.2f} ms, plain/kernel "
                         f"{pms / ms:.2f}" if plain else "")
                      + f", max |diff| {diff:.3g}", flush=True)
    return out


def crossover_study(dev, reps):
    """The block kernels against their plain versions from 17 to 64
    columns (and the wide kernels at 10 and 16): the crossover p."""
    widths = (10, 16, 17, 24, 32, 40, 48, 56, 64)
    t = _width_times(dev, widths, reps)
    for dname in ("float64", "float32"):
        for name in ("K1", "K2", "K3"):
            slower = [p for p in widths if p > 16
                      and t[(dname, p, name)][1] < t[(dname, p, name)][0]]
            print(f"{dname} {name}: the plain version is faster from p = "
                  f"{min(slower) if slower else 'none'} (of {widths[2:]})",
                  flush=True)


def variant_study(dev, which, reps):
    """The block kernels built as a study variant (see the module's
    docstring) and timed; run in a process of its own, since the flags
    name another build of every library the process loads."""
    from . import build, cuda_irls, cuda_ls, cuda_grid
    if which == "smem":
        build.NVCC_FLAGS = build.NVCC_FLAGS + (
            "-DDK_BLOCK_SMEM_TARGET=232448",)
        widths = (48, 56, 64)
    else:
        build.NVCC_FLAGS = build.NVCC_FLAGS + ("-DDK_BLOCK_MIN_P=8",)
        for mod in (cuda_irls, cuda_ls, cuda_grid):
            mod.P_WIDE = 8
        widths = (10, 16)
    build.build_all(("irls_block", "disp_ls_block", "disp_grid_block"))
    print(f"variant {which}: {' '.join(build.NVCC_FLAGS[-1:])}", flush=True)
    _width_times(dev, widths, reps, plain=False)



# phases_study's clock marks in the float64 block K1 (irls_block_mma) and
# K2 (lp_dlp_mma): (anchor, the anchor with a timer before or after it);
# DK_T0 starts a timer, DK_T(k, v) adds its clocks on thread 0 to slot k
# and restarts it (each region ends at a barrier, so thread 0's clocks are
# the block's).  The wide K2 (ls_wide_kernel, both dtypes) and the float32
# block K2 (lp_dlp_block) keep their clocks per warp (DK_TW: lane 0 of each
# warp; DK_TB: thread 0 of the block) in slots of their own (dk_wclk, 16 a
# warp, no atomics), slot k one of _K2_PHASES and slot 8 the trial points
# (DK_TN).
_PHASES = {
    "irls_block.cu": [
        ("  T dev[1] = {T(0)};\n  for (int s = threadIdx.x;",
         "  DK_T0(c0)\n  T dev[1] = {T(0)};\n  for (int s = threadIdx.x;"),
        ("  block_allsum<T, 1>(dev, red);\n  gram_mma_pass",
         "  block_allsum<T, 1>(dev, red);\n  DK_T(0, c0)\n  gram_mma_pass"),
        ("wg, zg);\n  return dev[0];",
         "wg, zg);\n  __syncthreads();\n  DK_T(1, c0)\n  return dev[0];"),
        ("      ++iters;\n", "      ++iters;\n      DK_T0(c1)\n"),
        ("                     ridge, rhs);\n",
         "                     ridge, rhs);\n      DK_T(2, c1)\n"),
        ("      block_cholesky_rows(amat, p, tile);\n",
         "      block_cholesky_rows(amat, p, tile);\n      DK_T(3, c1)\n"),
        ("      block_chol_solve_rows(amat, p, rhs);\n",
         "      block_chol_solve_rows(amat, p, rhs);\n      DK_T(4, c1)\n"),
        ("    // post-fit: the sandwich from X'WX at the final mu\n",
         "    // post-fit: the sandwich from X'WX at the final mu\n"
         "    DK_T0(c2)\n"),
        ("    block_cholesky_rows(amat, p, tile);\n"
         "    block_chol_inverse(amat, m2, amat, p);\n",
         "    block_cholesky_rows(amat, p, tile);\n    DK_T(5, c2)\n"
         "    block_chol_inverse(amat, m2, amat, p);\n    DK_T(6, c2)\n"),
        ("    hat_load(hat, amat, p);\n",
         "    hat_load(hat, amat, p);\n    DK_T(7, c2)\n"),
        ("    if (t == 0) {\n      dev_out[g] = dev;",
         "    __syncthreads();\n    DK_T(8, c2)\n"
         "    if (t == 0) {\n      dev_out[g] = dev;"),
        ("      mu_g[s] = m;\n    }\n",
         "      mu_g[s] = m;\n    }\n    __syncthreads();\n    DK_T(9, c2)\n"),
        ("        hat_g[s] = hat_g[s] * (T(2) * q);\n      }\n    }\n",
         "        hat_g[s] = hat_g[s] * (T(2) * q);\n      }\n    }\n"
         "    __syncthreads();\n    DK_T(10, c2)\n"
         "    if (t == 0) atomicAdd(&dk_clk[11], 1ull);\n"),
    ],
    "disp_ls_block.cu": [
        # lp_dlp_rows (the float32 block K2), then the float64 lp_dlp_mma
        ("  const int p = lay.p, tw = lay.tw, ts = lay.ts;\n"
         "  const T alpha = d_exp(la);\n  T acc[2] = {T(0), T(0)};\n",
         "  const int p = lay.p, tw = lay.tw, ts = lay.ts;\n  DK_T0(c0)\n"
         "  const T alpha = d_exp(la);\n  T acc[2] = {T(0), T(0)};\n"),
        ("  block_allsum<T, 2>(acc, red);\n  GramBlock<T> gb, gd;\n",
         "  block_allsum<T, 2>(acc, red);\n  DK_TB(0, c0)\n"
         "  GramBlock<T> gb, gd;\n"),
        ("    if (t < tw && s < S) rows_put(xb, ub, x, S, s, p, lay.pr, ts, t, "
         "wscr[s]);\n",
         "    DK_TB(2, c0)\n"
         "    if (t < tw && s < S) rows_put(xb, ub, x, S, s, p, lay.pr, ts, t, "
         "wscr[s]);\n"),
        ("    __syncthreads();\n    gram_add_rows(gm, gb, gd, ub, xb, ts, n);\n",
         "    __syncthreads();\n    DK_TB(1, c0)\n"
         "    gram_add_rows(gm, gb, gd, ub, xb, ts, n);\n"),
        ("  block_gram_store(gm, gb, bm, p, cm, true, "
         "static_cast<const T*>(nullptr));\n  // the factor on warp 0",
         "  __syncthreads();\n  DK_TB(2, c0)\n"
         "  block_gram_store(gm, gb, bm, p, cm, true, "
         "static_cast<const T*>(nullptr));\n  DK_TB(3, c0)\n"
         "  // the factor on warp 0"),
        ("  const T logdet = red[0];\n"
         "  block_chol_inverse_ld(bm, dm, bm, p);\n"
         "  block_gram_store(gm, gd, dm, p, cm, false, "
         "static_cast<const T*>(nullptr));\n"
         "  const T tr = block_trace_product(bm, dm, p, red);\n",
         "  const T logdet = red[0];\n  DK_TB(4, c0)\n"
         "  block_chol_inverse_ld(bm, dm, bm, p);\n  DK_TB(5, c0)\n"
         "  block_gram_store(gm, gd, dm, p, cm, false, "
         "static_cast<const T*>(nullptr));\n  DK_TB(3, c0)\n"
         "  const T tr = block_trace_product(bm, dm, p, red);\n"
         "  DK_TB(6, c0)\n  DK_TN(threadIdx.x == 0)\n"),
        ("  T acc[2] = {T(0), T(0)};\n  {\n"
         "    const NbConst<T> k = nb_const(T(1) / alpha);\n"
         "    for (int s = threadIdx.x;",
         "  DK_T0(c0)\n  T acc[2] = {T(0), T(0)};\n  {\n"
         "    const NbConst<T> k = nb_const(T(1) / alpha);\n"
         "    for (int s = threadIdx.x;"),
        ("  block_allsum<T, 2>(acc, red);\n  const MmaRun",
         "  block_allsum<T, 2>(acc, red);\n  DK_T(12, c0)\n  const MmaRun"),
        ("nullptr);\n  gram_mma_store(run, g, false,",
         "nullptr);\n  __syncthreads();\n  DK_T(13, c0)\n"
         "  gram_mma_store(run, g, false,"),
        ("cm, true, nullptr, nullptr);\n"
         "  const T logdet = block_cholesky<T, true>(bm, p);\n"
         "  block_chol_inverse(bm, dm, bm, p);\n",
         "cm, true, nullptr, nullptr);\n  DK_T(14, c0)\n"
         "  const T logdet = block_cholesky<T, true>(bm, p);\n"
         "  DK_T(15, c0)\n"
         "  block_chol_inverse(bm, dm, bm, p);\n  DK_T(16, c0)\n"),
        ("nullptr);\n  gram_mma_store(run, g, true,",
         "nullptr);\n  __syncthreads();\n  DK_T(13, c0)\n"
         "  gram_mma_store(run, g, true,"),
        ("cm, false, nullptr, nullptr);\n"
         "  const T tr = block_trace_product(bm, dm, p, red);\n",
         "cm, false, nullptr, nullptr);\n"
         "  const T tr = block_trace_product(bm, dm, p, red);\n"
         "  DK_T(17, c0)\n"
         "  if (threadIdx.x == 0) atomicAdd(&dk_clk[18], 1ull);\n"),
        # the step control of every block K2 (ls_block_genes)
        ("      ++iters;\n      const T a_propose",
         "      ++iters;\n      DK_T0(cs)\n      const T a_propose"),
        ("      T lp_new, dlp_next;\n      lp_dlp<T, UseW, UseCR>(gm,",
         "      T lp_new, dlp_next;\n      DK_TB(7, cs)\n"
         "      lp_dlp<T, UseW, UseCR>(gm,"),
        ("                             lp_new, dlp_next);\n",
         "                             lp_new, dlp_next);\n"
         "      DK_TR(cs)\n"),
        ("      if ((accept && (conv || under)) || stalled) break;\n",
         "      DK_TB(7, cs)\n"
         "      if ((accept && (conv || under)) || stalled) break;\n"),
    ],
    "disp_ls.cu": [
        # ls_wide_kernel's float32 evaluation (lp_dlp_wide)
        ("  const GramMap gm = gram_map(p);\n  const T alpha = d_exp(la);\n"
         "  const NbConst<T> k = wide_const(T(1) / alpha);\n",
         "  DK_T0(c0)\n  DK_TK0\n  const GramMap gm = gram_map(p);\n"
         "  const T alpha = d_exp(la);\n"
         "  const NbConst<T> k = wide_const(T(1) / alpha);\n  DK_TW(0, c0)\n"),
        ("        tile_put(xb, ub, x, S, s, p, w);\n",
         "        DK_TW(0, c0)\n        tile_put(xb, ub, x, S, s, p, w);\n"
         "        DK_TW(1, c0)\n"),
        ("      __syncwarp();\n"
         "      gram_add<T, true, false>(gm, gb, gd, rz, ub, xb,\n"
         "                               static_cast<const T*>(nullptr), n);\n"
         "      __syncwarp();\n",
         "      __syncwarp();\n      DK_TW(1, c0)\n"
         "      gram_add<T, true, false>(gm, gb, gd, rz, ub, xb,\n"
         "                               static_cast<const T*>(nullptr), n);\n"
         "      __syncwarp();\n      DK_TW(2, c0)\n"),
        ("    gram_store(gm, gd, dm, p, cm, false, "
         "static_cast<const T*>(nullptr));\n"
         "    const T logdet = warp_cholesky<T, true>(bm, p);\n"
         "    warp_chol_inverse(bm, li, bm, p);\n"
         "    const T tr = warp_trace_product(bm, dm, p);\n",
         "    gram_store(gm, gd, dm, p, cm, false, "
         "static_cast<const T*>(nullptr));\n    DK_TW(3, c0)\n"
         "    const T logdet = warp_cholesky<T, true>(bm, p);\n"
         "    DK_TW(4, c0)\n"
         "    warp_chol_inverse(bm, li, bm, p);\n    DK_TW(5, c0)\n"
         "    const T tr = warp_trace_product(bm, dm, p);\n"
         "    DK_TW(6, c0)\n    DK_TN(lane_id() == 0)\n    DK_TKW\n"),
        # its float64 evaluation (lp_dlp_wide_mma; the pass's staging and
        # products are marked in common.cuh's gram_mma_pass)
        ("  using T = double;\n  const T alpha = d_exp(la);\n",
         "  using T = double;\n  DK_T0(c0)\n  const T alpha = d_exp(la);\n"),
        ("  warp_allsum<T, 2>(acc);\n  const BlockLayout lay =\n",
         "  warp_allsum<T, 2>(acc);\n  DK_TW(0, c0)\n"
         "  const BlockLayout lay =\n"),
        ("                                             nullptr, gd);\n",
         "                                             nullptr, gd);\n"
         "  DK_TR(c0)\n"),
        ("  gram_mma_store<kMmaRunWide, 1, kPWide>(run, gd, true, dm, p, cm, "
         "false,\n                                         nullptr, nullptr);\n"
         "  const T logdet = warp_cholesky<T, true>(bm, p);\n"
         "  warp_chol_inverse(bm, li, bm, p);\n"
         "  const T tr = warp_trace_product(bm, dm, p);\n",
         "  gram_mma_store<kMmaRunWide, 1, kPWide>(run, gd, true, dm, p, cm, "
         "false,\n                                         nullptr, nullptr);\n"
         "  DK_TW(3, c0)\n"
         "  const T logdet = warp_cholesky<T, true>(bm, p);\n  DK_TW(4, c0)\n"
         "  warp_chol_inverse(bm, li, bm, p);\n  DK_TW(5, c0)\n"
         "  const T tr = warp_trace_product(bm, dm, p);\n  DK_TW(6, c0)\n"
         "  DK_TN(lane_id() == 0)\n"),
        # ls_wide_kernel's step control
        ("                                   prior_var, use_prior, wv, wscr, "
         "lp0,\n                                   dlp0);\n",
         "                                   prior_var, use_prior, wv, wscr, "
         "lp0,\n                                   dlp0);\n    DK_T0(cs)\n"),
        ("      T lp_new, dlp_next;\n      lp_dlp_wide_at<",
         "      T lp_new, dlp_next;\n      DK_TW(7, cs)\n"
         "      lp_dlp_wide_at<"),
        ("                                     lp_new, dlp_next);\n",
         "                                     lp_new, dlp_next);\n"
         "      DK_TR(cs)\n"),
        # lp_dlp_wide's samples by the branch their special functions take
        # (DK_TK; DK_TK0 and DK_TKW with the marks above)
        ("      wide_diffs(yv, k, lgd, dgd);\n"
         "      acc[0] += wscale<UseW>(lgd - (yv + k.c) * l1p, wr, s);\n"
         "      acc[1] += wscale<UseW>(l1p - mua * r + yv * alpha * r - "
         "dgd, wr, s);\n      if constexpr (UseCR) {\n",
         "      wide_diffs(yv, k, lgd, dgd);\n      DK_TK(yv, k.c)\n"
         "      acc[0] += wscale<UseW>(lgd - (yv + k.c) * l1p, wr, s);\n"
         "      acc[1] += wscale<UseW>(l1p - mua * r + yv * alpha * r - "
         "dgd, wr, s);\n      if constexpr (UseCR) {\n"),
    ],
    "disp_grid_block.cu": [
        # the block K3 with the Cox-Reid term: the float64 tensor-core
        # log_post_pair (two points: their terms first, both grams' tiles
        # on the tensor cores, then each gram's store and warp 0's factor
        # with the log determinant; a point's clocks are a pair's shared
        # phases halved) and the float32 log_post_rows (likewise two
        # points: their terms first, the sample-major tiles' staging and
        # both grams' adds, then each gram's reduction and store and warp
        # 0's factor); the points' constants count with the terms.  An earlier checkout's 4 x 4 design takes
        # _K3_EARLIER_MARKS.
        ("  using T = double;\n"
         "  const T alpha[2] = {d_exp(la[0]), d_exp(la[1])};\n",
         "  using T = double;\n"
         "  const T alpha[2] = {d_exp(la[0]), d_exp(la[1])};\n  DK_T0(c0)\n"),
        ("  block_allsum<T, 2>(acc, red);\n"
         "  const int p = lay.p, tw = lay.tw, ts = lay.ts;\n",
         "  block_allsum<T, 2>(acc, red);\n  DK_T(0, c0)\n"
         "  const int p = lay.p, tw = lay.tw, ts = lay.ts;\n"),
        ("    pair_add<kMmaRunK2>(run, ga, gb, tile, wa, wb, n);\n  }\n",
         "    pair_add<kMmaRunK2>(run, ga, gb, tile, wa, wb, n);\n  }\n"
         "  __syncthreads();\n  DK_T(1, c0)\n"),
        ("    gram_mma_store(run, e ? gb : ga, false, bm, p, cm, true, nullptr,\n"
         "                   nullptr);\n",
         "    gram_mma_store(run, e ? gb : ga, false, bm, p, cm, true, nullptr,\n"
         "                   nullptr);\n    DK_T(3, c0)\n"),
        ("    __syncthreads();\n    lp[e] = acc[e] - T(0.5) * *ldet;\n",
         "    __syncthreads();\n    DK_T(4, c0)\n"
         "    lp[e] = acc[e] - T(0.5) * *ldet;\n"),
        ("    if (use_prior) lp[e] -= T(0.5) * (la[e] - pm) * (la[e] - pm) / "
         "prior_var;\n",
         "    if (use_prior) lp[e] -= T(0.5) * (la[e] - pm) * (la[e] - pm) / "
         "prior_var;\n    DK_T(5, c0)\n"
         "    if (threadIdx.x == 0) atomicAdd(&dk_clk[8], 1ull);\n"),
        ("  using T = float;\n  const int t = threadIdx.x;\n",
         "  using T = float;\n  DK_T0(c0)\n  const int t = threadIdx.x;\n"),
        ("  block_allsum<T, 2>(acc, red);\n  GramBlock<T> ga, gb;\n",
         "  block_allsum<T, 2>(acc, red);\n  DK_T(0, c0)\n"
         "  GramBlock<T> ga, gb;\n"),
        ("    __syncthreads();\n"
         "    pair_add_rows(gm, ga, gb, xb, wa, wb, ts, n);\n",
         "    __syncthreads();\n    DK_T(1, c0)\n"
         "    pair_add_rows(gm, ga, gb, xb, wa, wb, ts, n);\n"
         "    DK_T(2, c0)\n"),
        ("    block_gram_store(gm, g, bm, p, cm, true, static_cast<const T*>"
         "(nullptr));\n    if (t < 32) {\n",
         "    block_gram_store(gm, g, bm, p, cm, true, static_cast<const T*>"
         "(nullptr));\n    DK_T(3, c0)\n    if (t < 32) {\n"),
        ("    __syncthreads();\n    lp[e] = acc[e] - 0.5f * *ldet;\n"
         "    if (use_prior) lp[e] -= 0.5f * (la[e] - pm) * (la[e] - pm) / "
         "prior_var;\n",
         "    __syncthreads();\n    DK_T(4, c0)\n"
         "    lp[e] = acc[e] - 0.5f * *ldet;\n"
         "    if (use_prior) lp[e] -= 0.5f * (la[e] - pm) * (la[e] - pm) / "
         "prior_var;\n    DK_T(5, c0)\n"
         "    if (threadIdx.x == 0) atomicAdd(&dk_clk[8], 1ull);\n"),
    ],
    "disp_grid.cu": [
        # the wide K3 with the Cox-Reid term (log_post_wide_pair, two points
        # a warp's pass, both dtypes): each tile's terms at both points on
        # its lanes, the weights' tile writes (and, past one chunk, the
        # block's design staging; else its staging once a gene, in the
        # kernel), the gram adds (float32 4 x 4 blocks, float64 mma), then
        # each gram's reduction and store, the factor, the prior; thread
        # 0's clock: warp 0's points
        ("  const int lane = lane_id();\n"
         "  const T alpha[2] = {d_exp(la[0]), d_exp(la[1])};\n",
         "  DK_T0(c0)\n  const int lane = lane_id();\n"
         "  const T alpha[2] = {d_exp(la[0]), d_exp(la[1])};\n"),
        ("      wide_stage(xs, x, S, base, cn, p, lay);\n      __syncthreads();\n",
         "      wide_stage(xs, x, S, base, cn, p, lay);\n      __syncthreads();\n"
         "      DK_T(1, c0)\n"),
        ("      if constexpr (UseCR) {\n"
         "        const int n = cn - t0 < kTile ? cn - t0 : kTile;\n",
         "      DK_T(0, c0)\n      if constexpr (UseCR) {\n"
         "        const int n = cn - t0 < kTile ? cn - t0 : kTile;\n"),
        ("        wb[lane] = w[1];\n        __syncwarp();\n",
         "        wb[lane] = w[1];\n        __syncwarp();\n        DK_T(1, c0)\n"),
        ("          pair_add<kMmaRunWide>(run, ga, gb, xs + t0, wa, wb, n);\n"
         "        }\n        __syncwarp();\n",
         "          pair_add<kMmaRunWide>(run, ga, gb, xs + t0, wa, wb, n);\n"
         "        }\n        __syncwarp();\n        DK_T(2, c0)\n"),
        ("  warp_allsum<T, 2>(acc);\n#pragma unroll\n",
         "  warp_allsum<T, 2>(acc);\n  DK_T(0, c0)\n#pragma unroll\n"),
        ("      lp[e] -= T(0.5) * warp_cholesky<T, true>(wv, p);\n",
         "      DK_T(3, c0)\n"
         "      lp[e] -= T(0.5) * warp_cholesky<T, true>(wv, p);\n"
         "      DK_T(4, c0)\n"),
        ("    if (use_prior) lp[e] -= T(0.5) * (la[e] - pm) * (la[e] - pm) / "
         "prior_var;\n  }\n}\n",
         "    if (use_prior) lp[e] -= T(0.5) * (la[e] - pm) * (la[e] - pm) / "
         "prior_var;\n    DK_T(5, c0)\n"
         "    if (threadIdx.x == 0) atomicAdd(&dk_clk[8], 1ull);\n  }\n}\n"),
        ("    wide_stage(xs, x, S, 0, S, p, lay);\n    __syncthreads();\n",
         "    DK_T0(cz)\n    wide_stage(xs, x, S, 0, S, p, lay);\n"
         "    __syncthreads();\n    DK_T(1, cz)\n"),
    ],
    "common.cuh": [
        # the float64 wide K2's pass (gram_mma_pass on one warp): staging
        # (tile writes) and products (gram adds)
        ("  for (int base = 0; base < S; base += tw) {\n"
         "    const int n = S - base < tw ? S - base : tw;\n"
         "    warps_sync<Warps>();\n",
         "  DK_T0(cp)\n"
         "  for (int base = 0; base < S; base += tw) {\n"
         "    const int n = S - base < tw ? S - base : tw;\n"
         "    warps_sync<Warps>();\n"),
        ("    cp_async_wait_all();\n    warps_sync<Warps>();\n"
         "    gram_mma_add<N, Sq, N, Both>(m, acc, tile, wb, n, sq);\n",
         "    cp_async_wait_all();\n    warps_sync<Warps>();\n"
         "    if constexpr (Warps == 1) DK_TW(1, cp)\n"
         "    gram_mma_add<N, Sq, N, Both>(m, acc, tile, wb, n, sq);\n"
         "    if constexpr (Warps == 1) DK_TW(2, cp)\n"),
    ],
}

_PHASE_NAMES = (
    "K1 pass: per-sample terms", "K1 pass: tiles (x staging, mma)",
    "K1 sweep: gram store", "K1 sweep: Cholesky", "K1 sweep: solve",
    "K1 post-fit: store, Cholesky", "K1 post-fit: inverse",
    "K1 post-fit: store, hat fragments", "K1 post-fit: sandwich",
    "K1 hat: per-sample terms", "K1 hat: tiles (x staging, mma)",
    "K1 genes", "K2 point: per-sample terms",
    "K2 point: both grams' tiles (x staging, mma)", "K2 point: b store",
    "K2 point: Cholesky", "K2 point: inverse", "K2 point: db store, trace",
    "K2 points")

# the slots of the block K3's clocks (DK_T, thread 0 of each block; slot 8
# the grid points)
_K3_PHASES = ("per-sample terms",
              "tile writes (tensor cores: the tiles' cp.async staging and "
              "mma)",
              "gram adds (4 x 4 blocks)",
              "reduction (4 x 4 blocks: the groups') and store",
              "Cholesky and log determinant",
              "prior (the scan's compare is unmarked)")

# the slots of the wide and float32 block K2's clocks (DK_TW, DK_TB)
_K2_PHASES = ("per-sample terms", "tile writes", "gram adds",
              "group reduction and store", "Cholesky", "inverse", "trace",
              "step control")
# the most warps (wide) or blocks (block) a launch keeps resident: 16
# blocks of 4 warps on each of 132 SMs
_K2_SLOTS = 8448

# The float32 K1 kernels' clocks (`phases k1`), per warp as K2's (the wide
# K1: DK_TW, each warp's gene on its lane 0's clock; the block K1: DK_TB,
# thread 0's), slot k one of _K1_PHASES, slot 8 the genes (DK_TN) and slot
# 9 the sweeps (DK_TC).  A region that ends at a barrier holds the wait
# for the block's slowest thread.
_K1_PHASES = ("per-sample terms", "tile writes", "gram adds",
              "group reduction and store", "Cholesky, solve and control",
              "post-fit factor and inverse", "sandwich", "hat-diagonal pass")

# The marks of the float32 K1 kernels: the wide K1 (its tiles
# column-major, a tile's terms on its lanes; the deviance constant's pass
# at beta0 counts in the same slots) and the block K1 (sample-major tiles,
# its terms first on every thread, its algebra on warp 0).
_K1_MARKS = {
    "irls.cu": [
        ("  T dev[1] = {T(0)};\n  __syncwarp();\n",
         "  T dev[1] = {T(0)};\n  __syncwarp();\n  DK_T0(c0)\n"),
        ("      for (int k = 0; k < p; ++k)\n"
         "        ub[k * kTileStride + lane] = w * xb[k * kTileStride + lane];\n",
         "      DK_TW(0, c0)\n"
         "      for (int k = 0; k < p; ++k)\n"
         "        ub[k * kTileStride + lane] = w * xb[k * kTileStride + lane];\n"),
        ("    __syncwarp();\n"
         "    gram_add<T, false, true>(gm, gb, unused, rz, ub, xb, zb, n);\n"
         "    __syncwarp();\n",
         "    __syncwarp();\n    DK_TW(1, c0)\n"
         "    gram_add<T, false, true>(gm, gb, unused, rz, ub, xb, zb, n);\n"
         "    __syncwarp();\n    DK_TW(2, c0)\n"),
        ("  gram_reduce<T, 4>(gm, rz, ub);\n  return dev[0];",
         "  gram_reduce<T, 4>(gm, rz, ub);\n  DK_TW(3, c0)\n  return dev[0];"),
        ("      ++iters;\n"
         "      gram_store(gm, gb, amat, p, ~0u, false, ridge);\n"
         "      const T r = wide_rhs(gm, rz, zb, p);\n",
         "      ++iters;\n      DK_T0(c1)\n      DK_TC(9, lane == 0)\n"
         "      gram_store(gm, gb, amat, p, ~0u, false, ridge);\n"
         "      const T r = wide_rhs(gm, rz, zb, p);\n      DK_TW(3, c1)\n"),
        ("      if (lane < p) sb[lane] = bn;\n      __syncwarp();\n",
         "      if (lane < p) sb[lane] = bn;\n      __syncwarp();\n"
         "      DK_TW(4, c1)\n"),
        ("    __syncwarp();\n    gram_store(gm, gb, gmat, p,",
         "    DK_T0(c2)\n    __syncwarp();\n    gram_store(gm, gb, gmat, p,"),
        ("      warp_chol_inverse(amat, li, amat, p);\n    if (lane < p) {\n",
         "      warp_chol_inverse(amat, li, amat, p);\n    DK_TW(5, c2)\n"
         "    if (lane < p) {\n"),
        ("    if (lane == 0) {\n      dev_out[g] = dev;",
         "    __syncwarp();\n    DK_TW(6, c2)\n"
         "    if (lane == 0) {\n      dev_out[g] = dev;"),
        ("              if (j < p) q += amat[i * kPWide + j] * (xv[i] * xv[j]);\n"
         "            }\n          }\n        }\n      }\n"
         "      hat_g[s] = wscale<UseW>(m / (T(1) + alpha * m), wr, s) * q;\n"
         "      mu_g[s] = m;\n    }\n",
         "              if (j < p) q += amat[i * kPWide + j] * (xv[i] * xv[j]);\n"
         "            }\n          }\n        }\n      }\n"
         "      hat_g[s] = wscale<UseW>(m / (T(1) + alpha * m), wr, s) * q;\n"
         "      mu_g[s] = m;\n    }\n"
         "    __syncwarp();\n    DK_TW(7, c2)\n    DK_TN(lane == 0)\n"),
    ],
    "irls_block.cu": [
        ("  T dev[1] = {T(0)};\n  T* xb = tile;\n",
         "  DK_T0(c0)\n  T dev[1] = {T(0)};\n  T* xb = tile;\n"),
        # the pass staging its terms (a tile holds the block's samples)
        ("        wb[t] = w;\n        zb[t] = wz;\n      }\n"
         "      __syncthreads();\n"
         "      k1_gram_add(gm, gb, rz, xb, wb, zb, ld, n);\n    }\n",
         "        wb[t] = w;\n        zb[t] = wz;\n        DK_TB(0, c0)\n"
         "      }\n      __syncthreads();\n      DK_TB(1, c0)\n"
         "      k1_gram_add(gm, gb, rz, xb, wb, zb, ld, n);\n"
         "      DK_TB(2, c0)\n    }\n"),
        # the pass with its terms first
        ("    block_allsum<T, 1>(dev, red);\n"
         "    for (int base = 0; base < S; base += tw) {\n",
         "    block_allsum<T, 1>(dev, red);\n    DK_TB(0, c0)\n"
         "    for (int base = 0; base < S; base += tw) {\n"),
        ("      __syncthreads();\n"
         "      k1_stage(xb, x, S, base, n, p, lay.pr, ld);\n",
         "      __syncthreads();\n      DK_TB(2, c0)\n"
         "      k1_stage(xb, x, S, base, n, p, lay.pr, ld);\n"),
        ("        zb[t] = zg[base + t];\n      }\n      __syncthreads();\n"
         "      k1_gram_add(gm, gb, rz, xb, wb, zb, ld, n);\n    }\n",
         "        zb[t] = zg[base + t];\n      }\n      __syncthreads();\n"
         "      DK_TB(1, c0)\n"
         "      k1_gram_add(gm, gb, rz, xb, wb, zb, ld, n);\n    }\n"),
        ("  // the tile is the reduction's scratch\n"
         "  rows_reduce(gm, gb, rz, tile, G, amat, ridge, xz, p);\n",
         "  __syncthreads();\n  DK_TB(2, c0)\n"
         "  // the tile is the reduction's scratch\n"
         "  rows_reduce(gm, gb, rz, tile, G, amat, ridge, xz, p);\n"
         "  DK_TB(3, c0)\n"),
        # the sweep: its factor, solve and control
        ("      ++iters;\n      // the ridge system and X'Wz from the last pass",
         "      ++iters;\n      DK_T0(c1)\n      DK_TC(9, t == 0)\n"
         "      // the ridge system and X'Wz from the last pass"),
        ("      const T dbeta = flag[1], bmax = flag[2];\n",
         "      const T dbeta = flag[1], bmax = flag[2];\n      DK_TB(4, c1)\n"),
        # after the fit
        ("    if (t < p) beta_out[(size_t)g * p + t] = rhs[t];\n",
         "    DK_T0(c2)\n    if (t < p) beta_out[(size_t)g * p + t] = rhs[t];\n"),
        ("    k1_inverse<kBlockWarpsN>(amat, p, li, ld, amat, p, lay.pr, rhs);\n",
         "    k1_inverse<kBlockWarpsN>(amat, p, li, ld, amat, p, lay.pr, rhs);\n"
         "    DK_TB(5, c2)\n"),
        ("      if (col < p && t % ks == 0) bvar_out[(size_t)g * p + col] = v;\n"
         "    }\n",
         "      if (col < p && t % ks == 0) bvar_out[(size_t)g * p + col] = v;\n"
         "    }\n    __syncthreads();\n    DK_TB(6, c2)\n"),
        ("                   k1_hat_part(li, ld, tile + t * ld, p, 0, 1);\n"
         "      }\n      continue;\n",
         "                   k1_hat_part(li, ld, tile + t * ld, p, 0, 1);\n"
         "      }\n      __syncthreads();\n      DK_TB(7, c2)\n"
         "      DK_TN(t == 0)\n      continue;\n"),
        ("      if (r < n && t % kh == 0) hat_g[base + r] *= q;\n    }\n",
         "      if (r < n && t % kh == 0) hat_g[base + r] *= q;\n    }\n"
         "    __syncthreads();\n    DK_TB(7, c2)\n    DK_TN(t == 0)\n"),
    ],
}

# The K3 marks in an earlier checkout's design (`phases k3 ROOT`: the
# wide K3's log_post_wide, a point a pass on column-major tiles; the
# float32 block K3's log_post_block with the Cox-Reid term, a point at a
# time, the terms on the tile's threads, tile writes, gram adds, the
# groups' reduction and store, block_cholesky), applied only to another
# checkout's sources
_K3_EARLIER_MARKS = {
    "disp_grid.cu": [
        # the wide K3's earlier point (log_post_wide, a point a pass): each
        # tile's terms on its lanes, the design's tile writes (x and w x),
        # the gram adds, then the groups' reduction and store, the factor,
        # the prior
        ("  const GramMap gm = gram_map(p);\n  const T alpha = d_exp(la);\n"
         "  const LgConst<T> k = lg_const(T(1) / alpha);\n",
         "  DK_T0(c0)\n  const GramMap gm = gram_map(p);\n"
         "  const T alpha = d_exp(la);\n"
         "  const LgConst<T> k = lg_const(T(1) / alpha);\n"),
        ("        tile_put(xb, ub, x, S, s, p, w);\n",
         "        DK_T(0, c0)\n        tile_put(xb, ub, x, S, s, p, w);\n"
         "        DK_T(1, c0)\n"),
        ("      __syncwarp();\n"
         "      gram_add<T, false, false>(gm, gb, unused, rz, ub, xb,\n"
         "                                static_cast<const T*>(nullptr), n);\n"
         "      __syncwarp();\n",
         "      __syncwarp();\n      DK_T(1, c0)\n"
         "      gram_add<T, false, false>(gm, gb, unused, rz, ub, xb,\n"
         "                                static_cast<const T*>(nullptr), n);\n"
         "      __syncwarp();\n      DK_T(2, c0)\n"),
        ("  warp_allsum<T, 1>(acc);\n  T lp = acc[0];\n",
         "  warp_allsum<T, 1>(acc);\n  DK_T(0, c0)\n  T lp = acc[0];\n"),
        ("    gram_store(gm, gb, wv, p, cm, true, static_cast<const T*>(nullptr));\n"
         "    lp = acc[0] - T(0.5) * warp_cholesky<T, true>(wv, p);\n",
         "    gram_store(gm, gb, wv, p, cm, true, static_cast<const T*>(nullptr));\n"
         "    DK_T(3, c0)\n"
         "    lp = acc[0] - T(0.5) * warp_cholesky<T, true>(wv, p);\n"
         "    DK_T(4, c0)\n"),
        ("  if (use_prior) lp -= T(0.5) * (la - pm) * (la - pm) / prior_var;\n"
         "  return lp;\n}\n\n// grid_kernel at a run-time p",
         "  if (use_prior) lp -= T(0.5) * (la - pm) * (la - pm) / prior_var;\n"
         "  DK_T(5, c0)\n  if (threadIdx.x == 0) atomicAdd(&dk_clk[8], 1ull);\n"
         "  return lp;\n}\n\n// grid_kernel at a run-time p"),
    ],
    "disp_grid_block.cu": [
        ("  const T alpha = d_exp(la);\n"
         "  const LgConst<T> k = lg_const(T(1) / alpha);\n",
         "  const T alpha = d_exp(la);\n  DK_T0(c0)\n"
         "  const LgConst<T> k = lg_const(T(1) / alpha);\n"),
        ("        block_tile_put(xb, ub, x, S, s, p, ts, w);\n",
         "        DK_T(0, c0)\n        block_tile_put(xb, ub, x, S, s, p, ts, "
         "w);\n        DK_T(1, c0)\n"),
        ("      __syncthreads();\n"
         "      block_gram_add(gm, gb, ub, xb, ts, n);\n",
         "      __syncthreads();\n      DK_T(1, c0)\n"
         "      block_gram_add(gm, gb, ub, xb, ts, n);\n      DK_T(2, c0)\n"),
        ("    if constexpr (UseCR) __syncthreads();\n",
         "    if constexpr (UseCR) __syncthreads();\n    DK_T(2, c0)\n"),
        ("    lp = acc[0] - T(0.5) * block_cholesky<T, true>(bm, p);\n",
         "    DK_T(3, c0)\n"
         "    lp = acc[0] - T(0.5) * block_cholesky<T, true>(bm, p);\n"
         "    DK_T(4, c0)\n"),
        ("  if (use_prior) lp -= T(0.5) * (la - pm) * (la - pm) / prior_var;\n"
         "  return lp;",
         "  if (use_prior) lp -= T(0.5) * (la - pm) * (la - pm) / prior_var;\n"
         "  DK_T(5, c0)\n  if (threadIdx.x == 0) atomicAdd(&dk_clk[8], 1ull);\n"
         "  return lp;"),
    ],
}

# the names an earlier checkout's sources give the marked functions
# (the float32 wide K2's special functions were nb_const and nb_diffs)
_EARLIER_NAMES = (("wide_const(", "nb_const("), ("wide_diffs(", "nb_diffs("))

_PHASE_HEAD = (
    "__device__ unsigned long long dk_clk[24];\n"
    f"__device__ unsigned long long dk_wclk[{_K2_SLOTS} * 16];\n"
    "#define DK_T0(v) long long v = clock64();\n"
    "#define DK_T(k, v) { if (threadIdx.x == 0) atomicAdd(&dk_clk[k],"
    " (unsigned long long)(clock64() - v)); v = clock64(); }\n"
    "#define DK_SLOT(k) dk_wclk[(((size_t)blockIdx.x * (blockDim.x >> 5) + "
    "(threadIdx.x >> 5)) << 4) + (k)]\n"
    "#define DK_TW(k, v) { if ((threadIdx.x & 31) == 0) DK_SLOT(k) += "
    "(unsigned long long)(clock64() - v); v = clock64(); }\n"
    "#define DK_TB(k, v) { if (threadIdx.x == 0) DK_SLOT(k) += "
    "(unsigned long long)(clock64() - v); v = clock64(); }\n"
    "#define DK_TR(v) v = clock64();\n"
    "#define DK_TN(first) { if (first) DK_SLOT(8) += 1ull; }\n"
    "#define DK_TC(k, first) { if (first) DK_SLOT(k) += 1ull; }\n"
    "#define DK_TK0 unsigned dk_nt = 0, dk_nl = 0, dk_ns = 0, dk_sh = 0;\n"
    "#define DK_TK(yv, c) { const bool l_ = large_c(yv, c); "
    "const double z_ = (double)(yv) + (double)(c); ++dk_nt; dk_nl += l_; "
    "if (!l_ && z_ < 8.0) { ++dk_ns; dk_sh += (unsigned)ceil(8.0 - z_); } }\n"
    "#define DK_TKW { unsigned v_[4] = {dk_nt, dk_nl, dk_ns, dk_sh}; "
    "for (int i_ = 0; i_ < 4; ++i_) { const unsigned s_ = "
    "__reduce_add_sync(0xffffffffu, v_[i_]); if ((threadIdx.x & 31) == 0) "
    "DK_SLOT(9 + i_) += s_; } }\n")
_PHASE_TAIL = (
    "int dk_clk_read(unsigned long long* o) { return (int)"
    "cudaMemcpyFromSymbol(o, dk_clk, sizeof(dk_clk)); }\n"
    "int dk_clk_reset() { unsigned long long z[24] = {0}; return "
    "(int)cudaMemcpyToSymbol(dk_clk, z, sizeof(z)); }\n"
    "int dk_wclk_read(unsigned long long* o) { return (int)"
    "cudaMemcpyFromSymbol(o, dk_wclk, sizeof(dk_wclk)); }\n"
    "int dk_wclk_reset() { void* a = nullptr; int e = (int)"
    "cudaGetSymbolAddress(&a, dk_wclk); return e ? e : (int)cudaMemset(a, "
    "0, sizeof(dk_wclk)); }\n")


def _marked_csrc(dst, src=None):
    """A copy of the csrc at src (default: this checkout's) in dst with
    _PHASES' clock marks and the float32 K1's (_K1_MARKS), and in another
    checkout's sources the block K3's earlier design's
    (_K3_EARLIER_MARKS)."""
    import shutil
    from . import build
    src = build.CSRC if src is None else src
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for name in _PHASES.keys() | _K1_MARKS.keys():
        s = (dst / name).read_text()
        if name == "common.cuh":
            s = s.replace("namespace dk {\n", _PHASE_HEAD + "namespace dk {\n",
                          1)
        earlier = _K3_EARLIER_MARKS.get(name, []) if src != build.CSRC \
            else []
        for a, b in _PHASES.get(name, []) + _K1_MARKS.get(name, []) \
                + earlier:
            # the first match (each anchor names its function's text); an
            # earlier checkout's source (src given) may name its functions
            # as before (_EARLIER_NAMES) or lack a design's functions
            # (the float64 K3's log_post_pair), whose marks it skips
            for new, old in _EARLIER_NAMES if a not in s else ():
                a, b = a.replace(new, old), b.replace(new, old)
            assert a in s or src != build.CSRC, (name, a)
            s = s.replace(a, b, 1)
        s = s.replace('extern "C" {\n', 'extern "C" {\n' + _PHASE_TAIL, 1)
        (dst / name).write_text(s)


def _warp_clocks(lib, run):
    """run() between a reset and a read of lib's per-warp (or per-block)
    clocks; returns each slot's total over the warps."""
    import ctypes
    from . import build
    build.bind(build.load(lib), "dk_wclk_reset", [])()
    torch.cuda.synchronize()
    run()
    torch.cuda.synchronize()
    buf = np.zeros(_K2_SLOTS * 16, dtype=np.uint64)
    build.bind(build.load(lib), "dk_wclk_read", [ctypes.c_void_p])(
        buf.ctypes.data_as(ctypes.c_void_p))
    return buf.reshape(-1, 16).sum(axis=0, dtype=np.float64)


def _k2_clocks(lib, run):
    """run() between a reset and a read of lib's per-warp (or per-block)
    K2 clocks; prints each phase's clocks a trial point and its share."""
    tot = _warp_clocks(lib, run)
    points = max(tot[8], 1.0)
    whole = tot[:len(_K2_PHASES)].sum()
    print(f"  {int(tot[8])} trial points, {whole / points:,.0f} clocks a "
          "trial point (a warp's or a block's own clock)", flush=True)
    for k, n in enumerate(_K2_PHASES):
        print(f"  {n}: {tot[k] / points:,.0f} clocks a trial point, share "
              f"{tot[k] / max(whole, 1.0):.3f}", flush=True)
    if tot[9]:
        # DK_TK's counts (the float32 wide K2): its samples by branch
        n = tot[9]
        print(f"  samples: {int(n)}; the large-c series {tot[10] / n:.4f}, "
              f"digamma's shifts (z = y + c < 8) {tot[11] / n:.4f} "
              f"({tot[12] / max(tot[11], 1.0):.3f} shifts each), z >= 8 "
              f"unshifted {(n - tot[10] - tot[11]) / n:.4f}", flush=True)


def _k3_clocks(pin, k2, p):
    """The block K3 (p > 16) or the wide K3 (8 < p <= 16), marked, in
    pin's dtype on the genes the line search k2 left (chip_smoke.py's
    kernel rows: the first 4,096 genes when it left none): its registers
    and spills, then each phase's clocks a grid point (thread 0's clock:
    the block's, or warp 0's points of the wide kernel) and share
    (_K3_PHASES)."""
    import ctypes
    import re
    from . import build
    from .cuda_grid import fit_disp_grid
    from .cuda_ls import P_WIDE
    dtype = pin["y"].dtype
    t, tname = ("d", "double") if dtype == torch.float64 else ("f", "float")
    name, kern = ("disp_grid", "grid_wide_kernel") if p <= P_WIDE \
        else ("disp_grid_block", "grid_block_kernel")
    for sym, (regs, spill) in sorted(build.ptxas_resources(name).items()):
        if re.search(rf"{kern}I{t}Lb\dELb1EE", sym):
            print(f"  {sym}: {regs} registers, {spill} spill bytes (marked "
                  f"build)", flush=True)
    conv = (k2["iter"] < 100) & (k2["iter"] != 1)
    need = torch.nonzero(~conv).squeeze(1)
    if need.numel() == 0:
        need = torch.arange(4096, device=pin["y"].device)
    args = (pin["y"][need], pin["x"], pin["mu"][need], pin["grid"],
            torch.zeros(len(need), dtype=dtype, device=pin["y"].device),
            1.0)
    fit_disp_grid(*args)
    lib = build.load(name)
    build.bind(lib, "dk_clk_reset", [])()
    torch.cuda.synchronize()
    fit_disp_grid(*args)
    torch.cuda.synchronize()
    buf = (ctypes.c_ulonglong * 24)()
    build.bind(lib, "dk_clk_read", [ctypes.c_void_p])(
        ctypes.cast(buf, ctypes.c_void_p))
    points = max(buf[8], 1)
    whole = sum(buf[k] for k in range(len(_K3_PHASES)))
    print(f"p={p} K3 ({kern}<{tname}>, {len(need)} genes): "
          f"{buf[8]} grid points, {whole / points:,.0f} clocks a grid point",
          flush=True)
    for k, n in enumerate(_K3_PHASES):
        print(f"  {n}: {buf[k] / points:,.0f} clocks a grid point, share "
              f"{buf[k] / max(whole, 1):.3f}", flush=True)


# `phases`' and `phases k3`'s float32 block K3 reading: the paired p = 25
K3_PHASE_F32_P = 25
# `phases k3`'s widths: the block K3 at the paired p = 25, the wide K3 at
# the paired p = 10
K3_PHASE_P = (K3_PHASE_F32_P, 10)


def phases_study(dev):
    """The float64 block K1, K2 and K3, the wide K2 and the float32 block
    K2 timed phase by phase: a copy of csrc under build/ with clock64 marks
    (_PHASES) is built and run on the paired pipeline inputs at 60,000 x
    1,024: the float64 block K1, K2 and K3 at p = 64 and 25 (each phase's
    clocks a gene (K1), a trial point (K2) or a grid point (K3) and its
    share), the wide K2 at p = 10 in float64 and float32 and the float32
    block K2 at p = 25 (_K2_PHASES' clocks a trial point and their shares;
    the float32 wide K2's samples by branch).  Run in a process of its own
    (it points ops/build.py at the copy)."""
    import ctypes

    import chip_smoke as cs
    from . import build
    from .cuda_irls import fit_beta
    from .cuda_ls import fit_disp_line_search
    dst = build.BUILD_DIR / "phases_csrc"
    _marked_csrc(dst)
    build.CSRC = dst
    build.build_all(("irls_block", "disp_ls_block", "disp_ls",
                     "disp_grid_block"))
    counts, _ = cs.make_inputs(cs.G_MAIN, cs.S_MAIN)
    libs = ("irls_block", "disp_ls_block")
    for p in (64, 25):
        pin = checks.pipeline_inputs(counts, cs.paired_x(cs.S_MAIN, p),
                                     torch.float64, dev)
        ls_args = (pin["y"], pin["x"], pin["mu"], pin["la0"], pin["la0"],
                   1.0, pin["min_la"])
        k2 = fit_disp_line_search(*ls_args)
        i_args = checks.irls_start(pin, k2["log_alpha"])
        fit_beta(*i_args)
        torch.cuda.synchronize()
        for lib in libs:
            build.bind(build.load(lib), "dk_clk_reset", [])()
        fit_disp_line_search(*ls_args)
        fit_beta(*i_args)
        torch.cuda.synchronize()
        clk = {}
        for lib, k in zip(libs, ("K1", "K2")):
            buf = (ctypes.c_ulonglong * 24)()
            build.bind(build.load(lib), "dk_clk_read", [ctypes.c_void_p])(
                ctypes.cast(buf, ctypes.c_void_p))
            clk.update({n: buf[i] for i, n in enumerate(_PHASE_NAMES)
                        if n.startswith(k)})
        for k, unit in (("K1", "K1 genes"), ("K2", "K2 points")):
            tot = sum(v for n, v in clk.items()
                      if n.startswith(k) and n != unit)
            print(f"p={p} {k}: {clk[unit]} {unit.split()[1]}", flush=True)
            for n, v in clk.items():
                if n.startswith(k) and n != unit:
                    print(f"  {n}: {v / max(clk[unit], 1):,.0f} clocks a "
                          f"{unit.split()[1][:-1]}, share {v / tot:.3f}",
                          flush=True)
        _k3_clocks(pin, k2, p)
        del pin, k2, i_args
    pin = checks.pipeline_inputs(counts, cs.paired_x(cs.S_MAIN,
                                                     K3_PHASE_F32_P),
                                 torch.float32, dev)
    k2 = fit_disp_line_search(pin["y"], pin["x"], pin["mu"], pin["la0"],
                              pin["la0"], 1.0, pin["min_la"])
    _k3_clocks(pin, k2, K3_PHASE_F32_P)
    del pin, k2
    for p, dtype, lib in ((10, torch.float64, "disp_ls"),
                          (10, torch.float32, "disp_ls"),
                          (25, torch.float32, "disp_ls_block")):
        pin = checks.pipeline_inputs(counts, cs.paired_x(cs.S_MAIN, p),
                                     dtype, dev)
        ls_args = (pin["y"], pin["x"], pin["mu"], pin["la0"], pin["la0"],
                   1.0, pin["min_la"])
        fit_disp_line_search(*ls_args)
        print(f"p={p} {str(dtype)[6:]} K2 "
              f"({'ls_wide_kernel' if p <= 16 else 'ls_block_kernel'}):",
              flush=True)
        _k2_clocks(lib, lambda: fit_disp_line_search(*ls_args))
        del pin


def k3_phases_study(dev, root=None):
    """The block and the wide K3 phase by phase (`phases k3 [ROOT]`): a
    copy of ROOT's csrc (default: this checkout's) with clock64 marks
    (_PHASES, and for an earlier design _K3_EARLIER_MARKS) built and run
    at the widths of K3_PHASE_P in float64 and float32 on the paired
    pipeline inputs at 60,000 x 1,024, on the genes this checkout's line
    search leaves (_k3_clocks).  Run in a process of its own (it points
    ops/build.py at other sources)."""
    import chip_smoke as cs
    from . import build
    from .cuda_ls import fit_disp_line_search
    counts, _ = cs.make_inputs(cs.G_MAIN, cs.S_MAIN)
    runs = []
    for p in K3_PHASE_P:
        for dtype in (torch.float64, torch.float32):
            pin = checks.pipeline_inputs(counts, cs.paired_x(cs.S_MAIN, p),
                                         dtype, dev)
            k2 = fit_disp_line_search(pin["y"], pin["x"], pin["mu"],
                                      pin["la0"], pin["la0"], 1.0,
                                      pin["min_la"])
            runs.append((p, {k: pin[k] for k in ("y", "x", "mu", "grid")},
                         {"iter": k2["iter"]}))
            del pin, k2
    src = build.CSRC if root is None else \
        Path(root).resolve() / "deseq2_tpu_torch" / "csrc"
    dst = build.BUILD_DIR / "phases_k3_csrc"
    _marked_csrc(dst, src)
    build.CSRC = dst
    build._libs.clear()
    build.build_all(("disp_grid_block", "disp_grid"))
    print(f"K3 phases of {src}", flush=True)
    for p, pin, k2 in runs:
        _k3_clocks(pin, k2, p)


# `phases k1`'s widths: the wide K1 at p = 10, the block K1 at 25 and 64
K1_PHASE_P = (10, 25, 64)


def k1_resources(p, S=1024):
    """Registers, spill bytes (ptxas, from the built library) and resident
    warps an SM of the float32 K1 at p (the wide or the block kernel), for
    each mode: {weighted: (registers, spill bytes, warps)}."""
    import ctypes
    import re
    from . import build
    from .cuda_ls import P_WIDE
    name = "irls" if p <= P_WIDE else "irls_block"
    funcs = build.ptxas_resources(name)
    if name == "irls":
        q = build.bind(build.load(name), "irls_blocks_per_sm",
                       [ctypes.c_int] * 5)
        warps = lambda w: 4 * q(0, w, p, S, 1)   # noqa: E731
    else:
        q = build.bind(build.load(name), "irls_block_blocks_per_sm",
                       [ctypes.c_int] * 3)
        warps = lambda w: 8 * q(0, w, p)   # noqa: E731
    sym = "irls_wide_kernel" if name == "irls" else "irls_block_kernel"
    out = {}
    for w in (0, 1):
        hit = [v for k, v in funcs.items()
               if re.search(rf"{sym}IfLb{w}EE", k)]
        regs, spill = hit[0] if len(hit) == 1 else (-1, -1)
        out[bool(w)] = (regs, spill, warps(w))
    return out


def k1_phases_study(dev, root=None):
    """The float32 K1 kernels phase by phase (`phases k1 [ROOT]`): the
    registers, spill bytes and resident warps of ROOT's kernels (default:
    this checkout's), then a copy of its csrc with clock64 marks
    (_K1_MARKS) on the paired pipeline inputs at 60,000 x 1,024, p in
    K1_PHASE_P: sweeps a gene, each phase's clocks a gene and its share
    (_K1_PHASES).  The line search that gives K1 its dispersions runs on
    this checkout's kernels.  Run in a process of its own (it points
    ops/build.py at other sources)."""
    import chip_smoke as cs
    from . import build
    from .cuda_irls import fit_beta
    from .cuda_ls import P_WIDE, fit_disp_line_search
    counts, _ = cs.make_inputs(cs.G_MAIN, cs.S_MAIN)
    args = {}
    for p in K1_PHASE_P:
        pin = checks.pipeline_inputs(counts, cs.paired_x(cs.S_MAIN, p),
                                     torch.float32, dev)
        k2 = fit_disp_line_search(pin["y"], pin["x"], pin["mu"], pin["la0"],
                                  pin["la0"], 1.0, pin["min_la"])
        args[p] = checks.irls_start(pin, k2["log_alpha"])
        del pin, k2
    src = build.CSRC if root is None else \
        Path(root).resolve() / "deseq2_tpu_torch" / "csrc"
    build.CSRC = src
    build._libs.clear()
    build.build_all(("irls", "irls_block"))
    for p in K1_PHASE_P:
        for w, (regs, spill, warps) in k1_resources(p).items():
            print(f"p={p} float32 K1 weighted={w} ({src}): {regs} registers,"
                  f" {spill} spill bytes, {warps} resident warps an SM",
                  flush=True)
    dst = build.BUILD_DIR / "phases_k1_csrc"
    _marked_csrc(dst, src)
    build.CSRC = dst
    build._libs.clear()
    build.build_all(("irls", "irls_block"))
    for p in K1_PHASE_P:
        lib = "irls" if p <= P_WIDE else "irls_block"
        fit_beta(*args[p])
        tot = _warp_clocks(lib, lambda: fit_beta(*args[p]))
        genes = max(tot[8], 1.0)
        whole = tot[:len(_K1_PHASES)].sum()
        print(f"p={p} float32 K1: {int(tot[8])} genes, "
              f"{tot[9] / genes:.3f} sweeps a gene, {whole / genes:,.0f} "
              f"clocks a gene (a warp's or a block's own clock)", flush=True)
        for k, n in enumerate(_K1_PHASES):
            print(f"  {n}: {tot[k] / genes:,.0f} clocks a gene, share "
                  f"{tot[k] / max(whole, 1.0):.3f}", flush=True)


def _time_paired(counts_path, subjects, dtype, calls, engine="auto"):
    """One turn of the paired study: a cold call, then `calls` warm calls
    of deseq() + results() on ~ subject + condition (sample j in subject
    j % subjects, the condition alternating within each subject) through
    `engine`; prints their wall seconds as one JSON line."""
    import json
    import time
    import numpy as np
    import torch
    import deseq2_tpu_torch as dt
    counts = np.load(counts_path)
    j = np.arange(counts.shape[1])
    col_data = {"subject": np.array([f"s{v}" for v in j % subjects]),
                "condition": np.where((j // subjects) % 2 == 0, "A", "B")}

    def call():
        dds = dt.dataset_from_matrix(counts, col_data,
                                     "~ subject + condition",
                                     config=dt.DESeqConfig(dtype=dtype))
        dt.results(dt.deseq(dds, engine=engine))
        torch.cuda.synchronize()

    call()
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        call()
        out.append(time.perf_counter() - t0)
    print(json.dumps(out))


def paired_args(args):
    """`paired`'s arguments PARENT_ROOT [P [CALLS [DTYPE [ENGINE]]]]:
    (root, p, calls, dtype name, engine)."""
    dtype = args[3] if len(args) > 3 else "float64"
    if dtype not in ("float64", "float32"):
        raise SystemExit(f"paired: DTYPE is float64 or float32, not {dtype}")
    engine = args[4] if len(args) > 4 else "auto"
    if engine not in ("auto", "host"):
        raise SystemExit(f"paired: ENGINE is auto or host, not {engine}")
    return (Path(args[0]).resolve(), int(args[1]) if len(args) > 1 else 64,
            int(args[2]) if len(args) > 2 else 1, dtype, engine)


def paired_study(parent_root, p, calls, dtype="float64", engine="auto"):
    """The paired call at p columns in dtype in both checkouts."""
    import numpy as np
    change_root = Path(__file__).resolve().parents[2]
    counts, _ = checks.bench_counts(60000, 1024)
    path = change_root / "build" / "study_main_counts.npy"
    path.parent.mkdir(parents=True, exist_ok=True)
    np.save(path, counts)
    import statistics
    got = {}
    for tag, root in (("parent", parent_root), ("change", change_root),
                      ("change", change_root), ("parent", parent_root)):
        secs = _run_turn(_time_paired,
                         (str(path), p - 1, dtype, calls, engine), root)
        got.setdefault(tag, []).extend(secs)
        print(f"turn {tag}: paired p = {p} {dtype} {engine} warm seconds "
              + ", ".join(f"{t:.3f}" for t in secs), flush=True)
    for tag, v in got.items():
        q = statistics.quantiles(v, n=4) if len(v) > 1 else [v[0]] * 3
        print(f"{tag}: median {statistics.median(v):.4f} s over {len(v)} "
              f"warm calls, quartiles {q[0]:.4f}-{q[2]:.4f}", flush=True)


def rlog_study(dev, n_seeds):
    import deseq2_tpu_torch as dt
    from ..engine import LOG2E, device_counts
    from ..hostdev import factors_t
    from ..transforms import (_blind, _dispersion_step, _rlog_prior_var,
                              rlog_arrow_irls)
    print(f"rlog's arrow IRLS, float32 against float64, {dev}")
    cases = [("main path's generator", checks.bench_counts, 4000, 0)] + [
        ("gate slice", checks.gate_counts, 2048, seed)
        for seed in range(n_seeds)]
    for name, make, G, seed in cases:
        S = 1024
        counts, _ = make(G, S, seed)
        dds = dt.dataset_from_matrix(
            counts, {"condition": np.repeat(["A", "B"], S // 2)},
            "~ condition")
        _blind(dds)
        dds = _dispersion_step(dt.estimate_size_factors(dds, device=dev),
                               "parametric", dev)
        nz = ~np.asarray(dds.row_data["allZero"], bool)
        y = device_counts(dds, dev)[torch.as_tensor(np.where(nz)[0],
                                                    device=dev)].double()
        nf = factors_t(dds, dev)
        dfit = torch.as_tensor(dds.row_data["dispFit"][nz], device=dev)
        bm = torch.as_tensor(dds.row_data["baseMean"][nz], device=dev)
        bpv = _rlog_prior_var(y / nf, bm, dfit)
        lam1, lam0 = (1.0 / bpv) / np.log(2.0) ** 2, 1e-6 / np.log(2.0) ** 2
        x64, _, it64 = rlog_arrow_irls(y, nf, dfit, lam0, lam1, True)
        x32, _, it32 = rlog_arrow_irls(y.float(), nf.float(), dfit.float(),
                                       lam0, lam1, True)
        d = (LOG2E * (x32.double() - x64).abs()).amax(dim=1).cpu().numpy()
        it = it64.cpu().numpy()
        print(f"  {name}, {G} x {S}, seed {seed}: float64 sweeps/gene mean {it.mean():.2f}, "
              f"p50/p90/p99 {np.percentile(it, [50, 90, 99])}, at maxit "
              f"{(it >= 100).mean():.4f}; float32 stops after other sweep "
              f"counts on {int((it32.cpu().numpy() != it).sum())} genes; "
              f"largest |float32 - float64| {d.max():.3g} log2 units, "
              f"genes past 1e-3 {int((d > 1e-3).sum())}, past 0.01 "
              f"{int((d > 0.01).sum())}", flush=True)


def sc_study(dev, G=30000, S=50000, seeds=7):
    from .. import profiling
    from ..parallel import sc
    counts, cells = checks.sc_bench_counts(G, S, dev)
    torch.cuda.synchronize()
    print(f"single-cell group QL, float32 calls, {G} x {S}, "
          f"max count {int(counts.max())}", flush=True)
    kw = dict(cells=cells, n_groups=2, size_factors=np.ones(S),
              test="LRT", fit_type="glmGamPoi", device=dev,
              dtype=torch.float32)
    sc.fused_sc_results(counts, **kw)          # warm-up
    f32, f64 = torch.float32, torch.float64
    cases = [(ck, f64) for ck in (1024, 2048, 4096, 8192)] + [(2048, f32)]
    for chunk, sdt in cases:
        sc.SEARCH_DTYPE = sdt
        info = {}
        profiling.reset()
        profiling.enable()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = sc.fused_sc_results(counts, chunk=chunk, info=info, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        profiling.disable()
        stages = {r["stage"]: round(r["seconds"], 3)
                  for r in profiling.records()}
        print(f"  chunk {chunk}, searches {str(sdt)[6:]}: {wall:.3f} s = "
              f"{G / wall:,.0f} genes/s, peak "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
              f"rejections {int(np.sum(out['padj'] < 0.1))}, stages "
              f"{stages}", flush=True)
    del counts
    # bench.py's gate: float32 calls on the card against the float64 call
    # on the CPU, with float64 and with float32 searches, over seeds
    for design in ("group", "covariate"):
        for seed in range(seeds if design == "group" else min(seeds, 3)):
            if design == "group":
                c, cl, sf = checks.sc_gate_inputs(2048, 4096, seed=seed)
                gk = dict(cells=cl, n_groups=2)
            else:
                c, x, red, sf = checks.sc_cov_gate_inputs(2048, 4096,
                                                          seed=seed + 1)
                gk = dict(design=x, reduced_design=red)
            gk.update(size_factors=sf, test="LRT", fit_type="glmGamPoi")
            sc.SEARCH_DTYPE = f64
            ref = sc.fused_sc_results(c, device="cpu", dtype=f64,
                                      use_hist=True, **gk)
            for sdt in (f64, f32):
                sc.SEARCH_DTYPE = sdt
                o = sc.fused_sc_results(c, device=dev, dtype=f32, **gk)
                r = checks.sc_gate(o, ref)
                print(f"  {design} gate, seed {seed}, searches "
                      f"{str(sdt)[6:]}: {r}", flush=True)
    sc.SEARCH_DTYPE = f64


def batch_rows_study(dev):
    """Row-count dependence of per-gene reductions and products."""
    from ..parallel.fused import rowcomb, rowdot
    g = torch.Generator(device="cpu").manual_seed(0)
    for dt in (torch.float64, torch.float32):
        for G, S in ((2048, 1024), (60000, 1024), (30000, 2048)):
            x = torch.rand(G, S, generator=g, dtype=torch.float64).to(dev, dt)
            w = torch.rand(S, 4, generator=g, dtype=torch.float64).to(dev, dt)
            forms = {"row sum": lambda a: a.sum(1),
                     "(N,S)@(S,4)": lambda a: a @ w,
                     "(N,4)@(4,S)": lambda a: a[:, :4] @ w.T,
                     "rowdot": lambda a: rowdot(a, w),
                     "rowcomb": lambda a: rowcomb(a[:, :4], w)}
            whole = {k: f(x) for k, f in forms.items()}
            for N in (3, 5, 15, 16, 17, 100, 1024, G // 4, G // 2):
                same = {k: (torch.equal(f(x[:N]), whole[k][:N]),
                            torch.equal(f(x[G - N:].contiguous()),
                                        whole[k][G - N:]))
                        for k, f in forms.items()}
                print(f"{str(dt)[6:]} G={G} S={S} N={N}: " + ", ".join(
                    f"{k} {a}/{b}" for k, (a, b) in same.items()), flush=True)
    # the fused pipeline on the gate slice, float64: a 2-block mesh on the
    # same device against one block, genes that differ per output
    from ..parallel import fused, gene_mesh
    from . import checks
    counts, _ = checks.gate_counts(2048, 1024)
    x = np.column_stack([np.ones(1024), np.repeat([0.0, 1.0], 512)])
    runs = [fused.fused_wald_pipeline(
        torch.as_tensor(counts).to(dev), torch.as_tensor(x), None,
        torch.as_tensor(fused.default_grid(1024)),
        cells=fused.design_cells(x), two_group=True, mesh=m)
        for m in (None, gene_mesh(devices=[dev, dev]))]
    for k, v in runs[0].items():
        if torch.is_tensor(v) and v.dim() and v.shape[0] == counts.shape[0]:
            a, b = v.double().cpu().numpy(), runs[1][k].double().cpu().numpy()
            off = ~np.isclose(b, a, rtol=1e-8, atol=1e-10, equal_nan=True)
            off = off.reshape(off.shape[0], -1).any(axis=1)
            print(f"fused pipeline, 2 blocks vs 1, {k}: {int(off.sum())} "
                  "genes differ", flush=True)


if __name__ == "__main__":
    if sys.argv[1] in ("edges", "expanded", "rlog", "batch_rows"):
        any_dev = (torch.device("cuda", 0) if torch.cuda.is_available()
                   else torch.device("cpu"))
        if sys.argv[1] == "edges":
            edges_study(any_dev, int(sys.argv[2]) if len(sys.argv) > 2
                        else 5, wide=sys.argv[3:4] == ["wide"])
        elif sys.argv[1] == "rlog":
            rlog_study(any_dev, int(sys.argv[2]) if len(sys.argv) > 2
                       else 4)
        elif sys.argv[1] == "batch_rows":
            batch_rows_study(any_dev)
        else:
            expanded_study(any_dev)
        raise SystemExit(0)
    if not torch.cuda.is_available():
        raise SystemExit("the studies need a CUDA device")
    dev = torch.device("cuda", 0)
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    if sys.argv[1] == "eigvalsh":
        eigvalsh_study(dev)
    elif sys.argv[1] == "mainpath":
        mainpath_study(Path(sys.argv[2]).resolve(),
                       int(sys.argv[3]) if len(sys.argv) > 3 else 5)
    elif sys.argv[1] == "wide":
        wide_study(dev, int(sys.argv[2]) if len(sys.argv) > 2 else 3)
    elif sys.argv[1] == "block":
        block_study(dev, int(sys.argv[2]) if len(sys.argv) > 2 else 3)
    elif sys.argv[1] == "crossover":
        crossover_study(dev, int(sys.argv[2]) if len(sys.argv) > 2 else 3)
    elif sys.argv[1] == "variant":
        variant_study(dev, sys.argv[2],
                      int(sys.argv[3]) if len(sys.argv) > 3 else 3)
    elif sys.argv[1] == "phases" and sys.argv[2:3] == ["k1"]:
        k1_phases_study(dev, *sys.argv[3:4])
    elif sys.argv[1] == "phases" and sys.argv[2:3] == ["k3"]:
        k3_phases_study(dev, *sys.argv[3:4])
    elif sys.argv[1] == "phases":
        phases_study(dev)
    elif sys.argv[1] == "paired":
        paired_study(*paired_args(sys.argv[2:]))
    elif sys.argv[1] == "sc":
        sc_study(dev, *[int(a) for a in sys.argv[2:5]])
    elif sys.argv[1] == "scpaths":
        scpaths_study(Path(sys.argv[2]).resolve(),
                      int(sys.argv[3]) if len(sys.argv) > 3 else 2)
    elif sys.argv[1] == "k2":
        k2_study(dev, *k2_args(sys.argv[2:]))
    elif sys.argv[1] == "k1":
        k1_study(dev, *k1_args(sys.argv[2:]))
    elif sys.argv[1] == "k3":
        k3_study(dev, *k3_args(sys.argv[2:]))
    elif sys.argv[1] == "kernels":
        kernels_study(dev, Path(sys.argv[2]).resolve(),
                      int(sys.argv[3]) if len(sys.argv) > 3 else 7)
    else:
        ls_study(dev, int(sys.argv[2]) if len(sys.argv) > 2 else 20)
