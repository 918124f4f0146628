"""Measurements on the card behind choices recorded in PERF.md and
ROADMAP.md:

    python -m deseq2_tpu_torch.ops.studies eigvalsh
    python -m deseq2_tpu_torch.ops.studies ls [N_SEEDS]
    python -m deseq2_tpu_torch.ops.studies kernels PARENT_ROOT [REPS]
    python -m deseq2_tpu_torch.ops.studies edges [N_PERM [wide]]
    python -m deseq2_tpu_torch.ops.studies expanded
    python -m deseq2_tpu_torch.ops.studies mainpath PARENT_ROOT [CALLS]
    python -m deseq2_tpu_torch.ops.studies wide [REPS]
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
parent's mean over the change's, and whether the two turns of each
checkout gave the same outputs bit for bit.

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
        ls_args = (t["y"], t["x"], t["mu"], t["la0"], t["la0"], 1.0,
                   t["min_la"])
        irls_args = (t["y"], t["x"], t["sf"], t["alpha"], t["beta0"],
                     t["ridge"])
        calls = {
            "disp_ls": lambda: cuda_ls.fit_disp_line_search(
                *ls_args, weights=t.get("w_ge")),
            "irls": lambda: cuda_irls.fit_beta(*irls_args,
                                               weights=t.get("w_n")),
            "disp_grid": lambda: {"log_alpha": cuda_grid.fit_disp_grid(
                t["gy"], t["x"], t["gmu"], t["grid"], t["gpm"], 1.0,
                weights=t.get("gw"))}}
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


def kernels_study(dev, parent_root, reps):
    change_root = Path(__file__).resolve().parents[2]
    data = _kernel_inputs(dev)
    path = change_root / "build" / "study_kernels_inputs.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save(data, path)
    del data
    torch.cuda.empty_cache()
    turns = (("parent", parent_root), ("change", change_root),
             ("change", change_root), ("parent", parent_root))
    got = []
    for tag, root in turns:
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
        print(f"{case}: {times}; parent/change "
              f"{mean['parent'] / mean['change']:.2f}x; repeat-identical "
              f"{same}")


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
    elif sys.argv[1] == "sc":
        sc_study(dev, *[int(a) for a in sys.argv[2:5]])
    elif sys.argv[1] == "scpaths":
        scpaths_study(Path(sys.argv[2]).resolve(),
                      int(sys.argv[3]) if len(sys.argv) > 3 else 2)
    elif sys.argv[1] == "kernels":
        kernels_study(dev, Path(sys.argv[2]).resolve(),
                      int(sys.argv[3]) if len(sys.argv) > 3 else 7)
    else:
        ls_study(dev, int(sys.argv[2]) if len(sys.argv) > 2 else 20)
