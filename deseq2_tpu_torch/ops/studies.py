"""Two measurements on the card behind choices recorded in PERF.md and
ROADMAP.md:

    python -m deseq2_tpu_torch.ops.studies eigvalsh
    python -m deseq2_tpu_torch.ops.studies ls [N_SEEDS]

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
"""

from __future__ import annotations

import sys
import time

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


if __name__ == "__main__":
    if not torch.cuda.is_available():
        raise SystemExit("the studies need a CUDA device")
    dev = torch.device("cuda", 0)
    print(torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    if sys.argv[1] == "eigvalsh":
        eigvalsh_study(dev)
    else:
        ls_study(dev, int(sys.argv[2]) if len(sys.argv) > 2 else 20)
