"""Build the block kernels' and the wide K1's and K2's CUDA sources for
the host and run them there.

`build(out_dir)` copies deseq2_tpu_torch/csrc/irls_block.cu,
disp_ls_block.cu, disp_grid_block.cu, disp_ls.cu, irls.cu and
disp_grid.cu with common.cuh, replaces their inline PTX (mma.sync,
cp.async) by cuda_runtime.h's emulation, their dynamic shared memory by
the emulated launch's buffer, their static shared arrays by static
variables (one for the whole launch, whose blocks run one after
another) and their kernel launches by emu::launch_kernel, and compiles
each with g++ -std=c++20 and an address sanitizer into a shared library
with the sources' own C interface.  disp_ls.cu, irls.cu and disp_grid.cu
are built with their templated kernels for p <= 8 at P = 1 and 2 in
float64 alone (DK_DISPATCH_P dispatches no other): those and their wide
kernels are what is emulated.

    python emulate.py LIB_DIR KERNEL P S G WEIGHTED [DTYPE [MODE]]

(run under LD_PRELOAD of the sanitizer's runtime, as
tests/test_torch_block_emulation.py does) holds the emulated K1 (irls)
or K2 (ls, with and without the prior), the templated kernel for p <= 2
(float64), the wide kernel for p <= 16 and the block kernel past it, or
K3 (grid, with and without the prior: the templated kernel for p <= 2 in
float64, the wide kernel for 8 < p <= 16, the block kernel past 16
columns), DTYPE float64 (the default)
or float32, in K2's and K3's MODE (nocr: without the Cox-Reid term; thr:
the weighted row cut at 0.5; checks.MODES) or K1's (sf: an (S,) row of
normalization factors exp(N(0, 0.4)); gsnf: a (G,S) matrix of them; else
unit factors), against the plain PyTorch version on ops/checks.py's
inputs with phase 3's readings (in float32: K1 held to the fit in
float64, a K2 or K3 reading past checks.TOL held to the plain version's
spread over permutations, as phase 3 holds them; in float64 K3 by phase
3's reading and by its pick: the plain version's, or a point whose log
posterior is within 1e-12 of the plain pick's, relative), runs each
launch twice, and prints the readings as one JSON line.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parents[1]
CSRC = REPO / "deseq2_tpu_torch" / "csrc"
LIBS = ("irls_block", "disp_ls_block", "disp_grid_block", "disp_ls",
        "irls", "disp_grid")


def _body(text, head, body):
    """text with the braces of the function starting at `head` holding
    `body` instead."""
    i = text.index(head)
    j = text.index("{", i)
    depth = 0
    for k in range(j, len(text)):
        depth += {"{": 1, "}": -1}.get(text[k], 0)
        if depth == 0:
            return text[:j] + "{" + body + "}" + text[k + 1:]
    raise ValueError(head)


def build(out_dir, names=LIBS):
    """Patch and compile the libraries `names` (default: all of LIBS) into
    out_dir; returns {name: path}."""
    out = Path(out_dir)
    common = (CSRC / "common.cuh").read_text()
    common = _body(common, "void mma_f64(", " emu::mma(c, a, b); ")
    common = _body(common, "void cp_async8(",
                   " *dst = valid ? *src : 0.0; ")
    common = _body(common, "void cp_async_wait_all(", " ")
    # of the templated instantiations (p <= 8) only P = 1 and 2 in float64
    # are built and dispatched
    i = common.index("#define DK_DISPATCH_P(p, ...)")
    common = (common[:i] + "#define DK_DISPATCH_P(p, ...) "
              "if constexpr (!dk::is_f32<T>()) { switch (p) { "
              "case 1: { constexpr int P = 1; __VA_ARGS__; } break; "
              "case 2: { constexpr int P = 2; __VA_ARGS__; } break; "
              "default: break; } } "
              "return (int)cudaErrorInvalidValue;\n")
    (out / "common.cuh").write_text(common)
    paths, procs = {}, {}
    for name in names:
        src = (CSRC / f"{name}.cu").read_text()
        src = src.replace(
            "extern __shared__ __align__(16) unsigned char smem_raw[];",
            "unsigned char* smem_raw = emu::smem;")
        src = re.sub(r"(\w+(?:<[\w, ]+>)?)<<<(\w+), ([^,]+), smem, st>>>\(",
                     r"emu::launch_kernel(\2, \3, smem, \1, ", src)
        src = re.sub(r"__shared__ (\w+) (\w+)\[", r"static \1 \2[", src)
        cpp = out / f"{name}.cpp"
        cpp.write_text("#include <cuda_runtime.h>\n" + src)
        paths[name] = out / f"lib{name}.so"
        # one g++ a library, all started together
        procs[name] = subprocess.Popen(
            ["g++", "-std=c++20", "-O1", "-fsanitize=address",
             "-fno-omit-frame-pointer", "-shared", "-fPIC", "-w", "-pthread",
             "-I", str(out), "-I", str(HERE), "-o", str(paths[name]),
             str(cpp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {name}:\n{log[-4000:]}")
    return paths


def build_special(out_dir):
    """common.cuh's lgamma_digamma for the host: special.cpp against the
    patched common.cuh that build(out_dir) wrote, without the sanitizer
    (the library is loaded in the test's own process); returns its
    path."""
    out = Path(out_dir)
    path = out / "libspecial.so"
    subprocess.run(
        ["g++", "-std=c++20", "-O1", "-shared", "-fPIC", "-w", "-I",
         str(out), "-I", str(HERE), "-o", str(path),
         str(HERE / "special.cpp")], check=True, capture_output=True,
        text=True)
    return path


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def run_grid(lib_dir, raw, p, S, G, dtype="float64", mode=None):
    """The emulated K3 (the templated kernel for p <= 8, the wide kernel
    for 8 < p <= 16, the block kernel past 16 columns) in dtype against the
    plain version on raw's inputs,
    with and without the prior: phase 3's reading (check_grid; in float32
    against the float64 reference, past checks.TOL the plain version's
    spread) and in float64 the pick rule (the module's docstring)."""
    import torch
    from deseq2_tpu_torch.ops import checks, disp
    f64 = dtype == "float64"
    kdt = getattr(torch, dtype)
    block = p > 16
    P, I = ctypes.c_void_p, ctypes.c_int
    scal = ctypes.c_double if f64 else ctypes.c_float
    name, sym = ("disp_grid_block", "grid_block") if block \
        else ("disp_grid", "grid")
    lib = ctypes.CDLL(str(Path(lib_dir) / f"lib{name}.so"))
    fn = getattr(lib, f"{sym}_launch_{'f64' if f64 else 'f32'}")
    fn.argtypes = [P] * 6 + [I] * 4 + [scal, I, I, scal, P] \
        + ([P, P, I] if block else []) + [P]
    fn.restype = I
    rows = lib.grid_block_scratch_rows if block else None
    if block:
        rows.argtypes = [I] * 5
        rows.restype = I
    d = checks.as_tensors(raw, kdt, torch.device("cpu"))
    if mode is not None:
        d = checks.with_mode(d, mode)

    def k3(y, x, mu, grid, pm, prior_var, use_prior=False, weights=None,
           use_cr=True, weight_threshold=checks.CR_WEIGHT_THRESHOLD):
        # the wide and the block kernels read the design transposed
        c = [t.to(kdt).contiguous() for t in
             (y, mu, x.t() if p > 8 else x, grid, pm)]
        w = None if weights is None else weights.to(kdt).contiguous()
        out = torch.empty(G, dtype=kdt)
        extra = ()
        if block:
            n = rows(int(f64), int(w is not None), p, int(use_cr), G)
            scratch = torch.full((max(n, 1), S), float("nan"), dtype=kdt)
            counter = torch.zeros(1, dtype=torch.int32)
            extra = (_ptr(counter), _ptr(scratch), n)
        err = fn(_ptr(c[0]), _ptr(c[1]), _ptr(w), _ptr(c[2]), _ptr(c[3]),
                 _ptr(c[4]), G, S, p, len(grid), float(prior_var),
                 int(use_prior), int(use_cr), float(weight_threshold),
                 _ptr(out), *extra, None)
        assert err == 0, err
        return out

    out = {}
    for use_prior in (False, True):
        a = checks.run_grid(k3, d, use_prior)
        pl = checks.run_grid(disp.fit_disp_grid_plain, d, use_prior)
        rep = checks.differing_outputs(
            {"log_alpha": a},
            {"log_alpha": checks.run_grid(k3, d, use_prior)})
        if f64:
            r = checks.check_grid(a, pl, d, use_prior)
            la, lpl = (checks.lp_at(v, d, use_prior, checks.PRIOR_VAR)
                       for v in (a, pl))
            close = (lpl - la).abs() <= 1e-12 * lpl.abs()
            out[f"grid prior={use_prior}"] = dict(
                ok=r["ok"] and bool(((a == pl) | close).all()),
                lp_rel=r["lp_rel"], same=r["same"],
                other_pick=int((a != pl).sum()), repeat_differs=rep)
        else:
            ref = checks.grid_reference(d, use_prior)
            r = checks.check_grid(a, pl, d, use_prior, ref=ref)
            if not r["ok"]:
                r = checks.within_plain_spread("grid", r, pl, d, use_prior,
                                               ref)
            out[f"grid prior={use_prior}"] = dict(
                ok=r["ok"], short_kernel=r["short_kernel"],
                same=r["same"], repeat_differs=rep)
    return out


def run(lib_dir, kernel, p, S, G, weighted, dtype="float64", mode=None):
    """The emulated kernel against the plain version (see the module's
    docstring); returns the readings."""
    import numpy as np
    import torch
    sys.path.insert(0, str(REPO))
    from deseq2_tpu_torch.ops import checks, disp, irls
    torch.set_num_threads(1)
    P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_double
    f64 = torch.float64
    # K2's modes on phase 3's inputs of its modes (check_kernel_modes)
    raw = checks.solver_inputs(
        G, S, p, checks.seed_of(p, S, mode if kernel == "ls" else None),
        weighted=weighted)
    d = checks.as_tensors(raw, f64, torch.device("cpu"))
    out = {}
    # the templated kernels (p <= 8) take the design as (S, p), the others
    # transposed
    xt = (lambda x: x) if p <= 8 else (lambda x: x.t())
    if kernel == "grid":
        return run_grid(lib_dir, raw, p, S, G, dtype, mode)
    if kernel == "irls":
        # the wide kernel (irls.cu) for p <= 16, the block kernel past it
        sym = "irls_block" if p > 16 else "irls"
        lib = ctypes.CDLL(str(Path(lib_dir) / f"lib{sym}.so"))
        kdt = getattr(torch, dtype)
        scal = D if dtype == "float64" else ctypes.c_float
        fn = getattr(lib, f"{sym}_launch_"
                     f"{'f64' if dtype == 'float64' else 'f32'}")
        fn.argtypes = [P, P, L, P, P, P, P, P, I, I, I, scal, I, scal] \
            + [P] * 8
        fn.restype = I

        def k1(y, x, nf, alpha, beta_init, ridge, tol=1e-8, maxit=100,
               min_mu=0.5, weights=None):
            c = [t.to(kdt).contiguous() for t in
                 (y, xt(x), nf, alpha, beta_init, ridge)]
            w = None if weights is None else weights.to(kdt).contiguous()
            res = dict(beta=torch.empty(G, p, dtype=kdt),
                       beta_var=torch.empty(G, p, dtype=kdt),
                       deviance=torch.empty(G, dtype=kdt),
                       iter=torch.empty(G, dtype=torch.int32),
                       mu=torch.empty(G, S, dtype=kdt),
                       hat_diag=torch.empty(G, S, dtype=kdt))
            counter = torch.zeros(1, dtype=torch.int32)
            err = fn(_ptr(c[0]), _ptr(c[2]), S if nf.dim() == 2 else 0,
                     _ptr(w), _ptr(c[3]),
                     _ptr(c[4]), _ptr(c[5]), _ptr(c[1]), G, S, p, tol,
                     maxit, min_mu,
                     *(_ptr(res[k]) for k in ("beta", "beta_var",
                                              "deviance", "iter", "mu",
                                              "hat_diag")),
                     _ptr(counter), None)
            assert err == 0, err
            return res

        dk = checks.as_tensors(raw, kdt, torch.device("cpu"))
        run_k1 = checks.run_irls
        if mode in ("sf", "gsnf"):
            # normalization factors exp(N(0, 0.4)): an (S,) row (sf) or a
            # (G,S) matrix (gsnf), where run_irls' unit factors leave
            # log(nf) = 0
            rng = np.random.default_rng(S)
            nf = torch.as_tensor(np.exp(rng.normal(
                0.0, 0.4, (G, S) if mode == "gsnf" else S)), dtype=kdt)

            def run_k1(f, dd):
                ridge = checks.ridge_for(p, kdt, torch.device("cpu"))
                return f(dd["y"], dd["x"], nf, dd["alpha"], dd["b0"], ridge,
                         maxit=100, min_mu=0.5, weights=dd.get("w"))
        a = run_k1(k1, dk)
        pl = run_k1(irls.fit_beta_plain, dk)
        # K1's other outputs against the fit in float64 (in float32 beside
        # the plain version's, checks.check_irls_f64's outputs rule), on
        # the genes the fits converged
        if dtype == "float64":
            r = checks.check_irls(a, pl)
            r["outputs_rel_f64_kernel"] = checks.irls_outputs_rel(
                a, pl, (a["iter"] < 100) & (pl["iter"] < 100))
            r["same_iter"] = (a["iter"] == pl["iter"]).double().mean().item()
        else:
            ref = run_k1(irls.fit_beta_plain, d)
            r = checks.check_irls_f64(a, pl, ref, outputs=True)
        out["irls"] = dict(ok=r["ok"], beta_rel=r["beta_rel"],
                           rel=r["outputs_rel_f64_kernel"],
                           repeat_differs=checks.differing_outputs(
                               a, run_k1(k1, dk)))
        if dtype == "float32":
            out["irls"]["rel_plain"] = r["outputs_rel_f64_plain"]
        else:
            out["irls"]["same_iter"] = r["same_iter"]
    else:
        # the wide kernel (disp_ls.cu) for p <= 16, the block kernel past it
        sym = "ls_block" if p > 16 else "ls"
        lib = ctypes.CDLL(str(Path(lib_dir) / f"libdisp_{sym}.so"))
        kdt = getattr(torch, dtype)
        d = checks.with_mode(checks.as_tensors(raw, kdt,
                                               torch.device("cpu")), mode)
        scal = D if dtype == "float64" else ctypes.c_float
        fn = getattr(lib, f"{sym}_launch_"
                     f"{'f64' if dtype == 'float64' else 'f32'}")
        fn.argtypes = [P] * 6 + [I, I, I] + [scal] * 4 + [I, I, I, scal] + \
            [P] * 9 + [P, I, P]
        fn.restype = I
        rows = getattr(lib, f"{sym}_scratch_rows")
        rows.argtypes = [I] * 5
        rows.restype = I
        names = ("log_alpha", "initial_lp", "initial_dlp", "last_lp",
                 "last_dlp", "last_change")

        def k2(y, x, mu, la0, pm, prior_var, min_la, kappa_0=1.0, tol=1e-6,
               maxit=100, use_prior=False, weights=None, use_cr=True,
               weight_threshold=checks.CR_WEIGHT_THRESHOLD):
            c = [t.to(kdt).contiguous() for t in (y, mu, xt(x), la0, pm)]
            w = None if weights is None else weights.to(kdt).contiguous()
            res = {k: torch.empty(G, dtype=kdt) for k in names}
            res["iter"] = torch.empty(G, dtype=torch.int32)
            res["iter_accept"] = torch.empty(G, dtype=torch.int32)
            n = rows(int(kdt == torch.float64), int(w is not None), p,
                     int(use_cr), G)
            scratch = torch.full((max(n, 1), S), float("nan"), dtype=kdt)
            counter = torch.zeros(1, dtype=torch.int32)
            err = fn(_ptr(c[0]), _ptr(c[1]), _ptr(w), _ptr(c[2]),
                     _ptr(c[3]), _ptr(c[4]), G, S, p, float(prior_var),
                     float(kappa_0), float(tol), float(min_la), maxit,
                     int(use_prior), int(use_cr), float(weight_threshold),
                     *(_ptr(res[k]) for k in names), _ptr(res["iter"]),
                     _ptr(res["iter_accept"]), _ptr(counter),
                     _ptr(scratch), n, None)
            assert err == 0, err
            return res

        f32 = dtype == "float32"
        for use_prior in (False, True):
            a = checks.run_ls(k2, d, use_prior)
            pl = checks.run_ls(disp.fit_disp_line_search_plain, d, use_prior)
            ref = checks.line_search_reference(d, use_prior) if f32 else None
            r = checks.check_ls(a, pl, d, use_prior, ref=ref)
            if f32 and not r["ok"]:
                r = checks.within_plain_spread(
                    "ls", r, pl, d, use_prior, ref, k=a,
                    edge=checks.edge_stops(a, pl, d, use_prior))
            out[f"ls prior={use_prior}"] = dict(
                ok=r["ok"], lp_rel=r.get("lp_rel"), agree=r.get("agree"),
                repeat_differs=checks.differing_outputs(
                    a, checks.run_ls(k2, d, use_prior)))
    return out


if __name__ == "__main__":
    lib_dir, kernel, p, S, G, weighted = sys.argv[1:7]
    print(json.dumps(run(lib_dir, kernel, int(p), int(S), int(G),
                         weighted == "1", *sys.argv[7:9])))
