"""Compare the machine code (SASS) of the kernels' default
instantiations, unweighted and weighted, between two checkouts of the
repository (the templated kernels for p = 1..8, the wide kernels for 8 <
p <= 16 and the block kernels for 16 < p <= 64, both dtypes):

    python -m deseq2_tpu_torch.ops.sass_compare OLD_ROOT NEW_ROOT [KERNEL ...]

KERNEL is irls, disp_ls, disp_grid, irls_block, disp_ls_block or
disp_grid_block (default: all six).  Each
checkout's csrc/<kernel>.cu is compiled to a cubin
with ops/build.py's nvcc flags (one nvcc per source, all started together)
into NEW_ROOT/build/sass/, and disassembled with cuobjdump.  For every
kernel, dtype and design width p it prints both instruction counts and
whether the instructions (addresses and encodings stripped) are the same.
Each kernel template's `bool UseW` parameter is matched by its `false`
(unweighted) and `true` (weighted) instantiations, and a trailing `bool
UseCR` parameter (K2, K3) by its `true` instantiation, the default
mode.  Needs the CUDA toolkit (nvcc,
cuobjdump), not a card.
"""

from __future__ import annotations

import difflib
import re
import shutil
import subprocess
import sys
from pathlib import Path

from .build import NVCC_FLAGS, _nvcc

SYMBOL = {"irls": "irls_kernel", "disp_ls": "ls_kernel",
          "disp_grid": "grid_kernel", "irls_block": "irls_block_kernel",
          "disp_ls_block": "ls_block_kernel",
          "disp_grid_block": "grid_block_kernel"}
KERNELS = tuple(SYMBOL)


def _cuobjdump():
    return shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"


def build_cubins(root, out, tag, kernels=KERNELS):
    """Compile root's kernel sources to out/<tag>_<kernel>.cubin."""
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    procs = {}
    for k in kernels:
        src = Path(root) / "deseq2_tpu_torch" / "csrc" / f"{k}.cu"
        procs[k] = subprocess.Popen(
            [_nvcc(), *flags, "-cubin", "-o", str(out / f"{tag}_{k}.cubin"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    for k, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {tag} {k}.cu:\n{log[-4000:]}")


def functions(cubin):
    """{mangled name: [instruction, ...]} of a cubin's SASS."""
    text = subprocess.run([_cuobjdump(), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    parts = re.split(r"\n\s*Function : (\S+)\n", text)
    out = {}
    for name, body in zip(parts[1::2], parts[2::2]):
        out[name] = [m.group(1) for m in
                     (re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
                      for line in body.splitlines()) if m]
    return out


def _pick(funcs, sym, t, p, w=0):
    """The <t, p> instantiation of kernel `sym` in its default mode,
    unweighted (w=0) or weighted (w=1), or None; p "wide" picks the wide
    kernel, p "block" a block kernel (p a launch argument of both)."""
    pat = (rf"{sym.replace('_kernel', '_wide_kernel')}I{t}Lb{w}E(Lb1E)?E"
           if p == "wide" else rf"{sym}I{t}Lb{w}E(Lb1E)?E" if p == "block"
           else rf"{sym}I{t}Li{p}ELb{w}E(Lb1E)?E")
    hits = [n for n in funcs if re.search(pat, n)]
    return funcs[hits[0]] if len(hits) == 1 else None


def compare(old_root, new_root, kernels=KERNELS):
    """Print one line per kernel, dtype and p; returns the number of
    instantiations whose instructions differ."""
    out = Path(new_root) / "build" / "sass"
    out.mkdir(parents=True, exist_ok=True)
    build_cubins(old_root, out, "old", kernels)
    build_cubins(new_root, out, "new", kernels)
    differ = 0
    for k in kernels:
        old, new = (functions(out / f"{tag}_{k}.cubin")
                    for tag in ("old", "new"))
        block = k.endswith("_block")
        for t, dname in (("f", "float"), ("d", "double")):
            for p in ("block",) if block else (*range(1, 9), "wide"):
                for w, wname in ((0, "unweighted"), (1, "weighted")):
                    a, b = (_pick(f, SYMBOL[k], t, p, w) for f in (old, new))
                    if a is None or b is None:
                        print(f"{k} <{dname},{p}> {wname}: not found")
                        differ += 1
                        continue
                    same = a == b
                    differ += not same
                    match = sum(m.size for m in difflib.SequenceMatcher(
                        None, a, b, autojunk=False).get_matching_blocks())
                    print(f"{k} <{dname},{p}> {wname}: {len(a)} / {len(b)} "
                          f"instructions, identical={same}, in order {match}")
    return differ


if __name__ == "__main__":
    n = compare(sys.argv[1], sys.argv[2], tuple(sys.argv[3:]) or KERNELS)
    print(f"{n} default instantiation(s) differ")
