"""The port stands alone: importing deseq2_tpu_torch loads neither jax nor
deseq2_tpu, and no file of the port or the smoke script imports them."""

import ast
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "deseq2_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "deseq2_tpu")


def test_import_loads_no_jax():
    code = ("import sys, deseq2_tpu_torch, deseq2_tpu_torch.parallel.fused, "
            "deseq2_tpu_torch.ops.cuda_irls, deseq2_tpu_torch.ops.cuda_ls, "
            "deseq2_tpu_torch.ops.cuda_grid, deseq2_tpu_torch.transforms, "
            "deseq2_tpu_torch.helper, deseq2_tpu_torch.io, "
            "deseq2_tpu_torch.plots, deseq2_tpu_torch.singlecell_tab, "
            "deseq2_tpu_torch.gampoi, deseq2_tpu_torch.parallel.sc, "
            "deseq2_tpu_torch.ops.padding\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]"
            "\nprint(bad)\nsys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"
