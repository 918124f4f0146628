"""The card studies' source edits, checked on the CPU: `studies phases`
inserts clock64 marks into a copy of the kernels' sources at anchors
(studies._PHASES, and the float32 K1's studies._K1_MARKS); each anchor
must still be in its source, so that the study builds what it says it
times."""

import pytest

from deseq2_tpu_torch.ops import build, studies
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", sorted(studies._PHASES))
def test_phase_marks_match_the_sources(name):
    src = (build.CSRC / name).read_text()
    for anchor, marked in studies._PHASES[name]:
        # the anchor is in the source, and the mark keeps its lines
        assert anchor in src, anchor
        assert "DK_T" in marked
        assert all(line in marked for line in anchor.split("\n")), anchor


@pytest.mark.parametrize("args, want", [
    (["root"], (64, 1, "float64", "auto")),
    (["root", "25", "2", "float32"], (25, 2, "float32", "auto")),
    (["root", "10", "1", "float64"], (10, 1, "float64", "auto")),
    (["root", "10", "4", "float64", "host"], (10, 4, "float64", "host")),
])
def test_paired_study_arguments(args, want):
    # `studies paired PARENT_ROOT [P [CALLS [DTYPE [ENGINE]]]]`: the dtype
    # argument times the float32 paired calls beside the float64 ones, the
    # engine argument the host engine's
    root, p, calls, dtype, engine = studies.paired_args(args)
    assert root.name == "root"
    assert (p, calls, dtype, engine) == want


def test_paired_study_refuses_other_dtypes():
    with pytest.raises(SystemExit):
        studies.paired_args(["root", "25", "1", "float16"])


def test_paired_study_refuses_other_engines():
    with pytest.raises(SystemExit):
        studies.paired_args(["root", "10", "1", "float64", "xla"])


@pytest.mark.parametrize("args, want", [
    (["root"], (5, studies.K2_CASES, ())),
    (["root", "3", "16:float64", "64:float32"],
     (3, ((16, "float64"), (64, "float32")), ())),
    (["root,a,b", "3", "25:float32"], (3, ((25, "float32"),), ("a", "b"))),
    (["root", "3", "1:float64", "2:float64", "8:float32"],
     (3, ((1, "float64"), (2, "float64"), (8, "float32")), ())),
])
def test_k2_study_arguments(args, want):
    # `studies k2 PARENT_ROOT[,ROOT...] [REPS [P:DTYPE ...]]`: the widths
    # past the default cases (the templated kernels' p = 1-8, the wide
    # kernel's p = 16, the block kernel's 17-64), and study variants timed
    # beside the change
    root, reps, cases, others = studies.k2_args(args)
    assert root.name == "root"
    assert (reps, cases, tuple(r.name for r in others)) == want


@pytest.mark.parametrize("case", ["0:float64", "65:float32", "16:float16",
                                  "16", "2:float64:w"])
def test_k2_study_refuses_other_cases(case):
    with pytest.raises(SystemExit):
        studies.k2_args(["root", "3", case])


def test_k3_phase_marks_time_every_phase_of_the_float32_point():
    # `phases k3`: the float32 block K3's point (log_post_rows) is marked
    # in every slot of _K3_PHASES and counts its points; the earlier
    # design's marks (for an earlier checkout) keep their anchors' lines
    src = (build.CSRC / "disp_grid_block.cu").read_text()
    i = src.index("__device__ __forceinline__ void log_post_rows(")
    body = src[i:src.index("\n}\n", i)]
    text = "".join(m for a, m in studies._PHASES["disp_grid_block.cu"]
                   if a in body)
    for k in range(len(studies._K3_PHASES)):
        assert f"DK_T({k}, c0)" in text, k
    assert "DK_T0(c0)" in text and "dk_clk[8]" in text
    # each anchor once in the source: a mark lands in its own function
    for anchor, _ in studies._PHASES["disp_grid_block.cu"]:
        assert src.count(anchor) == 1, anchor
    for anchor, marked in studies._K3_EARLIER_MARKS["disp_grid_block.cu"]:
        assert "DK_T" in marked
        assert all(line in marked for line in anchor.split("\n")), anchor


def test_k3_phase_marks_time_every_phase_of_the_wide_point():
    # `phases k3`: the wide K3's pair of points (log_post_wide_pair) is
    # marked in every slot of _K3_PHASES and counts its points, each
    # anchor once in disp_grid.cu; the earlier design's marks (a point a
    # pass, for an earlier checkout) time every slot and keep their
    # anchors' lines
    src = (build.CSRC / "disp_grid.cu").read_text()
    for marks in (studies._PHASES["disp_grid.cu"],
                  studies._K3_EARLIER_MARKS["disp_grid.cu"]):
        text = "".join(m for _, m in marks)
        for k in range(len(studies._K3_PHASES)):
            assert f"DK_T({k}, c" in text, k
        assert "dk_clk[8]" in text
        for anchor, marked in marks:
            assert all(line in marked for line in anchor.split("\n"))
    for anchor, _ in studies._PHASES["disp_grid.cu"]:
        assert src.count(anchor) == 1, anchor


@pytest.mark.parametrize("args, want", [
    (["root"], (5, studies.K3_CASES, ())),
    (["root", "5", "17:float32", "2:float64"],
     (5, ((17, "float32"), (2, "float64")), ())),
    (["root", "3", "1:float64:w", "2:float64:nocr", "3:float64"],
     (3, ((1, "float64", "w"), (2, "float64", "nocr"), (3, "float64")),
      ())),
])
def test_k3_study_arguments(args, want):
    # `studies k3 PARENT_ROOT[,ROOT...] [REPS [P:DTYPE[:MODE] ...]]`: by
    # default the float64 block K3's widths, the float32 block K3 at p =
    # 25 and the narrow float64 K3 at p = 2; a case may be weighted or
    # without the Cox-Reid term
    root, reps, cases, others = studies.k3_args(args)
    assert root.name == "root"
    assert (reps, cases, tuple(r.name for r in others)) == want
    assert (25, "float32") in studies.K3_CASES
    assert (2, "float64") in studies.K3_CASES
    # the wide K3 at the paired p = 10, both dtypes
    assert {(10, "float32"), (10, "float64")} <= set(studies.K3_CASES)


@pytest.mark.parametrize("case", ["2:float64:thr", "2:float64:w:x", "0:float64"])
def test_k3_study_refuses_other_cases(case):
    with pytest.raises(SystemExit):
        studies.k3_args(["root", "3", case])


def test_k1_phase_marks_match_the_sources():
    # `phases k1` marks this checkout's float32 K1 (the wide and the block
    # kernel): each anchor once per source and its lines kept
    for name, ms in studies._K1_MARKS.items():
        src = (build.CSRC / name).read_text()
        for anchor, marked in ms:
            assert src.count(anchor) == 1, anchor
            assert "DK_T" in marked
            assert all(line in marked for line in anchor.split("\n"))


@pytest.mark.parametrize("name", ["irls.cu", "irls_block.cu"])
def test_k1_phase_marks_time_every_phase(name):
    # every K1 phase slot is read, and the genes and sweeps are counted
    text = "".join(m for _, m in studies._K1_MARKS[name])
    for k in range(len(studies._K1_PHASES)):
        assert f"({k}, c" in text, k
    assert "DK_TN(" in text and "DK_TC(9," in text


@pytest.mark.parametrize("args, want", [
    (["root"], (5, studies.K1_CASES, ())),
    (["root", "3", "9:float32", "64:float32", "25:float64"],
     (3, ((9, "float32"), (64, "float32"), (25, "float64")), ())),
    (["root,v1", "2", "10:float32"], (2, ((10, "float32"),), ("v1",))),
    (["root", "3", "2:float64", "5:float64"],
     (3, ((2, "float64"), (5, "float64")), ())),
])
def test_k1_study_arguments(args, want):
    # `studies k1 PARENT_ROOT[,ROOT...] [REPS [P:DTYPE ...]]`: the paired
    # widths of the wide and the block K1 in both dtypes by default
    root, reps, cases, others = studies.k1_args(args)
    assert root.name == "root"
    assert (reps, cases, tuple(r.name for r in others)) == want


@pytest.mark.parametrize("case", ["0:float32", "65:float64", "25:float16"])
def test_k1_study_refuses_other_cases(case):
    with pytest.raises(SystemExit):
        studies.k1_args(["root", "3", case])


@pytest.mark.parametrize("p, want", [(1, [[1.0]] * 4),
                                     (2, [[1, 0], [1, 0], [1, 1], [1, 1]]),
                                     (3, [[1, 0, 0], [1, 1, 0], [1, 0, 1],
                                          [1, 1, 1]])])
def test_study_matrix_at_narrow_widths(p, want):
    # the narrow cases' designs: an intercept, the main path's ~ condition,
    # then the paired design (two subjects at p = 3)
    assert studies.study_matrix(4, p).tolist() == want


def test_phase_marks_build_a_marked_copy(tmp_path):
    # the clock slots and their macros head the shared header; every marked
    # library source reads them out
    studies._marked_csrc(tmp_path)
    assert "dk_wclk[" in (tmp_path / "common.cuh").read_text()
    for name in studies._PHASES.keys() | studies._K1_MARKS.keys():
        if name.endswith(".cu"):
            assert "dk_wclk_read" in (tmp_path / name).read_text()
