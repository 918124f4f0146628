"""The card studies' source edits, checked on the CPU: `studies phases`
inserts clock64 marks into a copy of the float64 block kernels' sources at
anchors (studies._PHASES); each anchor must still be in its source, so
that the study builds what it says it times."""

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
