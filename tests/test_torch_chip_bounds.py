"""chip_smoke.py's bounds (the least time the card could take for a
kernel's work): the grams' multiply-adds are counted apart from the rest
of a kernel's operations and, in float64, charged at the FP64 tensor
cores' peak, where the float64 block K1 and K2 run them; the totals are
the earlier counts'.  Pure arithmetic on the counts, no card."""

import pytest

import chip_smoke as cs
from torch_threads import one_torch_thread  # noqa: F401


def _total(o):
    return o.other + o.gram


@pytest.mark.parametrize("P", [1, 2, 10, 25, 64])
def test_gram_split_keeps_the_totals(P):
    """ops_irls, ops_ls and ops_grid count what they counted before the
    split (a sweep 20 + 2 nt + 5 P, the post-fit pass 6 + 2 P + 2 nt, a
    trial point's sample 55 + 4 nt + P, a grid point's 12 + 2 nt + P),
    with the grams' multiply-adds as the gram part."""
    nt = P * (P + 1) // 2
    o = cs.ops_irls(P)
    assert _total(o["sweep"]) == 20 + 2 * nt + 5 * P
    assert o["sweep"].gram == 2 * nt + 2 * P
    assert _total(o["post"]) == 6 + 2 * P + 2 * nt
    assert o["post"].gram == 2 * nt
    assert _total(cs.ops_ls(P)) == 55 + 4 * nt + P
    assert cs.ops_ls(P).gram == 4 * nt
    assert _total(cs.ops_ls(P, False)) == 94 + 4 * nt + P
    assert _total(cs.ops_grid(P)) == 12 + 2 * nt + P
    assert cs.ops_grid(P).gram == 2 * nt


def test_float64_grams_at_the_tensor_peak():
    """A float64 bound charges the grams at 67 TFLOP/s and the rest at 34;
    float32 charges both at 67 (its grams stay off the tensor cores)."""
    ops = cs.Ops(34e9, 67e9)
    t64, by64 = cs.bound(0, ops, "float64")
    t32, by32 = cs.bound(0, ops, "float32")
    assert by64 == by32 == "operations"
    assert t64 == pytest.approx(1.0 + 1.0)
    assert t32 == pytest.approx(34e9 / 67e12 * 1e3 + 1.0)
    # a plain number is all non-gram work
    assert cs.bound(0, 34e9, "float64")[0] == pytest.approx(1.0)
    # bytes win when they take longer
    assert cs.bound(3.35e12, ops, "float64") == (1e3, "bytes")
    # the arithmetic of Ops as the timing code uses it
    s = 3 * (cs.ops_ls(8) + 2) + cs.ops_ls_point(8)
    assert s.gram == 3 * cs.ops_ls(8).gram
    assert s.other == 3 * (cs.ops_ls(8).other + 2) + cs.ops_ls_point(8)
