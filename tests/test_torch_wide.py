"""Designs wider than 8 columns on the CPU: the plain K1, K2 and K3
(deseq2_tpu_torch.ops.irls / ops.disp, which the wide kernels (8 < p <=
16) and the block kernels (16 < p <= 64) of csrc/*.cu are held to on the
card) against the JAX package's XLA cores, the path it takes past 8
columns (pallas_irls.py:274, pallas_ls.py:329, pallas_disp.py:199), at p
= 9, 12 and 16 on 40 samples (120 genes) and p = 17, 24, 33, 57 and 64
on 4 p samples (60 genes; 24 fills its 8-column tiles, 57 leaves a
one-column last tile on the float64 block kernels' tensor cores)
(tests/test_torch_paired.py runs the public path on such designs).  Past
32 columns the weighted inputs also drop the last column from ten genes'
Cox-Reid term, a column past the first 32 bits of the block kernels'
column mask.

float64 on both sides, inputs made with numpy from a seed
(ops/checks.py:solver_inputs), at rtol 1e-6: K1 on the genes both fits
take as converged, K2 and K3 on every gene.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from deseq2_tpu.ops import disp as jdisp
from deseq2_tpu.ops.irls import _fit_beta_core
from deseq2_tpu_torch.ops import checks
from deseq2_tpu_torch.ops import disp as tdisp
from deseq2_tpu_torch.ops.irls import fit_beta_plain
from torch_threads import one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-6, 1e-9
# (weighted, use_cr): unweighted, weighted with the Cox-Reid row cut (the
# first ten genes' treated samples at 1e-3, under the 1e-2 threshold), and
# without the Cox-Reid term
MODES = {"default": (False, True), "weighted": (True, True),
         "nocr": (False, False)}


# the design widths: the wide kernels' and the block kernels' (24 and 57:
# whole and one-column last 8-column tiles of the float64 tensor-core gram)
WIDTHS = [9, 12, 16, 17, 24, 33, 57, 64]


def _inputs(p, mode):
    # past 16 columns 60 genes on 4 p samples: the JAX cores' p x p batches
    # dominate the cost there, and on 3 p samples random indicator designs
    # leave a quarter of the genes' fits unconverged (p = 57: 13 of 60)
    G, S = (120, 40) if p <= 16 else (60, 4 * p)
    raw = checks.solver_inputs(G, S, p, 100 + p, weighted=MODES[mode][0])
    return raw, raw.get("w")


@pytest.mark.parametrize("mode", ["default", "weighted"])
@pytest.mark.parametrize("p", WIDTHS)
def test_plain_irls_wide_matches_xla(p, mode):
    """K1's plain version against _fit_beta_core: beta, its variance, the
    deviance and the hat diagonal at rtol 1e-6 on the genes both take as
    converged, and the same convergence verdicts."""
    raw, w = _inputs(p, mode)
    G, S = raw["y"].shape
    ridge = np.full(p, 1e-6 / np.log(2.0) ** 2)
    args = (raw["y"], raw["x"], raw["alpha"], raw["b0"], ridge)
    got = {k: v.numpy() for k, v in fit_beta_plain(
        *(torch.as_tensor(a) for a in (raw["y"], raw["x"], np.ones(S),
                                       raw["alpha"], raw["b0"], ridge)),
        weights=None if w is None else torch.as_tensor(w)).items()}
    ref = {k: np.asarray(v) for k, v in _fit_beta_core(
        jnp.asarray(args[0]), jnp.asarray(args[1]), jnp.ones((G, S)),
        *(jnp.asarray(a) for a in args[2:]), maxit=100, min_mu=0.5,
        weights=None if w is None else jnp.asarray(w),
        use_weights=w is not None).items()}
    conv = (ref["iter"] < 100) & (got["iter"] < 100)
    # 16 random indicator columns on 40 samples leave some genes' fits
    # diverging (|beta| > 30) on both sides
    assert conv.mean() >= 0.8
    np.testing.assert_array_equal(got["iter"] < 100, ref["iter"] < 100)
    for k in ("beta", "beta_var", "deviance", "hat_diag"):
        np.testing.assert_allclose(got[k][conv], ref[k][conv], rtol=RTOL,
                                   atol=ATOL, err_msg=k)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("p", WIDTHS)
def test_plain_disp_wide_matches_xla(p, mode):
    """K2's and K3's plain versions against _fit_disp_line_search_core and
    _fit_disp_grid_core, with the prior: log alpha and the log posterior
    at rtol 1e-6 on every gene, and the line search's iteration counts on
    98% of them (without the Cox-Reid term the posterior is flat enough
    near its top that rounding can end a search at another step)."""
    raw, w = _inputs(p, mode)
    use_cr = MODES[mode][1]
    pv = checks.PRIOR_VAR
    t = [torch.as_tensor(raw[k]) for k in ("y", "x", "mu", "la0", "pm")]
    j = [jnp.asarray(raw[k]) for k in ("y", "x", "mu", "la0", "pm")]
    kw = dict(use_prior=True, use_cr=use_cr)
    got = {k: v.numpy() for k, v in tdisp.fit_disp_line_search_plain(
        *t, pv, checks.MIN_LA, maxit=100,
        weights=None if w is None else torch.as_tensor(w), **kw).items()}
    ref = {k: np.asarray(v) for k, v in jdisp._fit_disp_line_search_core(
        *j, pv, checks.MIN_LA, maxit=100,
        weights=None if w is None else jnp.asarray(w),
        use_weights=w is not None, **kw).items()}
    for k in ("log_alpha", "last_lp", "initial_lp", "initial_dlp"):
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    assert (got["iter"] == ref["iter"]).mean() >= 0.98
    t[3] = torch.as_tensor(raw["grid"])
    j[3] = jnp.asarray(raw["grid"])
    g = tdisp.fit_disp_grid_plain(
        *t, pv, weights=None if w is None else torch.as_tensor(w),
        **kw).numpy()
    gr = np.asarray(jdisp._fit_disp_grid_core(
        *j, pv, weights=None if w is None else jnp.asarray(w),
        use_weights=w is not None, **kw))
    np.testing.assert_allclose(g, gr, rtol=RTOL, atol=ATOL)


def test_cr_column_mask_past_32_columns():
    """The weighted Cox-Reid column mask at p = 40, past a 32-bit word (the
    block kernels keep it in a 64-bit one, common.cuh:block_cr_col_mask,
    and decide as make_cr_masks does: a column stays when some row above
    the threshold has x != 0): the port's make_cr_masks drops the same
    columns as the JAX package's, column 1 of the first ten genes and
    column 39 of the next ten, and no other."""
    raw = checks.solver_inputs(120, 120, 40, 140, weighted=True)
    _, got = tdisp.make_cr_masks(torch.as_tensor(raw["x"]),
                                 torch.as_tensor(raw["w"]))
    _, want = jdisp.make_cr_masks(jnp.asarray(raw["x"]),
                                  jnp.asarray(raw["w"]),
                                  checks.CR_WEIGHT_THRESHOLD, True)
    got, want = got.numpy(), np.asarray(want)
    np.testing.assert_array_equal(got, want)
    dropped = {g: list(np.where(~got[g])[0]) for g in range(len(got))
               if not got[g].all()}
    assert dropped == {**{g: [1] for g in range(10)},
                       **{g: [39] for g in range(10, 20)}}
