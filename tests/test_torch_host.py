"""The port's host-exact engine against the JAX package's host engine, on
the same numpy inputs: deseq(engine="host") + results() for the
configurations the fused engine does not take (poscounts and iterate size
factors, betaPrior on ~ batch + condition with the expanded and the
standard matrix, rows sent to L-BFGS-B, the LRT against a reduced formula, weights that fail the
rank tests, useCR = FALSE with two gene-wise iterations, a weight
threshold of 0.5, minmu = 0.1, the Monte-Carlo KL prior variance at 3
residual degrees of freedom, p = 10), the normal-shrinkage cases the JAX
package runs on its host Wald test, the "auto" routing, the plain K2/K3
no-Cox-Reid and threshold modes against the Pallas kernels (interpret
mode) and the XLA cores, and the one theta grid of the independent
filtering.

float64 on the CPU on both sides.  Converged rows are held at rtol 1e-6
(atol 1e-9, equal NaN patterns).  Two kinds of rows are not held there,
and their counts are asserted:
- rows whose IRLS went to L-BFGS-B (betaConv false after maxit, or an
  unstable fit): they differ in the last bits before scipy sees them, so
  their LFCs are held at 1e-4;
- gene-wise estimates at the 1e-8 floor: at 1/alpha = 1e8 the posterior
  is flat to within lgamma's rounding (|lgamma(1e8)| = 1.7e9), so the grid
  search's pick there depends on which lgamma implementation rounds how
  (torch's or XLA's).  Both packages put such a gene within 10 x minDisp;
  it is held there.
"""

import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import deseq2_tpu as jdt
import deseq2_tpu_torch as tdt
from deseq2_tpu import dispersions as jdisp_mod
from deseq2_tpu.ops import disp as jdisp
from deseq2_tpu.ops.pallas_disp import fit_disp_grid_pallas
from deseq2_tpu.ops.pallas_ls import fit_disp_line_search_pallas
from deseq2_tpu_torch import dispersions as tdisp_mod
from deseq2_tpu_torch.ops import disp as tdisp
from torch_threads import one_torch_thread  # noqa: F401

COLS = ("baseMean", "log2FoldChange", "lfcSE", "stat", "pvalue", "padj")
DISP = ("dispGeneEst", "dispFit", "dispersion")
MIN_DISP = 1e-8


def _cmp(a, b, name, rtol=1e-6, atol=1e-9):
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    assert np.array_equal(np.isnan(a), np.isnan(b)), \
        f"{name}: NaN pattern differs"
    m = ~np.isnan(a)
    np.testing.assert_allclose(a[m], b[m], rtol=rtol, atol=atol,
                               err_msg=name)


def cmp_disp(got, want, name, floor_rows=0):
    """rtol 1e-6, except gene-wise estimates at the floor (module
    docstring): both within 10 x minDisp, and `floor_rows` of them."""
    got, want = np.asarray(got, float), np.asarray(want, float)
    assert np.array_equal(np.isnan(got), np.isnan(want)), name
    m = ~np.isnan(want)
    off = m & ~np.isclose(got, want, rtol=1e-6, atol=0.0)
    assert np.all(got[off] <= 10 * MIN_DISP) \
        and np.all(want[off] <= 10 * MIN_DISP), (name, np.where(off)[0])
    assert off.sum() == floor_rows, (name, np.where(off)[0])


def _labels(j):
    cond = j.col_data["condition"]
    return np.asarray(cond.levels)[cond.codes]


def make_pair(n=200, m=12, seed=7, design="~ condition", batch=False,
              levels=None):
    """The JAX package's example counts as a pair of datasets, one per
    package, with the same column data."""
    j = jdt.make_example_dataset(n=n, m=m, beta_sd=1.0, seed=seed)
    counts = np.asarray(j.counts)
    cd = {"condition": _labels(j)}
    if levels is not None:
        cd["condition"] = np.array([f"L{i % levels}" for i in range(m)])
    if batch:
        cd["batch"] = np.tile(["x", "y", "z"], m // 3 + 1)[:m]
    return (jdt.DESeqDataSet(counts, dict(cd), design),
            tdt.dataset_from_arrays(counts, dict(cd), design))


def _weights_fail(d):
    w = np.ones(d.counts.shape)
    w[3, 6:] = 0.0
    w[10, :6] = 0.0
    d.assays["weights"] = w


def _weights_low(d):
    rng = np.random.default_rng(3)
    w = rng.uniform(0.3, 1.0, d.counts.shape)
    w[rng.random(d.counts.shape) < 0.1] = 0.2
    d.assays["weights"] = w


# name: (make_pair kwargs, JAX deseq kwargs, port deseq kwargs or None
#        for the same, prep, floor rows of dispGeneEst, L-BFGS-B rows)
CONFIGS = {
    "poscounts": (dict(), dict(sf_type="poscounts"), None, None, 0, 0),
    "bp_multi_expanded": (dict(design="~ batch + condition", batch=True),
                          dict(beta_prior=True), None, None, 1, 0),
    "bp_standard": (dict(), dict(beta_prior=True,
                                 model_matrix_type="standard"),
                    None, None, 0, 0),
    "bp_multi_standard": (dict(design="~ batch + condition", batch=True),
                          dict(beta_prior=True,
                               model_matrix_type="standard"),
                          None, None, 1, 0),
    "lrt_reduced_formula": (dict(design="~ batch + condition", batch=True),
                            dict(test="LRT", reduced="~ batch"), None, None,
                            1, 0),
    "weights_fail": (dict(), dict(), None, _weights_fail, 0, 0),
    "nocr_niter2": (dict(), dict(config=jdt.DESeqConfig(
        use_cr=False, niter_disp=2)), dict(config=tdt.DESeqConfig(
            use_cr=False, niter_disp=2)), None, 1, 0),
    "weight_threshold": (dict(), dict(config=jdt.DESeqConfig(
        weight_threshold=0.5)), dict(config=tdt.DESeqConfig(
            weight_threshold=0.5)), _weights_low, 0, 0),
    "minmu": (dict(), dict(minmu=0.1), None, None, 0, 0),
    "p10": (dict(m=30, levels=10, n=150), dict(), None, None, 0, 0),
    "mc_kl_df3": (dict(m=5, n=300), dict(), None, None, 0, 0),
}

_RUNS = {}


def run_pair(name):
    """Both engines' deseq(engine="host") + results() for a config,
    computed once per module."""
    if name in _RUNS:
        return _RUNS[name]
    pk, jkw, tkw, prep, _, _ = CONFIGS[name]
    j, t = make_pair(**pk)
    if prep is not None:
        prep(j)
        prep(t)
    if name == "mc_kl_df3":
        # the MC-KL branch is held to the JAX package's outputs on one set
        # of streams handed to both (their R-exact generators run ~20 s
        # each in Python, and the JAX package's reads uninitialised memory,
        # test_rng_r_twist_matches_scalar_mt): chi-square(3) and standard
        # normal draws in the shape _mc_kl_streams caches
        rng = np.random.default_rng(0)
        streams = (rng.chisquare(3, (200, 10000)),
                   rng.standard_normal((200, 10000)))
        jdisp_mod._MC_KL_CACHE[(2, 3, 200, 10000)] = streams
        tdisp_mod._MC_KL_CACHE[(2, 3, 200, 10000)] = streams
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jf = jdt.deseq(j, engine="host", **jkw)
        from deseq2_tpu_torch import glm
        glm.fit_glm_tensors.optim_rows = 0
        tf = tdt.deseq(t, engine="host", device="cpu",
                       **(jkw if tkw is None else tkw))
        optim = glm.fit_glm_tensors.optim_rows
        out = (jf, tf, jdt.results(jf), tdt.results(tf), optim)
    _RUNS[name] = out
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_host_results_match_jax(name):
    """The six results columns at rtol 1e-6 (L-BFGS-B rows' LFCs at
    1e-4, their count asserted)."""
    jf, tf, jr, tr, optim = run_pair(name)
    assert tf.attrs["engine"] == "host"
    assert optim == CONFIGS[name][5]
    for col in COLS:
        _cmp(tr[col], jr[col], f"{name}.{col}")
    assert tr.descriptions == jr.descriptions


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_host_dispersions_match_jax(name):
    """dispGeneEst, dispFit and dispersion at rtol 1e-6 (dispGeneEst's
    rows at the floor excepted and counted), the iteration counts equal
    as integers (the gene-wise ones off the floor, where the flat
    posterior lets rounding end the search at another step), and every
    stored column's name and description."""
    jf, tf, _, _, _ = run_pair(name)
    floor = CONFIGS[name][4]
    for col in DISP:
        cmp_disp(tf.row_data[col], jf.row_data[col], f"{name}.{col}",
                 floor if col == "dispGeneEst" else 0)
    off_floor = (np.asarray(jf.row_data["dispGeneEst"]) > 10 * MIN_DISP) \
        & (np.asarray(tf.row_data["dispGeneEst"]) > 10 * MIN_DISP)
    for col in ("dispGeneIter", "dispIter", "betaIter"):
        if col in jf.row_data:
            a, b = np.asarray(tf.row_data[col]), np.asarray(jf.row_data[col])
            m = ~np.isnan(b) & (off_floor if col == "dispGeneIter" else True)
            np.testing.assert_array_equal(a[m], b[m], err_msg=col)
    assert set(tf.row_data) == set(jf.row_data)
    for k in jf.row_meta:
        assert tf.row_meta[k] == jf.row_meta[k], k
    np.testing.assert_allclose(tf.size_factors, jf.size_factors,
                               rtol=1e-12)


def test_lbfgsb_rows_match_jax():
    """With maxit_beta = 4 the IRLS leaves rows unconverged, and both
    packages send them to L-BFGS-B (129 rows here, counted).  Their LFCs
    are held at rtol 1e-4 (atol 1e-5 on the log2 scale, for LFCs near 0),
    or, where L-BFGS-B stops in a flat optimum
    (row 99: no counts in one group, an LFC of 17), by the penalized
    objective it minimizes (equal to 1e-10 relative, counted); the other
    rows' columns at rtol 1e-6.  padj is not compared: BH ranks every
    row's p-value, the L-BFGS-B rows' included."""
    from deseq2_tpu_torch import glm
    from deseq2_tpu_torch.glm import nb_logpmf_np
    j, t = make_pair()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jf = jdt.deseq(j, engine="host",
                       config=jdt.DESeqConfig(maxit_beta=4))
        glm.fit_glm_tensors.optim_rows = 0
        tf = tdt.deseq(t, device="cpu",
                       config=tdt.DESeqConfig(maxit_beta=4))
    assert tf.attrs["engine"] == "host"
    assert glm.fit_glm_tensors.optim_rows == 129
    jr, tr = jdt.results(jf), tdt.results(tf)
    optim = np.asarray(tf.row_data["betaIter"]) == 4
    assert np.array_equal(optim, np.asarray(jf.row_data["betaIter"]) == 4)
    x = np.asarray(tf.attrs["modelMatrix"], float)
    sf = np.asarray(tf.size_factors)

    def objective(f, r):
        b = np.array([f.row_data["Intercept"][r],
                      f.row_data["condition_B_vs_A"][r]])
        mu = sf * 2.0 ** (x @ b)
        ll = nb_logpmf_np(np.asarray(f.counts[r], float), mu,
                          f.row_data["dispersion"][r]).sum()
        sd = 1000.0            # the wide prior, lambda 1e-6
        return -(ll + np.sum(-0.5 * np.log(2 * np.pi * sd ** 2)
                             - 0.5 * (b / sd) ** 2))
    a = np.asarray(tr["log2FoldChange"])
    b = np.asarray(jr["log2FoldChange"])
    off = optim & ~np.isclose(a, b, rtol=1e-4, atol=1e-5)
    assert np.where(off)[0].tolist() == [99]
    for r in np.where(off)[0]:
        np.testing.assert_allclose(objective(tf, r), objective(jf, r),
                                   rtol=1e-10)
    for col in ("baseMean", "log2FoldChange", "lfcSE", "stat", "pvalue"):
        _cmp(np.asarray(tr[col])[~optim], np.asarray(jr[col])[~optim],
             col)


def test_weights_fail_flagged_as_jax():
    """Rows whose weights leave the weighted design rank-deficient are
    flagged weightsFail and treated as all-zero, as in the JAX package."""
    jf, tf, _, tr, _ = run_pair("weights_fail")
    assert np.where(tf.row_data["weightsFail"])[0].tolist() == [3, 10]
    assert np.array_equal(tf.row_data["weightsFail"],
                          jf.row_data["weightsFail"])
    assert np.array_equal(tf.row_data["allZero"], jf.row_data["allZero"])
    assert np.isnan(tr["log2FoldChange"][[3, 10]]).all()


def test_weights_ok_matches_matrix_rank_loop():
    """The batched eigenvalue rank tests (glm.weights_ok, on the device)
    flag the rows the JAX package's per-gene matrix_rank loop flags: a
    group left without weight, a Cox-Reid subset that loses a column at
    the threshold, and rows that pass."""
    from deseq2_tpu.glm import get_and_check_weights as jcheck
    from deseq2_tpu_torch.glm import weights_ok
    rng = np.random.default_rng(11)
    S = 12
    x = np.column_stack([np.ones(S), np.repeat([0.0, 1.0], 6),
                         np.tile([0.0, 1.0], 6)])
    w = rng.uniform(0.2, 1.0, (60, S))
    w[0, 6:] = 0.0                     # condition B unweighted
    w[1, ::2] = 0.0                    # batch 0 unweighted
    w[2, 6:] = 0.3                     # below a 0.5 threshold
    w[3, 6:] = 1e-3                    # below 1e-2
    for thr in (1e-2, 0.5):
        j = jdt.make_example_dataset(n=60, m=S, seed=1)
        j.assays["weights"] = w
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            jout, _, _ = jcheck(j, x, weight_threshold=thr)
        want = ~np.asarray(jout.row_data.get("weightsFail",
                                             np.zeros(60, bool)))
        wn = torch.as_tensor(w / w.max(axis=1, keepdims=True))
        got = weights_ok(wn, x, thr)
        assert np.array_equal(got, want), (thr, np.where(got != want)[0])
        assert (~got).sum() >= 2


def test_iterate_size_factors_match_jax():
    """sf_type="iterate" on a small fixture: the alternating ~ 1 mean-trend
    fits and L-BFGS-B over the log size factors give the JAX package's
    size factors (to 1e-6: L-BFGS-B stops within its own tolerance, so
    the last bits of its optimum follow those of the objective), and,
    given those size factors, its results table: the table moves with
    the size factors (0.1 ppm in a size factor moves an LFC by up to
    ~5e-7), so it is held at rtol 1e-6 to the JAX package's table on the
    port's size factors."""
    j, t = make_pair(n=60, m=6, seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jf = jdt.deseq(j, engine="host", sf_type="iterate")
        tf = tdt.deseq(t, device="cpu", sf_type="iterate")
        assert tf.attrs["engine"] == "host"
        np.testing.assert_allclose(tf.size_factors, jf.size_factors,
                                   rtol=1e-6)
        j2, _ = make_pair(n=60, m=6, seed=3)
        j2.size_factors = tf.size_factors
        jr = jdt.results(jdt.deseq(j2, engine="host"))
    tr = tdt.results(tf)
    for col in COLS:
        _cmp(tr[col], jr[col], col)


def _scalar_mt_stream(mt, n):
    """R's unif_rand words from MT19937 state `mt` by the scalar twist
    (MT_genrand, R's RNG.c), as floats in [0, 1)."""
    mt = [int(v) for v in mt]
    N, M, A, U, L = 624, 397, 0x9908B0DF, 0x80000000, 0x7FFFFFFF
    out, mti = [], N
    while len(out) < n:
        if mti >= N:
            for k in range(N - 1):
                y = (mt[k] & U) | (mt[k + 1] & L)
                mt[k] = mt[(k + M) % N] ^ (y >> 1) ^ (A if y & 1 else 0)
            y = (mt[N - 1] & U) | (mt[0] & L)
            mt[N - 1] = mt[M - 1] ^ (y >> 1) ^ (A if y & 1 else 0)
            mti = 0
        y = mt[mti]
        mti += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        out.append((y & 0xFFFFFFFF) * 2.3283064365386963e-10)
    return np.array(out)


def test_rng_r_twist_matches_scalar_mt():
    """The port's copy of rng_r (the MC-KL branch's R-exact set.seed(2)
    streams) twists its Mersenne-Twister state as the scalar algorithm
    does, over several twists, and so gives the same streams in every
    instance and process.  The JAX package's vectorized twist reads words
    of its second phase before writing them (deseq2_tpu/rng_r.py); its
    first 454 words of a twist are the scalar algorithm's too."""
    from deseq2_tpu.rng_r import RRandomState as J
    from deseq2_tpu_torch.rng_r import RRandomState as T
    ref = _scalar_mt_stream(T(2).mt, 2000)
    a = T(2)
    np.testing.assert_array_equal([a.unif_rand() for _ in range(2000)],
                                  ref)
    j = J(2)
    np.testing.assert_array_equal([j.unif_rand() for _ in range(454)],
                                  ref[:454])
    np.testing.assert_array_equal(T(2).rchisq(300, 3), T(2).rchisq(300, 3))


# ---------------------------------------------------------------------------
# the normal shrinkage's host cases (deseq2_tpu/shrink.py:93-160)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shrink_fits():
    j, t = make_pair(n=200, m=12, seed=42)
    jf = jdt.deseq(j, engine="host")
    tf = tdt.deseq(t, device="cpu")
    wj, wt = make_pair(n=200, m=12, seed=42)
    w = np.random.default_rng(2).uniform(0.4, 1.0, wj.counts.shape)
    wj.assays["weights"] = w
    wt.assays["weights"] = w
    return dict(plain=(jf, tf),
                weights=(jdt.deseq(wj, engine="host"),
                         tdt.deseq(wt, device="cpu")))


SHRINK_CASES = {
    "coef": ("plain", dict(coef="condition_B_vs_A")),
    "numeric": ("plain", dict(contrast=np.array([0.0, -1.0, 1.0]),
                              res=("condition", "B", "A"))),
    "list": ("plain", dict(contrast=[["conditionB"], ["conditionA"]],
                           res=("condition", "B", "A"))),
    "threshold": ("plain", dict(contrast=("condition", "B", "A"),
                                lfc_threshold=0.5)),
    "weights": ("weights", dict(contrast=("condition", "B", "A"))),
}


@pytest.mark.parametrize("case", sorted(SHRINK_CASES))
def test_normal_host_cases_match_jax(shrink_fits, case):
    """lfc_shrink(type="normal") in the cases the JAX package runs on its
    host Wald test (coef mode, numeric and list contrasts over the
    expanded columns, lfc_threshold > 0, weights): the port runs its host
    nbinom_wald_test(beta_prior=True) and gives the same table."""
    which, kw = SHRINK_CASES[case]
    kw = dict(kw)
    jf, tf = shrink_fits[which]
    res = kw.pop("res", None)
    jres = tres = None
    if res is not None:
        jres = jdt.results(jf, contrast=res)
        tres = tdt.results(tf, contrast=res)
    jr = jdt.lfc_shrink(jf, type="normal", res=jres, **kw)
    tr = tdt.lfc_shrink(tf, type="normal", res=tres, **kw)
    for col in COLS:
        _cmp(tr[col], jr[col], col)
    np.testing.assert_allclose(tr.prior_info["betaPriorVar"],
                               jr.prior_info["betaPriorVar"], rtol=1e-6)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,reason", [
    (dict(sf_type="iterate"), "iterate"),
    (dict(config="use_cr"), "non-default config"),
    (dict(minmu=0.1), "minmu"),
    (dict(beta_prior=True, model_matrix_type="standard"),
     "standard model matrix"),
], ids=["iterate", "config", "minmu", "bp_standard"])
def test_auto_falls_back_to_host_with_warning(kw, reason):
    """engine="auto" runs the host engine for every fused_ineligibility
    reason, with the JAX package's warning when quiet=False; "fused"
    refuses them."""
    _, t = make_pair(n=40, m=6, seed=5)
    kw = dict(kw)
    if kw.get("config") == "use_cr":
        kw["config"] = tdt.DESeqConfig(use_cr=False)
    with pytest.warns(UserWarning, match=f"fused engine unavailable.*"
                                         f"{reason}.*host-exact path"):
        fit = tdt.deseq(t, device="cpu", quiet=False, **kw)
    assert fit.attrs["engine"] == "host"
    with pytest.raises(ValueError, match="engine='fused' unavailable"):
        tdt.deseq(t, device="cpu", engine="fused", **kw)


def test_auto_keeps_fused_where_eligible():
    """engine="auto" still runs the fused engine on an eligible
    configuration (poscounts included: its size factors come first)."""
    _, t = make_pair(n=40, m=6, seed=5)
    for kw in (dict(), dict(sf_type="poscounts")):
        assert tdt.deseq(t, device="cpu", **kw).attrs["engine"] == "fused"


def test_poscounts_fused_matches_host():
    """poscounts through the fused engine (size factors first, then the
    pipeline) equals the host engine's run."""
    _, t = make_pair(n=200, m=12, seed=8)
    a = tdt.results(tdt.deseq(t, device="cpu", sf_type="poscounts"))
    b = tdt.results(tdt.deseq(t, device="cpu", sf_type="poscounts",
                              engine="host"))
    for col in COLS:
        _cmp(a[col], b[col], col)


def test_samples_equal_coefficients_message_as_jax():
    """Samples <= coefficients reaches the host engine and raises the JAX
    package's error."""
    j, t = make_pair(n=30, m=4, seed=5, levels=4)
    with pytest.raises(ValueError) as ej:
        jdt.deseq(j, engine="host")
    with pytest.raises(ValueError) as et:
        tdt.deseq(t, device="cpu")
    assert str(et.value) == str(ej.value)


# ---------------------------------------------------------------------------
# the plain K2/K3 modes against the Pallas kernels and the XLA cores
# ---------------------------------------------------------------------------

def _sim(G=200, S=24, p=2, seed=0, weighted=False):
    rng = np.random.default_rng(seed)
    x = np.column_stack([np.ones(S)] + [rng.permutation([0.0, 1.0] * (S // 2))
                                        for _ in range(p - 1)])
    mu0 = np.exp(rng.normal(3.0, 1.5, (G, 1))) * np.ones((1, S))
    alpha = 4.0 / mu0[:, 0] + 0.1
    size = 1.0 / alpha[:, None]
    y = rng.negative_binomial(size, size / (size + mu0)).astype(np.float64)
    la0 = np.log(np.clip(alpha * np.exp(rng.normal(0, 0.5, G)), 1e-8, 10.0))
    w = None
    if weighted:
        w = np.clip(rng.random((G, S)) + 0.2, 0.0, 1.0)
        w[:10][:, x[:, 1] > 0] = 0.3       # under a 0.5 threshold
    grid = np.linspace(np.log(1e-8), np.log(max(10.0, S)), 20)
    return y, x, np.maximum(mu0, 0.5), la0, w, grid


def _t(*a):
    return [None if v is None else torch.as_tensor(v) for v in a]


def _j(*a):
    return [None if v is None else jnp.asarray(v) for v in a]


MODE_CASES = [(False, 1e-2, False), (False, 1e-2, True), (True, 0.5, True),
              (False, 0.5, True)]
MODE_IDS = ["nocr", "nocr-weighted", "thr05-weighted", "nocr-thr05-weighted"]


@pytest.mark.parametrize("use_cr,thr,weighted", MODE_CASES, ids=MODE_IDS)
@pytest.mark.parametrize("use_prior", [False, True])
def test_plain_line_search_modes_match_pallas_and_xla(use_cr, thr, weighted,
                                                      use_prior):
    """The plain K2 with use_cr and weight_threshold against the Pallas
    kernel (interpret mode) and the XLA core in the same mode: log alpha
    equal to 1e-8 on over 98% of genes, the rest at a posterior at least
    as good, the initial lp to 1e-9."""
    y, x, mu, la0, w, _ = _sim(seed=12, weighted=weighted)
    pm = np.log(np.full(len(y), 0.5))
    got = {k: v.numpy() for k, v in tdisp.fit_disp_line_search_plain(
        *_t(y, x, mu, la0, pm), 1.3, float(np.log(1e-9)),
        use_prior=use_prior, weights=_t(w)[0], use_cr=use_cr,
        weight_threshold=thr).items()}
    refs = [jdisp._fit_disp_line_search_core(
        *_j(y, x, mu, la0, pm), 1.3, float(np.log(1e-9)), maxit=100,
        use_prior=use_prior, weights=_j(w)[0], use_weights=w is not None,
        weight_threshold=thr, use_cr=use_cr),
        fit_disp_line_search_pallas(
            *_j(y, x, mu, la0, pm), 1.3, float(np.log(1e-9)),
            use_prior=use_prior, use_cr=use_cr, interpret=True,
            weights=_j(w)[0], weight_threshold=thr)]
    wt = _t(w)[0]
    rm, cm = tdisp.make_cr_masks(torch.as_tensor(x), wt, thr)

    def lp(la):
        return tdisp.log_posterior(*_t(la, y, mu, x, pm), 1.3, use_prior,
                                   wt, rm, cm, use_cr).numpy()
    for ref in refs:
        la_r = np.asarray(ref["log_alpha"])
        same = np.isclose(la_r, got["log_alpha"], rtol=1e-8, atol=1e-9)
        assert same.mean() > 0.98, (~same).sum()
        assert np.all(lp(got["log_alpha"]) >= lp(la_r) - 1e-6)
        np.testing.assert_allclose(got["initial_lp"],
                                   np.asarray(ref["initial_lp"]),
                                   rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("use_cr,thr,weighted", MODE_CASES, ids=MODE_IDS)
@pytest.mark.parametrize("use_prior", [False, True])
def test_plain_grid_modes_match_xla(use_cr, thr, weighted, use_prior):
    """The plain K3 with use_cr (and, weighted, weight_threshold) picks the
    XLA core's point for every gene; unweighted, also the Pallas
    kernel's (interpret mode; it has no weighted mode)."""
    y, x, mu, _, w, grid = _sim(seed=13, weighted=weighted)
    pm = np.log(np.full(len(y), 0.5))
    got = tdisp.fit_disp_grid_plain(
        *_t(y, x, mu, grid, pm), 1.3, use_prior=use_prior,
        weights=_t(w)[0], use_cr=use_cr, weight_threshold=thr).numpy()
    refs = [jdisp._fit_disp_grid_core(
        *_j(y, x, mu, grid, pm), 1.3, use_prior=use_prior,
        weights=_j(w)[0], use_weights=w is not None, weight_threshold=thr,
        use_cr=use_cr)]
    if w is None:
        refs.append(fit_disp_grid_pallas(*_j(y, x, mu, grid, pm), 1.3,
                                         use_prior=use_prior, use_cr=use_cr,
                                         interpret=True))
    for ref in refs:
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-9,
                                   atol=1e-9)


# ---------------------------------------------------------------------------
# the p > 8 route and the one theta grid
# ---------------------------------------------------------------------------

def test_wrappers_route_by_device_and_p():
    """On the CPU every wrapper runs its plain version whatever p (no
    counter moves), at p = 10, 12 and 16 (the wide kernels' widths on a
    card); at p = 10 the host and fused engines give the JAX host
    engine's table (test_host_results_match_jax[p10])."""
    from deseq2_tpu_torch.ops.cuda_grid import fit_disp_grid
    from deseq2_tpu_torch.ops.cuda_irls import fit_beta
    from deseq2_tpu_torch.ops.cuda_ls import fit_disp_line_search
    from deseq2_tpu_torch.ops.irls import fit_beta_plain
    before = [dict(vars(f)) for f in (fit_beta, fit_disp_line_search,
                                      fit_disp_grid)]
    for p in (10, 12, 16):
        y, x, mu, la0, _, grid = _sim(G=40, S=30, p=p, seed=2)
        pm = np.zeros(len(y))
        a = fit_disp_line_search(*_t(y, x, mu, la0, pm), 1.0, -20.0)
        b = tdisp.fit_disp_line_search_plain(*_t(y, x, mu, la0, pm), 1.0,
                                             -20.0)
        assert torch.equal(a["log_alpha"], b["log_alpha"])
        assert torch.equal(fit_disp_grid(*_t(y, x, mu, grid, pm), 1.0),
                           tdisp.fit_disp_grid_plain(*_t(y, x, mu, grid, pm),
                                                     1.0))
        b0 = np.zeros((len(y), p))
        b0[:, 0] = np.log(y.mean(axis=1) + 0.5)
        k1 = _t(y, x, np.ones(y.shape[1]), np.exp(la0), b0,
                np.full(p, 1e-6))
        assert torch.equal(fit_beta(*k1)["beta"], fit_beta_plain(*k1)["beta"])
    assert [dict(vars(f)) for f in (fit_beta, fit_disp_line_search,
                                    fit_disp_grid)] == before
    jf, tf, jr, tr, _ = run_pair("p10")
    assert len(tf.attrs["modelMatrixNames"]) == 10
    fused = tdt.results(tdt.deseq(tdt.dataset_from_arrays(
        np.asarray(tf.counts), {"condition": tf.col_data["condition"]},
        "~ condition"), device="cpu"))
    for col in COLS:
        _cmp(fused[col], jr[col], col)


def test_theta_grid_is_np_linspace():
    """The device filtering's theta grid (R's seq: lower + i * by, the
    last point set to upper, in float64) is bit-equal to the host flow's
    np.linspace over many filter statistics."""
    from deseq2_tpu_torch.parallel.filterdev import theta_grid_dev
    rng = np.random.default_rng(0)
    for _ in range(300):
        v = rng.gamma(0.5, 10.0, size=rng.integers(5, 3000))
        v[rng.random(len(v)) < rng.random()] = 0.0
        lq = np.mean(v == 0)
        want = np.linspace(lq, 0.95 if lq < 0.95 else 1.0, 50)
        assert np.array_equal(theta_grid_dev(torch.as_tensor(v)).numpy(),
                              want)


def test_fused_lo_fit_equals_host_flow():
    """On the 5-gene fixture where the two grids once moved lo.fit by
    0.61, the fused tail's filtering metadata equal the host flow's
    (results() with the default theta on the host path)."""
    dds = tdt.make_example_dataset(n=5, m=8, seed=9)
    fit = tdt.deseq(dds, device="cpu")
    fused = tdt.results(fit)
    host = tdt.results(fit, theta=np.linspace(
        np.mean(np.asarray(fused.base_mean) == 0), 0.95, 50))
    np.testing.assert_array_equal(fused.metadata["lo.fit"]["y"],
                                  host.metadata["lo.fit"]["y"])
    np.testing.assert_array_equal(fused.metadata["filterNumRej"]["numRej"],
                                  host.metadata["filterNumRej"]["numRej"])
    _cmp(fused["padj"], host["padj"], "padj")


def test_beta_prior_without_intercept_message_as_jax():
    """betaPrior on ~ 0 + condition (once refused as host-only) reaches the
    host engine and raises the JAX package's error; the two-factor and
    standard-matrix designs run (test_host_results_match_jax's
    bp_multi_expanded and bp_standard)."""
    j, t = make_pair(n=40, m=6, seed=5, design="~ 0 + condition")
    with pytest.raises(ValueError) as ej:
        jdt.deseq(j, engine="host", beta_prior=True)
    with pytest.raises(ValueError) as et:
        tdt.deseq(t, device="cpu", beta_prior=True)
    assert str(et.value) == str(ej.value)
