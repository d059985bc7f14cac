"""The port's fidelity scores (``repro_torch.core.metrics``) and reference
stand-ins (``repro_torch.data.reference``) against the JAX package's, on
the CPU (``device="cpu"``), from the same numpy inputs.

Tolerances: the stand-ins' arrays exactly (the same numpy code); integer
counts exactly (the joint histograms are compared bin for bin); the
histogram scores (``dcc``, ``js_divergence``, ``degree_feature_distance``,
``degree_dist``) within 1e-12 absolute; the correlations (Pearson,
correlation ratio, Theil's U, the association matrices and
``feature_correlation_score``) within 1e-9 — float64 sums taken in
another order than numpy's.
"""
import numpy as np
import pytest
import torch

from repro.core import metrics as JM
from repro.data import reference as JR
from repro.graph.ops import Graph as JGraph
from repro_torch.core import metrics as TM
from repro_torch.data import reference as TR
from repro_torch.graph.ops import Graph as TGraph

from tests._hypothesis_compat import given, settings, st

HIST = 1e-12
CORR = 1e-9
CPU = dict(device="cpu")


def _tg(jg):
    return TGraph(torch.from_numpy(np.asarray(jg.src)),
                  torch.from_numpy(np.asarray(jg.dst)), jg.n_src, jg.n_dst,
                  jg.bipartite)


@pytest.mark.parametrize("name", sorted(JR.REFERENCES))
@pytest.mark.parametrize("seed", [0, 11])
def test_reference_standins_equal_jax(name, seed):
    jg, jc, jk = JR.REFERENCES[name](seed=seed)
    tg, tc, tk = TR.REFERENCES[name](seed=seed)
    np.testing.assert_array_equal(tg.src.numpy(), np.asarray(jg.src))
    np.testing.assert_array_equal(tg.dst.numpy(), np.asarray(jg.dst))
    assert (tg.n_src, tg.n_dst, tg.bipartite) == \
        (jg.n_src, jg.n_dst, jg.bipartite)
    for a, b in ((tc, jc), (tk, jk)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


PAIRS = {
    "bipartite": lambda: (JR.tabformer_like(n_src=512, n_dst=64,
                                            n_edges=3000),
                          JR.tabformer_like(seed=4, n_src=1024, n_dst=64,
                                            n_edges=5000)),
    "homogeneous": lambda: (JR.paysim_like(n=1024, n_edges=3000),
                            JR.paysim_like(seed=9, n=2048, n_edges=4000)),
    "node_features": lambda: (JR.cora_like(n=512, n_edges=2000),
                              JR.cora_like(seed=5, n=512, n_edges=2000)),
    "many_columns": lambda: (JR.ieee_like(n_src=512, n_dst=64, n_edges=2000),
                             JR.ieee_like(seed=3, n_src=512, n_dst=64,
                                          n_edges=3000)),
}


def _close(got, want, tol):
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, rel=tol, abs=tol)


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("cols", ["both", "cont_only", "cat_only",
                                  "structure_only"])
def test_evaluate_all_matches_reference(pair, cols):
    (jg_r, cr, kr), (jg_s, cs, ks) = PAIRS[pair]()
    if cols in ("cat_only", "structure_only"):
        cr, cs = cr[:, :0], cs[:, :0]
    if cols in ("cont_only", "structure_only"):
        kr, ks = kr[:, :0], ks[:, :0]
    want = JM.evaluate_all(jg_r, cr, kr, jg_s, cs, ks)
    got = TM.evaluate_all(_tg(jg_r), cr, kr, _tg(jg_s), cs, ks, **CPU)
    assert set(got) == set(want)
    for k, tol in (("degree_dist", HIST), ("dcc", HIST),
                   ("feature_corr", CORR), ("degree_feat_dist", HIST)):
        _close(got[k], want[k], tol)
    # tensors go in as well as arrays
    got_t = TM.evaluate_all(_tg(jg_r), torch.from_numpy(cr),
                            torch.from_numpy(kr), _tg(jg_s),
                            torch.from_numpy(cs), torch.from_numpy(ks), **CPU)
    assert got_t == got


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_scores_match_reference(pair):
    (jg_r, cr, kr), (jg_s, cs, ks) = PAIRS[pair]()
    tg_r, tg_s = _tg(jg_r), _tg(jg_s)
    for n_points in (16, 5):
        _close(TM.dcc(tg_r, tg_s, n_points, **CPU),
               JM.dcc(jg_r, jg_s, n_points), HIST)
    np.testing.assert_allclose(TM.pearson_matrix(cr, **CPU).numpy(),
                               JM.pearson_matrix(cr), rtol=CORR, atol=CORR)
    for a, b in ((cr, kr), (cs, ks)):
        np.testing.assert_allclose(TM.association_matrix(a, b, **CPU).numpy(),
                                   JM.association_matrix(a, b),
                                   rtol=CORR, atol=CORR)
    _close(TM.feature_correlation_score(cr, kr, cs, ks, **CPU),
           JM.feature_correlation_score(cr, kr, cs, ks), CORR)
    for i in range(kr.shape[1]):
        for j in range(cr.shape[1]):
            _close(TM.correlation_ratio(kr[:, i], cr[:, j], **CPU),
                   JM.correlation_ratio(kr[:, i], cr[:, j]), CORR)
        for j in range(kr.shape[1]):
            _close(TM.theils_u(kr[:, i], kr[:, j], **CPU),
                   JM.theils_u(kr[:, i], kr[:, j]), CORR)
    _close(TM.degree_feature_distance(tg_r, cr[:, 0], tg_s, cs[:, 0], **CPU),
           JM.degree_feature_distance(jg_r, cr[:, 0], jg_s, cs[:, 0]), HIST)


@pytest.mark.parametrize("pair", sorted(PAIRS))
@pytest.mark.parametrize("side", ["src", "dst"])
def test_joint_hist_matches_reference(pair, side):
    """The joint histogram bin for bin, with the real side's quantile
    edges, and the synthetic side on those edges (values outside them
    dropped)."""
    (jg_r, cr, _), (jg_s, cs, _) = PAIRS[pair]()
    hr, fe = JM._joint_hist(jg_r, cr[:, 0], side=side)
    got, tfe = TM._joint_hist(_tg(jg_r), cr[:, 0], side=side, **CPU)
    np.testing.assert_array_equal(tfe, fe)
    np.testing.assert_array_equal(got.numpy(), hr)
    hs, _ = JM._joint_hist(jg_s, cs[:, 0] * 1.3, feat_edges=fe, side=side)
    got_s, _ = TM._joint_hist(_tg(jg_s), cs[:, 0] * 1.3, feat_edges=fe,
                              side=side, **CPU)
    np.testing.assert_array_equal(got_s.numpy(), hs)
    _close(TM.js_divergence(got, got_s, **CPU), JM.js_divergence(hr, hs),
           HIST)


def test_bin_index_follows_numpy_histogram():
    edges = np.array([0.0, 0.25, 0.5, 1.0])
    x = np.array([-0.1, 0.0, 0.1, 0.25, 0.49, 0.5, 0.99, 1.0, 1.01, np.nan])
    got = TM._histogram(torch.from_numpy(x), edges).numpy()
    np.testing.assert_array_equal(got, np.histogram(x[~np.isnan(x)],
                                                    edges)[0])


def test_sparse_joint_counts_and_unique_codes(rng):
    """Theil's U through ``unique`` over the int64 pair keys (many
    categories, wide values) and ``_Codes`` through ``torch.unique``
    (negative, float and wide integer values) give the reference's
    values."""
    x = rng.integers(-50, 50, 4000)
    y = (x // 3 + rng.integers(0, 4, 4000)).astype(np.float64)
    _close(TM.theils_u(x, y, **CPU), JM.theils_u(x, y), CORR)
    wide = x.astype(np.int64) * (1 << 40)
    _close(TM.theils_u(wide, y, **CPU), JM.theils_u(wide, y), CORR)
    _close(TM.theils_u(y, wide, **CPU), JM.theils_u(y, wide), CORR)
    _close(TM.correlation_ratio(x, y, **CPU), JM.correlation_ratio(x, y),
           CORR)


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 60), st.integers(0, 3))
def test_degenerate_columns_match_reference(n, width):
    """Empty and constant columns: the reference's defined values (0.0 for
    empty, 1.0 for constant x in Theil's U, 0.0 for a constant continuous
    column's correlation ratio), never NaN, and its association matrices
    (a constant column's Pearson entries NaN → 0)."""
    r = np.random.default_rng(n * 7 + width)
    cat = r.integers(0, max(width, 1), n).astype(np.int32)
    const_i = np.zeros(n, np.int32)
    cont = r.normal(size=n)
    const_f = np.full(n, 2.5)
    for x, y in ((cat, const_i), (const_i, cat), (cat, cat)):
        got = TM.theils_u(x, y, **CPU)
        assert np.isfinite(got)
        _close(got, JM.theils_u(x, y), CORR)
    for c, f in ((cat, cont), (const_i, cont), (cat, const_f)):
        got = TM.correlation_ratio(c, f, **CPU)
        assert np.isfinite(got)
        _close(got, JM.correlation_ratio(c, f), CORR)
    if n >= 2:
        conts = np.stack([cont, const_f, cont * 2][:width], 1) if width \
            else np.zeros((n, 0))
        cats = np.stack([cat, const_i][:width - 1], 1) if width > 1 \
            else np.zeros((n, 0), np.int32)
        np.testing.assert_allclose(
            TM.association_matrix(conts, cats, **CPU).numpy(),
            JM.association_matrix(conts, cats), rtol=CORR, atol=CORR)


def test_structure_only_and_identical_pairs():
    jg, jc, jk = JR.paysim_like(n=512, n_edges=1500)
    tg = _tg(jg)
    z_f, z_i = jc[:, :0], jk[:, :0]
    m = TM.evaluate_all(tg, z_f, z_i, tg, z_f, z_i, **CPU)
    assert m["feature_corr"] is None and m["degree_feat_dist"] is None
    assert m["degree_dist"] == 1.0 and m["dcc"] == 0.0
    m = TM.evaluate_all(tg, jc, jk, tg, jc, jk, **CPU)
    assert m["feature_corr"] == pytest.approx(1.0, abs=1e-12)
    assert m["degree_feat_dist"] == pytest.approx(0.0, abs=1e-9)
    # a graph without edges on one side: dcc's terms are skipped
    empty = TGraph(torch.zeros(0, dtype=torch.int32),
                   torch.zeros(0, dtype=torch.int32), 8, 8)
    assert TM.dcc(empty, tg, **CPU) == 1.0 == JM.dcc(
        JGraph(np.zeros(0, np.int32), np.zeros(0, np.int32), 8, 8), jg)
