"""The port's graph statistics (``repro_torch.graph.ops``: hop plot,
effective diameter, Table 10's statistics) against the JAX package's numpy
ones, on the CPU, from the same numpy edges.

Tolerances: integers (triangles, wedges, component sizes, the hop plot's
reach counts, hence the hop plot itself) exactly; float statistics within
1e-9 relative (degree assortativity and the entropy sum in float64 in
another order than numpy; gini and the power-law exponent sum the same
integers and logs).  Graphs are at most a few thousand edges.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import rmat as jrmat
from repro.core import structure as jstructure
from repro.data import reference as JR
from repro.graph import ops as JG
from repro.graph.ops import Graph as JGraph
from repro_torch import random as tr
from repro_torch.core import rmat as trmat
from repro_torch.core import structure as tstructure
from repro_torch.data import reference as TR
from repro_torch.graph import ops as TG
from repro_torch.graph.ops import Graph as TGraph

from tests._hypothesis_compat import given, settings, st

REL = 1e-9
#: the statistics that take a graph, and whether each is an integer
GRAPH_STATS = [("triangle_count", True), ("wedge_count", True),
               ("global_clustering", False), ("degree_assortativity", False),
               ("rel_edge_distribution_entropy", False),
               ("largest_connected_component", True)]


def _both(src, dst, n_src, n_dst, bipartite=False):
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    return (JGraph(src, dst, n_src, n_dst, bipartite),
            TGraph(torch.from_numpy(src), torch.from_numpy(dst), n_src, n_dst,
                   bipartite))


def _torch_graph(jg):
    return TGraph(torch.from_numpy(np.asarray(jg.src)),
                  torch.from_numpy(np.asarray(jg.dst)), jg.n_src, jg.n_dst,
                  jg.bipartite)


def _random_graph(seed, n=300, e=2000, bipartite=False, self_loops=True):
    r = np.random.default_rng(seed)
    w = np.arange(1, n + 1, dtype=np.float64) ** -1.1
    w /= w.sum()
    n_dst = n // 4 if bipartite else n
    src = r.choice(n, e, p=w)
    dst = r.choice(n_dst, e, p=w[:n_dst] / w[:n_dst].sum())
    if not self_loops and not bipartite:
        src, dst = src[src != dst], dst[src != dst]
    return _both(src, dst, n, n_dst, bipartite)


def _close(got, want, exact):
    if exact:
        assert got == want and isinstance(got, int)
    elif np.isnan(want):
        assert np.isnan(got)
    else:
        assert got == pytest.approx(want, rel=REL, abs=1e-12)


GRAPHS = {
    "homogeneous": lambda: _random_graph(0),
    "bipartite": lambda: _random_graph(1, bipartite=True),
    "no_self_loops": lambda: _random_graph(2, n=64, e=900, self_loops=False),
    "cora_like": lambda: (JR.cora_like(n=512, n_edges=2000)[0],
                          TR.cora_like(n=512, n_edges=2000)[0]),
    "tabformer_like": lambda: (
        JR.tabformer_like(n_src=512, n_dst=64, n_edges=3000)[0],
        TR.tabformer_like(n_src=512, n_dst=64, n_edges=3000)[0]),
}


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("stat,exact", GRAPH_STATS)
def test_graph_statistic_matches_reference(graph, stat, exact):
    jg, tg = GRAPHS[graph]()
    _close(getattr(TG, stat)(tg), getattr(JG, stat)(jg), exact)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_degree_sequence_statistics_match_reference(graph):
    jg, tg = GRAPHS[graph]()
    deg = np.concatenate([np.asarray(JG.out_degrees(jg)),
                          np.asarray(JG.in_degrees(jg))])
    tdeg = torch.from_numpy(deg)
    _close(TG.gini_coefficient(tdeg), JG.gini_coefficient(deg), False)
    for dmin in (1, 3):
        _close(TG.powerlaw_exponent(tdeg, dmin),
               JG.powerlaw_exponent(deg, dmin), False)
    # arrays go in as the reference takes them too
    _close(TG.gini_coefficient(deg), JG.gini_coefficient(deg), False)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("n_sources,max_hops,seed", [(32, 16, 0), (5, 3, 7)])
def test_hop_plot_equals_reference(graph, n_sources, max_hops, seed):
    jg, tg = GRAPHS[graph]()
    want = JG.hop_plot(jg, n_sources, max_hops, seed)
    got = TG.hop_plot(tg, n_sources, max_hops, seed)
    np.testing.assert_array_equal(got, want)
    assert TG.effective_diameter(got) == JG.effective_diameter(want)


def test_batched_expansion_equals_one_batch(monkeypatch):
    """Triangle candidates and BFS frontiers split into many batches give
    the single batch's results."""
    jg, tg = GRAPHS["cora_like"]()
    whole = (TG.triangle_stats(tg), TG.hop_plot(tg, n_sources=4))
    monkeypatch.setattr(TG, "EXPAND_BATCH", 50)
    tri, hp = TG.triangle_stats(tg), TG.hop_plot(tg, n_sources=4)
    assert tri == whole[0] and tri[0] == JG.triangle_count(jg)
    assert tri[1] > 50 * 20           # many batches
    np.testing.assert_array_equal(hp, whole[1])


def test_row_batches_cover_rows_within_budget():
    lens = torch.tensor([3, 0, 9, 1, 1, 4, 0, 2, 6])
    spans = TG._row_batches(lens, 5)
    assert spans[0][0] == 0 and spans[-1][1] == len(lens)
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    for r0, r1 in spans:
        assert int(lens[r0:r1].sum()) <= 5 + int(lens[r0])
    assert TG._row_batches(torch.zeros(3, dtype=torch.int64), 5) == []


def test_known_small_graphs():
    # K4: 4 triangles, 12 wedges, clustering 1, one component
    jg, tg = _both([0, 0, 0, 1, 1, 2], [1, 2, 3, 2, 3, 3], 4, 4)
    assert TG.triangle_stats(tg)[0] == 4 == JG.triangle_count(jg)
    assert TG.wedge_count(tg) == 12
    assert TG.global_clustering(tg) == pytest.approx(1.0)
    assert TG.largest_connected_component(tg) == 4
    # isolated nodes are components of one; duplicates and loops ignored
    jg, tg = _both([0, 1, 1, 5, 5], [1, 0, 1, 6, 6], 9, 9)
    assert TG.largest_connected_component(tg) == 2 == \
        JG.largest_connected_component(jg)
    assert TG.triangle_count(tg) == 0 and TG.wedge_count(tg) == 0
    assert TG.degree_assortativity(tg) == 0.0 == JG.degree_assortativity(jg)


@settings(max_examples=25, deadline=None)
@given(st.integers(2, 40), st.integers(1, 16))
def test_hop_plot_path_graph(n, max_hops):
    """A path 0-1-…-(n-1): reach grows by hops until the frontier empties,
    which then fills the rest of the curve (the reference's rule)."""
    jg, tg = _both(np.arange(n - 1), np.arange(1, n), n, n)
    want = JG.hop_plot(jg, n_sources=4, max_hops=max_hops, seed=n)
    got = TG.hop_plot(tg, n_sources=4, max_hops=max_hops, seed=n)
    np.testing.assert_array_equal(got, want)
    assert TG.largest_connected_component(tg) == n
    assert TG.triangle_count(tg) == 0
    assert TG.effective_diameter(got) == JG.effective_diameter(want)


@settings(max_examples=25, deadline=None)
@given(st.integers(3, 12), st.integers(0, 2 ** 31 - 1))
def test_triangle_and_cycle_graphs(k, seed):
    """A k-cycle with one chord per seed: triangle count, wedges,
    clustering and components equal the reference's."""
    r = np.random.default_rng(seed)
    src = list(range(k))
    dst = [(i + 1) % k for i in range(k)]
    a, b = r.integers(0, k, 2)
    src.append(int(a))
    dst.append(int(b))
    jg, tg = _both(src, dst, k, k)
    for stat, exact in GRAPH_STATS:
        _close(getattr(TG, stat)(tg), getattr(JG, stat)(jg), exact)


def test_degenerate_sequences():
    for deg in (np.zeros(0, np.int64), np.zeros(5, np.int64),
                np.full(7, 3)):
        _close(TG.gini_coefficient(torch.from_numpy(deg)),
               JG.gini_coefficient(deg), False)
        _close(TG.powerlaw_exponent(torch.from_numpy(deg)),
               JG.powerlaw_exponent(deg), False)
    jg, tg = _both([0], [0], 3, 3)
    assert TG.rel_edge_distribution_entropy(tg) == 1.0 == \
        JG.rel_edge_distribution_entropy(jg)
    assert TG.largest_connected_component(tg) == 1


def test_wide_ids_do_not_overflow():
    """Node ids past 2^31 (int64 tensors) key their pairs in int64."""
    n = (1 << 31) + 1000
    src = torch.tensor([0, n - 1, 5, n - 1], dtype=torch.int64)
    dst = torch.tensor([n - 1, 5, 0, 0], dtype=torch.int64)
    lo, hi, nn = TG._to_undirected(TGraph(src, dst, n, n))
    assert nn == n
    assert lo.tolist() == [0, 0, 5] and hi.tolist() == [5, n - 1, n - 1]


def _require_partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("the port reproduces jax's partitionable threefry mode; "
                    "jax is set to the other mode")


def _table10_row(G, g):
    deg = np.asarray(G.out_degrees(g)) + np.asarray(G.in_degrees(g))
    return {"maxdeg": int(deg.max()), "tri": G.triangle_count(g),
            "assort": G.degree_assortativity(g),
            "plaw": G.powerlaw_exponent(deg[deg > 0]),
            "clust": G.global_clustering(g),
            "gini": G.gini_coefficient(deg),
            "entro": G.rel_edge_distribution_entropy(g),
            "lcc": G.largest_connected_component(g)}


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_table10_row_matches_reference(noise):
    """``benchmarks/table10_structural_stats.py``'s row for a fit of
    ``cora_like``: ``fit_structure`` and ``sample_graph(PRNGKey(0))`` on
    the ``reference`` stream give the JAX package's edges, and the eight
    statistics of the sample equal the reference's."""
    _require_partitionable()
    jg = JR.cora_like(n=512, n_edges=2000)[0]
    jfit = jstructure.fit_structure(jg, noise=noise)
    tfit = tstructure.fit_structure(_torch_graph(jg), noise=noise)
    assert (tfit.a, tfit.b, tfit.c, tfit.d, tfit.n, tfit.m, tfit.E) == \
        (jfit.a, jfit.b, jfit.c, jfit.d, jfit.n, jfit.m, jfit.E)
    js, jd = jrmat.sample_graph(jax.random.PRNGKey(0), jfit)
    ts, td = trmat.sample_graph(tr.PRNGKey(0), tfit, device="cpu")
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    n = 2 ** jfit.n
    want = _table10_row(JG, JGraph(np.asarray(js), np.asarray(jd), n, n))
    got = _table10_row(TG, TGraph(ts, td, n, n))
    for k in want:
        _close(got[k], want[k], isinstance(want[k], int))
