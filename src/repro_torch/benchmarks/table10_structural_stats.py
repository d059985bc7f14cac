"""Paper Table 10: structural statistics vs a CORA-ML-like graph: ours
with and without per-level noise (App. 9), plus the R-MAT-default
baseline (fixed 3:1 ratios, no fitting).

As ``benchmarks/table10_structural_stats.py``, on ``device``: the graphs
are drawn by the port's auto backend (``cuda_prng``, K2, on the card;
the ``reference`` stream, the JAX package's ``xla``, on the CPU, where the
statistics equal the JAX module's).
"""
from __future__ import annotations

import time

from repro_torch import random as trandom
from repro_torch.benchmarks.common import device_of, emit, on, row, sync
from repro_torch.core import rmat
from repro_torch.core.structure import KroneckerFit, fit_structure
from repro_torch.data import reference as R
from repro_torch.graph import ops as G
from repro_torch.graph.ops import Graph


def _stats(g: Graph) -> str:
    deg = G.out_degrees(g) + G.in_degrees(g)
    return (f"maxdeg={int(deg.max())};tri={G.triangle_count(g)};"
            f"assort={G.degree_assortativity(g):.3f};"
            f"plaw={G.powerlaw_exponent(deg[deg > 0]):.2f};"
            f"clust={G.global_clustering(g):.2e};"
            f"gini={G.gini_coefficient(deg):.3f};"
            f"entro={G.rel_edge_distribution_entropy(g):.3f};"
            f"lcc={G.largest_connected_component(g)}")


def _sample(fit: KroneckerFit, dev) -> Graph:
    src, dst = rmat.sample_graph(trandom.PRNGKey(0), fit, backend="auto",
                                 device=dev)
    return Graph(src, dst, 2 ** fit.n, 2 ** fit.m)


def run(fast: bool = True, device="cuda"):
    dev = device_of(device)
    g, _, _ = R.cora_like(n=2048 if fast else 4096, n_edges=8000)
    g = on(g, dev)
    rows = [row("table10/original", 0.0, _stats(g))]
    for name, noise in (("ours_no_noise", 0.0), ("ours_noise", 0.05)):
        sync(dev)
        t0 = time.perf_counter()
        fit = fit_structure(g, noise=noise)
        gs = _sample(fit, dev)
        sync(dev)
        us = (time.perf_counter() - t0) * 1e6
        rows.append(row(f"table10/{name}", us, _stats(gs)))
    # R-MAT default (a/b = a/c = 3, no degree fitting)
    sync(dev)
    t0 = time.perf_counter()
    n = fit.n
    default = KroneckerFit(a=0.57, b=0.19, c=0.19, d=0.05, n=n, m=n,
                           E=g.n_edges)
    gs = _sample(default, dev)
    sync(dev)
    rows.append(row("table10/rmat_default",
                    (time.perf_counter() - t0) * 1e6, _stats(gs)))
    return emit(rows, "table10_structural_stats")
