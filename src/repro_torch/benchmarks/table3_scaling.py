"""Paper Table 3: big-graph generation timings at increasing scale, with
edges/s as the derived metric.

Renamed from ``benchmarks/table3_scaling.py``: the graphs are drawn by
the port's auto backend (``cuda_prng``, K2, on the card; the
``reference`` stream, the JAX package's ``xla``, on the CPU), and the
TPU dry-run projection rows (``table3/v5e_*_roofline``) are gone: the
port has no dry-run (``launch/`` is ROADMAP A7).
"""
from __future__ import annotations

import time

from repro_torch import random as trandom
from repro_torch.benchmarks.common import device_of, emit, row, sync
from repro_torch.core.rmat import sample_graph_chunked
from repro_torch.core.structure import KroneckerFit


def run(fast: bool = True, device="cuda"):
    dev = device_of(device)
    rows = []
    base_edges = 1 << (18 if fast else 21)
    for scale in (1, 2, 4):
        n = 16 + scale.bit_length()
        fit = KroneckerFit(a=0.45, b=0.22, c=0.2, d=0.13, n=n, m=n,
                           E=base_edges * scale ** 2)
        sync(dev)
        t0 = time.perf_counter()
        src, _ = sample_graph_chunked(trandom.PRNGKey(0), fit, k_pref=2,
                                      backend="auto", device=dev)
        sync(dev)
        dt = time.perf_counter() - t0
        rows.append(row(f"table3/scale{scale}x", dt * 1e6,
                        f"edges={len(src)};eps={fit.E / dt:.3e}"))
    return emit(rows, "table3_scaling")
