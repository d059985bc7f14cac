"""Paper Table 3: big-graph generation timings at increasing scale, with
edges/s as the derived metric.

Renamed from ``benchmarks/table3_scaling.py``: the graphs are drawn by
the port's auto backend (``cuda_prng``, K2, on the card; the
``reference`` stream, the JAX package's ``xla``, on the CPU).  The
dry-run's projection rows come from the port's graph-generation cells
(``python -m repro_torch.launch.dryrun --graphgen --mesh both``, written
to ``results/dryrun_torch/graphgen__1t__{mesh}.json``) when they exist,
named ``table3/h100_{mesh}_roofline``: the edges of one step of the
mesh and the edges/s of its roofline on H100 constants.
"""
from __future__ import annotations

import json
import os
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
    for mesh in ("single", "multi"):
        p = f"results/dryrun_torch/graphgen__1t__{mesh}.json"
        if os.path.exists(p):
            with open(p) as f:
                rec = json.load(f)
            if rec.get("status") == "ok":
                rl = rec["roofline"]
                rows.append(row(f"table3/h100_{mesh}_roofline", 0.0,
                                f"edges_per_step={rl['edges']:.3e};"
                                f"eps={rl['edges_per_s_roofline']:.3e}"))
    return emit(rows, "table3_scaling")
