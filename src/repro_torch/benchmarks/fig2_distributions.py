"""Paper Fig. 2: degree distribution + hop plot, original vs ours vs
baselines (curves written to ``results/bench_torch/fig2_curves.json``).

As ``benchmarks/fig2_distributions.py``, on ``device``: the pipelines
fit and generate there (``ours`` through the auto backend, K2 on the
card), and each variant's statistics are timed to the end of their work.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import (BENCH_DIR, device_of, emit, on,
                                           row, sync)
from repro_torch.core.pipeline import SyntheticGraphPipeline
from repro_torch.data import reference as R
from repro_torch.graph import ops as G


def run(fast: bool = True, device="cuda"):
    dev = device_of(device)
    g, cont, cat = R.tabformer_like(n_src=1024, n_dst=128, n_edges=8000)
    curves = {}
    rows = []
    variants = {"original": on(g, dev)}
    for name, kw in {
        "ours": dict(struct="kronecker", features="random", aligner="random",
                     noise=0.03),
        "random": dict(struct="er", features="random", aligner="random"),
        "graphworld": dict(struct="sbm", features="random", aligner="random"),
    }.items():
        pipe = SyntheticGraphPipeline(gan_steps=0, device=dev, **kw)
        pipe.fit(g, cont, cat)
        gs, _, _ = pipe.generate(seed=0)
        variants[name] = gs
    for name, graph in variants.items():
        sync(dev)
        t0 = time.perf_counter()
        deg = G.out_degrees(graph)
        hist = torch.bincount(deg[deg > 0], minlength=64)[:64].cpu().numpy()
        hp = G.hop_plot(graph, n_sources=16, max_hops=8)
        sync(dev)
        us = (time.perf_counter() - t0) * 1e6
        curves[name] = {"degree_hist": hist.tolist(),
                        "hop_plot": np.asarray(hp).tolist()}
        rows.append(row(f"fig2/{name}", us,
                        f"effdiam={G.effective_diameter(hp):.2f};"
                        f"maxdeg={int(deg.max())}"))
    os.makedirs(BENCH_DIR, exist_ok=True)
    with open(os.path.join(BENCH_DIR, "fig2_curves.json"), "w") as f:
        json.dump(curves, f)
    return emit(rows, "fig2_distributions")
