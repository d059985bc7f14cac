"""Paper Table 5 + Fig. 7: metric stability across generation scales
(nodes ×k, edges ×k² per Eq. 22).

As ``benchmarks/table5_scale_metrics.py``, with the pipeline fitted,
drawn (the auto backend: K2 on the card) and scored on ``device``, each
scale timed to the end of its work.
"""
from __future__ import annotations

import time

from repro_torch.benchmarks.common import device_of, emit, row, sync
from repro_torch.core.aligner import AlignerConfig
from repro_torch.core.gbdt import GBDTConfig
from repro_torch.core.metrics import evaluate_all
from repro_torch.core.pipeline import SyntheticGraphPipeline
from repro_torch.data import reference as R


def run(fast: bool = True, device="cuda"):
    dev = device_of(device)
    g, cont, cat = R.tabformer_like(n_src=512, n_dst=64, n_edges=4000)
    pipe = SyntheticGraphPipeline(
        struct="kronecker", features="gan", aligner="xgboost", noise=0.03,
        gan_steps=120 if fast else 400,
        aligner_cfg=AlignerConfig(gbdt=GBDTConfig(n_rounds=30)), device=dev)
    pipe.fit(g, cont, cat)
    rows = []
    for scale in (1, 2, 4) if fast else (1, 2, 4, 8):
        sync(dev)
        t0 = time.perf_counter()
        gs, cs, ks = pipe.generate(seed=0, scale_nodes=scale)
        m = evaluate_all(g, cont, cat, gs, cs, ks, device=dev)
        sync(dev)
        us = (time.perf_counter() - t0) * 1e6
        rows.append(row(
            f"table5/scale{scale}", us,
            f"E={gs.n_edges};deg={m['degree_dist']:.3f};"
            f"corr={m['feature_corr']:.3f};joint={m['degree_feat_dist']:.3f};"
            f"dcc={m['dcc']:.3f}"))
    return emit(rows, "table5_scale_metrics")
