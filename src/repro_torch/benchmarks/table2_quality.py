"""Paper Table 2: synthetic-data quality (Degree Dist ↑ / Feature Corr ↑ /
Degree-Feat Dist-Dist ↓) across datasets × methods.

Methods: ours (kronecker+GAN+GBDT), random (ER+random+random),
graphworld-like (fitted DC-SBM + GAN features + random aligner — the
paper's improved-GraphWorld baseline).

As ``benchmarks/table2_quality.py``, with each pipeline fitted, drawn
and scored on ``device`` (``ours`` through the auto backend, K2 on the
card), each row timed to the end of its work.
"""
from __future__ import annotations

import time

from repro_torch.benchmarks.common import device_of, emit, row, sync
from repro_torch.core.aligner import AlignerConfig
from repro_torch.core.gbdt import GBDTConfig
from repro_torch.core.metrics import evaluate_all
from repro_torch.core.pipeline import SyntheticGraphPipeline
from repro_torch.data import reference as R

METHODS = {
    "ours": dict(struct="kronecker", features="gan", aligner="xgboost",
                 noise=0.03),
    "random": dict(struct="er", features="random", aligner="random"),
    "graphworld": dict(struct="sbm", features="gan", aligner="random"),
}


def run(fast: bool = True, device="cuda"):
    dev = device_of(device)
    datasets = {
        "tabformer": R.tabformer_like(n_src=1024, n_dst=128, n_edges=8000),
        "ieee": R.ieee_like(n_src=1024, n_dst=128, n_edges=6000),
        "paysim": R.paysim_like(n=2048, n_edges=6000),
    }
    gan_steps = 150 if fast else 500
    rows = []
    acfg = AlignerConfig(gbdt=GBDTConfig(n_rounds=40 if fast else 100))
    for dname, (g, cont, cat) in datasets.items():
        for mname, kw in METHODS.items():
            sync(dev)
            t0 = time.perf_counter()
            pipe = SyntheticGraphPipeline(gan_steps=gan_steps,
                                          aligner_cfg=acfg, device=dev, **kw)
            pipe.fit(g, cont, cat)
            gs, cs, ks = pipe.generate(seed=0)
            m = evaluate_all(g, cont, cat, gs, cs, ks, device=dev)
            sync(dev)
            us = (time.perf_counter() - t0) * 1e6
            rows.append(row(
                f"table2/{dname}/{mname}", us,
                f"deg={m['degree_dist']:.3f};corr={m['feature_corr']:.3f};"
                f"joint={m['degree_feat_dist']:.3f}"))
    return emit(rows, "table2_quality")
