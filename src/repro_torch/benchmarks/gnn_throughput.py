"""Paper §8.1 / Table 4: GNN epoch-throughput realism — relative epoch
time of GCN/GAT on generated vs original graphs (Rel. Timing ↑).

As ``benchmarks/gnn_throughput.py``, with the port's
``make_node_classifier(cfg, g, device=)`` and ``init_gnn`` on
``device``: one warm-up step, then the epochs timed to the end of their
work on the device.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.benchmarks.common import device_of, emit, row, sync
from repro_torch.core.aligner import AlignerConfig
from repro_torch.core.gbdt import GBDTConfig
from repro_torch.core.pipeline import SyntheticGraphPipeline
from repro_torch.data import reference as R
from repro_torch.models.gnn import GNNConfig, init_gnn, make_node_classifier


def _epoch_time(g, dev, n_classes=7, kind="gcn", epochs=5):
    cfg = GNNConfig(kind=kind, n_classes=n_classes)
    feats = np.random.default_rng(0).normal(0, 1, (g.n_nodes, 16)).astype(
        np.float32)
    labels = np.random.default_rng(1).integers(0, n_classes, g.n_nodes)
    train_step, _ = make_node_classifier(cfg, g, device=dev)
    model = init_gnn(trandom.PRNGKey(0), cfg, 16, device=dev)
    opt = [torch.zeros_like(p) for p in model.parameters()]
    f = torch.from_numpy(feats).to(dev)
    lab = torch.from_numpy(labels.astype(np.int64)).to(dev)
    m = torch.ones(g.n_nodes, dtype=torch.float32, device=dev)
    train_step(model, opt, f, lab, m)                  # warm-up
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(epochs):
        train_step(model, opt, f, lab, m)
    sync(dev)
    return (time.perf_counter() - t0) / epochs


def run(fast: bool = True, device="cuda"):
    dev = device_of(device)
    g, cont, cat = R.paysim_like(n=2048, n_edges=8000)
    rows = []
    variants = {"original": g}
    pipe = SyntheticGraphPipeline(
        struct="kronecker", features="random", aligner="random",
        gan_steps=0, aligner_cfg=AlignerConfig(gbdt=GBDTConfig(n_rounds=5)),
        device=dev)
    pipe.fit(g, cont, cat)
    gs, _, _ = pipe.generate(seed=0)
    variants["ours"] = gs
    er = SyntheticGraphPipeline(struct="er", features="random",
                                aligner="random", device=dev)
    er.fit(g, cont, cat)
    ge, _, _ = er.generate(seed=0)
    variants["random"] = ge

    t_orig = None
    for kind in ("gcn", "gat"):
        for name, graph in variants.items():
            t = _epoch_time(graph, dev, kind=kind, epochs=3 if fast else 10)
            if name == "original":
                t_orig = t
                rel = 1.0
            else:
                rel = 1.0 - abs(t - t_orig) / t_orig
            rows.append(row(f"gnn/{kind}/{name}", t * 1e6,
                            f"rel_timing={rel:.3f}"))
    return emit(rows, "gnn_throughput")
