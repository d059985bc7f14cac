"""Reference graphs — offline stand-ins for the paper's datasets (Table 1).

Each generator produces a graph with known planted structure of the
class of a Table 1 dataset, plus features correlated with that
structure.  They are the JAX package's generators, copied so that the
port can fit and score them with no JAX present: the same seed gives the
same numpy arrays, here wrapped in the port's ``Graph`` (id tensors on
the CPU; the pipeline and the metrics move them to their device).

==============  ====================  ========================
reference       mirrors               class
==============  ====================  ========================
tabformer_like  Tabformer             bipartite power-law, edge feats
ieee_like       IEEE-Fraud            bipartite, many edge feats
paysim_like     Paysim                sparse transfer network
cora_like       Cora / CORA-ML        homophilous citation
==============  ====================  ========================
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.graph.ops import Graph


def _powerlaw_bipartite(rng, n_src, n_dst, n_edges, alpha=1.3):
    """Preferential-attachment-flavored bipartite multigraph."""
    w_src = (np.arange(1, n_src + 1, dtype=np.float64)) ** (-alpha)
    w_dst = (np.arange(1, n_dst + 1, dtype=np.float64)) ** (-alpha * 0.8)
    w_src /= w_src.sum()
    w_dst /= w_dst.sum()
    src = rng.choice(n_src, size=n_edges, p=w_src)
    dst = rng.choice(n_dst, size=n_edges, p=w_dst)
    return src.astype(np.int32), dst.astype(np.int32)


def _graph(src: np.ndarray, dst: np.ndarray, n_src: int, n_dst: int,
           bipartite: bool) -> Graph:
    return Graph(torch.from_numpy(src), torch.from_numpy(dst), n_src, n_dst,
                 bipartite=bipartite)


def tabformer_like(seed: int = 0, n_src: int = 4096, n_dst: int = 512,
                   n_edges: int = 40000
                   ) -> Tuple[Graph, np.ndarray, np.ndarray]:
    """Transaction-like bipartite graph: (user×card) -> merchant.

    Edge features: amount (log-normal, correlated with merchant
    popularity), latency (coupled to amount); categorical hour (from the
    user id hash), merchant category (amount-driven) and chip-use flag
    (hour-driven).  Returns ``(graph, cont (E, 2) float32, cat (E, 3)
    int32)``."""
    rng = np.random.default_rng(seed)
    src, dst = _powerlaw_bipartite(rng, n_src, n_dst, n_edges)
    g = _graph(src, dst, n_src, n_dst, True)

    dst_deg = np.bincount(dst, minlength=n_dst).astype(np.float64)
    pop = np.log1p(dst_deg)[dst]
    log_amount = 2.0 + 0.35 * pop + rng.normal(0, 0.7, n_edges)
    lat = 0.8 * log_amount + rng.normal(0, 0.4, n_edges)
    cont = np.stack([log_amount, lat], 1).astype(np.float32)

    hour = ((src.astype(np.int64) * 2654435761) % 24 // 4).astype(np.int32)
    mcc = np.clip(((log_amount - log_amount.mean()) * 1.5).astype(np.int32)
                  + 4, 0, 7).astype(np.int32)          # amount-driven
    chip = ((hour >= 3).astype(np.int32)
            ^ (rng.random(n_edges) < 0.1).astype(np.int32))  # hour-driven
    cat = np.stack([hour, mcc, chip], 1)
    return g, cont, cat


def ieee_like(seed: int = 1, n_src: int = 2048, n_dst: int = 256,
              n_edges: int = 12000) -> Tuple[Graph, np.ndarray, np.ndarray]:
    """Fraud-detection-like: many continuous edge features + fraud label."""
    rng = np.random.default_rng(seed)
    src, dst = _powerlaw_bipartite(rng, n_src, n_dst, n_edges, alpha=1.1)
    g = _graph(src, dst, n_src, n_dst, True)
    deg = np.bincount(src, minlength=n_src).astype(np.float64)[src]
    base = rng.normal(0, 1, (n_edges, 6))
    base[:, 0] += 0.8 * np.log1p(deg)
    base[:, 1] -= 0.5 * np.log1p(deg)
    base[:, 2] = 0.6 * base[:, 0] + 0.4 * rng.normal(0, 1, n_edges)
    cont = base.astype(np.float32)
    fraud = (rng.random(n_edges) <
             0.02 + 0.1 * (deg > np.quantile(deg, 0.95))).astype(np.int32)
    prod = rng.integers(0, 5, n_edges).astype(np.int32)
    cat = np.stack([fraud, prod], 1)
    return g, cont, cat


def paysim_like(seed: int = 2, n: int = 8192, n_edges: int = 20000
                ) -> Tuple[Graph, np.ndarray, np.ndarray]:
    """Homogeneous transfer network (nameOrig -> nameDest)."""
    rng = np.random.default_rng(seed)
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-1.15)
    w /= w.sum()
    src = rng.choice(n, size=n_edges, p=w).astype(np.int32)
    dst = rng.choice(n, size=n_edges, p=np.roll(w, 7)).astype(np.int32)
    g = _graph(src, dst, n, n, False)
    deg = np.bincount(src, minlength=n).astype(np.float64)[src]
    amount = rng.lognormal(3.0 + 0.3 * np.log1p(deg), 1.0)
    balance = rng.lognormal(5.0 - 0.2 * np.log1p(deg), 1.2)
    cont = np.stack([np.log1p(amount), np.log1p(balance)],
                    1).astype(np.float32)
    ttype = rng.integers(0, 5, n_edges).astype(np.int32)
    flag = (amount > np.quantile(amount, 0.98)).astype(np.int32)
    cat = np.stack([ttype, flag], 1)
    return g, cont, cat


def cora_like(seed: int = 3, n: int = 2048, n_edges: int = 8000,
              n_classes: int = 7, homophily: float = 0.85
              ) -> Tuple[Graph, np.ndarray, np.ndarray]:
    """Homophilous citation-like graph with node labels + features
    (node-feature pipeline / GNN downstream tests)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n).astype(np.int32)
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-1.05)
    w /= w.sum()
    src = rng.choice(n, size=n_edges * 2, p=w).astype(np.int32)
    dst = rng.choice(n, size=n_edges * 2, p=w).astype(np.int32)
    same = labels[src] == labels[dst]
    keep_p = np.where(same, homophily, 1 - homophily)
    keep = rng.random(len(src)) < keep_p
    src, dst = src[keep][:n_edges], dst[keep][:n_edges]
    g = _graph(src, dst, n, n, False)
    centers = rng.normal(0, 1.5, (n_classes, 8))
    cont = (centers[labels] + rng.normal(0, 1, (n, 8))).astype(np.float32)
    cat = labels[:, None]
    return g, cont, cat


REFERENCES = {
    "tabformer_like": tabformer_like,
    "ieee_like": ieee_like,
    "paysim_like": paysim_like,
    "cora_like": cora_like,
}
