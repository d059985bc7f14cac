"""Reference graphs — offline stand-ins for the paper's datasets (Table 1).

``tabformer_like`` mirrors Tabformer: a power-law bipartite transaction
graph with edge features correlated with its structure.  It is the JAX
package's generator, copied so that the port can fit it with no JAX
present: the same seed gives the same numpy arrays, here wrapped in the
port's ``Graph`` (id tensors on the CPU).
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
    g = Graph(torch.from_numpy(src), torch.from_numpy(dst), n_src, n_dst,
              bipartite=True)

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
