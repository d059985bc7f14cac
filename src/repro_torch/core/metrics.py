"""Evaluation metrics (paper §4.3), the part the structure fit needs.

``degree_dist_similarity`` is the paper's "Degree Dist. ↑": agreement in
[0, 1] of the normalized, log-binned degree distributions, well defined
when one graph is much larger than the other.  Degrees are counted on
the graphs' device (exact integers) and binned on the host in numpy, as
the JAX package bins them, so the score is the reference's to the bit.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graph.ops import Graph, in_degrees, out_degrees


def _normalized_log_hist(degrees, n_bins: int = 24) -> np.ndarray:
    """Histogram of degree/max_degree over log-spaced bins, normalized to a
    distribution (size-invariant — comparable across graph scales)."""
    d = np.asarray(degrees, np.float64)
    d = d[d > 0]
    if d.size == 0:
        return np.zeros(n_bins)
    x = d / d.max()
    edges = np.logspace(-6, 0, n_bins + 1)
    h, _ = np.histogram(x, bins=edges)
    h = h.astype(np.float64)
    return h / max(h.sum(), 1)


def degree_dist_similarity(g_real: Graph, g_syn: Graph,
                           n_bins: int = 24) -> float:
    """1 − total-variation distance between normalized degree histograms,
    averaged over in/out; in [0, 1]."""
    sims = []
    for deg_fn in (out_degrees, in_degrees):
        h1 = _normalized_log_hist(deg_fn(g_real).cpu().numpy(), n_bins)
        h2 = _normalized_log_hist(deg_fn(g_syn).cpu().numpy(), n_bins)
        sims.append(1.0 - 0.5 * np.abs(h1 - h2).sum())
    return float(np.mean(sims))
