"""Evaluation metrics (paper §4.3), the part the structure fit needs.

``degree_dist_similarity`` is the paper's "Degree Dist. ↑": agreement in
[0, 1] of the normalized, log-binned degree distributions, well defined
when one graph is much larger than the other.  Degrees are counted on
the graphs' device (exact integers) and binned on the host in numpy, as
the JAX package bins them, so the score is the reference's to the bit.
``degree_counts_similarity`` is the same score from degree histograms
(``fit_engine.DegreeSketch``, ``graph.ops.sparse_degree_histogram``), the
form the streamed fit scores its calibration samples in; it is numpy on
the host, the reference's arithmetic, so its scores are bit-equal too.
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


def _normalized_log_hist_counts(counts: np.ndarray, max_deg: int,
                                n_bins: int = 24) -> np.ndarray:
    """``_normalized_log_hist`` evaluated from a degree *histogram*
    (``counts[k]`` = #nodes with degree k) instead of the raw degree
    array — the form the streaming degree sketch produces.  Degrees
    clipped into the sketch's last bin sit at ``kmax / max_deg``."""
    counts = np.asarray(counts, np.float64)
    ks = np.arange(len(counts), dtype=np.float64)
    w = counts.copy()
    w[0] = 0.0                                  # d > 0 filter
    if w.sum() <= 0 or max_deg <= 0:
        return np.zeros(n_bins)
    x = np.clip(ks / max_deg, 1e-6, 1.0)
    edges = np.logspace(-6, 0, n_bins + 1)
    h, _ = np.histogram(x, bins=edges, weights=w)
    return h / max(h.sum(), 1)


def degree_counts_similarity(out_a, max_out_a: int, in_a, max_in_a: int,
                             out_b, max_out_b: int, in_b, max_in_b: int,
                             n_bins: int = 24) -> float:
    """``degree_dist_similarity`` between two degree-histogram pairs, from
    bounded-memory sketches, never touching a dense per-node array."""
    sims = []
    for ha, ma, hb, mb in ((out_a, max_out_a, out_b, max_out_b),
                           (in_a, max_in_a, in_b, max_in_b)):
        h1 = _normalized_log_hist_counts(ha, ma, n_bins)
        h2 = _normalized_log_hist_counts(hb, mb, n_bins)
        sims.append(1.0 - 0.5 * np.abs(h1 - h2).sum())
    return float(np.mean(sims))
