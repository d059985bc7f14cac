"""Evaluation metrics (paper §4.3, §8.12).

* ``degree_dist_similarity`` — normalized-degree-distribution agreement in
  [0, 1] (higher better; the paper's "Degree Dist. ↑").  Degrees are
  counted on the graphs' device and binned on the host in numpy, as the
  JAX package bins them, so the score is the reference's to the bit; the
  structure fit's calibration calls it.  ``degree_counts_similarity`` is
  the same score from degree histograms (``fit_engine.DegreeSketch``), the
  form the streamed fit scores its calibration samples in.
* ``dcc`` — the paper's Eq. 20/21 scalar (relative log-binned CCDF error).
* ``feature_correlation_score`` — mean agreement of the pairwise column
  association matrices: Pearson (cont–cont), correlation ratio (cat–cont),
  Theil's U (cat–cat), the paper's "Feature Corr. ↑".
* ``degree_feature_distance`` — JS divergence between the joint
  (degree-bin × feature-bin) histograms ("Degree-Feat Dist-Dist ↓").
* ``hop_plot`` / effective diameter live in ``repro_torch.graph.ops``.

Every entry point from ``dcc`` on takes ``device`` (default ``"cuda"``),
moves what it is given there and computes in float64 (the reference is
float64 numpy).  Bin edges are numpy's (``np.logspace``, ``np.quantile``
of the real side's column), built on the host and shipped as float64;
binning follows ``np.histogram``: ``[a, b)`` bins, the last one closed,
values outside the edges dropped.  Counts are exact integers; per-group
float sums go through ``graph.ops._EdgeSum`` (a stable sort and
``segment_reduce`` on the card), so a score repeats from run to run and
differs from the reference's only in the order of its float64 sums.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.graph.ops import Graph, _EdgeSum, in_degrees, out_degrees


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


# ---------------------------------------------------------------------------
# Placement and numpy's binning
# ---------------------------------------------------------------------------

def _to_device(x, device, dtype=None) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


def _on(g: Graph, device) -> Graph:
    return Graph(_to_device(g.src, device), _to_device(g.dst, device),
                 g.n_src, g.n_dst, g.bipartite)


def _bin_index(x: torch.Tensor, edges: np.ndarray) -> torch.Tensor:
    """``np.histogram``'s bin of each ``x`` over the sorted float64
    ``edges``: ``[e_i, e_{i+1})``, the last bin closed; -1 outside the
    edges (and for NaN)."""
    e = torch.from_numpy(np.asarray(edges, np.float64)).to(x.device)
    i = torch.bucketize(x, e, right=True) - 1
    i = torch.where(x == e[-1], e.numel() - 2, i)
    return torch.where((x >= e[0]) & (x <= e[-1]), i, -1)


def _histogram(x: torch.Tensor, edges: np.ndarray) -> torch.Tensor:
    i = _bin_index(x, edges)
    return torch.bincount(i[i >= 0], minlength=len(edges) - 1)


# ---------------------------------------------------------------------------
# Degree distribution: Eq. 20
# ---------------------------------------------------------------------------

def _ccdf(d: torch.Tensor, ks: np.ndarray) -> torch.Tensor:
    x = d[d > 0] / d.max()
    c = _histogram(x, ks).flip(0).cumsum(0).flip(0).to(torch.float64)
    return c / max(float(c.max()), 1)


def dcc(g_real: Graph, g_syn: Graph, n_points: int = 16,
        device="cuda") -> float:
    """Paper Eq. 20: mean relative error of the normalized degree
    distribution at log-spaced normalized degrees.  0 = identical."""
    g_real, g_syn = _on(g_real, device), _on(g_syn, device)
    ks = np.concatenate([[0], np.logspace(-3, 0, n_points)])
    errs = []
    for deg_fn in (out_degrees, in_degrees):
        d1 = deg_fn(g_real).to(torch.float64)
        d2 = deg_fn(g_syn).to(torch.float64)
        if float(d1.max()) == 0 or float(d2.max()) == 0:
            continue
        c1, c2 = _ccdf(d1, ks), _ccdf(d2, ks)
        ok = c1 > 0
        if bool(ok.any()):
            errs.append(float(((c1[ok] - c2[ok]).abs() / c1[ok]).mean()))
    return float(np.mean(errs)) if errs else 1.0


# ---------------------------------------------------------------------------
# Feature correlation (Pearson / correlation ratio / Theil's U)
# ---------------------------------------------------------------------------

def pearson_matrix(cont, device="cuda") -> torch.Tensor:
    """``np.corrcoef`` of the columns in float64 on ``device``: NaN for a
    constant column, clipped to [-1, 1]; ``ones`` below two columns."""
    x = _to_device(cont, device, torch.float64)
    k = x.shape[1]
    if k < 2:
        return torch.ones((k, k), dtype=torch.float64, device=device)
    fact = x.shape[0] - 1
    xc = x - x.mean(0)
    c = (xc.T @ xc) * (1.0 / fact if fact > 0 else math.inf)
    sd = torch.sqrt(torch.diagonal(c))
    return (c / sd[:, None] / sd[None, :]).clamp(-1.0, 1.0)


class _Codes:
    """A categorical column as codes ``0..k-1`` in the sorted order of its
    values (``np.unique``'s), with the count of each code; ``sums(v)``
    adds ``v`` per code (a stable sort of the codes, made once)."""

    def __init__(self, x: torch.Tensor):
        uniq, self.codes = torch.unique(x, sorted=True, return_inverse=True)
        self.k = uniq.numel()
        self.n = x.numel()
        self.counts = torch.bincount(self.codes, minlength=self.k)
        self._sum = None

    def sums(self, v: torch.Tensor) -> torch.Tensor:
        if self._sum is None:
            self._sum = _EdgeSum(torch.arange(self.n, device=v.device),
                                 self.codes, self.k)
        return self._sum(v)


def _correlation_ratio(cat: _Codes, cont: torch.Tensor) -> float:
    if cont.numel() == 0 or cat.n == 0:
        return 0.0
    n = cont.numel()
    mean = cont.mean()
    total_var = float(((cont - mean) ** 2).mean()) * n
    if not math.isfinite(total_var) or total_var <= 0:
        return 0.0
    cnt = cat.counts.to(torch.float64)
    ss_between = float((cnt * (cat.sums(cont) / cnt - mean) ** 2).sum())
    return float(min(math.sqrt(ss_between / total_var), 1.0))


def correlation_ratio(cat, cont, device="cuda") -> float:
    """η: sqrt(SS_between / SS_total) for one cat vs one cont column.

    Empty columns (no rows) and constant/degenerate continuous columns
    return 0.0, as in the reference."""
    return _correlation_ratio(_Codes(_to_device(cat, device)),
                              _to_device(cont, device, torch.float64))


def _entropy(counts: torch.Tensor) -> float:
    p = counts.to(torch.float64) / counts.sum()
    return float(-(p * torch.log(p + 1e-12)).sum())


def _theils_u(x: _Codes, y: _Codes) -> float:
    if x.n == 0 or y.n == 0:
        return 0.0
    hx = _entropy(x.counts)
    if hx <= 0:
        return 1.0
    # H(x|y) = Σ_y P(y) H(x | y), from the joint counts of (x, y)
    keys, c = torch.unique(x.codes * y.k + y.codes, return_counts=True)
    y_of = keys % y.k
    ny = y.counts.to(torch.float64)[y_of]
    p = c.to(torch.float64) / ny
    hxy = float((ny / x.n * -(p * torch.log(p + 1e-12))).sum())
    return float((hx - hxy) / hx)


def theils_u(x, y, device="cuda") -> float:
    """U(x|y) = (H(x) − H(x|y)) / H(x) ∈ [0,1].

    Empty columns return 0.0; constant ``x`` keeps its defined value 1.0
    (H(x) = 0: knowing y "explains" all of the zero entropy)."""
    return _theils_u(_Codes(_to_device(x, device)),
                     _Codes(_to_device(y, device)))


def association_matrix(cont, cat, device="cuda") -> torch.Tensor:
    """Full mixed-type column association matrix (float64 on ``device``);
    each categorical column is coded once."""
    cont = _to_device(cont, device, torch.float64)
    cat = _to_device(cat, device)
    nc, nd = cont.shape[1], cat.shape[1]
    m = np.eye(nc + nd)
    m[:nc, :nc] = np.nan_to_num(pearson_matrix(cont, device).cpu().numpy())
    codes = [_Codes(cat[:, i]) for i in range(nd)]
    for i in range(nd):
        for j in range(nc):
            m[nc + i, j] = m[j, nc + i] = _correlation_ratio(codes[i],
                                                             cont[:, j])
        for j in range(nd):
            if i != j:
                m[nc + i, nc + j] = _theils_u(codes[i], codes[j])
    return torch.from_numpy(m).to(device)


def feature_correlation_score(cont_r, cat_r, cont_s, cat_s,
                              device="cuda") -> float:
    """Similarity of association matrices over the *off-diagonal* entries
    (the diagonal is identically 1 and would inflate every method)."""
    mr = association_matrix(cont_r, cat_r, device)
    ms = association_matrix(cont_s, cat_s, device)
    n = mr.shape[0]
    if n <= 1:
        return 1.0
    off = ~torch.eye(n, dtype=torch.bool, device=mr.device)
    return float(1.0 - (mr[off] - ms[off]).abs().mean())


# ---------------------------------------------------------------------------
# Joint degree × feature distribution (JS)
# ---------------------------------------------------------------------------

def _joint_hist(g: Graph, feat, deg_bins: int = 16, feat_bins: int = 16,
                feat_edges: Optional[np.ndarray] = None, side: str = "src",
                device="cuda") -> Tuple[torch.Tensor, np.ndarray]:
    """The normalized (degree-bin × feature-bin) histogram of the edges'
    ``side`` end, and its feature edges: the given ones, or the quantile
    edges of ``feat`` by numpy on the host (synthetic features outside
    the real side's edges are dropped, not clipped).  Rows beyond the
    shorter of ``feat`` and the edges are cut, as in the reference."""
    g = _on(g, device)
    if side == "src":
        deg, ids = out_degrees(g).to(torch.float64), g.src
    else:
        deg, ids = in_degrees(g).to(torch.float64), g.dst
    d_edge = deg[ids.long()] / max(float(deg.max()), 1)
    f = _to_device(feat, device, torch.float64).reshape(-1)[: len(d_edge)]
    d_edge = d_edge[: len(f)]
    de = np.logspace(-4, 0, deg_bins + 1)
    de[0] = 0.0
    if feat_edges is None:
        fh = f.cpu().numpy()
        feat_edges = np.quantile(fh, np.linspace(0, 1, feat_bins + 1))
        feat_edges = np.unique(feat_edges)
        if len(feat_edges) < 3:
            feat_edges = np.linspace(fh.min(), fh.max() + 1e-6,
                                     feat_bins + 1)
    di, fi = _bin_index(d_edge, de), _bin_index(f, feat_edges)
    ok = (di >= 0) & (fi >= 0)
    nf = len(feat_edges) - 1
    h = torch.bincount(di[ok] * nf + fi[ok], minlength=deg_bins * nf)
    h = h.reshape(deg_bins, nf).to(torch.float64)
    return h / max(float(h.sum()), 1), feat_edges


def js_divergence(p, q, device="cuda") -> float:
    p = _to_device(p, device, torch.float64).reshape(-1) + 1e-12
    q = _to_device(q, device, torch.float64).reshape(-1) + 1e-12
    p, q = p / p.sum(), q / q.sum()
    m = 0.5 * (p + q)

    def kl(a, b):
        return (a * torch.log(a / b)).sum()

    return float(0.5 * kl(p, m) + 0.5 * kl(q, m))


def degree_feature_distance(g_real: Graph, feat_real, g_syn: Graph,
                            feat_syn, device="cuda") -> float:
    """JS divergence of the joint (degree × first-feature) histograms,
    averaged over the src- and dst-degree views (paper "Degree-Feat
    Dist-Dist ↓").  Degree axes are normalized per graph so different
    scales remain comparable."""
    total = 0.0
    for side in ("src", "dst"):
        hr, fe = _joint_hist(g_real, feat_real, side=side, device=device)
        hs, _ = _joint_hist(g_syn, feat_syn, feat_edges=fe, side=side,
                            device=device)
        n = min(hr.shape[0], hs.shape[0])
        total += js_divergence(hr[:n], hs[:n], device)
    return total / 2.0


def evaluate_all(g_real: Graph, cont_r, cat_r, g_syn: Graph, cont_s, cat_s,
                 device="cuda") -> Dict[str, Optional[float]]:
    """All paper metrics for one (real, synthetic) pair, on ``device``.
    Structure-only pairs (zero continuous AND zero categorical columns on
    either side) have no feature terms: those keys are ``None``."""
    g_real, g_syn = _on(g_real, device), _on(g_syn, device)
    out: Dict[str, Optional[float]] = {
        "degree_dist": degree_dist_similarity(g_real, g_syn),
        "dcc": dcc(g_real, g_syn, device=device),
    }
    n_cols_r = cont_r.shape[1] + cat_r.shape[1]
    n_cols_s = cont_s.shape[1] + cat_s.shape[1]
    if n_cols_r == 0 or n_cols_s == 0:
        out["feature_corr"] = None
        out["degree_feat_dist"] = None
        return out
    # select by column presence, not size: a zero-row table with
    # continuous columns must not fall through to the cat branch
    feat_r = cont_r[:, 0] if cont_r.shape[1] else cat_r[:, 0]
    feat_s = cont_s[:, 0] if cont_s.shape[1] else cat_s[:, 0]
    out["feature_corr"] = feature_correlation_score(cont_r, cat_r, cont_s,
                                                    cat_s, device)
    out["degree_feat_dist"] = degree_feature_distance(
        g_real, feat_r, g_syn, feat_s, device)
    return out
