"""The generalized stochastic Kronecker model (paper §3.2): its fit and
its per-level noise.

θ is never materialized at generation time: an edge is sampled by
descending ``max(n, m)`` levels of the 2×2 seed ``θ_S = [[a,b],[c,d]]``
plus ``|n-m|`` marginal levels, one uniform per level.

Fitting (paper §3.2.3), as the JAX package fits:

1. ``estimate_ratios_mle`` — the per-level bit-pair frequencies, the
   exact MLE of the quadrant distribution (``fit_engine.BitPairMLE``,
   integer counts on the graph's device);
2. ``fit_marginals`` — Eq. 6: minimize the degree-histogram error over
   ``p = a+b``, ``q = a+c`` with the closed-form expected histograms (Eq.
   7–8), scipy's Nelder-Mead on the host;
3. ``combine`` — ``(p, q, a/b)`` → ``(a, b, c, d)`` on the simplex;
4. ``fit_structure`` — draws one calibration sample per candidate θ
   (``candidate_fits``) on the ``reference`` stream and keeps the one
   whose degree distribution is closest to the input's.

The degree counts are exact integers and everything after them runs in
numpy/scipy, so a fit gives the reference's ``KroneckerFit`` exactly, on
the CPU and on the card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.fit_engine import BitPairMLE
from repro_torch.graph.ops import Graph, degree_histogram, in_degrees, \
    out_degrees


@dataclasses.dataclass
class KroneckerFit:
    a: float
    b: float
    c: float
    d: float
    n: int                  # src levels: 2^n rows
    m: int                  # dst levels: 2^m cols
    E: int                  # edges to sample at scale 1
    noise: float = 0.0      # max n_f amplitude (0 = no noise)
    bipartite: bool = False

    @property
    def p(self) -> float:
        return self.a + self.b

    @property
    def q(self) -> float:
        return self.a + self.c

    @property
    def theta(self) -> np.ndarray:
        return np.array([[self.a, self.b], [self.c, self.d]])

    def scaled(self, node_factor: int = 1, density_preserving: bool = True
               ) -> "KroneckerFit":
        """Scale: nodes ×2^k per partite; edges follow Eq. 22 (constant
        density: E ×4^k) or linear (×2^k)."""
        k = int(round(math.log2(node_factor)))
        E = self.E * (4 ** k if density_preserving else 2 ** k)
        return dataclasses.replace(self, n=self.n + k, m=self.m + k, E=E)


# ---------------------------------------------------------------------------
# Fitting
# ---------------------------------------------------------------------------

def estimate_ratios_mle(src, dst, n: int, m: int) -> np.ndarray:
    """Empirical bit-pair frequencies == MLE of (a, b, c, d) per level,
    averaged over the min(n, m) square levels; [a, b, c, d] is the order
    (0,0), (0,1), (1,0), (1,1)."""
    return BitPairMLE(n, m).update(src, dst).ratios()


def expected_degree_hist(p: float, levels: int, E: int, kmax: int,
                         ks: Optional[np.ndarray] = None) -> np.ndarray:
    """Eq. 7/8: E[#nodes with degree k] for k in ``ks`` under marginal prob
    ``p`` and ``levels`` bits.  Log-space binomials; Poisson-safe for huge E.
    """
    from scipy.special import gammaln
    if ks is None:
        ks = np.arange(kmax + 1)
    ks = ks.astype(np.float64)
    i = np.arange(levels + 1, dtype=np.float64)
    # π_i = p^(levels-i) (1-p)^i ; #nodes with i ones = C(levels, i)
    with np.errstate(divide="ignore"):
        log_pi = (levels - i) * np.log(max(p, 1e-12)) + i * np.log(
            max(1 - p, 1e-12))
    log_cmi = (gammaln(levels + 1) - gammaln(i + 1) - gammaln(levels - i + 1))
    # Binom(E, π_i) pmf at k (log space)
    K, I = np.meshgrid(ks, i, indexing="ij")
    LPI = np.broadcast_to(log_pi, I.shape)
    log_pmf = (gammaln(E + 1) - gammaln(K + 1) - gammaln(E - K + 1)
               + K * LPI + (E - K) * np.log1p(-np.minimum(np.exp(LPI),
                                                          1 - 1e-15)))
    return np.exp(log_pmf + log_cmi[None, :]).sum(axis=1)


def _hist_error(pred: np.ndarray, obs: np.ndarray) -> float:
    """Eq. 6 as the normalized log-binned total-variation distance that
    ``metrics.degree_dist_similarity`` reports: counts at degree k sit at
    k/k_max, binned log-spaced."""
    ks = np.arange(1, len(obs), dtype=np.float64)
    kmax = max(np.nonzero(obs)[0].max() if obs[1:].any() else 1, 1)
    edges = np.logspace(-6, 0, 25)

    def binned(c):
        x = ks / kmax
        w = c[1:]
        h, _ = np.histogram(np.clip(x, 1e-6, 1.0), bins=edges, weights=w)
        return h / max(h.sum(), 1e-9)

    return float(0.5 * np.abs(binned(pred) - binned(obs)).sum())


def fit_marginals(g: Graph, n: int, m: int, kmax: int = 2048,
                  anchor: Optional[Tuple[float, float]] = None,
                  trust: float = 0.06) -> Tuple[float, float]:
    """Minimize Eq. 6 over (p, q): the observed out/in degree histograms
    of ``g`` (counted on its device) through :func:`fit_marginals_hist`."""
    obs_out = degree_histogram(out_degrees(g), kmax).cpu().numpy() \
        .astype(np.float64)
    obs_in = degree_histogram(in_degrees(g), kmax).cpu().numpy() \
        .astype(np.float64)
    return fit_marginals_hist(obs_out, obs_in, g.n_edges, n, m, kmax=kmax,
                              anchor=anchor, trust=trust)


def fit_marginals_hist(obs_out: np.ndarray, obs_in: np.ndarray, E: int,
                       n: int, m: int, kmax: int = 2048,
                       anchor: Optional[Tuple[float, float]] = None,
                       trust: float = 0.06) -> Tuple[float, float]:
    """Eq. 6 marginal fit from observed ``(kmax+1,)`` out/in degree
    histograms: a 7×7 grid, then Nelder-Mead, inside ±``trust`` of
    ``anchor`` (the bit-pair MLE marginals) when given; the anchor wins
    if the optimum scores worse."""
    # scipy is imported on use, so processes that only sample (the
    # cluster's workers) do not pay for it at start
    from scipy.optimize import minimize
    ks = np.arange(kmax + 1)
    obs_out = np.asarray(obs_out, np.float64)
    obs_in = np.asarray(obs_in, np.float64)

    if anchor is not None:
        lo = (max(0.05, anchor[0] - trust), max(0.05, anchor[1] - trust))
        hi = (min(0.95, anchor[0] + trust), min(0.95, anchor[1] + trust))
    else:
        lo, hi = (0.5, 0.5), (0.95, 0.95)

    def J(x):
        p, q = x
        if not (lo[0] <= p <= hi[0] and lo[1] <= q <= hi[1]):
            return 1e9
        pred_out = expected_degree_hist(p, n, E, kmax, ks)
        pred_in = expected_degree_hist(q, m, E, kmax, ks)
        return _hist_error(pred_out, obs_out) + _hist_error(pred_in, obs_in)

    grid_p = np.linspace(lo[0], hi[0], 7)
    grid_q = np.linspace(lo[1], hi[1], 7)
    best = min(((J((p, q)), p, q) for p in grid_p for q in grid_q))
    res = minimize(J, x0=[best[1], best[2]], method="Nelder-Mead",
                   options={"xatol": 1e-4, "fatol": 1e-8, "maxiter": 200})
    p, q = res.x
    if anchor is not None and J((p, q)) > J(anchor):
        p, q = anchor
    return float(np.clip(p, 0.05, 0.95)), float(np.clip(q, 0.05, 0.95))


def combine(p: float, q: float, ratio_ab: float
            ) -> Tuple[float, float, float, float]:
    """(p, q, a/b) -> simplex-projected (a, b, c, d)."""
    a = p * ratio_ab / (1.0 + ratio_ab)
    a = min(a, q - 1e-4)
    b = p - a
    c = q - a
    d = 1.0 - a - b - c
    if d < 1e-4:
        # rescale (a,b,c) to leave room for d
        s = (1.0 - 1e-4) / (a + b + c)
        a, b, c = a * s, b * s, c * s
        d = 1.0 - a - b - c
    return float(a), float(b), float(c), float(d)


def candidate_fits(n: int, m: int, E: int, bipartite: bool, noise: float,
                   ratios: np.ndarray, marginals_fn,
                   calibrate: bool = True
                   ) -> "list[Tuple[str, KroneckerFit]]":
    """The named candidate θs, in a fixed order: the Eq. 6-refined point,
    then (with ``calibrate``) the MLE anchor if it differs, the
    independence-factorized Eq. 6 point and a skew ladder.
    ``marginals_fn(anchor_or_None) -> (p, q)`` is the Eq. 6 refinement."""
    ratio_ab = ratios[0] / max(ratios[1], 1e-6)
    anchor = (float(ratios[0] + ratios[1]), float(ratios[0] + ratios[2]))
    p_ref, q_ref = marginals_fn(anchor)

    def mk(p, q):
        a, b, c, d = combine(p, q, ratio_ab)
        nz = min(noise, (a + d) / 2, b, c) if noise > 0 else 0.0
        return KroneckerFit(a=a, b=b, c=c, d=d, n=n, m=m, E=E,
                            noise=nz, bipartite=bipartite)

    cand = [("eq6_refined", mk(p_ref, q_ref))]
    if calibrate:
        mle = mk(anchor[0], anchor[1])
        if abs(mle.p - p_ref) + abs(mle.q - q_ref) > 1e-3:
            cand.append(("mle_anchor", mle))
        # a=pq, b=p(1-q), c=(1-p)q, d=(1-p)(1-q) with free-range Eq. 6
        # marginals: reaches skews the MLE a/b ratio forbids
        p_f, q_f = marginals_fn(None)

        def mk_indep(p, q):
            a, b, c, d = p * q, p * (1 - q), (1 - p) * q, (1 - p) * (1 - q)
            nz = (min(noise, (a + d) / 2, max(b, 1e-4), max(c, 1e-4))
                  if noise > 0 else 0.0)
            return KroneckerFit(a=a, b=b, c=c, d=d, n=n, m=m, E=E,
                                noise=nz, bipartite=bipartite)

        cand.append(("indep_eq6", mk_indep(p_f, q_f)))
        # skew ladder: increasing tail mass
        for p, q in ((0.84, 0.82), (0.89, 0.87), (0.93, 0.92)):
            cand.append((f"indep_skew_{p:.2f}", mk_indep(p, q)))
    return cand


def fit_structure(g: Graph, noise: float = 0.0,
                  calibrate: bool = True) -> KroneckerFit:
    """The paper's fit of ``g``: MLE ratios, Eq. 6 marginals, and (with
    ``calibrate``) one calibration sample of ``min(E, 200 000)`` edges per
    candidate, drawn with ``PRNGKey(1234 + i)`` on the ``reference``
    stream on ``g``'s device; the candidate whose sample's degree
    distribution is most similar to ``g``'s wins (first on ties)."""
    n = max(1, math.ceil(math.log2(max(g.n_src, 2))))
    m = max(1, math.ceil(math.log2(max(g.n_dst, 2))))
    ratios = estimate_ratios_mle(g.src, g.dst, n, m)
    cand = candidate_fits(
        n, m, g.n_edges, g.bipartite, noise, ratios,
        lambda anchor: fit_marginals(g, n, m, anchor=anchor),
        calibrate=calibrate)
    if len(cand) == 1:
        return cand[0][1]

    from repro_torch import random as trandom
    from repro_torch.core import rmat as rmat_mod
    from repro_torch.core.metrics import degree_dist_similarity
    best, best_score = None, -1.0
    for i, (_, fit) in enumerate(cand):
        e_cal = min(fit.E, 200_000)
        src, dst = rmat_mod.sample_graph(trandom.PRNGKey(1234 + i), fit,
                                         n_edges=e_cal, device=g.src.device)
        score = degree_dist_similarity(
            g, Graph(src, dst, 2 ** n, 2 ** m, g.bipartite))
        if score > best_score:
            best, best_score = fit, score
    return best


# ---------------------------------------------------------------------------
# Per-level θ with noise (App. 9)
# ---------------------------------------------------------------------------

def noisy_thetas(fit: KroneckerFit, rng: np.random.Generator) -> np.ndarray:
    """(levels, 4) per-level (a,b,c,d) with the zero-sum noise
    ``N_i = [[-2 n_f a/(a+d), n_f], [n_f, -2 n_f d/(a+d)]]``,
    ``n_f ~ U[0, noise)``, one draw per level from ``rng``."""
    L = max(fit.n, fit.m)
    base = np.array([fit.a, fit.b, fit.c, fit.d])
    out = np.tile(base, (L, 1))
    if fit.noise > 0:
        ad = fit.a + fit.d
        for i in range(L):
            nf = rng.uniform(0, fit.noise)
            ni = np.array([-2 * nf * fit.a / ad, nf, nf, -2 * nf * fit.d / ad])
            th = np.clip(base + ni, 1e-6, 1 - 1e-6)
            out[i] = th / th.sum()
    return out
