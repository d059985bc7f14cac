"""The fitted generalized stochastic Kronecker model (paper §3.2).

θ is never materialized at generation time: an edge is sampled by
descending ``max(n, m)`` levels of the 2×2 seed ``θ_S = [[a,b],[c,d]]``
plus ``|n-m|`` marginal levels, one uniform per level.  This module holds
the fit (``KroneckerFit``) and its per-level noise (paper App. 9); the
fitting itself stays in the JAX package for now, and a fit crosses over
as plain numbers (``repro_torch.convert``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np


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
