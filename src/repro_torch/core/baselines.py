"""Structural-generator baselines (paper §4.1 and Table 6).

* ``ERGenerator`` — Erdős–Rényi ("random" in Table 2).
* ``SBMGenerator`` — degree-corrected stochastic block model with a fitting
  step, standing in for (improved) GraphWorld [30]: nodes are grouped into
  degree-quantile blocks, the block-pair edge mass is estimated from the
  input graph, and edges are sampled block-pair-first then
  degree-proportionally within blocks.

Every draw is the JAX package's ``np.random.Generator`` call, made in its
order, so a seed gives the reference's ids bit for bit.  The host keeps
what is numpy's own (the Generator's draws, node-sized quantiles, weights
and cdfs); the edge-sized work of ``rng.choice(p=...)`` (the bin search of
each uniform, the per-block masks and gathers) runs on the generator's
``device`` by :func:`choice_indices`, which gives numpy's indices exactly.
``sample`` returns a ``Graph`` of int32 ids on that device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.graph.ops import Graph, in_degrees, out_degrees


def choice_cdf(p) -> np.ndarray:
    """The cdf numpy's ``Generator.choice(..., p=p)`` searches: the float64
    cumulative sum of ``p`` divided by its last entry."""
    cdf = np.asarray(p, np.float64).cumsum()
    cdf /= cdf[-1]
    return cdf


def choice_indices(cdf: torch.Tensor, u: np.ndarray) -> torch.Tensor:
    """The indices ``rng.choice(len(cdf), len(u), p=p)`` returns when its
    uniforms were ``u = rng.random(len(u))`` (the draws ``choice`` makes)
    and ``cdf = choice_cdf(p)``, as a float64 tensor: each uniform's bin,
    found on the cdf's device (``searchsorted``, side right).  int64
    indices, numpy's exactly."""
    return torch.searchsorted(cdf, torch.from_numpy(u).to(cdf.device),
                              right=True)


def _ids(x: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.int32)).to(device)


class ERGenerator:
    """Uniform ids over the scaled node sets, ``E · scale_edges`` edges."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)

    def fit(self, g: Graph) -> "ERGenerator":
        self.n_src, self.n_dst = g.n_src, g.n_dst
        self.E = g.n_edges
        self.bipartite = g.bipartite
        return self

    def sample(self, rng: np.random.Generator, scale_nodes: int = 1,
               scale_edges: Optional[int] = None) -> Graph:
        se = scale_edges if scale_edges is not None else scale_nodes ** 2
        src = rng.integers(0, self.n_src * scale_nodes, self.E * se)
        dst = rng.integers(0, self.n_dst * scale_nodes, self.E * se)
        return Graph(_ids(src, self.device), _ids(dst, self.device),
                     self.n_src * scale_nodes, self.n_dst * scale_nodes,
                     self.bipartite)


@dataclasses.dataclass
class SBMFit:
    block_mass: np.ndarray      # (B, B) edge probability mass per block pair
    src_blocks: np.ndarray      # (n_src,) block id
    dst_blocks: np.ndarray
    src_deg_w: np.ndarray       # within-block degree weights
    dst_deg_w: np.ndarray


class SBMGenerator:
    """Degree-corrected SBM with degree-quantile blocks.

    ``degree_mode``:

    * ``"powerlaw"`` (default) — GraphWorld-faithful: within-block degree
      weights are *sampled* from a per-block fitted Pareto (GraphWorld's
      DC-SBM parameterizes the degree distribution; it never copies the
      observed per-node degree list).
    * ``"empirical"`` — per-node observed degrees as weights (an
      intentionally *stronger-than-GraphWorld* baseline, close to a
      block-constrained configuration model; reported separately).

    ``last_host_s`` holds the host seconds of the last ``sample`` (numpy's
    draws, the node-sized weights and cdfs); the rest of its wall is the
    device's, and its ids are ready once the device is synchronized."""

    def __init__(self, n_blocks: int = 8, degree_mode: str = "powerlaw",
                 seed: int = 0, device="cuda"):
        self.B = n_blocks
        self.degree_mode = degree_mode
        self._rng = np.random.default_rng(seed)
        self.device = torch.device(device)
        self.last_host_s = 0.0

    def fit(self, g: Graph) -> "SBMGenerator":
        """Degrees are counted on the graph's device and read as float64
        on the host, where the quantile blocks, the block mass
        (``np.add.at``) and the weights are the reference's numpy."""
        self.n_src, self.n_dst, self.E = g.n_src, g.n_dst, g.n_edges
        self.bipartite = g.bipartite
        od = out_degrees(g).cpu().numpy().astype(np.float64)
        idg = in_degrees(g).cpu().numpy().astype(np.float64)
        self.src_blocks = self._quantile_blocks(od)
        self.dst_blocks = self._quantile_blocks(idg)
        src_b = self.src_blocks[g.src.cpu().numpy()]
        dst_b = self.dst_blocks[g.dst.cpu().numpy()]
        mass = np.zeros((self.B, self.B))
        np.add.at(mass, (src_b, dst_b), 1.0)
        if self.degree_mode == "powerlaw":
            src_w = self._parametric_weights(od, self.src_blocks)
            dst_w = self._parametric_weights(idg, self.dst_blocks)
        else:
            src_w, dst_w = od + 0.1, idg + 0.1
        self.fitres = SBMFit(
            block_mass=mass / max(mass.sum(), 1),
            src_blocks=self.src_blocks, dst_blocks=self.dst_blocks,
            src_deg_w=src_w, dst_deg_w=dst_w)
        return self

    def _parametric_weights(self, deg, blocks):
        """Per block: fit a Pareto shape to mean degree, sample weights."""
        w = np.zeros_like(deg)
        for b in range(self.B):
            sel = blocks == b
            if not sel.any():
                continue
            mu = max(deg[sel].mean(), 0.1)
            # Pareto with mean mu (shape 2.0 fixed, scale = mu/2)
            w[sel] = self._rng.pareto(2.0, sel.sum()) * (mu / 2.0) + 0.05
        return w

    def _quantile_blocks(self, deg):
        qs = np.quantile(deg, np.linspace(0, 1, self.B + 1)[1:-1])
        return np.searchsorted(qs, deg).astype(np.int32)

    def _side(self, rng, blocks, weights, b, pair_side, count, out
              ) -> float:
        """Draw block ``b``'s ``count`` endpoints on one side among the
        block's nodes, with probability ∝ weight, into ``out`` where
        ``pair_side == b``.  Returns the host seconds spent."""
        t0 = time.perf_counter()
        nodes = np.where(blocks == b)[0]
        w = weights[nodes]
        w = w / w.sum()
        if not count:
            return time.perf_counter() - t0
        cdf = choice_cdf(w)
        u = rng.random(count)
        host = time.perf_counter() - t0
        dev = self.device
        idx = choice_indices(torch.from_numpy(cdf).to(dev), u)
        out[pair_side == b] = torch.from_numpy(nodes).to(dev)[idx]
        return host

    def sample(self, rng: np.random.Generator, scale_nodes: int = 1,
               scale_edges: Optional[int] = None) -> Graph:
        se = scale_edges if scale_edges is not None else scale_nodes ** 2
        E = self.E * se
        f = self.fitres
        dev = self.device
        t0 = time.perf_counter()
        # tile nodes for scaling; degree weights repeat
        src_blocks = np.tile(f.src_blocks, scale_nodes)
        dst_blocks = np.tile(f.dst_blocks, scale_nodes)
        src_w = np.tile(f.src_deg_w, scale_nodes)
        dst_w = np.tile(f.dst_deg_w, scale_nodes)
        pair_cdf = choice_cdf(f.block_mass.reshape(-1))
        u = rng.random(E)
        host = time.perf_counter() - t0
        pair_idx = choice_indices(torch.from_numpy(pair_cdf).to(dev), u)
        del u
        pair_src, pair_dst = pair_idx // self.B, pair_idx % self.B
        n_src_b = torch.bincount(pair_src, minlength=self.B).tolist()
        n_dst_b = torch.bincount(pair_dst, minlength=self.B).tolist()
        src_out = torch.empty(E, dtype=torch.int64, device=dev)
        dst_out = torch.empty(E, dtype=torch.int64, device=dev)
        for b in range(self.B):
            host += self._side(rng, src_blocks, src_w, b, pair_src,
                               n_src_b[b], src_out)
            host += self._side(rng, dst_blocks, dst_w, b, pair_dst,
                               n_dst_b[b], dst_out)
        self.last_host_s = host
        return Graph(src_out.to(torch.int32), dst_out.to(torch.int32),
                     self.n_src * scale_nodes, self.n_dst * scale_nodes,
                     self.bipartite)
