"""Graph substrate: COO edge lists and the structural node features the
aligner reads (degrees, PageRank, Katz).

A graph is ``(src, dst, n_src, n_dst)`` with id tensors on one device;
homogeneous graphs use ``n_src == n_dst``.  ``segment_sum`` of the JAX
package becomes ``index_add_`` on the CPU.  On CUDA ``index_add_`` adds
with atomics in no fixed order, so two calls on one graph differed in the
last bits, and those bits reach the aligner's rank matching; there the
edges are sorted by destination once per graph (a stable sort) and each
node's run is summed by ``segment_reduce``.  That sum is the same from
run to run, but it associates in its own order, so the card agrees with
the CPU's ``index_add_`` to a float tolerance, not bit for bit.  PageRank
and Katz agree with the reference to a float tolerance too (XLA sums in
its own order).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class Graph:
    src: torch.Tensor         # (E,) int32 or int64
    dst: torch.Tensor         # (E,)
    n_src: int
    n_dst: int
    bipartite: bool = False   # True: src/dst are distinct partites

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def n_nodes(self) -> int:
        return self.n_src + self.n_dst if self.bipartite else self.n_src


#: dense-degree guard: degrees materialize one counter per node; beyond
#: this many nodes the dense path raises instead of exhausting memory
MAX_DENSE_DEGREE_NODES = 1 << 27


def _check_dense_degrees(n: int, what: str) -> None:
    if n > MAX_DENSE_DEGREE_NODES:
        raise ValueError(
            f"{what}: dense degree array over {n:,} nodes exceeds the "
            f"{MAX_DENSE_DEGREE_NODES:,}-node guard — graphs this large "
            "need a streaming degree sketch")


def out_degrees(g: Graph) -> torch.Tensor:
    _check_dense_degrees(g.n_src, "out_degrees")
    return torch.bincount(g.src, minlength=g.n_src)


def in_degrees(g: Graph) -> torch.Tensor:
    _check_dense_degrees(g.n_dst, "in_degrees")
    return torch.bincount(g.dst, minlength=g.n_dst)


def degree_histogram(degrees: torch.Tensor, max_deg: Optional[int] = None
                     ) -> torch.Tensor:
    """c_k = #nodes with degree k (k = 0..max_deg); degrees above
    ``max_deg`` count in the last bin."""
    if max_deg is None:
        max_deg = int(degrees.max()) if degrees.numel() else 0
    _check_dense_degrees(max_deg + 1, "degree_histogram")
    return torch.bincount(torch.clamp(degrees, 0, max_deg),
                          minlength=max_deg + 1)


def sparse_degree_histogram(ids, n_nodes: int, kmax: int
                            ) -> Tuple[np.ndarray, int]:
    """``(histogram, max_degree)`` of the degree sequence behind ``ids``
    without a dense per-node array: unique-count on the ids' device is
    O(E log E) in the edge count and independent of ``n_nodes``, so it
    works at id spaces where ``in_degrees``/``out_degrees`` would refuse.
    Degrees above ``kmax`` are clipped into the last bin (the
    ``degree_histogram`` convention); zero-degree nodes land in bin 0.
    The histogram is an int64 numpy array of ``kmax + 1`` bins."""
    ids = ids if isinstance(ids, torch.Tensor) else torch.tensor(ids)
    _, cnt = torch.unique(ids, return_counts=True)
    hist = torch.bincount(torch.clamp(cnt, max=kmax), minlength=kmax + 1)
    hist = hist.cpu().numpy().astype(np.int64)
    hist[0] += int(n_nodes) - len(cnt)
    return hist, int(cnt.max()) if len(cnt) else 0


def compact_subgraph(src, dst, bipartite: bool, device=None) -> Graph:
    """Remap a sample's global ids onto a dense local id space (≤ 2E
    nodes) so per-node structural features stay sample-sized.  ``src``/
    ``dst`` are tensors (or numpy arrays) of ids; the graph lives on
    ``device`` (default: the ids' own).  Local ids are int32, the sorted
    rank of each global id, as numpy's ``unique``/``searchsorted`` give
    them."""
    src = torch.as_tensor(src, device=device)
    dst = torch.as_tensor(dst, device=device)
    if bipartite:
        su, si = torch.unique(src, sorted=True, return_inverse=True)
        du, di = torch.unique(dst, sorted=True, return_inverse=True)
        return Graph(si.to(torch.int32), di.to(torch.int32), len(su),
                     len(du), bipartite=True)
    ids = torch.unique(torch.cat([src, dst]), sorted=True)
    si = torch.searchsorted(ids, src).to(torch.int32)
    di = torch.searchsorted(ids, dst).to(torch.int32)
    return Graph(si, di, len(ids), len(ids), bipartite=False)


class _EdgeSum:
    """``x ↦ Σ_{e: dst[e] = v} x[src[e]]`` for every node ``v < n``, the
    per-iteration sum of PageRank and Katz.  The CPU takes ``index_add_``
    in edge order; CUDA sorts the edges by ``dst`` once (stable) and sums
    each node's run with ``segment_reduce``, so repeated calls are
    bit-equal (and equal the CPU's sums to a float tolerance)."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, n: int):
        self.n = n
        if dst.device.type == "cuda":
            order = torch.sort(dst, stable=True).indices
            self.src = src[order]
            self.lengths = torch.bincount(dst, minlength=n)
            self.dst = None
        else:
            self.src, self.dst, self.lengths = src, dst, None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.lengths is not None:
            return torch.segment_reduce(x[self.src], "sum",
                                        lengths=self.lengths, unsafe=True)
        return torch.zeros(self.n, dtype=x.dtype,
                           device=x.device).index_add_(0, self.dst,
                                                       x[self.src])


def pagerank(g: Graph, n_iter: int = 20, damping: float = 0.85
             ) -> torch.Tensor:
    """PageRank over the (possibly bipartite, treated as directed) graph.
    Returns (n_src + n_dst) scores for bipartite, (n) otherwise."""
    if g.bipartite:
        n = g.n_src + g.n_dst
        dst_b = g.dst + g.n_src
        # reverse edges too so both partites receive mass
        src = torch.cat([g.src, dst_b])
        dst = torch.cat([dst_b, g.src])
    else:
        n, src, dst = g.n_src, g.src, g.dst
    deg = torch.bincount(src, minlength=n).to(torch.float32)
    inv = torch.where(deg > 0, 1.0 / torch.clamp_min(deg, 1), 0.0)
    r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=src.device)
    edge_sum = _EdgeSum(src, dst, n)
    for _ in range(n_iter):
        contrib = r * inv
        r_new = edge_sum(contrib)
        dangling = torch.sum(torch.where(deg == 0, r, 0.0))
        r = (1 - damping) / n + damping * (r_new + dangling / n)
    return r


def katz_centrality(g: Graph, alpha: float = 0.05, n_iter: int = 15
                    ) -> torch.Tensor:
    """``x ← 1 + α·Aᵀx`` for ``n_iter`` rounds from ``x = 1``.  Kept as
    the reference computes it: on graphs with large hubs the float32
    iterate overflows to inf (``node_features`` then holds inf there)."""
    if g.bipartite:
        n = g.n_src + g.n_dst
        src = torch.cat([g.src, g.dst + g.n_src])
        dst = torch.cat([g.dst + g.n_src, g.src])
    else:
        n, src, dst = g.n_src, g.src, g.dst
    x = torch.ones(n, dtype=torch.float32, device=src.device)
    edge_sum = _EdgeSum(src, dst, n)
    for _ in range(n_iter):
        x = 1.0 + alpha * edge_sum(x)
    return x


def node_features(g: Graph, n_pr_iter: int = 20) -> torch.Tensor:
    """Structural features per node: [out_deg, in_deg, pagerank·n,
    log1p(katz)].  Bipartite graphs return (n_src + n_dst, 4) with degree
    in the matching role and zero in the other."""
    pr = pagerank(g, n_pr_iter)
    kz = katz_centrality(g)
    dev = g.src.device
    if g.bipartite:
        od = torch.cat([out_degrees(g),
                        torch.zeros(g.n_dst, dtype=torch.int64, device=dev)])
        idg = torch.cat([torch.zeros(g.n_src, dtype=torch.int64, device=dev),
                         in_degrees(g)])
    else:
        od, idg = out_degrees(g), in_degrees(g)
    return torch.stack([od.to(torch.float32), idg.to(torch.float32),
                        pr * pr.shape[0], torch.log1p(kz)], dim=1)
