"""Graph substrate: COO edge lists, the structural node features the
aligner reads (degrees, PageRank, Katz), and the statistics the paper
scores generated graphs by (hop plot, Table 10; below).

A graph is ``(src, dst, n_src, n_dst)`` with id tensors on one device;
homogeneous graphs use ``n_src == n_dst``.  ``segment_sum`` of the JAX
package becomes ``index_add_`` on the CPU.  On CUDA ``index_add_`` adds
with atomics in no fixed order, so two calls on one graph differed in the
last bits, and those bits reach the aligner's rank matching; there the
edges are sorted by destination once per graph (a stable sort) and each
node's run is summed by ``segment_reduce``.  That sum is the same from
run to run, but it associates in its own order.  So float32 values are
summed in float64 and rounded once to float32 (PageRank's dangling mass
too, and ``log1p`` of Katz is taken in float64): the card's node features
then equal the CPU's, short of a float64 sum that lands within float64
rounding of a float32 tie.  That matters because the aligner's rank
matching turns one moved GBDT prediction into many moved rows.  PageRank
and Katz agree with the reference to a float tolerance (XLA sums float32
in its own order).
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


def dedup_edges(src, dst, n_dst: int):
    """Remove duplicate (src, dst) pairs on the host (numpy); the pairs
    come back sorted by ``src * n_dst + dst``."""
    key = np.asarray(src, np.int64) * n_dst + np.asarray(dst, np.int64)
    _, idx = np.unique(key, return_index=True)
    return np.asarray(src)[idx], np.asarray(dst)[idx]


class _EdgeSum:
    """``x ↦ Σ_{e: dst[e] = v} x[src[e]]`` for every node ``v < n``, the
    per-iteration sum of PageRank and Katz.  The CPU takes ``index_add_``
    in edge order; CUDA sorts the edges by ``dst`` once (stable) and sums
    each node's run with ``segment_reduce``, so repeated calls are
    bit-equal.  float32 values are summed in float64 and rounded once, so
    the two devices' sums round to the same float32."""

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
        acc = torch.float64 if x.dtype == torch.float32 else x.dtype
        xs = x[self.src].to(acc)
        if self.lengths is not None:
            out = torch.segment_reduce(xs, "sum", lengths=self.lengths,
                                       unsafe=True)
        else:
            out = torch.zeros(self.n, dtype=acc,
                              device=x.device).index_add_(0, self.dst, xs)
        return out.to(x.dtype)


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
        # the dangling mass over n in float64, rounded once (CUDA divides
        # by a host scalar as a product with its reciprocal)
        dangling = (torch.sum(torch.where(deg == 0, r, 0.0),
                              dtype=torch.float64) / n).to(torch.float32)
        r = (1 - damping) / n + damping * (r_new + dangling)
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
                        pr * pr.shape[0],
                        torch.log1p(kz.to(torch.float64)).to(torch.float32)],
                       dim=1)


# ---------------------------------------------------------------------------
# Hop plot (effective diameter) and the exact structural statistics of the
# paper's Table 10.  The reference computes them in numpy with Python loops
# over nodes and edges; here they are torch ops on the graph's device, so
# they run on generated graphs of 10^8 edges.  Integer results (reach
# counts, triangles, wedges, component sizes) are exact; float results
# differ from the reference's only in the order of float64 sums.
# ---------------------------------------------------------------------------

#: list positions expanded per batch in ``triangle_count`` and
#: ``hop_plot``: bounds their temporaries to a few GiB
EXPAND_BATCH = 1 << 27


def _row_batches(lens: torch.Tensor, budget: Optional[int] = None):
    """Consecutive row ranges ``[r0, r1)`` whose ``lens`` sum to at most
    ``budget`` (default ``EXPAND_BATCH``) plus the first row's length."""
    budget = EXPAND_BATCH if budget is None else budget
    rows = lens.numel()
    cum = torch.cumsum(lens, 0)
    total = int(cum[-1]) if rows else 0
    if total <= budget:
        return [(0, rows)] if total else []
    cuts = torch.searchsorted(cum, torch.arange(budget, total, budget,
                                                device=lens.device),
                              right=True).tolist()
    bounds = sorted({0, rows, *cuts})
    return list(zip(bounds[:-1], bounds[1:]))


def _expand(starts: torch.Tensor, nodes: torch.Tensor, lens: torch.Tensor):
    """``(row, pos)``: for each ``nodes[row]`` every position of its list
    ``starts[v] .. starts[v] + lens[row] - 1``, row by row, as int64."""
    total = int(lens.sum())
    dev = nodes.device
    row = torch.repeat_interleave(
        torch.arange(nodes.numel(), device=dev), lens, output_size=total)
    base = starts[nodes] - (torch.cumsum(lens, 0) - lens)
    return row, base[row] + torch.arange(total, device=dev)


def hop_plot(g: Graph, n_sources: int = 32, max_hops: int = 16,
             seed: int = 0) -> np.ndarray:
    """d(h): mean fraction of node pairs reachable within h hops, over
    ``min(n_sources, n)`` BFS sources that numpy's ``default_rng(seed)``
    picks on the host, as the reference picks them.  The BFS runs on the
    graph's device over the undirected adjacency (every edge both ways,
    duplicates and self-loops kept), sorted once into a CSR.  The reach
    counts are integers, so the curve is the reference's exactly."""
    n = g.n_nodes
    dev = g.src.device
    src = g.src.to(torch.int64)
    dst = g.dst.to(torch.int64) + (g.n_src if g.bipartite else 0)
    heads = torch.cat([src, dst])
    tails = torch.cat([dst, src])[torch.argsort(heads)]
    deg = torch.bincount(heads, minlength=n)
    starts = torch.cumsum(deg, 0) - deg
    del src, dst, heads
    rng = np.random.default_rng(seed)
    sources = rng.choice(n, size=min(n_sources, n), replace=False)
    reach = np.zeros(max_hops + 1, np.int64)
    for s in sources:
        seen = torch.zeros(n, dtype=torch.bool, device=dev)
        seen[int(s)] = True
        frontier = torch.tensor([int(s)], dtype=torch.int64, device=dev)
        reach[0] += 1
        for h in range(1, max_hops + 1):
            grown = seen.clone()
            lens = deg[frontier]
            for r0, r1 in _row_batches(lens):
                _, pos = _expand(starts, frontier[r0:r1], lens[r0:r1])
                grown[tails[pos]] = True
            frontier = torch.nonzero(grown & ~seen).squeeze(1)
            seen = grown
            if frontier.numel() == 0:     # nothing new: reach stays put
                reach[h:] += int(seen.sum())
                break
            reach[h] += int(seen.sum())
    return reach / (len(sources) * n)


def effective_diameter(hp: np.ndarray, frac: float = 0.9) -> float:
    """Interpolated hop count reaching `frac` of the final reachable mass."""
    total = hp[-1]
    if total <= 0:
        return float("inf")
    target = frac * total
    for h in range(len(hp)):
        if hp[h] >= target:
            if h == 0:
                return 0.0
            lo, hi = hp[h - 1], hp[h]
            return h - 1 + (target - lo) / max(hi - lo, 1e-12)
    return float(len(hp))


def _to_undirected(g: Graph) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """``(lo, hi, n)``: the undirected simple graph of ``g`` on its
    device, each pair once as ``lo < hi`` in ascending ``(lo, hi)`` order
    (bipartite dst ids offset by ``n_src``), self-loops dropped after the
    deduplication, as the reference drops them.  Pairs are int64 keys
    ``lo * n + hi``, which wide ids would overflow in int32."""
    n = g.n_nodes
    if n * n > 1 << 63:
        raise ValueError(f"{n:,} nodes: pair keys lo * n + hi overflow int64")
    src = g.src.to(torch.int64)
    dst = g.dst.to(torch.int64) + (g.n_src if g.bipartite else 0)
    key = torch.unique(torch.minimum(src, dst) * n + torch.maximum(src, dst))
    del src, dst
    lo, hi = key // n, key % n
    keep = lo != hi
    return lo[keep], hi[keep], n


def _undirected_degrees(lo: torch.Tensor, hi: torch.Tensor, n: int
                        ) -> torch.Tensor:
    return torch.bincount(torch.cat([lo, hi]), minlength=n)


def triangle_stats(g: Graph) -> Tuple[int, int]:
    """``(triangles, candidates)``: the exact triangle count of ``g``'s
    undirected simple graph and the number of (edge, neighbour) pairs
    checked for it.  Each edge is oriented from its end of lower (degree,
    id); any acyclic orientation counts every triangle once, at the edge
    between its two lowest nodes, as the reference's does.  For each
    oriented edge the shorter of its two out-lists is searched in the
    longer (``searchsorted`` over the sorted int64 keys ``a * n + b``),
    so the work is Σ over edges of min(d⁺(u), d⁺(v)), in batches of at
    most ``EXPAND_BATCH`` pairs."""
    lo, hi, n = _to_undirected(g)
    if lo.numel() == 0:
        return 0, 0
    deg = _undirected_degrees(lo, hi, n)
    fwd = deg[lo] <= deg[hi]              # ties: lo < hi, the lower id
    del deg
    keys = torch.sort(torch.where(fwd, lo, hi) * n
                      + torch.where(fwd, hi, lo)).values
    del lo, hi, fwd
    a, b = keys // n, keys % n
    dplus = torch.bincount(a, minlength=n)
    starts = torch.cumsum(dplus, 0) - dplus
    shorter = dplus[a] <= dplus[b]
    s = torch.where(shorter, a, b)        # the list walked
    t = torch.where(shorter, b, a)        # the list searched
    del a, shorter
    lens = dplus[s]
    t_key = t * n                         # the searched list's key prefix
    del t
    count = 0
    for r0, r1 in _row_batches(lens):
        row, pos = _expand(starts, s[r0:r1], lens[r0:r1])
        q = t_key[r0:r1][row] + b[pos]
        del row, pos
        i = torch.searchsorted(keys, q).clamp_(max=keys.numel() - 1)
        count += int((keys[i] == q).sum())
    return count, int(lens.sum())


def triangle_count(g: Graph) -> int:
    """Exact number of triangles of ``g``'s undirected simple graph."""
    return triangle_stats(g)[0]


def wedge_count(g: Graph) -> int:
    """Σ_v C(d_v, 2) over the deduplicated undirected degrees."""
    deg = _undirected_degrees(*_to_undirected(g))
    return int((deg * (deg - 1) // 2).sum())


def global_clustering(g: Graph) -> float:
    w = wedge_count(g)
    return 3.0 * triangle_count(g) / w if w else 0.0


def degree_assortativity(g: Graph) -> float:
    """Pearson correlation of the deduplicated undirected degrees at the
    two ends of every edge (each edge both ways); 0.0 when they do not
    vary."""
    lo, hi, n = _to_undirected(g)
    deg = _undirected_degrees(lo, hi, n).to(torch.float64)
    x = torch.cat([deg[lo], deg[hi]])
    y = torch.cat([deg[hi], deg[lo]])
    if float(x.std(correction=0)) < 1e-12:
        return 0.0
    # np.corrcoef(x, y)[0, 1], clipped to [-1, 1]
    xc, yc = x - x.mean(), y - y.mean()
    r = (xc * yc).sum() / torch.sqrt((xc * xc).sum()) \
        / torch.sqrt((yc * yc).sum())
    return float(r.clamp(-1.0, 1.0))


def gini_coefficient(degrees) -> float:
    """Gini coefficient of a degree sequence (a tensor, computed on its
    device, or an array)."""
    d = torch.sort(torch.as_tensor(degrees).to(torch.float64)).values
    n = d.numel()
    if n == 0 or float(d.sum()) == 0:
        return 0.0
    cum = torch.cumsum(d, 0)
    return float((n + 1 - 2 * float((cum / cum[-1]).sum())) / n)


def powerlaw_exponent(degrees, dmin: int = 1) -> float:
    """MLE alpha for P(d) ∝ d^-alpha over d >= dmin (Clauset et al.)."""
    d = torch.as_tensor(degrees).to(torch.float64)
    d = d[d >= dmin]
    if d.numel() == 0:
        return float("nan")
    return float(1.0 + d.numel() / float(torch.log(d / (dmin - 0.5)).sum()))


def rel_edge_distribution_entropy(g: Graph) -> float:
    """Entropy of the degree distribution relative to uniform (Table 10):
    out-degrees, and for a bipartite graph the in-degrees beside them."""
    deg = out_degrees(g).to(torch.float64)
    if g.bipartite:
        deg = torch.cat([deg, in_degrees(g).to(torch.float64)])
    p = deg / max(float(deg.sum()), 1)
    p = p[p > 0]
    n = p.numel()
    if n <= 1:
        return 1.0
    return float(-(p * torch.log(p)).sum() / np.log(n))


def largest_connected_component(g: Graph) -> int:
    """Size of the largest connected component over ``g.n_nodes`` nodes
    (an isolated node is a component of one): min-label propagation over
    the undirected edges with pointer jumping, until no label moves."""
    lo, hi, n = _to_undirected(g)
    if n == 0:
        return 0
    label = torch.arange(n, device=lo.device)
    while True:
        low = torch.minimum(label[lo], label[hi])
        new = label.scatter_reduce(0, lo, low, "amin")
        new.scatter_reduce_(0, hi, low, "amin")
        while True:                       # pointer jumping
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, label):
            break
        label = new
    return int(torch.bincount(label, minlength=n).max())
