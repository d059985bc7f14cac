"""Deterministic chunk → shard → worker scheduling.

``ChunkScheduler`` partitions the ``rmat.chunk_plan`` output of a
``KroneckerFit`` into shards of at most ``shard_edges`` edges and assigns
shards to workers.  Everything is a pure function of
``(fit, seed, k_pref, shard_edges, num_workers)``:

* per-chunk PRNG keys are index-stable ``rmat.chunk_key`` fold-ins — a
  chunk's stream never depends on plan size or execution order;
* θ (incl. App. 9 noise) is derived exactly once from the job seed and
  recorded in the manifest, so a resumed job regenerates byte-identical
  shards;
* shard packing is first-fit over the plan's canonical chunk order and
  worker assignment is greedy least-loaded — both deterministic.

Memory bound: one shard (≤ ``shard_edges`` records per column) plus one
in-flight device chunk.  A single chunk larger than ``shard_edges`` (k_pref
capped by the fit's level count) becomes its own oversized shard — the
bound degrades to the largest chunk, never to the whole graph.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import random as trandom
from repro_torch.core import rmat
from repro_torch.core.structure import KroneckerFit

#: hard cap on prefix levels: 4^8 = 65536 chunks keeps planning cheap
MAX_K_PREF = 8


def auto_k_pref(fit: KroneckerFit, shard_edges: int,
                max_k: int = MAX_K_PREF) -> int:
    """Smallest k so the *expected* largest chunk fits in one shard.

    The largest chunk mass is max(a,b,c,d)^k · E; solve for k and clamp to
    the square level count (need ≥1 suffix level to sample within a chunk).
    """
    cap = max(0, min(max_k, min(fit.n, fit.m) - 1))
    pmax = max(fit.a, fit.b, fit.c, fit.d)
    k = 0
    while k < cap and fit.E * pmax ** k > shard_edges:
        k += 1
    return k


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """One unit of resumable work: a run of consecutive plan chunks."""
    shard_id: int
    chunk_indices: Tuple[int, ...]
    n_edges: int
    worker: int

    @property
    def stem(self) -> str:
        return f"shard-{self.shard_id:05d}"


class ChunkScheduler:
    def __init__(self, fit: KroneckerFit, shard_edges: int = 1 << 20,
                 k_pref: Optional[int] = None, num_workers: int = 1,
                 seed: int = 0, thetas: Optional[np.ndarray] = None):
        assert shard_edges > 0 and num_workers > 0
        self.fit = fit
        self.seed = int(seed)
        self.shard_edges = int(shard_edges)
        self.num_workers = int(num_workers)
        self.base_key = trandom.PRNGKey(self.seed)
        if thetas is None:
            thetas = rmat.derive_thetas(fit, key=self.base_key)
        self.thetas = np.asarray(thetas, np.float64)
        self.k_pref = (auto_k_pref(fit, shard_edges) if k_pref is None
                       else int(k_pref))
        assert 0 <= self.k_pref <= min(fit.n, fit.m), self.k_pref
        self.chunks = rmat.chunk_plan(fit, self.k_pref, self.thetas)
        self._by_index: Dict[int, rmat.Chunk] = {c.index: c
                                                 for c in self.chunks}
        self.shards = self._pack(self.chunks)

    # -- planning ----------------------------------------------------------
    def _pack(self, chunks: Sequence[rmat.Chunk]) -> List[ShardPlan]:
        """First-fit packing in canonical plan order, then greedy
        least-loaded worker assignment (ties → lowest worker id)."""
        groups: List[List[rmat.Chunk]] = []
        cur: List[rmat.Chunk] = []
        cur_edges = 0
        for ck in chunks:
            if cur and cur_edges + ck.n_edges > self.shard_edges:
                groups.append(cur)
                cur, cur_edges = [], 0
            cur.append(ck)
            cur_edges += ck.n_edges
        if cur:
            groups.append(cur)
        load = [0] * self.num_workers
        shards = []
        for sid, grp in enumerate(groups):
            n_e = sum(c.n_edges for c in grp)
            w = min(range(self.num_workers), key=lambda i: (load[i], i))
            load[w] += n_e
            shards.append(ShardPlan(sid, tuple(c.index for c in grp),
                                    n_e, w))
        return shards

    # -- lookups -----------------------------------------------------------
    def chunk(self, index: int) -> rmat.Chunk:
        return self._by_index[index]

    def key_for(self, chunk: rmat.Chunk):
        """Index-stable per-chunk PRNG key (see rmat.chunk_key)."""
        return rmat.chunk_key(self.base_key, chunk.index)

    def worker_queue(self, worker: int) -> List[ShardPlan]:
        return [s for s in self.shards if s.worker == worker]

    def pending(self, done_shard_ids) -> List[ShardPlan]:
        """Resumable progress: the shards still to generate."""
        done = set(done_shard_ids)
        return [s for s in self.shards if s.shard_id not in done]

    # -- provenance --------------------------------------------------------
    @property
    def theta_digest(self) -> str:
        import hashlib
        return hashlib.sha256(
            np.ascontiguousarray(self.thetas).tobytes()).hexdigest()[:16]

    @property
    def total_edges(self) -> int:
        return sum(s.n_edges for s in self.shards)

    @property
    def max_shard_edges(self) -> int:
        return max((s.n_edges for s in self.shards), default=0)
