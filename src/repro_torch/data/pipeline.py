"""Training data pipeline: the port of the JAX package's
``data/pipeline.py``.

Two token sources, numpy on one ``default_rng(seed)`` each, so their
batches equal the reference's bit for bit:

* ``SyntheticTokens``: Zipf-distributed tokens (throughput use).
* ``GraphWalkCorpus``: the paper integration (§5, §8.4): random walks
  over a (generated or reference) graph, tokenized as node ids, the
  synthetic dataset generator feeding LM pre-training.  Walks are
  node2vec-style (return parameter p only, q = 1) on a numpy CSR; a graph
  on the card is copied to the host once.

Both provide ``batches(batch, seq)`` yielding ``{tokens, labels}`` host
numpy.  The labels are already the next tokens, and ``lm_loss`` shifts
them once more, as in the reference (ROADMAP C11).  ``Prefetcher``
copies each batch to a device on its thread; ``ShardedLoader`` slices per
rank (``torch.distributed``'s rank and world size when it is initialised,
else 0 and 1) and counts straggler batches (latency above ``k×`` the EMA).
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.graph.ops import Graph


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class SyntheticTokens:
    def __init__(self, vocab: int, seed: int = 0, zipf_a: float = 1.2):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.zipf_a = zipf_a

    def batches(self, batch: int, seq: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            t = self.rng.zipf(self.zipf_a, size=(batch, seq + 1))
            t = np.minimum(t, self.vocab - 1).astype(np.int32)
            yield {"tokens": t[:, :-1], "labels": t[:, :-1] * 0 + t[:, 1:]}


class GraphWalkCorpus:
    """Random-walk corpus over a graph; node ids are tokens."""

    def __init__(self, g: Graph, vocab: Optional[int] = None, seed: int = 0,
                 p_return: float = 0.25):
        self.g = g
        self.vocab = vocab or g.n_nodes
        self.rng = np.random.default_rng(seed)
        self.p_return = p_return
        # undirected CSR
        src = _numpy(g.src)
        dst = _numpy(g.dst) + (g.n_src if g.bipartite else 0)
        heads = np.concatenate([src, dst])
        tails = np.concatenate([dst, src])
        order = np.argsort(heads, kind="stable")
        self._tails = tails[order]
        self._starts = np.searchsorted(heads[order],
                                       np.arange(g.n_nodes + 1))
        self._deg = np.diff(self._starts)
        self._noniso = np.where(self._deg > 0)[0]

    def walk(self, n_walks: int, length: int) -> np.ndarray:
        cur = self.rng.choice(self._noniso, size=n_walks)
        out = np.empty((n_walks, length), np.int64)
        out[:, 0] = cur
        prev = cur.copy()
        for t in range(1, length):
            deg = self._deg[cur]
            off = (self.rng.random(n_walks) * deg).astype(np.int64)
            nxt = self._tails[self._starts[cur] + off]
            back = self.rng.random(n_walks) < self.p_return
            nxt = np.where(back & (t > 1), prev, nxt)
            prev, cur = cur, nxt
            out[:, t] = cur
        return out

    def batches(self, batch: int, seq: int) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            w = self.walk(batch, seq + 1) % self.vocab
            w = w.astype(np.int32)
            yield {"tokens": w[:, :-1], "labels": w[:, 1:]}


class Prefetcher:
    """Host→device double buffering on a daemon thread: each batch's
    arrays become tensors on ``device`` (numpy kept when it is None)."""

    def __init__(self, it: Iterator, size: int = 2, device=None):
        self.it = it
        self.device = device
        self.q: queue.Queue = queue.Queue(maxsize=size)
        self.err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._work, daemon=True)
        self._t.start()

    def _work(self):
        try:
            for item in self.it:
                if self.device is not None:
                    item = {k: torch.from_numpy(np.ascontiguousarray(v))
                            .to(self.device) for k, v in item.items()}
                self.q.put(item)
        except BaseException as e:  # noqa: BLE001 — raised by __next__
            self.err = e
        self.q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise self.err or StopIteration
        return item


class ShardedLoader:
    """Per-rank shard slicing + straggler watchdog."""

    def __init__(self, source, batch: int, seq: int,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 straggler_factor: float = 5.0):
        dist = torch.distributed
        ready = dist.is_available() and dist.is_initialized()
        self.source = source
        self.batch = batch
        self.seq = seq
        self.pi = (process_index if process_index is not None
                   else dist.get_rank() if ready else 0)
        self.pc = (process_count if process_count is not None
                   else dist.get_world_size() if ready else 1)
        if batch % self.pc:
            raise ValueError(f"batch {batch} does not split over "
                             f"{self.pc} ranks")
        self.local_batch = batch // self.pc
        self.straggler_factor = straggler_factor
        self.ema: Optional[float] = None
        self.straggler_events = 0
        self._it = self.source.batches(self.local_batch, self.seq)

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.time()
        item = next(self._it)
        dt = time.time() - t0
        if self.ema is not None and dt > self.straggler_factor * self.ema:
            self.straggler_events += 1
        self.ema = dt if self.ema is None else 0.9 * self.ema + 0.1 * dt
        return item
