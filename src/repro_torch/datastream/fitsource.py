"""``FitSource``: chunked fit streams, the read-side mirror of
``ShardSource``.

A ``FitSource`` yields ``FitChunk(src, dst, cont, cat, start_row)``
blocks of host arrays from either in-memory arrays
(:class:`ArrayFitSource`) or a materialized ``ShardedGraphDataset`` on
disk (:class:`DatasetFitSource`), consumed by the one-pass accumulators
of ``repro_torch.core.fit_engine`` (which move each chunk's ids to the
fit's device once).

Every chunk carries its **global row offset** (``start_row``) in the
dataset's canonical order, so row-keyed randomness (the reservoir's
priorities) is a function of row identity, not arrival order — the
property that makes the fit byte-identical across chunk orderings.
``DatasetFitSource`` accepts an explicit ``shard_order`` so that
invariance can be shown by streaming shards shuffled.
"""
from __future__ import annotations

import math
import os
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.fit_engine import FitChunk
from repro_torch.datastream.reader import ShardedGraphDataset
from repro_torch.graph.ops import Graph

#: default rows per chunk — the fit-side memory bound
DEFAULT_CHUNK_ROWS = 1 << 20


def _host(a) -> Optional[np.ndarray]:
    if a is None:
        return None
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class FitSource:
    """Contract consumed by ``fit_engine.accumulate``: metadata
    properties plus a ``chunks()`` iterator of :class:`FitChunk`.
    ``chunks()`` may be called repeatedly (each call is a fresh pass)."""

    n_src: int
    n_dst: int
    bipartite: bool
    total_rows: int
    has_features: bool

    def chunks(self) -> Iterator[FitChunk]:
        raise NotImplementedError

    def describe(self) -> Dict:
        """JSON-native provenance for the fit output."""
        raise NotImplementedError


class ArrayFitSource(FitSource):
    """In-memory arrays (host arrays or tensors on any device, held on
    the host) sliced into fixed-size chunks — the adapter that lets
    ``fit_streamed`` take the ``fit(g, cont, cat)`` inputs."""

    def __init__(self, src, dst, cont=None, cat=None,
                 n_src: Optional[int] = None, n_dst: Optional[int] = None,
                 bipartite: bool = False,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS):
        self.src = _host(src)
        self.dst = _host(dst)
        if len(self.src) != len(self.dst):
            raise ValueError(f"src/dst lengths differ: {len(self.src)} != "
                             f"{len(self.dst)}")
        self.cont = _host(cont)
        self.cat = _host(cat)
        for tbl in (self.cont, self.cat):
            if tbl is not None and len(tbl) != len(self.src):
                raise ValueError("feature rows must match edge rows")
        self.n_src = int(n_src if n_src is not None
                         else (self.src.max() + 1 if len(self.src) else 1))
        self.n_dst = int(n_dst if n_dst is not None
                         else (self.dst.max() + 1 if len(self.dst) else 1))
        self.bipartite = bool(bipartite)
        self.chunk_rows = int(chunk_rows)
        self.total_rows = int(len(self.src))
        self.has_features = self.cont is not None or self.cat is not None

    @classmethod
    def from_graph(cls, g: Graph, cont=None, cat=None,
                   chunk_rows: int = DEFAULT_CHUNK_ROWS
                   ) -> "ArrayFitSource":
        """A port ``Graph`` (its ids copied to the host) and its feature
        table."""
        return cls(g.src, g.dst, cont, cat, n_src=g.n_src, n_dst=g.n_dst,
                   bipartite=g.bipartite, chunk_rows=chunk_rows)

    def chunks(self) -> Iterator[FitChunk]:
        n = self.total_rows
        step = self.chunk_rows
        for off in range(0, max(n, 1), step):
            sl = slice(off, min(off + step, n))
            yield FitChunk(self.src[sl], self.dst[sl],
                           None if self.cont is None else self.cont[sl],
                           None if self.cat is None else self.cat[sl],
                           start_row=off)

    def describe(self) -> Dict:
        return {"kind": "arrays", "rows": self.total_rows,
                "chunk_rows": self.chunk_rows,
                "n_chunks": max(1, math.ceil(self.total_rows
                                             / self.chunk_rows))}


class DatasetFitSource(FitSource):
    """Chunks out of a ``ShardedGraphDataset`` (manifest-in): shards are
    read mmap-ed one at a time and sliced to ``chunk_rows``, so peak
    memory is one chunk regardless of dataset size.

    Global row offsets come from the manifest's shard order (by
    ``shard_id``), which is stable however the stream is actually
    iterated; ``shard_order`` re-orders iteration only.  ``columns`` can
    drop the feature tables for a structure-only fit over a featured
    dataset."""

    def __init__(self, dataset, chunk_rows: int = DEFAULT_CHUNK_ROWS,
                 shard_order: Optional[Sequence[int]] = None,
                 columns: Sequence[str] = ("src", "dst", "cont", "cat")):
        self.ds = (dataset if isinstance(dataset, ShardedGraphDataset)
                   else ShardedGraphDataset(str(dataset)))
        self.chunk_rows = int(chunk_rows)
        self.columns = tuple(columns)
        self.n_src = self.ds.n_src
        self.n_dst = self.ds.n_dst
        self.bipartite = self.ds.bipartite
        self.total_rows = self.ds.total_edges
        self.has_features = (self.ds.has_features
                             and ("cont" in self.columns
                                  or "cat" in self.columns))
        recs = sorted(self.ds.manifest.shards, key=lambda r: r.shard_id)
        self._offsets = {}
        off = 0
        for rec in recs:
            self._offsets[rec.shard_id] = off
            off += rec.n_edges
        self._order = ([r.shard_id for r in recs] if shard_order is None
                       else [int(s) for s in shard_order])
        missing = set(self._order) - set(self._offsets)
        if missing:
            raise ValueError(f"shard_order names unknown shards: "
                             f"{sorted(missing)}")

    def chunks(self) -> Iterator[FitChunk]:
        want_feat = self.has_features
        for sid in self._order:
            blk = self.ds.load_shard(sid)
            base = self._offsets[sid]
            for off in range(0, blk.n_edges, self.chunk_rows):
                sl = slice(off, min(off + self.chunk_rows, blk.n_edges))
                yield FitChunk(
                    np.asarray(blk.src[sl]), np.asarray(blk.dst[sl]),
                    (np.asarray(blk.cont[sl]) if want_feat
                     and blk.cont is not None else None),
                    (np.asarray(blk.cat[sl]) if want_feat
                     and blk.cat is not None else None),
                    start_row=base + off)

    def describe(self) -> Dict:
        man = self.ds.manifest
        return {"kind": "dataset", "rows": self.total_rows,
                "chunk_rows": self.chunk_rows,
                "n_shards": len(man.shards),
                "dtype": man.dtype, "mode": man.mode,
                "theta_digest": man.theta_digest,
                "generator_fit": dict(man.fit)}


def as_fit_source(source, chunk_rows: int = DEFAULT_CHUNK_ROWS) -> FitSource:
    """Coerce the things callers naturally hold into a ``FitSource``:
    an existing source (pass-through), a ``ShardedGraphDataset`` or a
    dataset directory path, a ``Graph`` (structure only), or a
    ``(Graph, cont, cat)`` tuple."""
    if isinstance(source, FitSource):
        return source
    if isinstance(source, ShardedGraphDataset):
        return DatasetFitSource(source, chunk_rows=chunk_rows)
    if isinstance(source, (str, bytes, os.PathLike)):
        return DatasetFitSource(ShardedGraphDataset(str(source)),
                                chunk_rows=chunk_rows)
    if isinstance(source, Graph):
        return ArrayFitSource.from_graph(source, chunk_rows=chunk_rows)
    if isinstance(source, tuple) and len(source) == 3 \
            and isinstance(source[0], Graph):
        g, cont, cat = source
        return ArrayFitSource.from_graph(g, cont, cat,
                                         chunk_rows=chunk_rows)
    raise TypeError(f"cannot build a FitSource from {type(source)!r}")
