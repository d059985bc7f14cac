"""Manifest-driven reading of a materialized dataset.

``ShardedGraphDataset`` never loads more than one shard of edges (plus the
requested batch) into memory — shard columns are opened with
``np.load(mmap_mode="r")`` so the OS pages data in as it is consumed.
``to_graph()`` assembles an in-memory ``Graph`` (the port's, with its id
tensors on the device asked for) for evaluation-sized outputs and refuses
(by default) to do so above a size guard.  The on-disk format is the JAX
package's, so either package reads what the other wrote.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.datastream.writer import Manifest, ShardRecord, ShardWriter
from repro_torch.graph.ops import Graph


@dataclasses.dataclass
class ShardBlock:
    """One shard's worth of columns (numpy views, possibly memory-mapped)."""
    shard_id: int
    src: np.ndarray
    dst: np.ndarray
    cont: Optional[np.ndarray] = None
    cat: Optional[np.ndarray] = None

    @property
    def n_edges(self) -> int:
        return int(self.src.shape[0])


class ShardedGraphDataset:
    """Iterator over the shards of a ``DatasetJob`` output directory."""

    def __init__(self, path: str, mmap: bool = True,
                 allow_partial: bool = False):
        self.path = path
        self.mmap = mmap
        self.manifest = Manifest.load(path)
        if not allow_partial and not self.manifest.is_complete():
            done = len(self.manifest.done_ids())
            raise RuntimeError(
                f"dataset at {path} is incomplete ({done}/"
                f"{len(self.manifest.shards)} shards done) — resume the "
                "job or pass allow_partial=True")

    # -- metadata ----------------------------------------------------------
    @property
    def total_edges(self) -> int:
        return self.manifest.total_edges

    @property
    def n_src(self) -> int:
        return self.manifest.n_src

    @property
    def n_dst(self) -> int:
        return self.manifest.n_dst

    @property
    def bipartite(self) -> bool:
        return self.manifest.bipartite

    @property
    def has_features(self) -> bool:
        return self.manifest.features is not None

    def __len__(self) -> int:
        return len(self.manifest.shards)

    # -- shard access ------------------------------------------------------
    def _load_col(self, rec: ShardRecord, col: str) -> Optional[np.ndarray]:
        fname = rec.files.get(col)
        if fname is None:
            return None
        return np.load(os.path.join(self.path, fname),
                       mmap_mode="r" if self.mmap else None)

    def load_shard(self, shard_id: int) -> ShardBlock:
        rec = self.manifest.record(shard_id)
        if rec.status != "done":
            raise RuntimeError(f"shard {shard_id} not materialized")
        return ShardBlock(shard_id,
                          src=self._load_col(rec, "src"),
                          dst=self._load_col(rec, "dst"),
                          cont=self._load_col(rec, "cont"),
                          cat=self._load_col(rec, "cat"))

    def __iter__(self) -> Iterator[ShardBlock]:
        for rec in self.manifest.shards:
            if rec.status == "done":
                yield self.load_shard(rec.shard_id)

    def batches(self, batch_edges: int
                ) -> Iterator[Tuple[np.ndarray, np.ndarray,
                                    Optional[np.ndarray],
                                    Optional[np.ndarray]]]:
        """Fixed-size edge batches for training loops; batches may span a
        shard boundary (the last one may be short)."""
        hold: List[ShardBlock] = []
        held = 0
        for blk in self:
            hold.append(blk)
            held += blk.n_edges
            while held >= batch_edges:
                yield self._take(hold, batch_edges)
                held -= batch_edges
        if held:
            yield self._take(hold, held)

    @staticmethod
    def _take(hold: List[ShardBlock], n: int):
        outs = {"src": [], "dst": [], "cont": [], "cat": []}
        left = n
        while left > 0:
            blk = hold[0]
            take = min(left, blk.n_edges)
            for col in outs:
                arr = getattr(blk, col)
                if arr is not None:
                    outs[col].append(np.asarray(arr[:take]))
            rest = {col: (getattr(blk, col)[take:]
                          if getattr(blk, col) is not None else None)
                    for col in outs}
            if take == blk.n_edges:
                hold.pop(0)
            else:
                hold[0] = ShardBlock(blk.shard_id, **rest)
            left -= take
        cat = lambda xs: np.concatenate(xs) if xs else None  # noqa: E731
        return (cat(outs["src"]), cat(outs["dst"]),
                cat(outs["cont"]), cat(outs["cat"]))

    # -- small-output assembly --------------------------------------------
    def to_graph(self, max_edges: int = 50_000_000, device="cuda"
                 ) -> Graph:
        """Assemble the full edge list as an in-memory ``Graph`` with its
        id tensors on ``device`` (for evaluation / training on small
        outputs only)."""
        if self.total_edges > max_edges:
            raise MemoryError(
                f"{self.total_edges} edges > max_edges={max_edges}; "
                "iterate shards instead of materializing")
        srcs, dsts = [], []
        for blk in self:
            srcs.append(np.asarray(blk.src))
            dsts.append(np.asarray(blk.dst))
        src = np.concatenate(srcs) if srcs else np.zeros(0, np.int32)
        dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int32)
        return Graph(torch.from_numpy(src).to(device),
                     torch.from_numpy(dst).to(device), self.n_src,
                     self.n_dst, self.bipartite)

    def features(self, max_edges: int = 50_000_000
                 ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
        if self.total_edges > max_edges:
            raise MemoryError("feature table too large to materialize")
        conts = [np.asarray(b.cont) for b in self if b.cont is not None]
        cats = [np.asarray(b.cat) for b in self if b.cat is not None]
        return (np.concatenate(conts) if conts else None,
                np.concatenate(cats) if cats else None)

    # -- integrity ---------------------------------------------------------
    def verify(self, deep: bool = False) -> List[str]:
        """Return a list of integrity problems (empty == dataset is sound).

        Checks: per-shard files exist with the planned row counts, shard
        edge counts sum exactly to ``total_edges``, observed id ranges fall
        inside the address space; ``deep`` additionally re-hashes every
        column against the manifest crc32 — in streamed
        ``writer.CRC_BLOCK_ROWS`` blocks over the memory map, so
        deep-verifying a dataset far larger than RAM stays
        bounded-memory (CLI: ``generate_dataset --verify-deep``).
        """
        problems: List[str] = []
        writer = ShardWriter(self.path, self.manifest)
        done_sum = 0
        for rec in self.manifest.shards:
            if rec.status != "done":
                problems.append(f"shard {rec.shard_id}: not materialized")
                continue
            done_sum += rec.n_edges
            if not writer.shard_ok_on_disk(rec, deep=deep):
                problems.append(f"shard {rec.shard_id}: on-disk data does "
                                "not match manifest")
            if rec.src_range and not (0 <= rec.src_range[0]
                                      and rec.src_range[1] < self.n_src):
                problems.append(f"shard {rec.shard_id}: src ids outside "
                                f"[0, {self.n_src})")
            if rec.dst_range and not (0 <= rec.dst_range[0]
                                      and rec.dst_range[1] < self.n_dst):
                problems.append(f"shard {rec.shard_id}: dst ids outside "
                                f"[0, {self.n_dst})")
        if done_sum != self.total_edges and self.manifest.is_complete():
            problems.append(f"shard edge counts sum to {done_sum}, manifest "
                            f"says {self.total_edges}")
        return problems
