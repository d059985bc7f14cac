"""Streaming fit engine: the fit side of ``repro_torch.datastream``.

``pipeline.fit`` takes the whole graph and feature table in memory; a
dataset the port wrote to disk can be far larger.  Here one-pass
accumulators consume ``(src, dst, cont, cat)`` chunks from any
``FitSource`` (``repro_torch.datastream.fitsource``) and reduce them to
exactly the statistics the fitting code needs; memory is bounded by the
chunk size plus fixed-size sketches, never by the graph.  Every
accumulator is one-pass and chunk-order invariant, and each runs where
its result stays exact:

* :class:`BitPairMLE` — per-level bit-pair counts == the exact MLE of
  the quadrant distribution (paper §3.2.3): one ``torch.bincount`` per
  level and block on the ids' device, int64 ids split into the ``(hi,
  lo)`` int32 words of ``repro_torch.core.descend``.  The counts stay on
  that device across chunks and are read once, when ``counts`` is read.
* :class:`DegreeSketch` — degree histogram over a fixed id space: dense
  int64 counters on the card (``torch.bincount`` per chunk) up to
  ``DENSE_NODE_LIMIT`` nodes, 128 MiB at most; above it the ids spill to
  per-id-range bucket files on the host, replayed bucket by bucket.
* :class:`ReservoirSample` — order-invariant bottom-k priority sample:
  each global row's priority is the splitmix64 hash of its index, the k
  smallest win.  The hashes, the per-chunk selection and the merge run
  on the card in int64 arithmetic that wraps as uint64 does; the chosen
  rows' feature columns are gathered on the host.
* :class:`Moments` — per-continuous-column count/mean/var/min/max, numpy
  float64 on the host (see its docstring: a device sum would change the
  fit JSON's last bits).
* :class:`CatCards` — exact per-categorical-column cardinality (max+1),
  numpy on the host.

``accumulate`` drives one pass over a source and returns
:class:`StreamFitStats`; ``fit_structure_streamed`` turns the stats into
a ``KroneckerFit`` through the MLE → Eq. 6 marginals → calibration
ladder of ``structure.fit_structure``, scoring candidates against the
sketched histograms; ``fit_to_json`` serializes (fit, provenance)
deterministically.  Given the same chunks, every statistic, and so the
fit JSON, equals the JAX package's byte for byte, on the card and on the
CPU.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import tempfile
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.descend import LO_BITS
from repro_torch.graph.ops import sparse_degree_histogram

#: rows counted per block: bounds the per-level temporaries
BITPAIR_BLOCK = 1 << 20

#: DegreeSketch stays dense up to this many nodes (int64 counters:
#: 2^24 nodes == 128 MiB); larger id spaces spill per id-range bucket
DENSE_NODE_LIMIT = 1 << 24

#: rows loaded per block when replaying a bucket spill
SPILL_BLOCK_ROWS = 1 << 22


class FitChunk(NamedTuple):
    """One chunk of a fit stream, host arrays.  ``start_row`` is the
    chunk's global row offset in the dataset's canonical order —
    accumulators key per-row randomness on it, which is what makes every
    accumulator invariant to the order chunks actually arrive in."""
    src: np.ndarray
    dst: np.ndarray
    cont: Optional[np.ndarray]
    cat: Optional[np.ndarray]
    start_row: int

    @property
    def n_rows(self) -> int:
        return int(len(self.src))


def _on(ids, device: torch.device) -> torch.Tensor:
    """Ids as a tensor on ``device``; a host array is copied (a memory
    map's read-only pages are never shared with torch)."""
    if isinstance(ids, torch.Tensor):
        return ids.to(device)
    return torch.tensor(np.asarray(ids), device=device)


# ---------------------------------------------------------------------------
# Bit-pair MLE
# ---------------------------------------------------------------------------

def _split_id_words(ids: torch.Tensor
                    ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Split node ids into the engine's (hi, lo) int32 words; ``hi`` is
    None for ids of at most 32 bits (cf. ``descend.combine_ids``, the
    inverse)."""
    if ids.element_size() <= 4:
        return None, ids.to(torch.int32)
    a = ids.to(torch.int64)
    lo = (a & ((1 << LO_BITS) - 1)).to(torch.int32)
    hi = (a >> LO_BITS).to(torch.int32)
    return hi, lo


def _bitpair_counts(s_hi, s_lo, d_hi, d_lo, n: int, m: int) -> torch.Tensor:
    """(hi, lo) id words of one block → (min(n, m), 4) int64 counts of
    ``sb * 2 + db`` per level, level 0 the most significant bit."""

    def bit_at(hi, lo, pos: int):
        if pos >= LO_BITS:
            if hi is None:
                return torch.zeros_like(lo)
            return (hi >> (pos - LO_BITS)) & 1
        return (lo >> pos) & 1

    rows = []
    for ell in range(min(n, m)):
        sb = bit_at(s_hi, s_lo, n - 1 - ell)
        db = bit_at(d_hi, d_lo, m - 1 - ell)
        rows.append(torch.bincount(sb * 2 + db, minlength=4))
    return torch.stack(rows)


class BitPairMLE:
    """One-pass per-level bit-pair counts == per-level quadrant MLE.

    ``counts[ell]`` holds the (a, b, c, d)-order joint counts of
    ``(src_bit_ell, dst_bit_ell)`` over every row seen, an int64 numpy
    array read from the device the ids were counted on; ``ratios()`` is
    the level-averaged frequency vector."""

    def __init__(self, n: int, m: int, block: int = BITPAIR_BLOCK):
        self.n, self.m = int(n), int(m)
        self.lv = min(self.n, self.m)
        self.block = int(block)
        self.rows = 0
        self._counts: Optional[torch.Tensor] = None   # on the ids' device

    def update(self, src, dst) -> "BitPairMLE":
        """Count a chunk of ids (tensors on any device, or host arrays)."""
        src = torch.as_tensor(src)
        dst = torch.as_tensor(dst, device=src.device)
        if len(src) != len(dst):
            raise ValueError(f"src/dst lengths differ: {len(src)} != "
                             f"{len(dst)}")
        self.rows += len(src)
        if not self.lv or not len(src):
            return self
        for off in range(0, len(src), self.block):
            s_hi, s_lo = _split_id_words(src[off: off + self.block])
            d_hi, d_lo = _split_id_words(dst[off: off + self.block])
            out = _bitpair_counts(s_hi, s_lo, d_hi, d_lo, self.n, self.m)
            self._counts = out if self._counts is None else \
                self._counts + out.to(self._counts.device)
        return self

    @property
    def counts(self) -> np.ndarray:
        """(max(min(n, m), 1), 4) int64 counts, read from the device."""
        out = np.zeros((max(self.lv, 1), 4), np.int64)
        if self._counts is not None:
            out[: self.lv] = self._counts.cpu().numpy()
        return out

    def ratios(self) -> np.ndarray:
        """Level-averaged (a, b, c, d) frequency — the MLE point."""
        counts = self.counts
        return counts.sum(axis=0) / max(counts.sum(), 1)


# ---------------------------------------------------------------------------
# Degree histogram sketch (dense on the device / bucketed host spill)
# ---------------------------------------------------------------------------

class DegreeSketch:
    """Bounded-memory degree histogram over a fixed ``n_nodes`` id space.

    * ``n_nodes <= dense_limit``: exact dense int64 counters on
      ``device``, one ``torch.bincount`` per chunk (integer sums: exact
      in any order, so the card's atomics are harmless).
    * larger: ids spill to per-id-range bucket files on the host (one
      bucket spans ``dense_limit`` ids); ``finalize`` replays each bucket
      through a unique-count (small spills) or a dense bucket array
      filled in ``SPILL_BLOCK_ROWS`` blocks — peak memory is one bucket,
      never the id space.

    Either path yields the exact ``degree_histogram(degrees, kmax)``
    (tail clipped into the ``kmax`` bin, zero-degree nodes in bin 0) as
    an int64 numpy array, plus the exact max degree.
    """

    def __init__(self, n_nodes: int, kmax: int = 2048,
                 dense_limit: int = DENSE_NODE_LIMIT, device="cuda"):
        self.n_nodes = int(n_nodes)
        self.kmax = int(kmax)
        self.dense_limit = int(dense_limit)
        self.device = torch.device(device)
        self.rows = 0
        self._finalized: Optional[Tuple[np.ndarray, int]] = None
        if self.n_nodes <= self.dense_limit:
            self.mode = "dense"
            self._deg = torch.zeros(self.n_nodes, dtype=torch.int64,
                                    device=self.device)
            self._tmp = None
        else:
            self.mode = "bucketed"
            self._deg = None
            self.n_buckets = math.ceil(self.n_nodes / self.dense_limit)
            self._tmp = tempfile.TemporaryDirectory(prefix="degsketch-")
            self._spill_rows = np.zeros(self.n_buckets, np.int64)

    def _bucket_path(self, b: int) -> str:
        return os.path.join(self._tmp.name, f"bucket-{b:06d}.i64")

    def update(self, ids) -> "DegreeSketch":
        """Count a chunk of ids (a tensor on any device, or a host
        array)."""
        self.rows += len(ids)
        if not len(ids):
            return self
        if self.mode == "dense":
            ids = _on(ids, self.device)
            self._deg += torch.bincount(ids, minlength=self.n_nodes)
            return self
        if isinstance(ids, torch.Tensor):
            ids = ids.cpu().numpy()
        ids = np.sort(np.asarray(ids).astype(np.int64, copy=False))
        buckets = ids // self.dense_limit
        bounds = np.searchsorted(buckets, np.arange(self.n_buckets + 1))
        for b in np.unique(buckets):
            lo, hi = bounds[b], bounds[b + 1]
            with open(self._bucket_path(int(b)), "ab") as f:
                f.write(np.ascontiguousarray(ids[lo:hi]).tobytes())
            self._spill_rows[b] += hi - lo
        return self

    def _bucket_hist(self, b: int) -> Tuple[np.ndarray, int]:
        """Histogram + max degree of one bucket's spilled ids."""
        size = min(self.dense_limit,
                   self.n_nodes - b * self.dense_limit)
        n_sp = int(self._spill_rows[b])
        if n_sp == 0:
            h = np.zeros(self.kmax + 1, np.int64)
            h[0] = size
            return h, 0
        path = self._bucket_path(b)
        base = np.int64(b) * self.dense_limit
        if n_sp <= SPILL_BLOCK_ROWS:
            local = np.fromfile(path, np.int64) - base
            return sparse_degree_histogram(torch.from_numpy(local), size,
                                           self.kmax)
        dense = np.zeros(size, np.int64)
        mm = np.memmap(path, np.int64, mode="r")
        for off in range(0, n_sp, SPILL_BLOCK_ROWS):
            blk = np.asarray(mm[off: off + SPILL_BLOCK_ROWS]) - base
            u, c = np.unique(blk, return_counts=True)
            dense[u] += c
        h = np.bincount(np.minimum(dense, self.kmax),
                        minlength=self.kmax + 1).astype(np.int64)
        return h, int(dense.max())

    def finalize(self) -> Tuple[np.ndarray, int]:
        """``(histogram (kmax+1,) int64, max_degree)``; idempotent."""
        if self._finalized is not None:
            return self._finalized
        if self.mode == "dense":
            hist = torch.bincount(torch.clamp(self._deg, max=self.kmax),
                                  minlength=self.kmax + 1)
            hist = hist.cpu().numpy().astype(np.int64)
            max_deg = int(self._deg.max()) if self.n_nodes else 0
            self._deg = None
        else:
            hist = np.zeros(self.kmax + 1, np.int64)
            max_deg = 0
            for b in range(self.n_buckets):
                h, md = self._bucket_hist(b)
                hist += h
                max_deg = max(max_deg, md)
            self._tmp.cleanup()
        self._finalized = (hist, max_deg)
        return self._finalized


# ---------------------------------------------------------------------------
# Order-invariant row sampling + streaming moments
# ---------------------------------------------------------------------------

_M1, _M2 = 0xBF58476D1CE4E5B9, 0x94D049BB133111EB
_SIGN = 1 << 63


def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer on uint64 — the fixed per-row-index priority
    hash (the host form; :func:`_mix64_t` is the device form)."""
    x = x.astype(np.uint64, copy=True)
    x ^= x >> np.uint64(30)
    x *= np.uint64(_M1)
    x ^= x >> np.uint64(27)
    x *= np.uint64(_M2)
    x ^= x >> np.uint64(31)
    return x


def _signed(u: int) -> int:
    """A uint64 value as the int64 with the same bits."""
    u = int(u) & ((1 << 64) - 1)
    return u - (1 << 64) if u & _SIGN else u


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits: torch's ``>>`` is arithmetic,
    so the sign-extended top ``k`` bits are masked off."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _mix64_t(x: torch.Tensor) -> torch.Tensor:
    """:func:`_mix64` on int64 tensors holding uint64 bits: xor and shift
    act on bits, and a product wraps modulo 2^64 as uint64's does."""
    x = x ^ _shr(x, 30)
    x = x * _signed(_M1)
    x = x ^ _shr(x, 27)
    x = x * _signed(_M2)
    return x ^ _shr(x, 31)


def _bottom(key: torch.Tensor, row: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` smallest ``(key, row)`` pairs in that order:
    ``np.lexsort((row, key))[:k]`` (two stable sorts)."""
    o = torch.sort(row, stable=True).indices
    o = o[torch.sort(key[o], stable=True).indices]
    return o[:k]


class ReservoirSample:
    """Bottom-k priority sample over global row indices.

    Every row's priority is ``_mix64(row_index XOR mix(seed))`` — a pure
    function of identity, not arrival order — and the k smallest
    priorities win, so the selected set is invariant to chunk order and
    to how the stream is chunked (streamed == in-memory exactly).  On the
    device the priorities are int64 tensors with bit 63 flipped, whose
    signed order is the uint64 order; ties (none: ``_mix64`` is a
    bijection) break by row.

    ``stratified=True`` additionally caps each chunk's candidates at its
    proportional share ``ceil(k · chunk_rows / total_rows)`` (requires
    ``total_rows``), guaranteeing spread across the id-space/chunk
    structure for heavily skewed datasets; still order-invariant because
    the cap depends only on the chunk's own content.

    ``finalize`` returns host arrays: ``src``/``dst`` in the chunks' id
    dtype, ``cont``/``cat`` as the chunks hold them.
    """

    def __init__(self, k: int, seed: int = 0, stratified: bool = False,
                 total_rows: Optional[int] = None, device="cuda"):
        self.k = int(k)
        self.seed = int(seed)
        self.stratified = bool(stratified)
        self.total_rows = total_rows
        if stratified and not total_rows:
            raise ValueError("stratified sampling needs total_rows "
                             "(the proportional per-chunk quota)")
        self.device = torch.device(device)
        self.rows_seen = 0
        self._seed_mix = _signed(
            _mix64(np.array([self.seed], np.uint64))[0])
        self._key: Optional[torch.Tensor] = None   # flipped priorities
        self._row: Optional[torch.Tensor] = None
        self._cols: Dict[str, Any] = {}

    def update(self, chunk: FitChunk) -> "ReservoirSample":
        """Offer a chunk's rows; ``chunk.src``/``dst`` may be tensors on
        the device already (``accumulate`` passes them so)."""
        n = chunk.n_rows
        self.rows_seen += n
        if n == 0:
            return self
        dev = self.device
        rows = torch.arange(chunk.start_row, chunk.start_row + n,
                            dtype=torch.int64, device=dev)
        # uint64 priorities as int64 bits, bit 63 flipped: signed order
        key = _mix64_t(rows ^ self._seed_mix) ^ _signed(_SIGN)
        quota = (math.ceil(self.k * n / self.total_rows)
                 if self.stratified else self.k)
        keep = _bottom(key, rows, min(quota, self.k))
        host_keep = (keep.cpu().numpy() if chunk.cont is not None
                     or chunk.cat is not None else None)
        cols = {"src": _on(chunk.src, dev)[keep],
                "dst": _on(chunk.dst, dev)[keep],
                "cont": (np.asarray(chunk.cont)[host_keep]
                         if chunk.cont is not None else None),
                "cat": (np.asarray(chunk.cat)[host_keep]
                        if chunk.cat is not None else None)}
        if self._key is None:
            self._key, self._row, self._cols = key[keep], rows[keep], cols
            return self
        key = torch.cat([self._key, key[keep]])
        row = torch.cat([self._row, rows[keep]])
        order = _bottom(key, row, self.k)
        self._key, self._row = key[order], row[order]
        host_order = None
        for name, cur in self._cols.items():
            if isinstance(cur, torch.Tensor):
                self._cols[name] = torch.cat([cur, cols[name]])[order]
            elif cur is not None:
                if host_order is None:
                    host_order = order.cpu().numpy()
                self._cols[name] = np.concatenate([cur, cols[name]])[
                    host_order]
        return self

    def finalize(self) -> Dict[str, Any]:
        """Sampled rows in global-row order + provenance, host arrays."""
        if self._key is None:                # empty stream
            out = {"src": np.zeros(0, np.int64), "dst": np.zeros(0, np.int64),
                   "cont": None, "cat": None, "rows": np.zeros(0, np.int64)}
        else:
            order = torch.sort(self._row, stable=True).indices
            host_order = order.cpu().numpy()
            out = {}
            for name, arr in self._cols.items():
                if isinstance(arr, torch.Tensor):
                    out[name] = arr[order].cpu().numpy()
                else:
                    out[name] = arr[host_order] if arr is not None else None
            out["rows"] = self._row[order].cpu().numpy()
        out["provenance"] = {
            "kind": "stratified" if self.stratified else "uniform",
            "requested": self.k, "rows": int(len(out["rows"])),
            "seed": self.seed, "rows_seen": int(self.rows_seen)}
        return out


class Moments:
    """Streaming per-column count/mean/var/min/max for the continuous
    block, numpy float64 on the host: per-chunk ``col.sum()`` (numpy's
    pairwise sum) and ``math.fsum`` (exactly rounded) across chunks, so
    the result is bit-identical under any chunk ordering and equal to
    the JAX package's.  A float64 sum on the card associates in another
    order; its last bits would reach the fit JSON's ``moments`` and break
    its byte identity, so these sums stay on the host."""

    def __init__(self, n_cols: int):
        self.n_cols = int(n_cols)
        self.count = 0
        self._sums: List[List[float]] = [[] for _ in range(n_cols)]
        self._sumsq: List[List[float]] = [[] for _ in range(n_cols)]
        self._min = np.full(n_cols, np.inf)
        self._max = np.full(n_cols, -np.inf)

    def update(self, cont: np.ndarray) -> "Moments":
        cont = np.asarray(cont, np.float64)
        self.count += cont.shape[0]
        if cont.shape[0] == 0 or self.n_cols == 0:
            return self
        if cont.shape[1] != self.n_cols:
            raise ValueError(f"{cont.shape[1]} continuous columns, "
                             f"expected {self.n_cols}")
        for j in range(self.n_cols):
            col = cont[:, j]
            self._sums[j].append(float(col.sum()))
            self._sumsq[j].append(float((col * col).sum()))
        self._min = np.minimum(self._min, cont.min(axis=0))
        self._max = np.maximum(self._max, cont.max(axis=0))
        return self

    def finalize(self) -> List[Dict[str, float]]:
        out = []
        for j in range(self.n_cols):
            s = math.fsum(self._sums[j])
            sq = math.fsum(self._sumsq[j])
            n = max(self.count, 1)
            mean = s / n
            out.append({"count": self.count, "mean": mean,
                        "var": max(sq / n - mean * mean, 0.0),
                        "min": float(self._min[j]),
                        "max": float(self._max[j])})
        return out


class CatCards:
    """Exact categorical cardinalities (running per-column max + 1)."""

    def __init__(self, n_cols: int):
        self.n_cols = int(n_cols)
        self._max = np.full(n_cols, -1, np.int64)

    def update(self, cat: np.ndarray) -> "CatCards":
        cat = np.asarray(cat)
        if cat.shape[0] and self.n_cols:
            self._max = np.maximum(self._max, cat.max(axis=0))
        return self

    def cards(self) -> Tuple[int, ...]:
        return tuple(int(m) + 1 if m >= 0 else 1 for m in self._max)


# ---------------------------------------------------------------------------
# One pass over a source
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StreamFitStats:
    """Everything one pass over a ``FitSource`` reduces to."""
    n: int
    m: int
    n_src: int
    n_dst: int
    bipartite: bool
    rows: int
    n_chunks: int
    bitpair: np.ndarray                 # (min(n,m), 4) int64
    hist_out: np.ndarray                # (kmax+1,) int64
    hist_in: np.ndarray
    max_deg_out: int
    max_deg_in: int
    kmax: int
    sample: Dict[str, Any]              # ReservoirSample.finalize()
    moments: List[Dict[str, float]]
    n_cont: int
    cat_cards: Tuple[int, ...]
    has_features: bool
    source: Dict[str, Any]              # FitSource.describe()

    def ratios(self) -> np.ndarray:
        total = self.bitpair.sum()
        return self.bitpair.sum(axis=0) / max(total, 1)

    def _hist_digest(self, h: np.ndarray) -> str:
        return hashlib.sha256(
            np.ascontiguousarray(h, np.int64).tobytes()).hexdigest()[:16]

    def provenance(self) -> Dict[str, Any]:
        """JSON-native provenance block (deterministic content)."""
        return {
            "rows": int(self.rows), "n_chunks": int(self.n_chunks),
            "n": self.n, "m": self.m,
            "bitpair_counts": [[int(x) for x in row]
                               for row in self.bitpair],
            "theta_mle": [float(x) for x in self.ratios()],
            "degree_sketch": {
                "kmax": self.kmax,
                "max_deg_out": int(self.max_deg_out),
                "max_deg_in": int(self.max_deg_in),
                "hist_out_digest": self._hist_digest(self.hist_out),
                "hist_in_digest": self._hist_digest(self.hist_in)},
            "sample": self.sample.get("provenance", {}),
            "moments": self.moments,
            "n_cont": self.n_cont,
            "cat_cards": list(self.cat_cards),
            "source": self.source,
        }


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def accumulate(source, sample_rows: int = 100_000, seed: int = 0,
               kmax: int = 2048, dense_limit: int = DENSE_NODE_LIMIT,
               stratified: bool = False, tracer=None,
               device="cuda") -> StreamFitStats:
    """One pass over ``source`` (anything with ``n_src``/``n_dst``/
    ``bipartite``/``total_rows``/``has_features``/``chunks()``/
    ``describe()`` — see ``repro_torch.datastream.fitsource``) through
    every accumulator.  Each chunk's ids cross to ``device`` once; the
    bit-pair counts, dense degree counters and the sample's selection
    stay there until the pass ends.  Memory: one chunk + the sketches.
    ``tracer`` (a ``repro_torch.obs`` tracer) records per-chunk
    ``fit.read``/``fit.update`` spans (the update span ends after a
    device synchronize) and a ``fit.finalize`` span."""
    from repro_torch.obs import profile
    from repro_torch.obs.trace import NULL_TRACER
    tracer = tracer if tracer is not None else NULL_TRACER
    dev = torch.device(device)

    n = max(1, math.ceil(math.log2(max(source.n_src, 2))))
    m = max(1, math.ceil(math.log2(max(source.n_dst, 2))))
    mle = BitPairMLE(n, m)
    sk_out = DegreeSketch(source.n_src, kmax, dense_limit, device=dev)
    sk_in = DegreeSketch(source.n_dst, kmax, dense_limit, device=dev)
    res = ReservoirSample(sample_rows, seed=seed, stratified=stratified,
                          total_rows=(source.total_rows if stratified
                                      else None), device=dev)
    moments: Optional[Moments] = None
    cards: Optional[CatCards] = None
    n_chunks = 0
    chunk_iter = iter(source.chunks())
    while True:
        with tracer.span("fit.read", chunk=n_chunks):
            chunk = next(chunk_iter, None)
        if chunk is None:
            break
        n_chunks += 1
        with tracer.span("fit.update", chunk=n_chunks - 1,
                         rows=chunk.n_rows):
            with profile.annotation("fit.update"):
                src, dst = _on(chunk.src, dev), _on(chunk.dst, dev)
                mle.update(src, dst)
                sk_out.update(src)
                sk_in.update(dst)
                res.update(chunk._replace(src=src, dst=dst))
            if chunk.cont is not None:
                if moments is None:
                    moments = Moments(chunk.cont.shape[1])
                moments.update(chunk.cont)
            if chunk.cat is not None:
                if cards is None:
                    cards = CatCards(chunk.cat.shape[1])
                cards.update(chunk.cat)
            _sync(dev)
    with tracer.span("fit.finalize"):
        hist_out, max_out = sk_out.finalize()
        hist_in, max_in = sk_in.finalize()
        sample = res.finalize()
        bitpair = mle.counts[: mle.lv]
    return StreamFitStats(
        n=n, m=m, n_src=source.n_src, n_dst=source.n_dst,
        bipartite=source.bipartite, rows=mle.rows, n_chunks=n_chunks,
        bitpair=bitpair, hist_out=hist_out, hist_in=hist_in,
        max_deg_out=max_out, max_deg_in=max_in, kmax=kmax,
        sample=sample, moments=(moments.finalize() if moments else []),
        n_cont=(moments.n_cols if moments else 0),
        cat_cards=(cards.cards() if cards else ()),
        has_features=bool(source.has_features),
        source=dict(source.describe()))


# ---------------------------------------------------------------------------
# Structure fit from stats
# ---------------------------------------------------------------------------

def fit_structure_streamed(stats: StreamFitStats, noise: float = 0.0,
                           calibrate: bool = True, device="cuda"):
    """``structure.fit_structure`` evaluated from one-pass stats: exact
    bit-pair MLE anchor, Eq. 6 marginal refinement on the sketched
    histograms, then the same candidate ladder.  Each candidate's
    calibration sample (``PRNGKey(1234 + i)``, ``min(E, 200 000)``
    edges, the ``reference`` stream — the JAX package's ``xla`` stream)
    is drawn on ``device`` and histogrammed there sparsely, then scored
    against the sketches by ``metrics.degree_counts_similarity`` on the
    host.  Returns ``(KroneckerFit, provenance_dict)``."""
    from repro_torch import random as trandom
    from repro_torch.core import rmat as rmat_mod
    from repro_torch.core import structure as st
    from repro_torch.core.descend import default_id_dtype
    from repro_torch.core.metrics import degree_counts_similarity

    E = stats.rows
    ratios = stats.ratios()

    def marginals(anchor):
        return st.fit_marginals_hist(
            stats.hist_out.astype(np.float64),
            stats.hist_in.astype(np.float64),
            E, stats.n, stats.m, kmax=stats.kmax, anchor=anchor)

    cand = st.candidate_fits(stats.n, stats.m, E, stats.bipartite, noise,
                             ratios, marginals, calibrate=calibrate)
    prov = stats.provenance()
    prov["candidates"] = [name for name, _ in cand]
    if len(cand) == 1:
        prov["chosen"] = cand[0][0]
        return cand[0][1], prov

    dt = default_id_dtype(max(stats.n, stats.m))
    scores = []
    best, best_score = None, -1.0
    for i, (name, fit) in enumerate(cand):
        e_cal = min(fit.E, 200_000)
        src, dst = rmat_mod.sample_graph(trandom.PRNGKey(1234 + i), fit,
                                         n_edges=e_cal, dtype=dt,
                                         device=device)
        h_out, mx_out = sparse_degree_histogram(src, 2 ** stats.n,
                                                stats.kmax)
        h_in, mx_in = sparse_degree_histogram(dst, 2 ** stats.m,
                                              stats.kmax)
        score = degree_counts_similarity(
            stats.hist_out, stats.max_deg_out, stats.hist_in,
            stats.max_deg_in, h_out, mx_out, h_in, mx_in)
        scores.append({"candidate": name, "score": round(float(score), 6)})
        if score > best_score:
            best, best_score, best_name = fit, score, name
    prov["calibration"] = scores
    prov["chosen"] = best_name
    return best, prov


# ---------------------------------------------------------------------------
# Deterministic fit JSON
# ---------------------------------------------------------------------------

def fit_to_json(fit, provenance: Dict[str, Any]) -> str:
    """Serialize ``(KroneckerFit, provenance)`` deterministically: sorted
    keys, ``indent=1``, repr floats — identical stats in ⇒ identical
    bytes out (the round-trip/ordering contract, and the JAX package's
    bytes)."""
    payload = {"fit": dataclasses.asdict(fit), "provenance": provenance}
    return json.dumps(payload, sort_keys=True, indent=1)


def fit_from_json(text: str):
    """Inverse of :func:`fit_to_json` → ``(KroneckerFit, provenance)``."""
    from repro_torch.core.structure import KroneckerFit
    d = json.loads(text)
    return KroneckerFit(**d["fit"]), d.get("provenance", {})
