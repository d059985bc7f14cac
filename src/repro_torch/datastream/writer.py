"""Sharded on-disk edge/feature store + the double-buffered write pump.

Layout of a dataset directory::

    manifest.json                  # provenance + per-shard records
    shard-00000.src.npy            # (n_edges,) int32/int64 source ids
    shard-00000.dst.npy            # (n_edges,) destination ids
    shard-00000.cont.npy           # optional (n_edges, n_cont) float32
    shard-00000.cat.npy            # optional (n_edges, n_cat) int32

Shard files are plain ``.npy`` (fixed-record, mmap-able) written
atomically (tmp + ``os.replace``).  Progress durability is O(1) per
shard: each completion appends one JSON line to ``progress.jsonl`` (a
full manifest rewrite per shard would be O(n_shards²) at the scale this
subsystem targets); the manifest itself is compacted — rewritten
atomically and the journal truncated — every ``checkpoint_every`` shards
and at the end of a run.  ``Manifest.load`` replays any surviving
journal, so a killed job loses at most the shard in flight.
``pump_chunks`` is the double-buffered device→host loop: chunk *i+1* is
launched on the card while chunk *i* is copied to pinned host memory on a
side stream and flushed, overlapping generation with host I/O.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import re
import threading
import time
import zlib
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.sinks import iter_events
from repro_torch.obs.trace import NULL_TRACER

MANIFEST_NAME = "manifest.json"
JOURNAL_NAME = "progress.jsonl"
FORMAT_VERSION = 1

#: per-worker journal files of a multi-process run: worker *k* appends
#: its shard completions to ``journal.w{k}.jsonl`` so N processes never
#: contend on one append stream; ``Manifest.load`` replays every worker
#: journal alongside ``progress.jsonl`` and a coordinator folds them into
#: the one authoritative manifest via ``Manifest.merge_worker_journals``.
#: The format is the JAX package's, byte for byte.
_WORKER_JOURNAL_RE = re.compile(r"^journal\.w(\d+)\.jsonl$")


def worker_journal_name(worker_id: int) -> str:
    return f"journal.w{int(worker_id)}.jsonl"


def worker_journal_paths(out_dir: str) -> List[str]:
    """Existing per-worker journals under ``out_dir``, sorted by worker
    id (numeric, so w10 sorts after w2)."""
    try:
        names = os.listdir(out_dir)
    except OSError:
        return []
    found = []
    for name in names:
        m = _WORKER_JOURNAL_RE.match(name)
        if m:
            found.append((int(m.group(1)), os.path.join(out_dir, name)))
    return [p for _, p in sorted(found)]

#: block size (rows) for streamed CRC of on-disk shards — deep verify
#: touches one block at a time, so re-hashing a >RAM dataset stays
#: bounded-memory.  crc32 chains across consecutive blocks, so the
#: streamed digest is bit-identical to the one-shot digest.
CRC_BLOCK_ROWS = 1 << 20


def _crc32_stream(arr: np.ndarray,
                  block_rows: Optional[int] = None) -> int:
    """crc32 of ``arr`` computed ``block_rows`` rows at a time.  For a
    memory-mapped array only one block is ever resident, so deep verify
    of arbitrarily large shards never materializes a full column."""
    block = block_rows or CRC_BLOCK_ROWS
    crc = 0
    for i in range(0, max(len(arr), 1), block):
        chunk = np.ascontiguousarray(arr[i: i + block])
        crc = zlib.crc32(chunk.tobytes(), crc)
    return crc & 0xFFFFFFFF


def _atomic_write_bytes(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


#: bytes written (and CRC'd) per block by the fused save+checksum pass
SAVE_BLOCK_BYTES = 1 << 23


def _atomic_save_npy_crc(path: str, arr: np.ndarray,
                         block_bytes: int = SAVE_BLOCK_BYTES) -> int:
    """Atomically write ``arr`` as ``.npy`` AND return the crc32 of its
    data bytes, in one streamed pass over the buffer.

    The header is written exactly as ``np.save`` writes it (format 1.0),
    then the array's own buffer is fed block-by-block to both the file
    and the chained crc — the file ``np.save`` writes, the digest
    ``zlib.crc32`` of ``tobytes()`` gives (crc32 chains across blocks),
    and no staging copy that would hold the GIL against the struct
    stage.
    """
    arr = np.ascontiguousarray(arr)
    tmp = path + ".tmp"
    crc = 0
    with open(tmp, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, np.lib.format.header_data_from_array_1_0(arr))
        mv = memoryview(arr).cast("B")
        for off in range(0, max(len(mv), 1), block_bytes):
            block = mv[off: off + block_bytes]
            f.write(block)
            crc = zlib.crc32(block, crc)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return crc & 0xFFFFFFFF


@dataclasses.dataclass
class ShardRecord:
    shard_id: int
    stem: str
    chunk_indices: List[int]
    n_edges: int
    worker: int = 0
    status: str = "pending"            # pending | done
    files: Dict[str, str] = dataclasses.field(default_factory=dict)
    crc32: Dict[str, int] = dataclasses.field(default_factory=dict)
    src_range: Optional[List[int]] = None     # [min, max] observed
    dst_range: Optional[List[int]] = None

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ShardRecord":
        return cls(**d)


def _iter_journal_records(path: str) -> Iterable["ShardRecord"]:
    """Parse one journal file into ``ShardRecord``s with the
    ``load_events`` partial-write policy: blank, torn and corrupt lines
    (including a record whose JSON parses but whose fields don't form a
    ShardRecord) are skipped, never raised on — a SIGKILL mid-append
    must cost at most the record in flight."""
    if not os.path.exists(path):
        return
    for d in iter_events(path):
        try:
            yield ShardRecord.from_json(d)
        except TypeError:
            continue        # valid JSON dict, but not a shard record


@dataclasses.dataclass
class Manifest:
    """Self-describing dataset index: fit provenance + shard records."""
    fit: dict                           # KroneckerFit fields
    seed: int
    k_pref: int
    shard_edges: int
    num_workers: int
    dtype: str                          # edge id dtype, e.g. "int32"
    total_edges: int
    n_src: int
    n_dst: int
    bipartite: bool
    theta: List[List[float]]            # per-level θ actually used
    theta_digest: str
    mode: str = "chunks"                # chunks | device_steps
    backend: Optional[str] = None       # PRNG stream marker: sampler
                                        # backend name (chunks mode) or
                                        # the device stream tag; resume
                                        # validates it (streams differ)
    n_dev: Optional[int] = None         # device_steps: mesh size the
                                        # step seeds/shapes depend on
    features: Optional[dict] = None     # {"n_cont": int, "cat_cards": [...]}
    executor: Optional[dict] = None     # {"pipeline_depth", "host_workers"}
                                        # — provenance only: the executor
                                        # is byte-transparent, so resume
                                        # does NOT validate these knobs
    shards: List[ShardRecord] = dataclasses.field(default_factory=list)
    version: int = FORMAT_VERSION

    # -- (de)serialization -------------------------------------------------
    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["shards"] = [s.to_json() for s in self.shards]
        return d

    @classmethod
    def from_json(cls, d: dict) -> "Manifest":
        d = dict(d)
        d["shards"] = [ShardRecord.from_json(s) for s in d.get("shards", [])]
        return cls(**d)

    def save(self, out_dir: str) -> None:
        payload = json.dumps(self.to_json(), indent=1).encode()
        _atomic_write_bytes(os.path.join(out_dir, MANIFEST_NAME), payload)

    @classmethod
    def load(cls, out_dir: str) -> "Manifest":
        path = os.path.join(out_dir, MANIFEST_NAME)
        with open(path, "rb") as f:
            manifest = cls.from_json(json.loads(f.read().decode()))
        manifest._replay_journal(out_dir)
        return manifest

    def _replay_journal(self, out_dir: str) -> None:
        """Apply per-shard completion records journaled since the last
        manifest compaction — from ``progress.jsonl`` and from every
        per-worker ``journal.w{k}.jsonl`` a multi-process run left
        behind.  Line parsing goes through ``repro_torch.obs.sinks``'s
        torn-line-tolerant iterator (the same partial-write policy as
        ``JsonlSink.load_events``): a torn final line (crash mid-append)
        is skipped, never raised on; replaying already-compacted records
        is idempotent."""
        for path in ([os.path.join(out_dir, JOURNAL_NAME)]
                     + worker_journal_paths(out_dir)):
            for rec in _iter_journal_records(path):
                self._apply_record(rec)

    def _apply_record(self, rec: "ShardRecord") -> bool:
        """Adopt one journaled completion record if it names a planned
        shard (id in range, stem matches — stale records from an
        unrelated plan are ignored)."""
        if 0 <= rec.shard_id < len(self.shards) and \
                self.shards[rec.shard_id].stem == rec.stem:
            self.shards[rec.shard_id] = rec
            return True
        return False

    def merge_worker_journals(self, out_dir: str) -> Dict[str, Dict[str, int]]:
        """Fold every per-worker journal into this manifest — the
        coordinator's merge step after a round of worker processes.

        Unlike the last-wins replay in ``load``, the merge is *strict*:
        a shard committed by two **different** worker journals means the
        stripes overlapped (two processes generated — and raced writing
        — the same shard files), which is a coordination bug, so it
        raises instead of silently keeping either record.  Re-reading a
        journal whose records were already compacted into the manifest
        is idempotent.  Returns per-journal stats
        ``{journal_name: {"shards": n, "edges": n}}``.
        """
        owner: Dict[int, str] = {}
        stats: Dict[str, Dict[str, int]] = {}
        for path in worker_journal_paths(out_dir):
            name = os.path.basename(path)
            st = stats[name] = {"shards": 0, "edges": 0}
            for rec in _iter_journal_records(path):
                if not (0 <= rec.shard_id < len(self.shards)
                        and self.shards[rec.shard_id].stem == rec.stem):
                    continue
                prev = owner.get(rec.shard_id)
                if prev is not None and prev != name:
                    raise ValueError(
                        f"shard {rec.shard_id} ({rec.stem}) was committed "
                        f"by both {prev} and {name} — worker stripes "
                        f"overlapped; refusing to merge")
                owner[rec.shard_id] = name
                if rec.status == "done":
                    self.shards[rec.shard_id] = rec
                    st["shards"] += 1
                    st["edges"] += rec.n_edges
        return stats

    @staticmethod
    def exists(out_dir: str) -> bool:
        return os.path.exists(os.path.join(out_dir, MANIFEST_NAME))

    # -- progress ----------------------------------------------------------
    def record(self, shard_id: int) -> ShardRecord:
        return self.shards[shard_id]

    def done_ids(self) -> List[int]:
        return [s.shard_id for s in self.shards if s.status == "done"]

    def is_complete(self) -> bool:
        return bool(self.shards) and all(s.status == "done"
                                         for s in self.shards)

    def done_edges(self) -> int:
        return sum(s.n_edges for s in self.shards if s.status == "done")


class ShardWriter:
    """Atomic per-shard column writes + O(1)-per-shard progress journal.

    ``tracer``/``metrics`` (``repro_torch.obs``) instrument the write path:
    every committed shard is one ``write`` span (journal fsync as a
    ``write.journal`` sub-span) and updates the rows/bytes counters and
    the per-shard write-duration histogram.  Both default to the no-op
    implementations; the executor adopts the writer into its own
    tracer/registry so one run reports through one pipeline-wide set.
    """

    COLUMNS = ("src", "dst", "cont", "cat")

    def __init__(self, out_dir: str, manifest: Manifest,
                 checkpoint_every: int = 256, tracer=None, metrics=None,
                 journal_name: str = JOURNAL_NAME, compact: bool = True):
        self.out_dir = out_dir
        self.manifest = manifest
        self.checkpoint_every = checkpoint_every
        # None = "unset": the executor (or DatasetJob) adopts the writer
        # into the run's tracer/registry; standalone use lazily creates
        # a private registry on first write.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics
        # multi-process worker mode: each worker appends to its own
        # journal (journal.w{k}.jsonl) and never rewrites manifest.json —
        # the coordinator owns compaction, so concurrent workers can't
        # race on the manifest.  compact=False makes checkpoint() a
        # no-op; the journal is the worker's only durable output.
        self.journal_name = str(journal_name)
        self.compact = bool(compact)
        self._since_checkpoint = 0
        os.makedirs(out_dir, exist_ok=True)

    @property
    def journal_path(self) -> str:
        return os.path.join(self.out_dir, self.journal_name)

    def _metrics(self) -> MetricsRegistry:
        if self.metrics is None:
            self.metrics = MetricsRegistry()
        return self.metrics

    def _journal(self, rec: ShardRecord) -> None:
        with self.tracer.span("write.journal", shard=rec.shard_id):
            with open(self.journal_path, "ab") as f:
                f.write(json.dumps(rec.to_json()).encode() + b"\n")
                f.flush()
                os.fsync(f.fileno())

    def checkpoint(self) -> None:
        """Compact: persist the full manifest and truncate the journal
        (whose records it now subsumes).  A ``compact=False`` worker
        writer no-ops — only the cluster coordinator may rewrite
        ``manifest.json``, and truncating the worker journal would throw
        away its durability."""
        if not self.compact:
            self._since_checkpoint = 0
            return
        with self.tracer.span("write.checkpoint",
                              shards=len(self.manifest.shards)):
            self.manifest.save(self.out_dir)
            if os.path.exists(self.journal_path):
                os.truncate(self.journal_path, 0)
            self._since_checkpoint = 0

    def write_shard(self, shard_id: int,
                    arrays: Dict[str, np.ndarray]) -> ShardRecord:
        """Write all columns of one shard, then checkpoint the manifest.

        ``arrays`` maps column name ('src'/'dst'/'cont'/'cat') → host array;
        'src' and 'dst' are required and must agree in length.
        """
        rec = self.manifest.record(shard_id)
        src, dst = arrays["src"], arrays["dst"]
        if len(src) != rec.n_edges or len(dst) != rec.n_edges:
            raise ValueError(f"shard {shard_id}: got {len(src)} edges, "
                             f"plan says {rec.n_edges}")
        n_bytes = 0
        with self.tracer.span("write", shard=shard_id) as sp:
            rec.files, rec.crc32 = {}, {}
            for col in self.COLUMNS:
                arr = arrays.get(col)
                if arr is None:
                    continue
                arr = np.asarray(arr)
                fname = f"{rec.stem}.{col}.npy"
                # fused save+crc: one pass over the column, no staging
                # copy — the file np.save writes, the digest zlib.crc32 gives
                rec.crc32[col] = _atomic_save_npy_crc(
                    os.path.join(self.out_dir, fname), arr)
                rec.files[col] = fname
                n_bytes += arr.nbytes
            rec.src_range = ([int(src.min()), int(src.max())]
                             if len(src) else None)
            rec.dst_range = ([int(dst.min()), int(dst.max())]
                             if len(dst) else None)
            rec.status = "done"
            self._journal(rec)
        m = self._metrics()
        m.counter("writer.rows_written", "rows").inc(rec.n_edges)
        m.counter("writer.bytes_flushed", "bytes").inc(n_bytes)
        m.counter("writer.shards_committed", "shards").inc()
        m.histogram("writer.shard_write_s", "s").observe(sp.dur)
        self._since_checkpoint += 1
        if self._since_checkpoint >= self.checkpoint_every:
            self.checkpoint()
        return rec

    def shard_ok_on_disk(self, rec: ShardRecord, deep: bool = False) -> bool:
        """Cheap (existence + row count) or deep (crc32) check of a shard
        previously marked done — used before skipping it on resume.  The
        deep CRC streams the memory-mapped column in blocks
        (``CRC_BLOCK_ROWS``), so deep-verifying a >RAM dataset never
        materializes a full shard."""
        if rec.status != "done" or not rec.files:
            return False
        for col, fname in rec.files.items():
            path = os.path.join(self.out_dir, fname)
            if not os.path.exists(path):
                return False
            try:
                arr = np.load(path, mmap_mode="r")
            except (ValueError, OSError):
                return False
            if arr.shape[0] != rec.n_edges:
                return False
            if deep and _crc32_stream(arr) != rec.crc32.get(col):
                return False
        return True

    def async_flush(self, depth: int = 2) -> "AsyncFlushQueue":
        """A bounded in-order write queue on a dedicated flush thread —
        the executor's IO stage.  Ordering/journal/checkpoint behaviour
        is exactly ``write_shard`` called serially in submission order."""
        return AsyncFlushQueue(self, depth)


class AsyncFlushQueue:
    """Single-threaded, in-order, bounded shard flush.

    ``submit`` blocks when ``depth`` shards are already queued
    (backpressure — measured as a ``stall.write`` span plus the
    ``writer.backpressure_stalls`` counter); the flush thread runs
    ``writer.write_shard`` in FIFO order, so journal appends and
    manifest compaction points are identical to the serial loop.  After
    a write failure the queue stops writing (later shards are drained
    unwritten — the journal stays a clean prefix) and ``submit``/
    ``close`` re-raise the error.  ``busy_s`` accumulates write-stage
    busy time for overlap reporting; per-shard submit→committed latency
    lands in the ``writer.commit_latency_s`` histogram (p50/p95/p99).
    """

    def __init__(self, writer: "ShardWriter", depth: int = 2):
        self.writer = writer
        self.busy_s = 0.0
        self._q: queue.Queue = queue.Queue(maxsize=max(1, int(depth)))
        self._err: Optional[BaseException] = None
        writer._metrics()        # materialize before the thread races us
        self._thread = threading.Thread(target=self._loop,
                                        name="shard-flush", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        latency = self.writer._metrics().histogram(
            "writer.commit_latency_s", "s")
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._err is not None:
                    continue        # drain, but keep the journal a prefix
                shard_id, arrays, t_submit = item
                t0 = time.perf_counter()
                try:
                    self.writer.write_shard(shard_id, arrays)
                    latency.observe(time.perf_counter() - t_submit)
                except BaseException as e:   # noqa: BLE001 — carried over
                    self._err = e
                finally:
                    self.busy_s += time.perf_counter() - t0
            finally:
                self._q.task_done()

    def submit(self, shard_id: int, arrays: Dict[str, np.ndarray]) -> None:
        if self._err is not None:
            raise RuntimeError(
                f"shard flush thread failed on an earlier shard: "
                f"{self._err!r}") from self._err
        metrics = self.writer._metrics()
        item = (shard_id, arrays, time.perf_counter())
        try:
            self._q.put_nowait(item)
        except queue.Full:
            # the writer is the bottleneck right now: record how long
            # the pipeline stalled waiting for a queue slot
            metrics.counter("writer.backpressure_stalls", "stalls").inc()
            with self.writer.tracer.span("stall.write", shard=shard_id):
                self._q.put(item)
        metrics.gauge("writer.queue_depth", "shards").set(self._q.qsize())

    def close(self) -> None:
        """Drain the queue, join the flush thread, re-raise any write
        error.  Idempotent."""
        if self._thread.is_alive():
            self._q.put(None)
            self._thread.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError(
                f"shard flush failed: {err!r}") from err


def _start_copy(bufs, side: Optional[torch.cuda.Stream]):
    """Queue the device→host copies of ``bufs`` (a tensor, ``None`` or
    nested tuples of them): each CUDA tensor lands in pinned host
    memory through ``copy_(non_blocking=True)`` on ``side``, which first
    waits on an event recorded after the launches that made it.  Returns
    ``(host_bufs, done_event_or_None, bufs)``; ``bufs`` stays referenced
    until the copy is waited on, so its memory is not reused early."""
    if side is None:
        return bufs, None, None
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(side.device))
    side.wait_event(ready)

    def copy(x):
        if isinstance(x, torch.Tensor) and x.device.type == "cuda":
            host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            host.copy_(x, non_blocking=True)
            return host
        if isinstance(x, tuple):         # plain tuples and IdParts
            vals = [copy(v) for v in x]
            return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
        return x

    with torch.cuda.stream(side):
        host = copy(bufs)
        done = torch.cuda.Event()
        done.record()
    return host, done, bufs


def _finish_copy(pending):
    """Wait for a ``_start_copy`` and return its host buffers."""
    host, done, _ = pending
    if done is not None:
        done.synchronize()
    return host


def _side_stream(work_device) -> Optional[torch.cuda.Stream]:
    if work_device is None or torch.device(work_device).type != "cuda":
        return None
    return torch.cuda.Stream(device=work_device)


def pump_chunks(work: Iterable, dispatch: Callable, flush: Callable,
                double_buffered: bool = True, device=None) -> int:
    """Double-buffered device→host pump.

    ``dispatch(item)`` launches device generation for one chunk and
    returns its (not yet materialized) device buffers; ``flush(item,
    host)`` consumes their host copies.  With double buffering, the copy
    of chunk *i* is queued on a side stream behind an event recorded
    after its launches, chunk *i+1* is launched, and only then does the
    host wait for chunk *i*'s copy and flush it — so the card samples
    chunk *i+1* while chunk *i* crosses to pinned host memory and is
    flushed.  ``double_buffered=False`` is the serial baseline: copy and
    flush each chunk before launching the next.  ``device`` names the
    card the buffers live on; for CPU buffers (``None`` or a CPU device)
    the copy is the identity.  Returns #items pumped."""
    side = _side_stream(device)
    n = 0
    prev = None
    for item in work:
        bufs = dispatch(item)
        pending = _start_copy(bufs, side)
        if not double_buffered:
            flush(item, _finish_copy(pending))
            n += 1
            continue
        if prev is not None:
            flush(prev[0], _finish_copy(prev[1]))
            n += 1
        prev = (item, pending)
    if prev is not None:
        flush(prev[0], _finish_copy(prev[1]))
        n += 1
    return n
