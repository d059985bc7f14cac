"""Pipelined shard executor: overlapped struct / feature / IO stages.

The serial materialization loop pays ``struct + feat + align + write``
per shard — the device idles while the host decodes features and the
writer idles while the device samples.  ``ShardExecutor`` restructures
the loop into three overlapped stages with bounded queues:

    struct (device)   shard k+1   ── ShardSource.generate, the caller's
                                     thread
    host (features)   shard k     ── FeatureSpec draw + align, a pool of
                                     ``host_workers`` threads (their
                                     draws and alignment run on the card)
    write (IO)        shard k−1   ── ShardWriter async flush, one thread

Steady-state wall clock approaches ``max(struct, feat+align, write)``
instead of their sum.  Guarantees:

* **Byte identity with the serial path.**  Every shard is a pure
  function of ``(fit, seed, shard_id)`` (see ``source.py``), and commits
  happen strictly in record order through a single writer thread, so the
  shard files, the ``progress.jsonl`` journal (same order, same
  compaction points) and the manifest are byte-identical to
  ``pipeline_depth=0``.
* **Resume semantics unchanged.**  Only committed shards are journaled;
  a failure (or kill) mid-pipeline drops the queued-but-uncommitted
  suffix, leaving the journal a clean prefix that ``resume`` regrows.
* **Bounded memory.**  At most ``pipeline_depth`` shards wait between
  struct and host stages and ``pipeline_depth`` more in the write queue,
  so peak memory is ``O(pipeline_depth · shard_edges)`` columns — the
  knob trades memory for overlap (2 is enough to hide a balanced
  pipeline).

``pipeline_depth=0`` runs the exact serial loop (the golden baseline the
tests compare against).  Per-stage *busy* time is accumulated separately
from wall time so ``stats.overlap`` (busy/wall) reports how much the
stages actually overlapped: ~1.0 means serial behaviour, >1 means the
pipeline hid host or IO time behind the device.

All threads launch on the card through torch's current stream, the
device's default stream unless the caller set another, so the card runs
their work in launch order; the pool overlaps the host side of the
feature stage (launch overhead, numpy rank-matching noise, the copy to
the host) with the struct stage's launches and the writer's I/O.

Observability: the executor owns one ``repro_torch.obs`` tracer + metrics
registry per run (or adopts the ones ``DatasetJob`` passes in) and
threads them through the source, the feature spec and the writer, so
every stage reports into one timeline: ``struct`` spans on the calling
thread, ``feat``/``align`` spans on the host pool threads, ``write``
spans on the flush thread, ``stall.host``/``stall.write`` spans where
the pipeline blocked.  ``ExecutorStats`` is *derived from* those spans
(same keys and semantics as the ad-hoc timers it replaced); attach a
sink (``--trace``) and the identical numbers come with a replayable
event log.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.datastream.source import FeatureSpec, ShardSource, _host
from repro_torch.datastream.writer import ShardRecord, ShardWriter
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER, Tracer


@dataclasses.dataclass
class ExecutorStats:
    """Per-stage busy seconds vs wall seconds of one ``run`` call —
    derived from the run's ``struct``/``feat``/``align``/``write``
    span aggregates.  ``stall_s`` is the time the commit path spent
    blocked (waiting on a host feature future or a write-queue slot)."""
    n_shards: int = 0
    struct_s: float = 0.0
    feat_s: float = 0.0
    align_s: float = 0.0
    write_s: float = 0.0
    wall_s: float = 0.0
    stall_s: float = 0.0

    @property
    def busy_s(self) -> float:
        return self.struct_s + self.feat_s + self.align_s + self.write_s

    @property
    def overlap(self) -> float:
        """busy/wall — 1.0 ≈ serial, >1 means stages ran concurrently."""
        return self.busy_s / self.wall_s if self.wall_s > 0 else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {**dataclasses.asdict(self), "overlap": self.overlap}


class ShardExecutor:
    """Drive a ``ShardSource`` through the staged pipeline into a
    ``ShardWriter``.

    The struct stage runs on the calling thread (it owns the device);
    feature draw/alignment runs on ``host_workers`` pool threads (each
    shard's draw is an independent pure function of ``(seed, shard_id)``,
    so parallel shards stay deterministic); writes run on the writer's
    flush thread, strictly in record order.
    """

    def __init__(self, source: ShardSource, writer: ShardWriter,
                 features: Optional[FeatureSpec] = None, seed: int = 0,
                 bipartite: bool = False,
                 feature_batch: Optional[int] = None,
                 pipeline_depth: int = 2, host_workers: int = 1,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None):
        if pipeline_depth < 0:
            raise ValueError(f"pipeline_depth must be >= 0, "
                             f"got {pipeline_depth}")
        if host_workers < 1:
            raise ValueError(f"host_workers must be >= 1, "
                             f"got {host_workers}")
        self.source = source
        self.writer = writer
        self.features = features
        self.seed = int(seed)
        self.bipartite = bool(bipartite)
        self.feature_batch = feature_batch
        self.pipeline_depth = int(pipeline_depth)
        self.host_workers = int(host_workers)
        self.tracer = tracer if tracer is not None else Tracer()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.stats = ExecutorStats()
        self._adopt_obs()

    def _adopt_obs(self) -> None:
        """Point source/features/writer at this run's tracer + registry
        so every stage reports into one timeline.  Components already
        wired to a real tracer (e.g. by ``DatasetJob``, which passes the
        same one here) are left alone; duck-typed stand-ins without the
        attributes (test stubs) are skipped."""
        for obj in (self.source, self.features, self.writer):
            if obj is None:
                continue
            if getattr(obj, "tracer", "absent") in (None, NULL_TRACER):
                obj.tracer = self.tracer
            if getattr(obj, "metrics", "absent") is None:
                obj.metrics = self.metrics

    # -- stages ------------------------------------------------------------
    def _feature_task(self, rec: ShardRecord,
                      arrays: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if "cont" in arrays:
            # a fused source already drew the feature rows on the card in
            # the struct stage — the host stage shrinks to alignment (+
            # the final dtype casts)
            cont, cat = self.features.align_for_shard(
                self.seed, rec.shard_id, arrays["src"], arrays["dst"],
                arrays["cont"], arrays["cat"], self.bipartite,
                batch=self.feature_batch)
        else:
            cont, cat = self.features.sample_for_shard(
                self.seed, rec.shard_id, arrays["src"], arrays["dst"],
                self.bipartite, batch=self.feature_batch)
        arrays["cont"] = _host(cont, np.float32)
        arrays["cat"] = _host(cat, np.int32)
        return arrays

    def _feat_snapshot(self):
        if self.features is None:
            return (0.0, 0.0)
        # feat_s/align_s are written by pool threads under the spec's
        # lock; snapshot under the same lock so the pair is coherent
        # (duck-typed stubs without a _lock read bare).
        lock = getattr(self.features, "_lock", None)
        with (lock if lock is not None else contextlib.nullcontext()):
            return (self.features.feat_s, self.features.align_s)

    # -- serial baseline ---------------------------------------------------
    def _run_serial(self, records: Sequence[ShardRecord],
                    stats: ExecutorStats) -> None:
        for rec in records:
            with self.tracer.span("struct", shard=rec.shard_id):
                arrays = self.source.generate(rec)
            if self.features is not None:
                arrays = self._feature_task(rec, arrays)
            with self._write_span(rec.shard_id):
                self.writer.write_shard(rec.shard_id, arrays)
            stats.n_shards += 1

    def _write_span(self, shard_id: int):
        """Write-stage accounting: a real ``ShardWriter`` adopted into
        this run's tracer spans its own ``write_shard``, so the caller
        must not double-book; duck-typed writers without a tracer still
        get their time recorded under ``write`` via this outer span."""
        if getattr(self.writer, "tracer", None) is self.tracer:
            return contextlib.nullcontext()
        return self.tracer.span("write", shard=shard_id)

    # -- pipelined ---------------------------------------------------------
    def _run_pipelined(self, records: Sequence[ShardRecord],
                       stats: ExecutorStats) -> None:
        depth = self.pipeline_depth
        pool = (ThreadPoolExecutor(self.host_workers,
                                   thread_name_prefix="shard-feat")
                if self.features is not None else None)
        flush = self.writer.async_flush(depth=depth)
        stalls = self.metrics.counter("executor.host_stalls", "stalls")
        #: (rec, future|None, arrays) in record order; commits pop left
        pending: deque = deque()

        def commit_one() -> None:
            rec, fut, arrays = pending.popleft()
            if fut is not None:
                if not fut.done():
                    # the host stage is the bottleneck right now —
                    # record how long the commit path waited on it
                    stalls.inc()
                    with self.tracer.span("stall.host",
                                          shard=rec.shard_id):
                        arrays = fut.result()
                else:
                    arrays = fut.result()   # re-raises a host failure
            flush.submit(rec.shard_id, arrays)
            stats.n_shards += 1

        try:
            for rec in records:
                with self.tracer.span("struct", shard=rec.shard_id):
                    arrays = self.source.generate(rec)
                fut = (pool.submit(self._feature_task, rec, arrays)
                       if pool is not None else None)
                pending.append((rec, fut, arrays))
                while len(pending) > depth:
                    commit_one()
            while pending:
                commit_one()
        finally:
            # a failure drops the queued-but-uncommitted suffix: cancel
            # outstanding feature draws, drain writes already submitted
            # (in-order prefix), then surface the writer's error if any —
            # without masking an exception already propagating from the
            # struct or host stage.
            in_flight_exc = sys.exc_info()[1]
            for _, fut, _ in pending:
                if fut is not None:
                    fut.cancel()
            if pool is not None:
                pool.shutdown(wait=True)
            try:
                flush.close()
            except Exception as flush_err:
                if in_flight_exc is None:
                    raise
                # don't let the propagating struct/host failure bury the
                # write error (often the root cause, e.g. disk full)
                if hasattr(in_flight_exc, "add_note"):    # py3.11+
                    in_flight_exc.add_note(
                        f"the write stage also failed: {flush_err!r}")
                else:
                    print(f"warning: write stage also failed during "
                          f"pipeline teardown: {flush_err!r}",
                          file=sys.stderr)
            finally:
                if getattr(self.writer, "tracer", None) is not self.tracer:
                    # duck-typed writer that doesn't span itself — fall
                    # back to the flush queue's own busy accounting
                    stats.write_s += flush.busy_s

    # -- entry point -------------------------------------------------------
    _STAGE_TOTALS = ("struct", "write", "stall.host", "stall.write")

    def run(self, records: Sequence[ShardRecord]) -> ExecutorStats:
        """Materialize ``records`` (already filtered to pending work, in
        commit order).  Returns per-stage stats (derived from the run's
        span aggregates); also kept on ``self.stats``."""
        stats = ExecutorStats()
        feat0 = self._feat_snapshot()
        t0 = {k: self.tracer.total(k) for k in self._STAGE_TOTALS}
        t_wall = time.perf_counter()
        try:
            with self.tracer.span("run", n_shards=len(records),
                                  depth=self.pipeline_depth):
                if self.pipeline_depth == 0:
                    self._run_serial(records, stats)
                else:
                    self._run_pipelined(records, stats)
        finally:
            stats.wall_s = time.perf_counter() - t_wall
            delta = {k: self.tracer.total(k) - t0[k]
                     for k in self._STAGE_TOTALS}
            stats.struct_s = delta["struct"]
            stats.write_s += delta["write"]
            stats.stall_s = delta["stall.host"] + delta["stall.write"]
            feat1 = self._feat_snapshot()
            stats.feat_s = feat1[0] - feat0[0]
            stats.align_s = feat1[1] - feat0[1]
            self.stats = stats
        return stats
