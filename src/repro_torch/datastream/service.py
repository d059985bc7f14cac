"""The ``DatasetJob`` API: plan → run → resume → verify.

A thin planner/facade over the focused layers of the subsystem:

* ``repro_torch.datastream.source`` — ``ShardSource``: one shard's
  structure (and ``FeatureSpec``: its features) as a pure function of
  ``(fit, seed, shard_id)``.  Two sources exist: ``ChunkShardSource``
  (``mode="chunks"``, θ-weighted chunk plan — full distributional
  fidelity) and ``DeviceStepShardSource`` (``mode="device_steps"``,
  step-indexed seeds on one card).
* ``repro_torch.datastream.executor`` — ``ShardExecutor``: the staged
  pipeline overlapping struct sampling on the card, the feature draw and
  alignment, and the writer's flush (``pipeline_depth=0`` is the exact
  serial loop; output is byte-identical either way).
* ``repro_torch.datastream.writer`` / ``scheduler`` — durable sharded
  store + deterministic chunk→shard planning.

``DatasetJob`` owns planning (manifest + provenance), resume validation
(refusing configs whose PRNG streams differ) and stitches
source+executor+writer together.  Resuming a killed job regenerates only
the missing shards, byte-identical to an uninterrupted run.

The manifest is the JAX package's format, and its ``backend`` is the
*stream* the job's sampler reproduces (``reference`` writes ``"xla"``,
``cuda_bits``/``cuda_prng`` write ``"pallas_bits"``, ``device_steps``
``"device_descend_v2"``): a struct-only dataset from either package is
resumed and verified by the other.  A featured dataset records the
port's feature stream markers, so it never resumes across packages.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.descend import check_id_capacity, default_id_dtype
from repro_torch.core.distributed_gen import N_DEV
from repro_torch.core.sampler import resolve_backend
from repro_torch.core.structure import KroneckerFit
from repro_torch.datastream.executor import ShardExecutor
from repro_torch.datastream.reader import ShardedGraphDataset
from repro_torch.datastream.scheduler import ChunkScheduler
from repro_torch.datastream.source import (ChunkShardSource,
                                           DeviceStepShardSource,
                                           FeatureSpec, ShardSource)
from repro_torch.datastream.writer import (Manifest, ShardRecord,
                                           ShardWriter, worker_journal_name)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.utils import accepts_kwarg

__all__ = ["DatasetJob", "FeatureSpec"]

#: stream marker recorded for device_steps manifests — the JAX package's
#: (its steps draw all L level keys with one split), which a single-card
#: step reproduces; a resume across a stream change must refuse.
_DEVICE_STREAM = "device_descend_v2"


def _edge_dtype(fit: KroneckerFit, id_dtype=None):
    """Auto int32/int64 by fit size, or validate an explicit request;
    returns a numpy dtype (the manifest's and the shard files').

    int64 ids are sampled as the engine's (hi, lo) int32 word pair and
    combined on the host."""
    bits = max(fit.n, fit.m)
    if id_dtype is None:
        dt = np.dtype(str(default_id_dtype(bits)).replace("torch.", ""))
    else:
        dt = np.dtype(str(id_dtype).replace("torch.", ""))
    check_id_capacity(bits, dt, "DatasetJob id space")
    return dt


class DatasetJob:
    """Resumable streaming materialization of one synthetic graph.

    ``pipeline_depth``/``host_workers`` configure the executor:
    ``pipeline_depth=0`` runs the serial loop, ``>=1`` overlaps device
    struct sampling with host feature decode and writer flush (at most
    ``pipeline_depth`` shards queued per stage — memory scales with it).
    Both knobs are provenance-recorded in the manifest but never
    validated on resume: the executor is byte-transparent, so any
    depth/worker combination regenerates identical shards.

    ``device`` is where the struct stage samples (``cuda`` by default; a
    job on a card that is not there fails at construction, before a
    manifest is written).  Features run on their generator's device."""

    def __init__(self, fit: KroneckerFit, out_dir: str,
                 shard_edges: int = 1 << 20, seed: int = 0,
                 k_pref: Optional[int] = None, num_workers: int = 1,
                 double_buffered: bool = True, mode: str = "chunks",
                 features: Optional[FeatureSpec] = None,
                 backend: Optional[str] = None, id_dtype=None,
                 pipeline_depth: int = 2, host_workers: int = 1,
                 fused: bool = False,
                 tracer: Optional[Tracer] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 device="cuda"):
        assert mode in ("chunks", "device_steps"), mode
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            # fail before a manifest lands on disk; no CPU fallback
            raise ValueError(f"device {device!r}: no CUDA card is visible "
                             "(pass device='cpu' to run on the CPU)")
        self.fit = fit
        self.out_dir = out_dir
        self.shard_edges = int(shard_edges)
        self.seed = int(seed)
        self.num_workers = int(num_workers)
        self.double_buffered = double_buffered
        self.mode = mode
        self.features = features
        # fused generation: the struct stage also draws the shard's
        # feature rows on the card (generators with a per-block draw).
        # Byte-transparent like the executor knobs — recorded as
        # provenance, never validated.
        self.fused = bool(fused)
        self.pipeline_depth = int(pipeline_depth)
        self.host_workers = int(host_workers)
        self.tracer = tracer
        self.metrics = metrics
        self.dtype = _edge_dtype(fit, id_dtype)
        # per-stage wall time of the last run() call (README "timings"):
        # busy seconds per stage plus wall_s/overlap from the executor,
        # all derived from the run's span aggregates (repro_torch.obs)
        self.timings: Dict[str, float] = {
            "gen_struct_s": 0.0, "gen_feat_s": 0.0, "gen_align_s": 0.0,
            "write_s": 0.0, "wall_s": 0.0, "overlap": 0.0,
            "stall_s": 0.0}
        # resolve the engine backend at plan time against the job's
        # device: the manifest records the stream it reproduces (streams
        # differ per backend, so a resume must not silently switch).
        # device_steps has its own sampling path — the marker names its
        # stream so a resume across stream-changing upgrades refuses.
        if mode == "device_steps":
            if backend not in (None, "auto"):
                raise ValueError(
                    "mode='device_steps' generates through "
                    "core.distributed_gen, not a sampler backend — "
                    f"drop backend={backend!r} or use mode='chunks'")
            self.sampler = None
            self.backend = _DEVICE_STREAM
        else:
            be = resolve_backend(backend, int(shard_edges), self.device)
            self.sampler = be.name
            self.backend = be.stream
        self.scheduler = ChunkScheduler(
            fit, shard_edges=self.shard_edges, k_pref=k_pref,
            num_workers=self.num_workers, seed=self.seed)
        self.k_pref = self.scheduler.k_pref
        self._source: Optional[ShardSource] = None
        self._by_worker: Optional[Dict[int, int]] = None

    # -- the shard source (structure generation) ---------------------------
    @property
    def source(self) -> ShardSource:
        """The mode's ``ShardSource``, built once per job."""
        if self._source is None:
            if self.mode == "chunks":
                self._source = ChunkShardSource(
                    self.scheduler, self.sampler, self.dtype,
                    double_buffered=self.double_buffered,
                    fused=self.fused, features=self.features,
                    seed=self.seed, feature_batch=self._feature_batch(),
                    device=self.device)
            else:
                self._source = DeviceStepShardSource(
                    self.fit, self.scheduler.thetas, self.shard_edges,
                    self.seed, self.dtype,
                    fused=self.fused, features=self.features,
                    feature_batch=self._feature_batch(),
                    device=self.device)
        return self._source

    def _feature_batch(self) -> Optional[int]:
        if self.features is None:
            return None
        return int(self.features.batch or self.shard_edges)

    def _features_meta(self) -> Optional[dict]:
        """Manifest record for the feature config.  When the generator or
        aligner runs through the batched engine, the resolved batch AND
        the device class are included: the per-block PRNG stream depends
        on the batch, and float sums depend on the device — a resume under
        either change would silently alter the feature bytes, so both are
        recorded and validated like backend/dtype.  ``device`` is the
        torch device type the features run on.

        Detection: an ``engine_batched`` class attribute when present
        (``GANFeatureGenerator``/``GBDTAligner`` set True,
        ``RandomAligner`` False); otherwise accepting ``batch=`` is taken
        as engine use.  Stream markers of the generator and the aligner
        (``generator_stream``/``aligner_stream``) name the port's float
        sums, which agree with the JAX package's only to a tolerance, so
        a featured dataset never resumes across packages."""
        if self.features is None:
            return None

        def engine_batched(obj, method):
            if obj is None:
                return False
            flag = getattr(obj, "engine_batched", None)
            if flag is not None:
                return bool(flag)
            return accepts_kwarg(getattr(obj, method), "batch")

        meta = self.features.describe()
        if engine_batched(self.features.generator, "sample") \
                or engine_batched(self.features.aligner, "align"):
            meta.update(batch=self._feature_batch(),
                        device=self.features.work_device.type)
        for key, obj in (("generator_stream", self.features.generator),
                         ("aligner_stream", self.features.aligner)):
            marker = getattr(obj, "stream_marker", None)
            if marker is not None:
                meta[key] = str(marker)
        return meta

    # -- plan --------------------------------------------------------------
    def plan(self, overwrite: bool = False) -> Manifest:
        """Build (and persist) the manifest with every shard pending."""
        if Manifest.exists(self.out_dir) and not overwrite:
            raise FileExistsError(
                f"{self.out_dir} already has a manifest — pass resume=True "
                "to DatasetJob.run (or overwrite=True to replan)")
        if self.mode == "chunks":
            shards = [ShardRecord(s.shard_id, s.stem,
                                  list(s.chunk_indices), s.n_edges,
                                  worker=s.worker)
                      for s in self.scheduler.shards]
        else:
            shards = self._device_step_records()
        manifest = Manifest(
            fit=dataclasses.asdict(self.fit), seed=self.seed,
            k_pref=self.k_pref, shard_edges=self.shard_edges,
            num_workers=self.num_workers,
            dtype=np.dtype(self.dtype).name,
            total_edges=self.fit.E, n_src=2 ** self.fit.n,
            n_dst=2 ** self.fit.m, bipartite=self.fit.bipartite,
            theta=[[float(x) for x in row] for row in self.scheduler.thetas],
            theta_digest=self.scheduler.theta_digest, mode=self.mode,
            backend=self.backend,
            n_dev=(N_DEV if self.mode == "device_steps" else None),
            features=self._features_meta(),
            executor={"pipeline_depth": self.pipeline_depth,
                      "host_workers": self.host_workers,
                      "fused": self.fused},
            shards=shards)
        os.makedirs(self.out_dir, exist_ok=True)
        manifest.save(self.out_dir)
        return manifest

    def _device_step_records(self) -> List[ShardRecord]:
        """Device-step shards stripe round-robin across the worker queues
        (every step costs the same mesh-wide step, so striping is also
        load-balanced).  The recorded ``worker`` is plan-time provenance;
        ``run(worker=)`` re-stripes with the running job's num_workers so
        resume can scale the process count up or down."""
        step_edges = self.shard_edges
        n_steps = max(1, math.ceil(self.fit.E / step_edges))
        recs = []
        left = self.fit.E
        for s in range(n_steps):
            n_e = min(step_edges, left)
            left -= n_e
            recs.append(ShardRecord(s, f"shard-{s:05d}", [], n_e,
                                    worker=s % self.num_workers))
        return recs

    # -- run / resume ------------------------------------------------------
    def _assigned_worker(self, rec: ShardRecord) -> int:
        """Worker-queue assignment of one shard under *this* job's
        num_workers (chunks: the scheduler's greedy least-loaded packing;
        device_steps: round-robin striping).  Deterministic, so N
        processes configured identically always compute disjoint,
        covering queues without coordination."""
        if self.mode == "chunks":
            if self._by_worker is None:
                self._by_worker = {s.shard_id: s.worker
                                   for s in self.scheduler.shards}
            return self._by_worker.get(rec.shard_id, 0)
        return rec.shard_id % self.num_workers

    def _pending_records(self, manifest: Manifest, writer: ShardWriter,
                         distrust: bool, worker: Optional[int],
                         max_shards: Optional[int]) -> List[ShardRecord]:
        if distrust:
            # distrust 'done' records whose files are missing/short
            for rec in manifest.shards:
                if rec.status == "done" and \
                        not writer.shard_ok_on_disk(rec):
                    rec.status = "pending"
        records = [rec for rec in manifest.shards
                   if rec.status != "done"
                   and (worker is None
                        or self._assigned_worker(rec) == worker)]
        if max_shards is not None:
            records = records[:max_shards]
        return records

    def _execute(self, records: List[ShardRecord],
                 writer: ShardWriter, checkpoint: bool = True) -> None:
        """Drive ``records`` through the staged executor; fold the run's
        span-derived stage timings into ``self.timings``.  ``checkpoint``
        compacts journal → manifest afterwards (workers of a
        multi-process run skip it — their journal IS the durable
        output and the coordinator owns the manifest)."""
        executor = ShardExecutor(
            self.source, writer, features=self.features, seed=self.seed,
            bipartite=self.fit.bipartite,
            feature_batch=self._feature_batch(),
            pipeline_depth=self.pipeline_depth,
            host_workers=self.host_workers,
            tracer=self.tracer, metrics=self.metrics)
        try:
            executor.run(records)
        finally:
            # the journal already holds every committed shard; compacting
            # here (even after a failure) just folds it into the manifest
            if checkpoint:
                writer.checkpoint()
            self.timings = {
                "gen_struct_s": executor.stats.struct_s,
                "gen_feat_s": executor.stats.feat_s,
                "gen_align_s": executor.stats.align_s,
                "write_s": executor.stats.write_s,
                "wall_s": executor.stats.wall_s,
                "overlap": executor.stats.overlap,
                "stall_s": executor.stats.stall_s}

    def run(self, resume: bool = False, max_shards: Optional[int] = None,
            worker: Optional[int] = None) -> Manifest:
        """Materialize pending shards through the executor.
        ``max_shards`` bounds this call (simulating preemption /
        incremental progress); ``worker`` restricts to one worker's queue
        so N processes can run disjoint shard sets."""
        if resume and Manifest.exists(self.out_dir):
            manifest = self._load_validated()
        else:
            manifest = self.plan(overwrite=resume)
        writer = ShardWriter(self.out_dir, manifest)
        # worker queues come from *this* job's configuration, not the
        # manifest: shard composition is num_workers-independent (chunks
        # pack first-fit, device steps stripe), so a resume may re-stripe
        # the remaining shards across a different --workers count — N
        # processes with worker=0..N-1 always cover disjoint queues.
        if worker is not None and not 0 <= worker < self.num_workers:
            raise ValueError(f"worker={worker} outside this job's "
                             f"0..{self.num_workers - 1} worker queues "
                             f"(num_workers={self.num_workers})")
        records = self._pending_records(manifest, writer, distrust=resume,
                                        worker=worker,
                                        max_shards=max_shards)
        self._execute(records, writer)
        return manifest

    def run_worker(self, worker_id: int,
                   max_shards: Optional[int] = None) -> Manifest:
        """Materialize one stripe of an **existing** plan — the building
        block of a multi-process run, one process per stripe.

        Differences from ``run(resume=True, worker=k)``: the plan must
        already exist (the coordinator plans exactly once), the
        manifest's recorded ``num_workers`` must equal this job's (a
        mismatch means the stripes of concurrently-running workers would
        overlap or starve), completions append to the per-worker journal
        ``journal.w{k}.jsonl`` instead of ``progress.jsonl``, and
        ``manifest.json`` is never rewritten — the coordinator merges
        worker journals into the authoritative manifest after the round.
        """
        worker_id = int(worker_id)
        if not Manifest.exists(self.out_dir):
            raise FileNotFoundError(
                f"{self.out_dir} has no manifest — a worker stripe runs "
                "an existing plan; the coordinator (or a plain run) "
                "plans first")
        manifest = self._load_validated()
        if manifest.num_workers != self.num_workers:
            raise ValueError(
                f"plan at {self.out_dir} is striped for "
                f"num_workers={manifest.num_workers} but this worker was "
                f"launched with num_workers={self.num_workers} — "
                f"concurrent stripes would overlap or starve; relaunch "
                f"with the plan's worker count")
        if not 0 <= worker_id < self.num_workers:
            raise ValueError(
                f"worker_id={worker_id} outside this plan's "
                f"0..{self.num_workers - 1} stripes")
        writer = ShardWriter(self.out_dir, manifest,
                             journal_name=worker_journal_name(worker_id),
                             compact=False)
        records = self._pending_records(manifest, writer, distrust=True,
                                        worker=worker_id,
                                        max_shards=max_shards)
        self._execute(records, writer, checkpoint=False)
        return manifest

    def resume(self, max_shards: Optional[int] = None,
               worker: Optional[int] = None) -> Manifest:
        return self.run(resume=True, max_shards=max_shards, worker=worker)

    def verify(self, deep: bool = True) -> List[str]:
        """Integrity report of what is on disk (empty list == sound)."""
        return ShardedGraphDataset(self.out_dir,
                                   allow_partial=True).verify(deep=deep)

    def dataset(self, **kwargs) -> ShardedGraphDataset:
        return ShardedGraphDataset(self.out_dir, **kwargs)

    # -- resume validation -------------------------------------------------
    def _load_validated(self) -> Manifest:
        manifest = Manifest.load(self.out_dir)
        if manifest.backend is None and manifest.mode == "chunks":
            # pre-engine manifest: its sample_chunk stream is bit-for-bit
            # the engine's "xla" backend, so those resumes stay legal
            manifest.backend = "xla"
        want = {"fit": dataclasses.asdict(self.fit), "seed": self.seed,
                "k_pref": self.k_pref, "shard_edges": self.shard_edges,
                "mode": self.mode,
                # PRNG streams differ per engine backend
                "backend": self.backend,
                # a resumed job must keep writing the planned id width
                "dtype": np.dtype(self.dtype).name,
                "theta_digest": self.scheduler.theta_digest,
                # step seeds and per-device shapes depend on mesh size
                "n_dev": (N_DEV if self.mode == "device_steps" else None),
                # a resumed job must produce the same columns per shard
                # (and, for batched generators, the same feature stream)
                "features": self._features_meta()}
        have = {k: getattr(manifest, k) for k in want}
        if have != want:
            diffs = {k: (have[k], want[k]) for k in want
                     if have[k] != want[k]}
            raise ValueError(
                f"manifest at {self.out_dir} was written by a different "
                f"job configuration; refusing to resume (mismatch: "
                f"{sorted(diffs)})")
        # executor knobs are byte-transparent provenance: refresh them to
        # this run's values so the compacted manifest reflects reality
        manifest.executor = {"pipeline_depth": self.pipeline_depth,
                             "host_workers": self.host_workers,
                             "fused": self.fused}
        return manifest
