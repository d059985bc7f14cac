"""``ShardSource``: one shard's structure as a pure function.

* ``ChunkShardSource`` — the θ-weighted chunk plan (``mode="chunks"``):
  one shard = a run of id-disjoint prefix chunks, sampled through a
  ``repro_torch.core.sampler`` backend on the job's device, launched in
  groups of chunks that are pumped double-buffered to the host
  (``writer.pump_chunks``).  Full
  distributional fidelity (every src/dst level is θ-distributed).
* ``DeviceStepShardSource`` — step-indexed generation
  (``mode="device_steps"``): one shard = one ``device_generate`` step
  with step-indexed seeds (paper App. 10's zero-collective design, on one
  card).

Either way ``generate(rec)`` is a pure function of
``(fit, seed, shard_id)`` — byte-identical on regeneration, which is
what makes kill/resume and the pipelined executor's equivalence with the
serial loop hold.  ``generate`` launches on the card: the executor calls
it from one thread, its struct stage.  The returned arrays are freshly
allocated host (numpy) arrays per shard; a fused source adds the shard's
feature rows as tensors on the features' device.

``FeatureSpec`` (the per-shard feature draw and alignment) lives here too:
the other pure per-shard function, run by the executor's host stage,
possibly from several worker threads at once (its stage timers
accumulate under a lock).  Its draws run on the generator's device; the
rows cross to the host as float32/int32 numpy only at the edge, for the
writer.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core.descend import (as_torch_dtype, check_id_capacity,
                                      combine_ids, narrow_ids)
from repro_torch.core.sampler import get_backend
from repro_torch.core.structure import KroneckerFit
from repro_torch.datastream.scheduler import ChunkScheduler
from repro_torch.datastream.writer import (ShardRecord, _finish_copy,
                                           _side_stream, _start_copy,
                                           pump_chunks)
from repro_torch.graph.ops import compact_subgraph
from repro_torch.obs import profile
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.utils import call_with_optional_kwargs

_FEATURE_SALT = 0xFEA7


def _host(x, dtype) -> np.ndarray:
    """A tensor (any device) or array as a host numpy array of ``dtype``."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


@dataclasses.dataclass
class FeatureSpec:
    """Per-shard feature generation: a *fitted* generator (+ optional
    fitted aligner).  Only edge features stream (node features would need
    cross-shard node identity; see ``reader.batches`` for training
    access).

    ``batch`` fixes the block size of the feature draw (GAN sample +
    decode, GBDT inference) — ``None`` lets the caller (``DatasetJob``)
    derive it from ``shard_edges``, so a row's block (and with it the
    GAN's batch statistics and per-block key) does not depend on where
    its shard ends.  ``feat_s``/``align_s`` accumulate wall time so the
    pipeline can report feature/align cost apart from structure; the
    executor's host stage may draw several shards concurrently, so the
    accumulation is lock-guarded.  The draws and the alignment run on
    ``device``; None means the generator's ``device`` (the CPU for
    generators without one).  A planner that holds the weights elsewhere
    than the workers that draw (the cluster coordinator) names the
    workers' device here, and the manifest records it."""
    generator: Any                      # .sample(rng, n) -> (cont, cat)
    aligner: Any = None                 # .align(g, cont, cat, rng)
    batch: Optional[int] = None
    device: Any = None
    feat_s: float = 0.0
    align_s: float = 0.0
    tracer: Any = NULL_TRACER           # set by the executor's _adopt_obs
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    @property
    def work_device(self) -> torch.device:
        if self.device is not None:
            return torch.device(self.device)
        return torch.device(getattr(self.generator, "device", "cpu"))

    def describe(self) -> dict:
        schema = getattr(self.generator, "schema", None)
        if schema is None:
            return {"n_cont": None, "cat_cards": None}
        return {"n_cont": int(schema.n_cont),
                "cat_cards": [int(c) for c in schema.cat_cards]}

    def _push_tracer(self) -> None:
        """Propagate this spec's tracer into the aligner.  Duck-typed
        aligners without the attribute are left alone."""
        if (self.aligner is not None
                and getattr(self.aligner, "tracer", None)
                is not self.tracer):
            try:
                self.aligner.tracer = self.tracer
            except AttributeError:
                pass

    def block_draw(self, batch: int):
        """The generator's per-block draw ``key → (cont, cat)`` (see
        ``GANFeatureGenerator.block_draw``), or ``None`` for generators
        without one — in which case the fused sources keep the staged
        host feature stage."""
        fn = getattr(self.generator, "block_draw", None)
        return fn(batch) if callable(fn) else None

    def feature_key_int(self, seed: int, shard_id: int) -> int:
        """The seed the staged path's ``generator.sample`` draws first for
        this shard — the fused draw consumes the same value so its
        feature stream matches byte for byte."""
        rng = np.random.default_rng([seed, _FEATURE_SALT, shard_id])
        return int(rng.integers(2 ** 63))

    def _align(self, shard_id, src, dst, cont, cat, bipartite, rng, b):
        """Align on the device, then bring the rows to the host inside
        the span, so the card's queued work is counted here."""
        t0 = time.perf_counter()
        with self.tracer.span("align", shard=shard_id) as sp:
            # id compaction is part of the alignment cost
            g_local = compact_subgraph(src, dst, bipartite,
                                       device=self.work_device)
            cont, cat = call_with_optional_kwargs(
                self.aligner.align, g_local, cont, cat, rng, batch=b)
            cont, cat = _host(cont, np.float32), _host(cat, np.int32)
        return cont, cat, sp.dur or (time.perf_counter() - t0)

    def sample_for_shard(self, seed: int, shard_id: int, src: np.ndarray,
                         dst: np.ndarray, bipartite: bool,
                         batch: Optional[int] = None):
        """Deterministic per-shard draw + shard-local alignment, returned
        as host float32/int32 arrays.

        Alignment uses structural features of the id-compacted shard
        subgraph (degrees/PageRank *within* the shard) — a bounded-memory
        approximation of the global §3.4 alignment.
        """
        self._push_tracer()
        rng = np.random.default_rng([seed, _FEATURE_SALT, shard_id])
        b = batch or self.batch
        # feat_s/align_s mirror the span durations; the perf_counter
        # fallback covers the NULL_TRACER case (span durations read 0)
        t0 = time.perf_counter()
        aligned = self.aligner is not None and len(src)
        with self.tracer.span("feat", shard=shard_id, rows=len(src)) as sp:
            cont, cat = call_with_optional_kwargs(self.generator.sample, rng,
                                                  len(src), batch=b)
            if not aligned:
                cont, cat = _host(cont, np.float32), _host(cat, np.int32)
        dt_feat = sp.dur or (time.perf_counter() - t0)
        dt_align = 0.0
        if aligned:
            cont, cat, dt_align = self._align(shard_id, src, dst, cont, cat,
                                              bipartite, rng, b)
        with self._lock:
            self.feat_s += dt_feat
            self.align_s += dt_align
        return cont, cat

    def align_for_shard(self, seed: int, shard_id: int, src: np.ndarray,
                        dst: np.ndarray, cont, cat, bipartite: bool,
                        batch: Optional[int] = None):
        """Host half of the *fused* path: the feature rows were already
        drawn on the card by the struct stage (which consumed the shard's
        ``feature_key_int`` seed), so this replays the staged rng stream
        up to the alignment draw — burning the generator's one
        ``integers(2**63)`` — and runs alignment only.  Byte-identical to
        ``sample_for_shard`` on the same shard."""
        self._push_tracer()
        rng = np.random.default_rng([seed, _FEATURE_SALT, shard_id])
        if len(src):
            rng.integers(2 ** 63)   # consumed by the fused draw
        b = batch or self.batch
        dt_align = 0.0
        if self.aligner is not None and len(src):
            cont, cat, dt_align = self._align(shard_id, src, dst, cont, cat,
                                              bipartite, rng, b)
        else:
            cont, cat = _host(cont, np.float32), _host(cat, np.int32)
        with self._lock:
            self.align_s += dt_align
        return cont, cat


class ShardSource:
    """Contract: ``generate(rec)`` → ``{"src": ..., "dst": ...}``, a pure
    function of the construction arguments and ``rec.shard_id`` /
    ``rec.chunk_indices``.  Single-threaded: the executor calls it from
    its struct stage only."""

    name = "base"
    #: replaced per-instance by the executor's ``_adopt_obs`` so struct
    #: sub-spans (dispatch/combine/device_step) land in the run timeline
    tracer = NULL_TRACER

    def generate(self, rec: ShardRecord) -> Dict[str, np.ndarray]:
        raise NotImplementedError


def _feature_plan(features: Optional[FeatureSpec],
                  feature_batch: Optional[int], n_rows: int):
    """(block_draw, batch, n_blocks) for a fused draw of ``n_rows`` rows —
    ``(None, 0, 0)`` without a generator that has a per-block draw."""
    if features is None or n_rows == 0:
        return None, 0, 0
    b = int(feature_batch or features.batch or n_rows)
    draw = features.block_draw(b)
    if draw is None:
        return None, 0, 0
    return draw, b, -(-n_rows // b)


def _fused_features(features: FeatureSpec, draw, n_blocks: int, seed: int,
                    shard_id: int, n_rows: int):
    """The staged ``generator.sample`` of one shard, block by block on the
    card: key ``PRNGKey(feature_key_int)``, block ``i`` on ``fold_in(key,
    i)``, trimmed to ``n_rows``.  The rows stay on the device."""
    key = trandom.PRNGKey(features.feature_key_int(seed, shard_id))
    conts, cats = [], []
    for i in range(n_blocks):
        c, k = draw(trandom.fold_in(key, i))
        conts.append(c)
        cats.append(k)
    return torch.cat(conts)[:n_rows], torch.cat(cats)[:n_rows]


#: the struct stage launches consecutive chunks into one device buffer
#: until it holds at least this many edges, and pumps such groups to the
#: host: each crossing costs an event, a pinned copy and a host wait (0.16–
#: 0.26 ms of host a crossing on an H100 80GB HBM3 at 700 W, phase 13(a)
#: of ``chip_smoke.py``), which chunks of ~10 000 edges would pay one by one
PUMP_GROUP_EDGES = 1 << 21


def _chunk_groups(chunks, min_edges: int):
    """Consecutive runs of ``chunks`` holding at least ``min_edges`` edges
    each (the last run may hold fewer)."""
    groups, cur, n = [], [], 0
    for ck in chunks:
        cur.append(ck)
        n += ck.n_edges
        if n >= min_edges:
            groups.append(cur)
            cur, n = [], 0
    if cur:
        groups.append(cur)
    return groups


class ChunkShardSource(ShardSource):
    """θ-weighted prefix-chunk sampling through the engine backend.

    ``backend`` is the port's backend name (``reference``/``cuda_bits``/
    ``cuda_prng``); every chunk is one call of it on ``device``.  Chunks
    are launched in groups of at least ``PUMP_GROUP_EDGES`` edges into one
    device buffer, and the groups are pumped double-buffered to the host
    (``writer.pump_chunks``): group *g*'s copy overlaps group *g+1*'s
    launches.

    ``fused=True`` also draws the shard's feature rows on the card in the
    struct stage, when ``features`` carries a generator with a per-block
    draw (``block_draw``), so raw feature draws do not round-trip through
    host numpy between the struct and feature stages.  No trace or compile
    is involved: it runs the feature stage's own eager calls (feature
    seed, block shapes and op order replayed exactly), so the emitted
    bytes are identical.
    """

    name = "chunks"

    def __init__(self, scheduler: ChunkScheduler, backend: str,
                 dtype, double_buffered: bool = True, fused: bool = False,
                 features: Optional[FeatureSpec] = None, seed: int = 0,
                 feature_batch: Optional[int] = None, device="cuda"):
        self.scheduler = scheduler
        self.fit: KroneckerFit = scheduler.fit
        self.backend = backend
        self.dtype = np.dtype(dtype)
        self.double_buffered = double_buffered
        self.fused = bool(fused)
        self.features = features
        self.seed = int(seed)
        self.feature_batch = feature_batch
        self.device = torch.device(device)
        self._suffix_dev = None
        if self.dtype.itemsize <= 4:
            # narrow ids take the prefix in the id word itself
            check_id_capacity(self.fit.n, self.dtype, "src prefix+level bits")
            check_id_capacity(self.fit.m, self.dtype, "dst prefix+level bits")

    def _suffix(self):
        """The suffix θ as a float32 tensor on the device (made once: a
        pageable upload per chunk would wait for the chunk before it) and
        the suffix level counts."""
        sched = self.scheduler
        if self._suffix_dev is None:
            self._suffix_dev = torch.as_tensor(
                np.asarray(sched.thetas)[sched.k_pref:], dtype=torch.float32,
                device=self.device).contiguous()
        return (self._suffix_dev, self.fit.n - sched.k_pref,
                self.fit.m - sched.k_pref)

    def _chunk_parts(self, ck):
        """The backend's id words of one chunk on the device: what
        ``rmat.sample_chunk`` samples before it finalizes the ids."""
        suffix, n_s, m_s = self._suffix()
        be = get_backend(self.backend)
        return be.sample_parts(self.scheduler.key_for(ck), suffix, n_s, m_s,
                               ck.n_edges, self.device)

    def _narrow_chunk(self, ck, tdt):
        """One narrow chunk's ids on the device: ``rmat.sample_chunk``'s
        trim, cast and prefix add."""
        _, n_s, m_s = self._suffix()
        sp, dp = self._chunk_parts(ck)
        return (narrow_ids(sp, ck.n_edges, tdt, ck.src_prefix, n_s),
                narrow_ids(dp, ck.n_edges, tdt, ck.dst_prefix, m_s))

    def _combine_chunk(self, ck, sparts, dparts, tdt):
        """One wide chunk's int64 ids from its (hi, lo) words on the host
        (the backend may pad past ``n_edges``)."""
        _, n_s, m_s = self._suffix()
        return (combine_ids(sparts, n_s, tdt, ck.src_prefix)[: ck.n_edges],
                combine_ids(dparts, m_s, tdt, ck.dst_prefix)[: ck.n_edges])

    def generate(self, rec: ShardRecord) -> Dict[str, np.ndarray]:
        """Double-buffered group loop into a preallocated shard buffer.

        Wide (int64) ids launch the backend's device-resident ``(hi, lo)``
        id words and combine them on the host in ``flush``."""
        sched = self.scheduler
        np_dtype = self.dtype
        tdt = as_torch_dtype(np_dtype)
        src_buf = np.empty(rec.n_edges, np_dtype)
        dst_buf = np.empty(rec.n_edges, np_dtype)
        chunks = [sched.chunk(i) for i in rec.chunk_indices]
        offsets = dict(zip(rec.chunk_indices,
                           np.cumsum([0] + [c.n_edges for c in chunks])))
        wide = np_dtype.itemsize > 4

        def dispatch(group):
            # the host span times the launches only (they are async on the
            # card); the profile range names the device-side work
            with self.tracer.span("struct.dispatch", chunk=group[0].index,
                                  chunks=len(group)):
                with profile.annotation("struct.dispatch"):
                    if wide:
                        parts = [self._chunk_parts(ck) for ck in group]
                        return (tuple(p[0] for p in parts),
                                tuple(p[1] for p in parts))
                    ids = [self._narrow_chunk(ck, tdt) for ck in group]
                    return (torch.cat([s for s, _ in ids]),
                            torch.cat([d for _, d in ids]))

        def flush(group, host):
            off = offsets[group[0].index]
            with self.tracer.span("struct.combine", chunk=group[0].index,
                                  chunks=len(group)):
                if not wide:
                    n = len(host[0])
                    src_buf[off: off + n] = host[0].numpy()
                    dst_buf[off: off + n] = host[1].numpy()
                    return
                for ck, sp, dp in zip(group, *host):
                    s, d = self._combine_chunk(ck, sp, dp, tdt)
                    src_buf[off: off + ck.n_edges] = s.numpy()
                    dst_buf[off: off + ck.n_edges] = d.numpy()
                    off += ck.n_edges

        pump_chunks(_chunk_groups(chunks, PUMP_GROUP_EDGES), dispatch, flush,
                    double_buffered=self.double_buffered, device=self.device)
        arrays = {"src": src_buf, "dst": dst_buf}
        draw, _, n_blocks = (_feature_plan(self.features,
                                           self.feature_batch, rec.n_edges)
                             if self.fused else (None, 0, 0))
        if n_blocks:
            with self.tracer.span("struct.fused", shard=rec.shard_id,
                                  feature_blocks=n_blocks):
                with profile.annotation("struct.fused"):
                    arrays["cont"], arrays["cat"] = _fused_features(
                        self.features, draw, n_blocks, self.seed,
                        rec.shard_id, rec.n_edges)
        return arrays


class DeviceStepShardSource(ShardSource):
    """One ``device_generate`` step == one shard; the step index (==
    shard id) seeds the step's stream, so any step can be regenerated in
    isolation.  The step spans ``mesh`` (a sequence of torch devices,
    e.g. ``distributed_gen.device_mesh``): each of its ``n_dev`` devices
    draws ``ceil(shard_edges / n_dev)`` edges under its own seed, its index
    the top ``log2(n_dev)`` src levels."""

    name = "device_steps"

    def __init__(self, fit: KroneckerFit, thetas: np.ndarray,
                 shard_edges: int, seed: int, dtype,
                 fused: bool = False,
                 features: Optional[FeatureSpec] = None,
                 feature_batch: Optional[int] = None, mesh=("cuda",)):
        from repro_torch.core.distributed_gen import mesh_bits
        self.fit = fit
        self.thetas = np.asarray(thetas)
        self.shard_edges = int(shard_edges)
        self.seed = int(seed)
        self.dtype = np.dtype(dtype)
        self.fused = bool(fused)
        self.features = features
        self.feature_batch = feature_batch
        self.mesh = list(mesh)
        self.n_dev = len(self.mesh)
        # the device index takes the top src levels
        self.n_loc = self.fit.n - mesh_bits(self.n_dev)

    def generate(self, rec: ShardRecord) -> Dict[str, np.ndarray]:
        from repro_torch.core.distributed_gen import (device_generate,
                                                      step_seeds)

        # full θ rows: the descend runs max(n_loc, m) levels (dst keeps
        # all m levels; only src loses its top levels to the prefix)
        epd = math.ceil(self.shard_edges / self.n_dev)
        draw, _, n_blocks = (_feature_plan(self.features,
                                           self.feature_batch, rec.n_edges)
                             if self.fused else (None, 0, 0))
        span = "struct.fused" if n_blocks else "struct.device_step"
        with self.tracer.span(span, shard=rec.shard_id):
            with profile.annotation(span):
                seeds = step_seeds(self.seed, rec.shard_id, self.n_dev)
                src, dst = device_generate(self.thetas, seeds, self.n_loc,
                                           self.fit.m, epd, mesh=self.mesh,
                                           dtype=as_torch_dtype(self.dtype))
                host = _finish_copy(_start_copy(
                    (src.reshape(-1)[: rec.n_edges],
                     dst.reshape(-1)[: rec.n_edges]),
                    _side_stream(src.device)))
                arrays = {"src": host[0].numpy(), "dst": host[1].numpy()}
                if n_blocks:
                    arrays["cont"], arrays["cat"] = _fused_features(
                        self.features, draw, n_blocks, self.seed,
                        rec.shard_id, rec.n_edges)
        return arrays
