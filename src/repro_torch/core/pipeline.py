"""The synthetic-graph pipeline (paper Fig. 1).

``SyntheticGraphPipeline`` wires the three components — structural
generator, feature generator, aligner — behind one fit/generate API::

    pipe = SyntheticGraphPipeline(noise=0.03, gan_steps=200)  # on "cuda"
    pipe.fit(graph, cont, cat)
    g_syn, cont_syn, cat_syn = pipe.generate(seed=0, scale_nodes=2)
    ds = pipe.generate_streamed("/data/ds", seed=0, scale_nodes=64)

or generates from a saved fit (``repro_torch.convert``, whose
``state_from_pipeline`` saves one)::

    pipe = repro_torch.convert.pipeline_from_state(state, device="cuda")

or refits from a dataset on disk, one pass over its shards
(``repro_torch.core.fit_engine``)::

    pipe = SyntheticGraphPipeline(noise=0.03).fit_streamed("/data/ds")

Component choices mirror the paper's ablation (Table 6):
struct ∈ {kronecker, sbm, er}, features ∈ {gan, kde, random},
aligner ∈ {xgboost, random}; each is built on the pipeline's device::

    pipe = SyntheticGraphPipeline(struct="er", features="random",
                                  aligner="random").fit(graph, cont, cat)

A fit gives the JAX package's structure, VGMs, SBM/ER, KDE and Random
state exactly and its GAN and forests to the tolerances stated in the
tests; the same seed gives the reference's edges bit for bit (SBM and ER
too), its KDE and Random rows bit for bit and its GAN features and GBDT
alignment to stated tolerances.  Streamed fitting and generation take the
kronecker structure only, as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core import rmat
from repro_torch.core.aligner import ALIGNERS, AlignerConfig, RandomAligner
from repro_torch.core.baselines import ERGenerator, SBMGenerator
from repro_torch.core.descend import default_id_dtype
from repro_torch.core.features import FEATURE_GENERATORS, GANFeatureGenerator
from repro_torch.core.structure import KroneckerFit, fit_structure
from repro_torch.graph.ops import Graph
from repro_torch.tabular.schema import TableSchema, infer_schema
from repro_torch.utils import call_with_optional_kwargs


@dataclasses.dataclass
class PipelineTimings:
    fit_struct_s: float = 0.0
    fit_feat_s: float = 0.0
    fit_align_s: float = 0.0
    gen_struct_s: float = 0.0
    gen_feat_s: float = 0.0
    gen_align_s: float = 0.0
    # streamed generation only: writer-stage busy time, end-to-end wall
    # time, busy/wall overlap factor (>1 ⇒ stages ran concurrently) and
    # how long the commit path sat blocked on the host/write stages
    gen_write_s: float = 0.0
    gen_wall_s: float = 0.0
    gen_overlap: float = 0.0
    gen_stall_s: float = 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SyntheticGraphPipeline:
    """Components by name, as in the paper's ablation (Table 6): struct
    "kronecker", "sbm" or "er"; features "gan", "kde" or "random"; aligner
    "xgboost" (or "gbdt") or "random"."""

    def __init__(self, struct: str = "kronecker", features: str = "gan",
                 aligner: str = "xgboost", noise: float = 0.0,
                 gan_steps: int = 300, feature_kind: str = "edge",
                 aligner_cfg: Optional[AlignerConfig] = None,
                 device="cuda"):
        self.struct_kind = struct
        self.feat_kind = features
        self.aligner_kind = aligner
        self.noise = noise
        self.gan_steps = gan_steps
        self.feature_kind = feature_kind
        self.aligner_cfg = aligner_cfg or AlignerConfig()
        self.device = torch.device(device)
        self.timings = PipelineTimings()

    @classmethod
    def fitted(cls, struct, features, aligner, bipartite: bool,
               feature_kind: str = "edge", device="cuda"
               ) -> "SyntheticGraphPipeline":
        """A pipeline from fitted components (``repro_torch.convert``, or
        the ablation's fit-once-and-recompose): a ``KroneckerFit``,
        ``SBMGenerator`` or ``ERGenerator``, one of ``FEATURE_GENERATORS``
        and an aligner; the kinds are read off their types."""
        struct_kind = {KroneckerFit: "kronecker", SBMGenerator: "sbm",
                       ERGenerator: "er"}[type(struct)]
        feat_kind = next(k for k, c in FEATURE_GENERATORS.items()
                         if isinstance(features, c))
        pipe = cls(struct=struct_kind, features=feat_kind,
                   aligner="random" if isinstance(aligner, RandomAligner)
                   else "xgboost", feature_kind=feature_kind, device=device)
        pipe.struct, pipe.features, pipe.aligner = struct, features, aligner
        pipe.schema = features.schema
        pipe.bipartite = bool(bipartite)
        return pipe

    def fit(self, g: Graph, cont: np.ndarray, cat: np.ndarray
            ) -> "SyntheticGraphPipeline":
        """Fit every component on ``g`` (moved to the pipeline's device)
        and its host feature table ``cont`` (E or N, n_cont) float32,
        ``cat`` int32.  Stage times land in ``self.timings``, each taken
        after a device synchronize."""
        dev = self.device
        g = Graph(g.src.to(dev), g.dst.to(dev), g.n_src, g.n_dst,
                  g.bipartite)
        cont, cat = np.asarray(cont), np.asarray(cat)
        self.schema = infer_schema(cont, cat)
        t0 = time.time()
        if self.struct_kind == "kronecker":
            self.struct = fit_structure(g, noise=self.noise)
        elif self.struct_kind == "sbm":
            self.struct = SBMGenerator(device=dev).fit(g)
        elif self.struct_kind == "er":
            self.struct = ERGenerator(device=dev).fit(g)
        else:
            raise ValueError(self.struct_kind)
        _sync(dev)
        self.timings.fit_struct_s = time.time() - t0

        t0 = time.time()
        gen_cls = FEATURE_GENERATORS[self.feat_kind]
        self.features = gen_cls(self.schema, device=dev).fit(
            cont, cat, steps=self.gan_steps)
        _sync(dev)
        self.timings.fit_feat_s = time.time() - t0

        t0 = time.time()
        al_cls = ALIGNERS[self.aligner_kind]
        self.aligner = al_cls(self.schema, kind=self.feature_kind) \
            if self.aligner_kind == "random" else \
            al_cls(self.schema, self.aligner_cfg, kind=self.feature_kind)
        self.aligner.fit(g, cont, cat)
        _sync(dev)
        self.timings.fit_align_s = time.time() - t0
        self.bipartite = g.bipartite
        return self

    def fit_streamed(self, source, sample_rows: int = 100_000,
                     chunk_rows: int = 1 << 20, kmax: int = 2048,
                     seed: int = 0, calibrate: bool = True,
                     stratified: bool = False, tracer=None
                     ) -> "SyntheticGraphPipeline":
        """Fit every component from a chunked ``(src, dst, cont, cat)``
        stream — a ``repro_torch.datastream`` dataset directory, a
        ``ShardedGraphDataset``, a ``FitSource``, or a ``Graph`` (with its
        table as ``(g, cont, cat)``) — without holding the graph or the
        table in memory.  A dataset written by :meth:`generate_streamed`
        refits from its manifest.  ``source`` may also be the
        ``fit_engine.StreamFitStats`` of an ``accumulate`` pass already
        made: the fit then reads its sketches and sample as they are, and
        ``sample_rows``, ``chunk_rows``, ``kmax``, ``seed`` and
        ``stratified`` go unused.

        Structure: one pass of ``fit_engine.accumulate`` on the pipeline's
        device (bit-pair MLE, degree sketches, the priority sample), then
        the MLE → Eq. 6 → calibration ladder of ``fit_structure``.
        Features and aligner: the VGM/GAN/GBDT fits on the order-invariant
        ``sample_rows``-row sample (``stratified=True`` caps each chunk's
        share); the aligner trains on the sample's id-compacted subgraph.
        Memory is bounded by ``chunk_rows`` plus the sample.

        Provenance (θ candidates, sketch digests, sample identity) lands
        in ``self.fit_provenance``: ``fit_engine.fit_to_json(pipe.struct,
        pipe.fit_provenance)`` is the JAX package's bytes and the same
        across chunk orderings.  Stage times land in ``self.timings``,
        each taken after a device synchronize."""
        from repro_torch.core import fit_engine
        from repro_torch.datastream.fitsource import as_fit_source
        from repro_torch.graph.ops import compact_subgraph
        from repro_torch.obs.trace import NULL_TRACER

        if self.struct_kind != "kronecker":
            raise ValueError("streamed fitting supports the kronecker "
                             f"structure generator, not {self.struct_kind}")
        tracer = tracer if tracer is not None else NULL_TRACER
        dev = self.device
        t0 = time.time()
        with tracer.span("fit.struct"):
            if isinstance(source, fit_engine.StreamFitStats):
                stats = source
            else:
                stats = fit_engine.accumulate(
                    as_fit_source(source, chunk_rows=chunk_rows),
                    sample_rows=sample_rows, seed=seed, kmax=kmax,
                    stratified=stratified, tracer=tracer, device=dev)
            self.struct, self.fit_provenance = \
                fit_engine.fit_structure_streamed(
                    stats, noise=self.noise, calibrate=calibrate,
                    device=dev)
        _sync(dev)
        self.timings.fit_struct_s = time.time() - t0

        sample = stats.sample
        n_rows = max(len(sample["rows"]), 1)
        cont_s = (sample["cont"] if sample["cont"] is not None
                  else np.zeros((n_rows, 0), np.float32))
        cat_s = (sample["cat"] if sample["cat"] is not None
                 else np.zeros((n_rows, 0), np.int32))
        # exact cardinalities from the full pass, not the sample — a
        # rare category missing from the sample must still be decodable
        self.schema = TableSchema(n_cont=stats.n_cont,
                                  cat_cards=stats.cat_cards)

        t0 = time.time()
        with tracer.span("fit.features"):
            # zero-width tables carry nothing to learn: skip the GAN steps
            steps = self.gan_steps if (stats.n_cont + len(stats.cat_cards)) \
                else 0
            gen_cls = FEATURE_GENERATORS[self.feat_kind]
            self.features = gen_cls(self.schema, device=dev).fit(
                cont_s, cat_s, steps=steps)
            _sync(dev)
        self.timings.fit_feat_s = time.time() - t0

        t0 = time.time()
        with tracer.span("fit.align"):
            g_local = compact_subgraph(sample["src"], sample["dst"],
                                       stats.bipartite, device=dev)
            al_cls = ALIGNERS[self.aligner_kind]
            self.aligner = al_cls(self.schema, kind=self.feature_kind) \
                if self.aligner_kind == "random" else \
                al_cls(self.schema, self.aligner_cfg,
                       kind=self.feature_kind)
            self.aligner.fit(g_local, cont_s, cat_s)
            _sync(dev)
        self.timings.fit_align_s = time.time() - t0
        self.bipartite = stats.bipartite
        return self

    def generate(self, seed: int = 0, scale_nodes: int = 1,
                 density_preserving: bool = True, chunked: bool = False,
                 k_pref: int = 2, backend: Optional[str] = None,
                 id_dtype=None, feature_batch: Optional[int] = None
                 ) -> Tuple[Graph, torch.Tensor, torch.Tensor]:
        """``backend`` picks the ``repro_torch.core.sampler`` backend
        (None/'auto' = by device); ``id_dtype`` widens node ids (auto
        int32/int64 by fit size); ``feature_batch`` fixes the feature
        block size (None = the generator's default).  These three and
        ``chunked``/``k_pref`` apply to kronecker structure; SBM and ER
        draw ``scale_nodes`` times the nodes and ``scale_nodes**2`` (or,
        not density-preserving, ``scale_nodes``) times the edges.  The
        numpy rng is drawn from in the reference's order: structure,
        features, aligner.  Stage times land in ``self.timings``, each
        taken after a device synchronize."""
        dev = self.device
        rng = np.random.default_rng(seed)
        t0 = time.time()
        if self.struct_kind == "kronecker":
            key = trandom.PRNGKey(seed)
            backend = "auto" if backend is None else backend
            fit = self.struct.scaled(scale_nodes, density_preserving)
            if id_dtype is None:
                id_dtype = default_id_dtype(max(fit.n, fit.m))
            if chunked:
                src, dst = rmat.sample_graph_chunked(
                    key, fit, k_pref, rng=rng, dtype=id_dtype,
                    backend=backend, device=dev)
            else:
                src, dst = rmat.sample_graph(key, fit, rng=rng,
                                             dtype=id_dtype, backend=backend,
                                             device=dev)
            g = Graph(src, dst, 2 ** fit.n, 2 ** fit.m, self.bipartite)
        else:
            se = scale_nodes ** 2 if density_preserving else scale_nodes
            g = self.struct.sample(rng, scale_nodes, se)
        _sync(dev)
        self.timings.gen_struct_s = time.time() - t0

        t0 = time.time()
        n_rows = g.n_edges if self.feature_kind == "edge" else g.n_nodes
        cont_s, cat_s = call_with_optional_kwargs(
            self.features.sample, rng, n_rows, batch=feature_batch)
        _sync(dev)
        self.timings.gen_feat_s = time.time() - t0

        t0 = time.time()
        cont_s, cat_s = call_with_optional_kwargs(
            self.aligner.align, g, cont_s, cat_s, rng, batch=feature_batch)
        _sync(dev)
        self.timings.gen_align_s = time.time() - t0
        return g, cont_s, cat_s

    # -- generate to disk (repro_torch.datastream) -------------------------
    def generate_streamed(self, out_dir: str, seed: int = 0,
                          scale_nodes: int = 1,
                          density_preserving: bool = True,
                          shard_edges: int = 1 << 20,
                          k_pref: Optional[int] = None,
                          include_features: bool = True,
                          double_buffered: bool = True,
                          resume: bool = False, mode: str = "chunks",
                          backend: Optional[str] = None, id_dtype=None,
                          pipeline_depth: int = 2, host_workers: int = 1,
                          fused: bool = False, tracer=None, metrics=None):
        """Materialize the generated graph to a sharded on-disk dataset
        instead of device memory (see ``repro_torch.datastream``) — the
        path for outputs that exceed memory.  Returns a
        ``ShardedGraphDataset``.  Structure is sampled on the pipeline's
        device.

        ``backend`` picks the edge-sampler backend (None/'auto' = by
        device: ``cuda_prng`` on a card); the manifest records the stream
        it reproduces.  ``id_dtype`` overrides the auto int32/int64 node
        id width.

        Features/alignment ride along per shard when the pipeline is
        fitted with edge features; node-feature pipelines stream structure
        only (cross-shard node identity is not streamed).

        ``pipeline_depth``/``host_workers`` configure the staged shard
        executor: depth 0 is the serial loop, ``>=1`` overlaps struct
        sampling with the host feature stage (a pool of ``host_workers``
        threads) and the async writer flush — output is byte-identical
        either way.  Timings are split per stage *busy* time:
        ``gen_struct_s`` covers edge sampling only, the per-shard feature
        draw / alignment land in ``gen_feat_s`` / ``gen_align_s``, writes
        in ``gen_write_s``; ``gen_wall_s`` is end-to-end and
        ``gen_overlap`` (busy/wall) reports how much the pipeline hid.

        ``fused=True`` draws each shard's feature rows on the card in its
        struct stage; the host stage shrinks to alignment + write.  Output
        stays byte-identical to the staged path.

        ``tracer``/``metrics`` (a ``repro_torch.obs`` ``Tracer`` /
        ``MetricsRegistry``) flow through the executor into every stage.
        """
        from repro_torch.datastream import DatasetJob, FeatureSpec

        if self.struct_kind != "kronecker":
            raise ValueError("streamed generation needs the kronecker "
                             f"structure generator, not {self.struct_kind}")
        fit: KroneckerFit = self.struct.scaled(scale_nodes,
                                               density_preserving)
        features = None
        if include_features and hasattr(self, "features") \
                and self.feature_kind == "edge":
            features = FeatureSpec(self.features,
                                   getattr(self, "aligner", None))
        job = DatasetJob(fit, out_dir, shard_edges=shard_edges, seed=seed,
                         k_pref=k_pref, double_buffered=double_buffered,
                         mode=mode, features=features, backend=backend,
                         id_dtype=id_dtype, pipeline_depth=pipeline_depth,
                         host_workers=host_workers, fused=fused,
                         tracer=tracer, metrics=metrics, device=self.device)
        job.run(resume=resume)
        self.timings.gen_struct_s = job.timings["gen_struct_s"]
        self.timings.gen_feat_s = job.timings["gen_feat_s"]
        self.timings.gen_align_s = job.timings["gen_align_s"]
        self.timings.gen_write_s = job.timings["write_s"]
        self.timings.gen_wall_s = job.timings["wall_s"]
        self.timings.gen_overlap = job.timings["overlap"]
        self.timings.gen_stall_s = job.timings["stall_s"]
        return job.dataset()
