"""The synthetic-graph pipeline (paper Fig. 1).

``SyntheticGraphPipeline`` wires the three components — structural
generator, feature generator, aligner — behind one fit/generate API::

    pipe = SyntheticGraphPipeline(noise=0.03, gan_steps=200)  # on "cuda"
    pipe.fit(graph, cont, cat)
    g_syn, cont_syn, cat_syn = pipe.generate(seed=0, scale_nodes=2)

or generates from a saved fit (``repro_torch.convert``, whose
``state_from_pipeline`` saves one)::

    pipe = repro_torch.convert.pipeline_from_state(state, device="cuda")

The port fits the paper's default components: kronecker structure, GAN
features and the GBDT (``"xgboost"``) or random aligner.  A fit gives the
JAX package's structure and VGMs exactly and its GAN and forests to the
tolerances stated in the tests; the same seed gives the reference's
edges bit for bit and its features and alignment to stated tolerances.
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
from repro_torch.core.descend import default_id_dtype
from repro_torch.core.features import GANFeatureGenerator
from repro_torch.core.structure import KroneckerFit, fit_structure
from repro_torch.graph.ops import Graph
from repro_torch.tabular.schema import infer_schema


@dataclasses.dataclass
class PipelineTimings:
    fit_struct_s: float = 0.0
    fit_feat_s: float = 0.0
    fit_align_s: float = 0.0
    gen_struct_s: float = 0.0
    gen_feat_s: float = 0.0
    gen_align_s: float = 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SyntheticGraphPipeline:
    """Components by name, as in the paper's ablation (Table 6); the port
    fits struct="kronecker", features="gan" and aligner "xgboost" (or
    "gbdt") or "random"."""

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
    def fitted(cls, struct: KroneckerFit, features: GANFeatureGenerator,
               aligner, bipartite: bool, feature_kind: str = "edge",
               device="cuda") -> "SyntheticGraphPipeline":
        """A pipeline from fitted components (``repro_torch.convert``)."""
        pipe = cls(aligner="random" if isinstance(aligner, RandomAligner)
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
        if self.struct_kind != "kronecker" or self.feat_kind != "gan":
            raise NotImplementedError(
                f"struct={self.struct_kind!r}, features={self.feat_kind!r}: "
                "the port fits kronecker structure and GAN features; the "
                "SBM/ER and KDE/random generators are ROADMAP A3")
        dev = self.device
        g = Graph(g.src.to(dev), g.dst.to(dev), g.n_src, g.n_dst,
                  g.bipartite)
        cont, cat = np.asarray(cont), np.asarray(cat)
        self.schema = infer_schema(cont, cat)
        t0 = time.time()
        self.struct = fit_structure(g, noise=self.noise)
        _sync(dev)
        self.timings.fit_struct_s = time.time() - t0

        t0 = time.time()
        self.features = GANFeatureGenerator(self.schema, device=dev).fit(
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

    def generate(self, seed: int = 0, scale_nodes: int = 1,
                 density_preserving: bool = True, chunked: bool = False,
                 k_pref: int = 2, backend: Optional[str] = None,
                 id_dtype=None, feature_batch: Optional[int] = None
                 ) -> Tuple[Graph, torch.Tensor, torch.Tensor]:
        """``backend`` picks the ``repro_torch.core.sampler`` backend
        (None/'auto' = by device); ``id_dtype`` widens node ids (auto
        int32/int64 by fit size); ``feature_batch`` fixes the feature
        block size (None = the generator's default).  Stage times land in
        ``self.timings``, each taken after a device synchronize."""
        dev = self.device
        rng = np.random.default_rng(seed)
        key = trandom.PRNGKey(seed)
        t0 = time.time()
        backend = "auto" if backend is None else backend
        fit = self.struct.scaled(scale_nodes, density_preserving)
        if id_dtype is None:
            id_dtype = default_id_dtype(max(fit.n, fit.m))
        if chunked:
            src, dst = rmat.sample_graph_chunked(key, fit, k_pref, rng=rng,
                                                 dtype=id_dtype,
                                                 backend=backend, device=dev)
        else:
            src, dst = rmat.sample_graph(key, fit, rng=rng, dtype=id_dtype,
                                         backend=backend, device=dev)
        g = Graph(src, dst, 2 ** fit.n, 2 ** fit.m, self.bipartite)
        _sync(dev)
        self.timings.gen_struct_s = time.time() - t0

        t0 = time.time()
        n_rows = g.n_edges if self.feature_kind == "edge" else g.n_nodes
        cont_s, cat_s = self.features.sample(rng, n_rows, batch=feature_batch)
        _sync(dev)
        self.timings.gen_feat_s = time.time() - t0

        t0 = time.time()
        cont_s, cat_s = self.aligner.align(g, cont_s, cat_s, rng,
                                           batch=feature_batch)
        _sync(dev)
        self.timings.gen_align_s = time.time() - t0
        return g, cont_s, cat_s
