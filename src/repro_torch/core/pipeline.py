"""The synthetic-graph pipeline (paper Fig. 1), generation side.

``SyntheticGraphPipeline`` wires the three components — structural
generator, feature generator, aligner — behind ``generate``::

    pipe = repro_torch.convert.pipeline_from_state(state, device="cuda")
    g_syn, cont_syn, cat_syn = pipe.generate(seed=0, scale_nodes=2)

The components come fitted (``repro_torch.convert``): this slice of the
port generates from a fit made by the JAX package, with the paper's
default components (kronecker structure, GAN features, GBDT aligner).
The same seed gives the reference's edges bit for bit and its features
and alignment to the tolerances stated in the tests.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core import rmat
from repro_torch.core.descend import default_id_dtype
from repro_torch.core.structure import KroneckerFit
from repro_torch.graph.ops import Graph


@dataclasses.dataclass
class PipelineTimings:
    gen_struct_s: float = 0.0
    gen_feat_s: float = 0.0
    gen_align_s: float = 0.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class SyntheticGraphPipeline:
    def __init__(self, struct: KroneckerFit, features, aligner,
                 bipartite: bool, feature_kind: str = "edge",
                 device="cuda"):
        self.struct_kind = "kronecker"
        self.struct = struct
        self.features = features
        self.aligner = aligner
        self.bipartite = bool(bipartite)
        self.feature_kind = feature_kind
        self.device = torch.device(device)
        self.timings = PipelineTimings()

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
