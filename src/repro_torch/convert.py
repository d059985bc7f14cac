"""Carry a fitted pipeline across: a flat dict of numpy arrays → the
port's ``SyntheticGraphPipeline``.

The state is framework-free, so a fit made by the JAX package
(``scripts/export_torch_state.py`` writes one) loads here without JAX.
Keys (``{j}``/``{i}`` are column / block indices):

=================================  ======================================
``struct/{a,b,c,d,noise}``         the ``KroneckerFit`` (float)
``struct/{n,m,E}``, ``struct/bipartite``
``pipe/feature_kind``              ``"edge"`` or ``"node"``
``pipe/bipartite``                 whether the fitted graph is bipartite
``schema/n_cont``, ``schema/cat_cards``
``gan/{n_modes,d_z,n_blocks,sample_batch}``
``gan/vgm/{j}/{weights,means,stds,active}``
``gan/g/{in,out}/{w,b}``           generator weights, ``(din, dout)``
``gan/g/blocks/{i}/bn/{scale,bias}``, ``gan/g/blocks/{i}/fc/{w,b}``
``aligner/kind``                   ``"xgboost"`` or ``"random"``
``aligner/col_quality``, ``aligner/max_cat_classes``
``aligner/cont/{j}/*``             a regressor's bin pack:
                                   ``E, code, leaf_bot, base, lr, depth``
``aligner/cat/{j}/*``              a classifier's pack, ``code`` (C,T,S),
                                   plus ``n_classes``; absent for columns
                                   above ``max_cat_classes``
=================================  ======================================

``lm_params_from_numpy`` carries an LM's weights across: the JAX package's
parameter tree as numpy arrays → the port's ``DenseLM`` module.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.aligner import (AlignerConfig, GBDTAligner,
                                      RandomAligner)
from repro_torch.core.features import (GANConfig, GANFeatureGenerator,
                                       GeneratorMLP, TableCodec)
from repro_torch.core.gbdt import (GBDTClassifier, GBDTRegressor,
                                   forest_from_state)
from repro_torch.core.pipeline import SyntheticGraphPipeline
from repro_torch.core.structure import KroneckerFit
from repro_torch.models.params import tree_map
from repro_torch.models.transformer import DenseLM
from repro_torch.tabular.schema import TableSchema
from repro_torch.tabular.vgm import VGMParams

State = Dict[str, np.ndarray]


def save_state(state: State, path) -> None:
    np.savez_compressed(path, **{k: np.asarray(v) for k, v in state.items()})


def load_state(path) -> State:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _str(v) -> str:
    return str(np.asarray(v).item())


def _gan_tree(state: State, n_blocks: int) -> Dict:
    def lin(p):
        return {"w": state[f"{p}/w"], "b": state[f"{p}/b"]}
    return {"in": lin("gan/g/in"),
            "blocks": [{"bn": {"scale": state[f"gan/g/blocks/{i}/bn/scale"],
                               "bias": state[f"gan/g/blocks/{i}/bn/bias"]},
                        "fc": lin(f"gan/g/blocks/{i}/fc")}
                       for i in range(n_blocks)],
            "out": lin("gan/g/out")}


def pipeline_from_state(state: State, device="cuda") -> SyntheticGraphPipeline:
    fit = KroneckerFit(
        **{k: float(state[f"struct/{k}"]) for k in ("a", "b", "c", "d",
                                                     "noise")},
        **{k: int(state[f"struct/{k}"]) for k in ("n", "m", "E")},
        bipartite=bool(state["struct/bipartite"]))
    schema = TableSchema(
        n_cont=int(state["schema/n_cont"]),
        cat_cards=tuple(int(c) for c in np.atleast_1d(
            state["schema/cat_cards"])))
    feature_kind = _str(state["pipe/feature_kind"])

    n_modes = int(state["gan/n_modes"])
    n_blocks = int(state["gan/n_blocks"])
    vgms = [VGMParams(**{f: state[f"gan/vgm/{j}/{f}"]
                         for f in ("weights", "means", "stds", "active")})
            for j in range(schema.n_cont)]
    codec = TableCodec(schema, n_modes, vgms)
    cfg = GANConfig(d_z=int(state["gan/d_z"]), n_blocks=n_blocks,
                    sample_batch=int(state["gan/sample_batch"]))
    w_in = state["gan/g/in/w"]
    gen = GeneratorMLP(cfg.d_z, w_in.shape[1], n_blocks, codec.enc_dim)
    gen.load_jax_params(_gan_tree(state, n_blocks))
    features = GANFeatureGenerator(schema, codec, gen, cfg, device)

    if _str(state["aligner/kind"]) == "random":
        aligner = RandomAligner(schema, kind=feature_kind)
    else:
        conts = [GBDTRegressor(forest_from_state(state, f"aligner/cont/{j}",
                                                 device))
                 for j in range(schema.n_cont)]
        cats = []
        for j in range(schema.n_cat):
            pk = forest_from_state(state, f"aligner/cat/{j}", device)
            cats.append(None if pk is None else GBDTClassifier(
                int(state[f"aligner/cat/{j}/n_classes"]), pk))
        aligner = GBDTAligner(
            schema, conts, cats,
            [float(q) for q in np.atleast_1d(state["aligner/col_quality"])],
            AlignerConfig(int(state["aligner/max_cat_classes"])),
            kind=feature_kind)
    return SyntheticGraphPipeline(fit, features, aligner,
                                  bool(state["pipe/bipartite"]),
                                  feature_kind, device)


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """numpy → torch, bfloat16 (numpy's ml_dtypes extension type, which
    torch cannot read) by its 16-bit pattern.  A read-only array (as
    ``np.asarray`` of a jax array is) is copied: torch tensors are
    writable."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def lm_params_from_numpy(tree, cfg, device="cuda") -> DenseLM:
    """The JAX package's LM parameter tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``) → the port's weights on
    ``device``.  Layouts are kept (``wq`` (D, H, Hd), ``wo`` (H, Hd, D),
    ...); stacked ``(L, ...)`` leaves are split per layer."""
    return DenseLM(tree_map(lambda a: tensor_from_numpy(a).to(device), tree),
                   cfg)
