"""Carry a fitted pipeline across: a flat dict of numpy arrays ↔ the
port's ``SyntheticGraphPipeline``.

The state is framework-free, so a fit made by the JAX package
(``scripts/export_torch_state.py`` writes one) loads here without JAX,
and a fit made by the port (``state_from_pipeline``) saves in the same
format.  Keys (``{j}``/``{i}`` are column / block indices):

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

``lm_params_from_numpy`` carries an LM's weights across, of any family
and in either tree form (stacked layers or a list of them): the JAX
package's parameter tree as numpy arrays → the port's ``LM`` module, and
``opt_state_from_numpy`` its optimizer state; ``lm_params_to_numpy`` and
``opt_state_to_numpy`` carry both back as numpy trees of the reference's
structure.  ``gnn_params_from_numpy`` does the same for a GCN / GAT.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.aligner import (AlignerConfig, GBDTAligner,
                                      RandomAligner)
from repro_torch.core.features import (MLP, GANConfig, GANFeatureGenerator,
                                       TableCodec)
from repro_torch.core.gbdt import (GBDTClassifier, GBDTRegressor,
                                   PackedForest, forest_from_state)
from repro_torch.core.pipeline import SyntheticGraphPipeline
from repro_torch.core.structure import KroneckerFit
from repro_torch.models.gnn import GNN, GNNConfig, gnn_from_params
from repro_torch.models.params import tree_map
from repro_torch.models.transformer import LM
from repro_torch.tabular.schema import TableSchema
from repro_torch.tabular.vgm import VGMParams
from repro_torch.training.optimizer import OptState

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
    gen = MLP(cfg.d_z, w_in.shape[1], n_blocks, codec.enc_dim)
    gen.load_jax_params(_gan_tree(state, n_blocks))
    features = GANFeatureGenerator(schema, cfg, device=device, codec=codec,
                                   generator=gen)

    return SyntheticGraphPipeline.fitted(
        fit, features, aligner_from_state(state, schema, feature_kind,
                                          device),
        bool(state["pipe/bipartite"]), feature_kind, device)


def aligner_from_state(state: State, schema: TableSchema, kind: str,
                       device="cuda"):
    """The ``aligner/*`` keys of a state → a fitted aligner on
    ``device``."""
    if _str(state["aligner/kind"]) == "random":
        return RandomAligner(schema, kind=kind)
    conts = [GBDTRegressor(packed=forest_from_state(
        state, f"aligner/cont/{j}", device))
        for j in range(schema.n_cont)]
    cats = []
    for j in range(schema.n_cat):
        pk = forest_from_state(state, f"aligner/cat/{j}", device)
        cats.append(None if pk is None else GBDTClassifier(
            int(state[f"aligner/cat/{j}/n_classes"]), packed=pk))
    return GBDTAligner(
        schema,
        AlignerConfig(max_cat_classes=int(state["aligner/max_cat_classes"])),
        kind=kind, cont_models=conts, cat_models=cats,
        col_quality=[float(q) for q in
                     np.atleast_1d(state["aligner/col_quality"])])


def _put_forest(out: State, prefix: str, pk: PackedForest,
                n_classes=None) -> None:
    out[f"{prefix}/E"] = pk.E.cpu().numpy()
    out[f"{prefix}/code"] = pk.code.cpu().numpy()
    out[f"{prefix}/leaf_bot"] = pk.leaf_bot.cpu().numpy()
    out[f"{prefix}/base"] = pk.base.cpu().numpy()
    out[f"{prefix}/lr"] = np.float32(pk.lr)
    out[f"{prefix}/depth"] = np.int64(pk.depth)
    if n_classes is not None:
        out[f"{prefix}/n_classes"] = np.int64(n_classes)


def state_from_pipeline(pipe: SyntheticGraphPipeline) -> State:
    """The state of a fitted port pipeline (kronecker + GAN), the inverse
    of :func:`pipeline_from_state`: the keys, dtypes and shapes that
    ``scripts/export_torch_state.py`` writes for a JAX-made fit."""
    if pipe.struct_kind != "kronecker" or pipe.feat_kind != "gan":
        raise ValueError("the state carries kronecker + gan pipelines")
    st = pipe.struct
    out = {f"struct/{k}": np.float64(getattr(st, k))
           for k in ("a", "b", "c", "d", "noise")}
    out.update({f"struct/{k}": np.int64(getattr(st, k))
                for k in ("n", "m", "E")})
    out["struct/bipartite"] = np.bool_(st.bipartite)
    out["pipe/feature_kind"] = np.str_(pipe.feature_kind)
    out["pipe/bipartite"] = np.bool_(pipe.bipartite)
    out["schema/n_cont"] = np.int64(pipe.schema.n_cont)
    out["schema/cat_cards"] = np.asarray(pipe.schema.cat_cards, np.int64)

    gan = pipe.features
    out["gan/n_modes"] = np.int64(gan.codec.n_modes)
    out["gan/d_z"] = np.int64(gan.cfg.d_z)
    out["gan/n_blocks"] = np.int64(gan.cfg.n_blocks)
    out["gan/sample_batch"] = np.int64(gan.cfg.sample_batch)
    for j, v in enumerate(gan.codec.vgms):
        for f in ("weights", "means", "stds", "active"):
            out[f"gan/vgm/{j}/{f}"] = np.asarray(getattr(v, f))
    g = gan.generator

    def put(key, param):
        out[key] = param.detach().cpu().numpy().astype(np.float32)

    for name, lin in (("in", g.inp), ("out", g.out)):
        put(f"gan/g/{name}/w", lin.w)
        put(f"gan/g/{name}/b", lin.b)
    for i, blk in enumerate(g.blocks):
        p = f"gan/g/blocks/{i}"
        put(f"{p}/bn/scale", blk.bn.scale)
        put(f"{p}/bn/bias", blk.bn.bias)
        put(f"{p}/fc/w", blk.fc.w)
        put(f"{p}/fc/b", blk.fc.b)

    al = pipe.aligner
    if isinstance(al, RandomAligner):
        out["aligner/kind"] = np.str_("random")
        return out
    out["aligner/kind"] = np.str_("xgboost")
    out["aligner/col_quality"] = np.asarray(al.col_quality, np.float64)
    out["aligner/max_cat_classes"] = np.int64(al.cfg.max_cat_classes)
    for j, mdl in enumerate(al.cont_models):
        _put_forest(out, f"aligner/cont/{j}", mdl.packed)
    for j, mdl in enumerate(al.cat_models):
        if mdl is not None:
            _put_forest(out, f"aligner/cat/{j}", mdl.packed, mdl.n_classes)
    return out


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


def lm_params_from_numpy(tree, cfg, device="cuda") -> LM:
    """The JAX package's LM parameter tree as numpy arrays
    (``jax.tree.map(np.asarray, params)``), of any family → the port's
    weights on ``device``.  Layouts and the tree's form are kept (``wq``
    (D, H, Hd), ``wo`` (H, Hd, D), stacked ``(L, ...)`` leaves or lists of
    layers, MoE experts stacked or listed)."""
    return LM(tree_map(lambda a: tensor_from_numpy(a).to(device), tree), cfg)


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch → numpy on the host; bfloat16 comes back as float32 of the
    same values (numpy has no bfloat16 of its own: ``jnp.asarray(a,
    jnp.bfloat16)`` restores it exactly)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def lm_params_to_numpy(params: LM):
    """The port's weights → the JAX package's parameter tree as numpy
    arrays, in the form they were given (stacked ``(L, ...)`` leaves or
    lists)."""
    return tree_map(tensor_to_numpy, params.tree())


def opt_state_from_numpy(state, device="cuda") -> OptState:
    """The JAX package's ``OptState`` as numpy arrays (``jax.tree.map(
    np.asarray, opt_state)``: master, mu, nu trees and the int32 step) →
    the port's on ``device``."""
    def tree(t):
        return tree_map(lambda a: tensor_from_numpy(a).to(device), t)
    return OptState(master=tree(state.master), mu=tree(state.mu),
                    nu=tree(state.nu),
                    step=torch.tensor(int(state.step), dtype=torch.int32,
                                      device=device))


def opt_state_to_numpy(state: OptState) -> OptState:
    """The port's ``OptState`` → the same fields as numpy arrays (the step
    an int32 scalar array), the reference's ``OptState(*...)`` fields."""
    return OptState(*(tree_map(tensor_to_numpy, t)
                      for t in (state.master, state.mu, state.nu)),
                    step=np.asarray(int(state.step), np.int32))


def gnn_params_from_numpy(tree, cfg: GNNConfig, device="cuda") -> GNN:
    """The JAX package's GNN parameters as numpy arrays (a list of one dict
    a layer: ``w``, ``b``, and GAT's ``att_src``/``att_dst``) → the port's
    ``GCN``/``GAT`` with the same weights on ``device``."""
    return gnn_from_params(cfg, [
        {k: tensor_from_numpy(np.asarray(v)).to(device) for k, v in p.items()}
        for p in tree])
