"""Paper Table 6: component ablation on the IEEE-like dataset.

{struct: kronecker | sbm | er} × {features: gan | kde | random} ×
{aligner: gbdt | random}.  Components are fit once and re-composed, like
the paper (note their structural metric is constant within a struct row).

As ``benchmarks/table6_ablation.py``, with every component fitted, drawn
and scored on ``device``; the kronecker graph is drawn by the auto
backend (K2 on the card; the ``reference`` stream, the JAX package's
``xla``, on the CPU).  Each row is timed to the end of its work.
"""
from __future__ import annotations

import itertools
import time

import numpy as np

from repro_torch import random as trandom
from repro_torch.benchmarks.common import device_of, emit, on, row, sync
from repro_torch.core import rmat
from repro_torch.core.aligner import ALIGNERS, AlignerConfig
from repro_torch.core.baselines import ERGenerator, SBMGenerator
from repro_torch.core.features import FEATURE_GENERATORS
from repro_torch.core.gbdt import GBDTConfig
from repro_torch.core.metrics import evaluate_all
from repro_torch.core.structure import fit_structure
from repro_torch.data import reference as R
from repro_torch.graph.ops import Graph
from repro_torch.tabular.schema import infer_schema


def run(fast: bool = True, device="cuda"):
    dev = device_of(device)
    g, cont, cat = R.ieee_like(n_src=1024, n_dst=128, n_edges=6000)
    g = on(g, dev)
    schema = infer_schema(cont, cat)
    acfg = AlignerConfig(gbdt=GBDTConfig(n_rounds=30 if fast else 100))

    # fit each component once
    structs = {}
    kf = fit_structure(g, noise=0.03)
    src, dst = rmat.sample_graph(trandom.PRNGKey(0), kf, backend="auto",
                                 device=dev)
    structs["kronecker"] = Graph(src, dst, 2 ** kf.n, 2 ** kf.m, True)
    structs["sbm"] = SBMGenerator(device=dev).fit(g).sample(
        np.random.default_rng(0), 1, 1)
    structs["er"] = ERGenerator(device=dev).fit(g).sample(
        np.random.default_rng(0), 1, 1)

    feats = {}
    for fname, cls in FEATURE_GENERATORS.items():
        gen = cls(schema, device=dev)
        gen.fit(cont, cat, steps=120 if fast else 400)
        feats[fname] = gen

    aligners = {
        "xgboost": ALIGNERS["xgboost"](schema, acfg, kind="edge").fit(g, cont,
                                                                      cat),
        "random": ALIGNERS["random"](schema).fit(g, cont, cat),
    }

    rows = []
    combos = itertools.product(structs, feats, aligners)
    for sname, fname, aname in combos:
        sync(dev)
        t0 = time.perf_counter()
        gs = structs[sname]
        rng = np.random.default_rng(1)
        cs, ks = feats[fname].sample(rng, gs.n_edges)
        cs, ks = aligners[aname].align(gs, cs, ks, rng)
        m = evaluate_all(g, cont, cat, gs, cs, ks, device=dev)
        sync(dev)
        us = (time.perf_counter() - t0) * 1e6
        rows.append(row(
            f"table6/{sname}+{fname}+{aname}", us,
            f"deg={m['degree_dist']:.3f};corr={m['feature_corr']:.3f};"
            f"joint={m['degree_feat_dist']:.3f}"))
    return emit(rows, "table6_ablation")
