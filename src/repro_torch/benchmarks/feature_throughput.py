"""Feature/alignment hot-path throughput: rows/s for codec decode, GAN
sampling, GBDT inference and rank-match alignment, the host references
against the port's batched engine on ``device``.

Emits ``results/bench_torch/BENCH_features.json``.  The engine sides run
a full 2^20-row shard (fast mode: 2^16) on the device; the reference
sides (per-row ``rng.choice`` decode, per-tree loops of ``predict_np``)
stay on the host, as in the JAX package, on a capped row count, and are
reported as rows/s.

As ``benchmarks/feature_throughput.py``, with the threefry key and
normals of the activated generator output from ``repro_torch.random``
in place of ``jax.random``.  Every engine call is timed to the end of its
work on the device.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.benchmarks.common import (device_of, emit_bench, sync,
                                           timeit)
from repro_torch.core.aligner import AlignerConfig, GBDTAligner
from repro_torch.core.features import GANConfig, GANFeatureGenerator
from repro_torch.core.gbdt import GBDTConfig
from repro_torch.graph.ops import Graph
from repro_torch.tabular.schema import infer_schema


def _rows_per_sec(fn, n_rows, dev, repeats=3):
    # common.timeit: 1 warmup call, median µs/call
    return n_rows / (timeit(fn, repeats=repeats, device=dev) / 1e6)


def _stage(ref_fn, ref_rows, engine_fn, engine_rows, repeats, dev):
    """Interleaved ref/engine timing: each rep times the pair back to
    back; the recorded speedup is the median of the per-rep ratios
    (rows/s are the medians of their own samples)."""
    ref_fn(), engine_fn()                  # warmup
    ref_ts, eng_ts = [], []
    for _ in range(repeats):
        sync(dev)
        t0 = time.perf_counter()
        ref_fn()
        sync(dev)
        ref_ts.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        engine_fn()
        sync(dev)
        eng_ts.append(time.perf_counter() - t0)
    med = lambda ts: sorted(ts)[len(ts) // 2]
    ratios = sorted((engine_rows / e) / (ref_rows / r)
                    for r, e in zip(ref_ts, eng_ts))
    return {"reference_rows": ref_rows, "engine_rows": engine_rows,
            "reference_rows_per_s": ref_rows / med(ref_ts),
            "engine_rows_per_s": engine_rows / med(eng_ts),
            "speedup_vs_reference": ratios[len(ratios) // 2]}


def _train_table(rng, n=4000):
    comp = rng.integers(0, 2, n)
    c0 = np.where(comp == 0, rng.normal(-3, .5, n), rng.normal(4, 1., n))
    cont = np.stack([c0, rng.exponential(2., n)], 1).astype(np.float32)
    cat = np.stack([comp, rng.integers(0, 8, n)], 1).astype(np.int32)
    return cont, cat


def _graph(src, dst, n, dev) -> Graph:
    return Graph(torch.from_numpy(src.astype(np.int32)).to(dev),
                 torch.from_numpy(dst.astype(np.int32)).to(dev), n, n)


def run(fast: bool = True, device="cuda") -> dict:
    dev = device_of(device)
    n = 1 << 16 if fast else 1 << 20          # engine-side shard size
    n_ref = 1 << 11 if fast else 1 << 13      # reference-side cap
    reps = 3
    batch = min(n, 1 << 16)
    rng = np.random.default_rng(0)
    cont, cat = _train_table(rng)
    schema = infer_schema(cont, cat)

    gen = GANFeatureGenerator(schema, GANConfig(batch=128), device=dev).fit(
        cont, cat, steps=60, seed=0)
    codec = gen.codec

    # one shard's worth of activated generator output, decoded many ways
    z = trandom.normal(trandom.PRNGKey(1), (n, gen.cfg.d_z), dev)
    with torch.no_grad():
        raw = gen._activate(gen.generator(z))
    raw_host = raw.cpu().numpy()

    res = {"rows": n, "reference_rows": n_ref, "batch": batch}

    dec = codec.batched(batch, dev)
    res["decode"] = _stage(
        lambda: codec.decode_reference(raw_host[:n_ref],
                                       np.random.default_rng(2)), n_ref,
        lambda: dec.decode(raw, np.random.default_rng(2)), n, reps, dev)
    res["decode"]["numpy_rows_per_s"] = _rows_per_sec(
        lambda: codec.decode(raw_host, np.random.default_rng(2)), n, dev,
        reps)

    def _sample_reference():
        # one giant unbatched generator call + per-row host decode
        r = np.random.default_rng(3)
        k = trandom.PRNGKey(int(r.integers(2 ** 31)))
        kz, _ = trandom.split(k)
        zr = trandom.normal(kz, (n_ref, gen.cfg.d_z), dev)
        with torch.no_grad():
            out = gen._activate(gen.generator(zr))
        return codec.decode_reference(out.cpu().numpy(), r)

    res["gan_sample"] = _stage(
        _sample_reference, n_ref,
        lambda: gen.sample(np.random.default_rng(3), n, batch=batch), n,
        reps, dev)

    # aligner fit on a planted structure↔feature coupling (the regime the
    # aligner exists for): first cont column is a function of src degree
    n_fit_edges = 4000
    fs = rng.integers(0, 512, n_fit_edges)
    fd = rng.integers(0, 512, n_fit_edges)
    g_fit = _graph(fs, fd, 512, dev)
    deg = np.bincount(fs, minlength=512)
    cont_fit = cont[:n_fit_edges].copy()
    cont_fit[:, 0] = (np.log1p(deg[fs])
                      + 0.01 * rng.normal(size=n_fit_edges))
    al = GBDTAligner(schema, AlignerConfig(gbdt=GBDTConfig(n_rounds=100)),
                     kind="edge").fit(g_fit, cont_fit, cat[:n_fit_edges])
    g_big = _graph(rng.integers(0, 1 << 14, n), rng.integers(0, 1 << 14, n),
                   1 << 14, dev)
    X_big = al._inputs(g_big)
    X_ref = X_big[:n_ref].cpu().numpy()

    def _predict_np_reference(X):
        cols = [m.predict_np(X) for m in al.cont_models]
        cols += [mdl.predict_np(X).astype(np.float32)
                 for mdl in al.cat_models if mdl is not None]
        return np.stack(cols, 1)

    # full per-column stack; capped row count (align only scores the two
    # key columns: this stage times the all-columns predict); 5 paired
    # reps for its median
    n_pred = min(n, 1 << 18)
    res["gbdt_predict"] = _stage(
        lambda: _predict_np_reference(X_ref), n_ref,
        lambda: al.predict_rows(X_big[:n_pred], batch=batch), n_pred,
        max(reps, 5), dev)

    rows_c, rows_k = gen.sample(np.random.default_rng(4), n, batch=batch)
    n_nodes = max(2, n_ref // 4)
    g_ref = _graph(rng.integers(0, n_nodes, n_ref),
                   rng.integers(0, n_nodes, n_ref), n_nodes, "cpu")
    ref_c, ref_k = rows_c[:n_ref].cpu(), rows_k[:n_ref].cpu()

    def _align_reference():
        # align on the host, end to end: structural inputs + full
        # predict_np stack + rank match
        pred = _predict_np_reference(
            al._inputs(g_ref).to(torch.float32).numpy())
        al._match_keys(pred, al._rows_matrix(ref_c, ref_k),
                       np.random.default_rng(5))

    res["align"] = _stage(
        _align_reference, n_ref,
        lambda: al.align(g_big, rows_c, rows_k,
                         np.random.default_rng(5), batch=batch), n, reps,
        dev)

    for stage, r in res.items():
        if not isinstance(r, dict):
            continue
        # 3 clean comma-separated fields like every other table module
        print(f"features/{stage}_engine,0.0,{r['engine_rows_per_s']:.0f} "
              f"rows/s ({r['speedup_vs_reference']:.1f}x ref)")

    emit_bench("features", res)
    return res
