"""Streaming fit engine throughput: rows/s of the streamed fit
(accumulators over a sharded dataset) vs the in-memory fit on the same
edges, plus per-accumulator rates.  Writes
``results/bench_torch/BENCH_fit.json``.

    python -m repro_torch.benchmarks.run --only fit_throughput [--full]

Renamed from ``benchmarks/fit_throughput.py``: the dataset is written
through the port's ``reference`` backend (the JAX package's ``xla``
stream), and ``device`` is the torch device the accumulators and fits
run on, with the card's name.  Every timed call ends in a synchronize.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
import time

import torch

from repro_torch.benchmarks.common import device_of, emit_bench, sync


def _fit(E: int):
    from repro_torch.core.structure import KroneckerFit
    n = max(8, math.ceil(math.log2(max(E // 8, 16))))
    return KroneckerFit(a=0.45, b=0.22, c=0.2, d=0.13, n=n, m=n, E=E)


def _dataset(tmp: str, E: int, shard_edges: int, dev) -> str:
    from repro_torch.datastream import DatasetJob
    out = os.path.join(tmp, "ds")
    DatasetJob(_fit(E), out, shard_edges=shard_edges, backend="reference",
               device=dev).run()
    return out


def _time(fn, reps: int, dev):
    ts = []
    out = None
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2], out


def device_name(dev: torch.device) -> str:
    """``cpu``, or ``cuda:0 (<the card's name>)``."""
    if dev.type != "cuda":
        return str(dev)
    return f"{dev} ({torch.cuda.get_device_name(dev)})"


def run(fast: bool = True, device="cuda") -> dict:
    from repro_torch.core import fit_engine as fe
    from repro_torch.core.structure import fit_structure
    from repro_torch.datastream import DatasetFitSource, ShardedGraphDataset

    dev = device_of(device)
    E = 1 << 18 if fast else 1 << 21
    shard_edges = 1 << 16 if fast else 1 << 19
    chunk_rows = shard_edges
    reps = 3 if fast else 2
    tmp = tempfile.mkdtemp(prefix="bench-fit-")
    res = {"rows": E, "shard_edges": shard_edges,
           "device": device_name(dev)}
    try:
        out = _dataset(tmp, E, shard_edges, dev)
        g = ShardedGraphDataset(out).to_graph(device=dev)
        src, dst = g.src, g.dst

        # streamed fit: one accumulator pass + θ-fit from the stats
        def streamed():
            s = DatasetFitSource(out, chunk_rows=chunk_rows)
            stats = fe.accumulate(s, sample_rows=10_000, device=dev)
            return fe.fit_structure_streamed(stats, calibrate=False,
                                             device=dev)[0]

        # in-memory fit on the materialized graph (historical path)
        def in_memory():
            return fit_structure(g, calibrate=False)

        t_s, fit_s = _time(streamed, reps, dev)
        t_m, fit_m = _time(in_memory, reps, dev)
        res["streamed_fit"] = {"seconds": round(t_s, 3),
                               "rows_per_s": round(E / t_s)}
        res["inmemory_fit"] = {"seconds": round(t_m, 3),
                               "rows_per_s": round(E / t_m)}
        res["theta_delta"] = round(max(
            abs(fit_s.a - fit_m.a), abs(fit_s.b - fit_m.b),
            abs(fit_s.c - fit_m.c), abs(fit_s.d - fit_m.d)), 6)
        res["slowdown"] = round(t_s / t_m, 2)

        # per-accumulator rates on in-memory ids (no IO in the loop)
        n = m = _fit(E).n
        t, _ = _time(lambda: fe.BitPairMLE(n, m).update(src, dst), reps,
                     dev)
        res["bitpair_mle"] = {"seconds": round(t, 3),
                              "rows_per_s": round(E / t)}
        t, _ = _time(lambda: fe.DegreeSketch(1 << n, 2048, device=dev)
                     .update(src).finalize(), reps, dev)
        res["degree_sketch"] = {"seconds": round(t, 3),
                                "rows_per_s": round(E / t)}
        chunk = fe.FitChunk(src, dst, None, None, 0)
        t, _ = _time(lambda: fe.ReservoirSample(10_000, device=dev)
                     .update(chunk).finalize(), reps, dev)
        res["reservoir"] = {"seconds": round(t, 3),
                            "rows_per_s": round(E / t)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    emit_bench("fit", res)
    for k in ("streamed_fit", "inmemory_fit", "bitpair_mle",
              "degree_sketch", "reservoir"):
        print(f"fit/{k},{res[k]['seconds'] * 1e6:.0f},"
              f"{res[k]['rows_per_s']}")
    print(f"# streamed vs in-memory: {res['slowdown']}x slower, "
          f"theta delta {res['theta_delta']}")
    return res
