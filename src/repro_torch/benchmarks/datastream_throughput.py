"""Streaming materialization throughput: edges/s to disk, double-buffered
vs serial device→host pump (``repro_torch.datastream``).

As ``benchmarks/datastream_throughput.py``, with the job's struct stage
on ``device`` (the auto backend: K2 on the card).  Emits
``results/bench_torch/BENCH_datastream.json``.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
import time

from repro_torch.benchmarks.common import device_of, emit_bench, sync
from repro_torch.core.structure import KroneckerFit
from repro_torch.datastream import DatasetJob, ShardedGraphDataset


def _materialize(fit, out, double_buffered, shard_edges, dev):
    sync(dev)
    t0 = time.time()
    # pipeline_depth=0: this benchmark isolates the chunk-level
    # device→host pump; executor-level overlap is executor_overlap.py
    job = DatasetJob(fit, out, shard_edges=shard_edges, seed=0,
                     double_buffered=double_buffered, pipeline_depth=0,
                     device=dev)
    job.run()
    dt = time.time() - t0
    assert ShardedGraphDataset(out).total_edges == fit.E
    return dt


def run(fast: bool = True, device="cuda") -> dict:
    dev = device_of(device)
    E = 2_000_000 if fast else 50_000_000
    shard_edges = 1 << 18 if fast else 1 << 22
    n = max(8, math.ceil(math.log2(max(E // 8, 16))))
    fit = KroneckerFit(a=0.45, b=0.22, c=0.2, d=0.13, n=n, m=n, E=E)
    root = tempfile.mkdtemp(prefix="bench_datastream_")
    rows = {}
    try:
        # warmup: same chunk shapes as the measured runs
        _materialize(fit, os.path.join(root, "warmup"), True, shard_edges,
                     dev)
        for label, dbl in (("double_buffered", True), ("serial", False)):
            out = os.path.join(root, label)
            dt = _materialize(fit, out, dbl, shard_edges, dev)
            bytes_written = sum(
                os.path.getsize(os.path.join(out, f))
                for f in os.listdir(out))
            rows[label] = {
                "seconds": dt,
                "edges_per_sec": E / dt,
                "mb_per_sec": bytes_written / dt / 1e6,
            }
            print(f"datastream_{label},{dt * 1e6 / E:.3f},"
                  f"{E / dt:,.0f} edges/s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    speedup = rows["serial"]["seconds"] / rows["double_buffered"]["seconds"]
    result = {"edges": E, "shard_edges": shard_edges,
              "overlap_speedup": speedup, **rows}
    emit_bench("datastream", result)
    print(f"datastream_overlap_speedup,{speedup:.3f},x")
    return result
