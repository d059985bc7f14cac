"""Multi-process cluster scaling: 1 against 2 worker processes end to end.

As ``benchmarks/cluster_scaling.py``: times
``python -m repro_torch.scripts.generate_dataset`` materializing the same
demo dataset in one process and through the ``--num-workers 2`` cluster
coordinator (``repro_torch.distributed.cluster``), byte-compares the two
outputs (the cluster must be a pure throughput change), and records each
worker's stage timings and K2 launches from its ``--metrics-out`` file.
The reference pins ``--backend xla``; here the backend is left to auto on
the card (``cuda_prng``: K2, the stream the main path writes) and is
``reference`` on the CPU.  On one card both workers share it.  The R-MAT
library is built before either run is timed, so no worker pays ``nvcc``;
at the full size on the card a third run, ``cluster2_cold``, repeats the
2-worker run against an empty kernel build directory
(``REPRO_TORCH_BUILD``), so each worker starts its own ``nvcc`` at once,
as on a fresh machine: what a first-use cluster run costs.
Emits ``results/bench_torch/BENCH_cluster.json``; run it with
``python -m repro_torch.benchmarks.run --only cluster_scaling``.

Every run pays the same per-process start (torch import, CUDA context),
so the headline ``speedup`` is honest about coordination overhead — at
the fast size it sits below 1; the per-worker stage rows tell whether the
stripes ran concurrently.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from repro_torch.benchmarks.common import device_of, emit_bench
from repro_torch.distributed.launcher import worker_env


def _cli(out: str, edges: int, shard_edges: int, device: str,
         *extra: str, env=None) -> float:
    """Run one generate_dataset invocation (in ``env``, default
    ``worker_env()``); returns wall seconds."""
    argv = [sys.executable, "-m", "repro_torch.scripts.generate_dataset",
            "--fit", "demo", "--edges", str(edges),
            "--shard-edges", str(shard_edges), "--out", out, "--seed", "0",
            "--device", device, *extra]
    if device == "cpu":
        argv += ["--backend", "reference"]
    t0 = time.perf_counter()
    r = subprocess.run(argv, env=env or worker_env(),
                       stdout=subprocess.DEVNULL,
                       stderr=subprocess.PIPE, text=True)
    dt = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"generate_dataset exited {r.returncode}: "
                           f"{r.stderr[-2000:]}")
    return dt


def _file_hashes(root: str) -> dict:
    out = {}
    for name in sorted(os.listdir(root)):
        if name.endswith(".npy"):
            with open(os.path.join(root, name), "rb") as f:
                out[name] = hashlib.md5(f.read()).hexdigest()
    return out


def _worker_metrics(root: str, num_workers: int) -> dict:
    """Per-worker stage timings and kernel launches from the
    ``metrics.w{k}.json`` files the workers wrote."""
    out = {}
    for k in range(num_workers):
        path = os.path.join(root, f"metrics.w{k}.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            m = json.load(f)["metrics"]
        out[f"w{k}"] = {"timings": m["timings"], "launches": m["launches"]}
    return out


def run(fast: bool = True, device="cuda") -> dict:
    dev = device_of(device)
    shard_edges = 1 << 14 if fast else 1 << 18
    n_shards = 8
    edges = n_shards * shard_edges
    if dev.type == "cuda":
        from repro_torch.kernels import _build, rmat_sample as rs
        _build.build_all([rs.LIBRARY])
    root = tempfile.mkdtemp(prefix="bench_cluster_")
    result = {"edges": edges, "shard_edges": shard_edges, "num_workers": 2,
              "device": dev.type}
    try:
        serial_out = os.path.join(root, "serial")
        cluster_out = os.path.join(root, "cluster")
        dt1 = _cli(serial_out, edges, shard_edges, dev.type)
        result["serial"] = {"seconds": dt1, "rows_per_sec": edges / dt1}
        print(f"cluster_serial,{dt1:.2f}s,{edges / dt1:,.0f} rows/s")
        dt2 = _cli(cluster_out, edges, shard_edges, dev.type,
                   "--num-workers", "2",
                   "--metrics-out", os.path.join(root, "metrics.json"))
        workers = _worker_metrics(root, 2)
        result["cluster2"] = {"seconds": dt2, "rows_per_sec": edges / dt2,
                              "workers": workers}
        print(f"cluster_2workers,{dt2:.2f}s,{edges / dt2:,.0f} rows/s")
        result["speedup"] = dt1 / dt2
        print(f"cluster_speedup,{result['speedup']:.3f},x")
        identical = _file_hashes(serial_out) == _file_hashes(cluster_out)
        result["byte_identical"] = identical
        print(f"cluster_byte_identical,{identical},")
        if not identical:
            raise AssertionError(
                "2-worker cluster output differs from the "
                "single-process run — placement changed bytes")
        if not fast and dev.type == "cuda":
            cold_out = os.path.join(root, "cold")
            cold_build = os.path.join(root, "kernels")
            cold_metrics = os.path.join(root, "cold", "metrics.json")
            dt3 = _cli(cold_out, edges, shard_edges, dev.type,
                       "--num-workers", "2", "--metrics-out", cold_metrics,
                       env=worker_env(REPRO_TORCH_BUILD=cold_build))
            same = _file_hashes(cold_out) == _file_hashes(serial_out)
            result["cluster2_cold"] = {
                "seconds": dt3, "first_use_s": dt3 - dt2,
                "built": sorted(os.listdir(cold_build)),
                "byte_identical": same,
                "workers": _worker_metrics(cold_out, 2)}
            print(f"cluster_2workers_cold,{dt3:.2f}s,"
                  f"{dt3 - dt2:+.2f}s first use")
            if not same:
                raise AssertionError("the cold 2-worker cluster's output "
                                     "differs from the single-process run")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit_bench("cluster", result)
    return result
