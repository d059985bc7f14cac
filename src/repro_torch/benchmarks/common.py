"""Shared benchmark helpers: device checks, timing, the CSV row protocol
and the BENCH envelope.

Every table module exposes ``run(fast: bool, device: str) -> rows`` with
keys ``name, us_per_call, derived`` (derived = the table's headline
quantity); ``repro_torch.benchmarks.run`` prints them as CSV and each
table writes its JSON under ``results/bench_torch/``.

``emit_bench`` writes a suite (``BENCH_*.json``) in the envelope of
``repro_torch.obs.metrics``: ``{schema_version, suite, created_unix, env:
{git_sha, host, torch, cuda, card, power_limit, ...}, metrics:
<payload>}``.

Times are host clock around work that ends on the device: on CUDA,
``sync`` before the clock starts and after the timed call.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.graph.ops import Graph
from repro_torch.obs.metrics import write_bench

BENCH_DIR = "results/bench_torch"


def device_of(device) -> torch.device:
    """``device`` as a torch device; a CUDA device with no card visible
    raises (no table carries on on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r}: no CUDA card is visible "
                           "(pass --device cpu to run on the CPU)")
    return dev


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def on(g: Graph, device) -> Graph:
    """``g`` with its id tensors on ``device``."""
    return Graph(g.src.to(device), g.dst.to(device), g.n_src, g.n_dst,
                 g.bipartite)


def emit_bench(suite: str, metrics: Any,
               extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Write ``results/bench_torch/BENCH_<suite>.json`` in the envelope."""
    path = os.path.join(BENCH_DIR, f"BENCH_{suite}.json")
    return write_bench(suite, metrics, path, extra)


def timeit(fn: Callable, *, device, repeats: int = 3,
           warmup: int = 1) -> float:
    """Median wall time per call in microseconds.  On CUDA the device is
    synchronized before the clock starts and after every call, so a call
    is timed to the end of its work, not of its launches.  ``device`` has
    no default, so that no caller can leave the synchronize out."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(repeats):
        sync(device)
        t0 = time.perf_counter()
        fn()
        sync(device)
        ts.append((time.perf_counter() - t0) * 1e6)
    ts.sort()
    return ts[len(ts) // 2]


def row(name: str, us: float, derived) -> Dict:
    return {"name": name, "us_per_call": round(us, 1), "derived": derived}


def emit(rows: List[Dict], out_name: str):
    os.makedirs(BENCH_DIR, exist_ok=True)
    with open(os.path.join(BENCH_DIR, f"{out_name}.json"), "w") as f:
        json.dump(rows, f, indent=2)
    for r in rows:
        print(f"{r['name']},{r['us_per_call']},{r['derived']}")
    return rows
